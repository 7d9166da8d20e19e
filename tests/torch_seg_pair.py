"""Shared by the port's segmenter tests: a tiny float32 SegFormer held by the
JAX package's Segmenter2D and by the port's, loaded from one npz snapshot."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import torch

from fusion3dseg_tpu.models import SegFormer, SegFormerConfig as JConfig
from fusion3dseg_tpu.pipeline.get2dseg import Segmenter2D as JSegmenter, save_params_npz
from fusion3dseg_tpu_torch.models import SegFormerConfig as TConfig
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D as TSegmenter

TINY = dict(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_heads=(1, 2, 3, 4), decoder_dim=32)


def segmenter_pair(tmp_dir, input_hw=(64, 64), batch_size=2, seed=0):
    """(JAX segmenter, port segmenter on the CPU) restored from the same
    snapshot of a seeded random init (jitted: the JAX segmenter's own eager
    init takes half a minute on the CPU)."""
    jcfg = JConfig(**TINY, dtype=jnp.float32)
    init = jax.jit(SegFormer(jcfg).init)
    params = nn.meta.unbox(
        init(jax.random.PRNGKey(seed), jnp.zeros((1, *input_hw, 3), jnp.float32))["params"])
    path = tmp_dir / "tiny.npz"
    save_params_npz(path, params, input_hw=input_hw)
    jseg = JSegmenter(config=jcfg, checkpoint_dir=path, batch_size=batch_size)
    tseg = TSegmenter(config=TConfig(**TINY, dtype=torch.float32), checkpoint_dir=path,
                      batch_size=batch_size, device="cpu")
    assert jseg.input_hw == tseg.input_hw == tuple(input_hw)
    return jseg, tseg
