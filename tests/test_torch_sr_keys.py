"""K3 (`sr_attention`) with more keys than one tile: the port on the CPU
(its plain version) against the JAX package, at the numbers of keys that
SegFormer-B2 gives at 640x640 (M = 400, here 300) and 1024x1024 (M = 1024),
and a narrow SegFormer whose first two stages take the fused branch with
1024 keys. The card holds its kernels to the same plain version
(tests/test_torch_cuda.py)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion3dseg_tpu.models import segformer as jseg
from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.models import convert
from fusion3dseg_tpu_torch.models import segformer as tseg
from fusion3dseg_tpu_torch.ops import attention as tattn

# the bars of tests/test_torch_attention.py
F32_SR, BF16 = 2e-3, 3e-2
# embed dims 16-32, one block a stage, a reduction of 2 in stage 0 only: at
# 256x256 stage 0 has N = 4096 queries against M = 1024 keys, stage 1
# N = M = 1024, and both take the fused branch (N % 512 == 0)
NARROW = dict(num_classes=134, embed_dims=(16, 32, 32, 32), depths=(1, 1, 1, 1),
              num_heads=(1, 2, 2, 4), sr_ratios=(2, 1, 1, 1), decoder_dim=32,
              use_pallas_attention=True)


@pytest.mark.parametrize("dtype,atol", [("f32", F32_SR), ("bf16", BF16)])
@pytest.mark.parametrize("H", [1, 2])
@pytest.mark.parametrize("M", [300, 1024])
def test_plain_matches_pallas_interpret(rng, M, H, dtype, atol):
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 512, H, 64), (1, M, H, 64), (1, M, H, 64)))
    tj = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = jattn.sr_attention(*(jnp.asarray(a, tj) for a in (q, k, v)), interpret=True)
    tattn.reset_sr_counts()
    got = tattn.sr_attention(*(torch.from_numpy(a).to(tt) for a in (q, k, v)))
    assert tattn.sr_attention.launches == 0  # CPU tensors: the plain version
    assert got.dtype == tt and got.shape == (1, 512, H, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)


@pytest.fixture(scope="module")
def narrow_pair():
    """(flax model, perturbed flax params as numpy, port model holding them)
    at 256x256 in float32, where the point is the algorithm."""
    model = jseg.SegFormer(jseg.SegFormerConfig(**NARROW, dtype=jnp.float32))
    dummy = jnp.zeros((1, 256, 256, 3), jnp.float32)
    params = nn.meta.unbox(jax.jit(model.init)(jax.random.PRNGKey(0), dummy)["params"])
    rng = np.random.default_rng(1)
    # move biases and norms off their init values
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    tcfg = tseg.SegFormerConfig(**NARROW, dtype=torch.float32)
    tm = tseg.SegFormer(tcfg).eval()
    tm.load_state_dict(convert.from_flax_params(params, tcfg))
    return model, params, tm


def test_narrow_segformer_1024_keys_matches_flax(narrow_pair):
    model, params, tm = narrow_pair
    x = np.random.default_rng(0).random((2, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    tattn.reset_sr_counts()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert tattn.sr_attention.launches == 0
    assert got.shape == want.shape == (2, 256, 256, 134) and got.dtype == np.float32
    # float32 on both sides; the bar of tests/test_torch_segformer.py
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_narrow_segformer_takes_the_fused_branch(narrow_pair, monkeypatch):
    # both of the first two stages reach sr_attention with 1024 keys
    _, _, tm = narrow_pair
    seen = []
    plain = tattn.sr_attention_reference

    def spy(q, k, v):
        seen.append((q.shape[1], k.shape[1]))
        return plain(q, k, v)

    monkeypatch.setattr(tattn, "sr_attention_reference", spy)
    with torch.no_grad():
        tm(torch.zeros((1, 256, 256, 3)))
    assert seen == [(4096, 1024), (1024, 1024)]
