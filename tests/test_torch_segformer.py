"""The port's SegFormer against the Flax model on the CPU: Flax parameters
go through `from_flax_params`, the same numpy images through both models.
Mirrors tests/test_attention.py (model flags), tests/test_import_hf.py
(the "hf" head) and tests/test_shipped_weights.py (the shipped snapshot)."""

import dataclasses

import flax.linen as nn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.io import synthetic as jsynthetic
from fusion3dseg_tpu.models import segformer as jseg
from fusion3dseg_tpu.pipeline import get2dseg as jget
from fusion3dseg_tpu_torch.models import segformer as tseg
from fusion3dseg_tpu_torch.models import convert

TINY = dict(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_heads=(1, 2, 3, 4), decoder_dim=32)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(hw, dtype=torch.float32, **kw):
    """(flax model, perturbed flax params as numpy, port model holding them)."""
    jcfg = jseg.SegFormerConfig(**TINY, dtype=JDT[dtype], **kw)
    tcfg = tseg.SegFormerConfig(**TINY, dtype=dtype, **kw)
    model = jseg.SegFormer(jcfg)
    # jitted init and apply: op-by-op dispatch of the Flax model takes half a
    # minute on the CPU
    dummy = jnp.zeros((1, *hw, 3), jnp.float32)
    params = nn.meta.unbox(jax.jit(model.init)(jax.random.PRNGKey(0), dummy)["params"])
    rng = np.random.default_rng(1)
    # move biases, norms and batch-norm statistics off their init values
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    if "bn_var" in params:
        params["bn_var"] = np.abs(params["bn_var"]) + 0.5
    tm = tseg.SegFormer(tcfg).eval()
    tm.load_state_dict(convert.from_flax_params(params, tcfg))
    return model, params, tm


def _logits(model, params, tm, x):
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("hw,kw", [
    ((64, 64), {}),
    ((64, 64), {"head": "hf"}),
    ((128, 128), {"use_pallas_attention": True}),  # stage 0 has N = 1024: the K3 branch
    ((64, 64), {"nat_windows": (5, 0, 0, 0)}),  # a K2 stage
    ((72, 40), {}),  # token grids the reduction conv must pad (Flax SAME)
], ids=["native", "hf", "sr_kernel_branch", "nat_stage", "ragged_grid"])
def test_logits_match_flax_f32(hw, kw):
    model, params, tm = _pair(hw, **kw)
    x = np.random.default_rng(0).random((2, *hw, 3)).astype(np.float32)
    got, want = _logits(model, params, tm, x)
    assert got.shape == want.shape == (2, *hw, 134) and got.dtype == np.float32
    # float32 on both sides; only summation order differs (found: 2e-6)
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert np.abs(got - want).max() < 5e-5


def test_logits_match_flax_bf16_tiny():
    model, params, tm = _pair((64, 64), dtype=torch.bfloat16)
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    got, want = _logits(model, params, tm, x)
    # bfloat16 activations round at different places in the two frameworks
    # (found: 0.019 on logits up to 1.5)
    assert np.abs(got - want).max() < 0.06
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.9


def test_parameter_dtypes_and_count():
    tm = tseg.SegFormer(tseg.SegFormerConfig(**TINY))
    for name, p in tm.named_parameters():
        f32 = "norm" in name or name.startswith("classifier")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    jshapes = jax.eval_shape(jseg.SegFormer(jseg.SegFormerConfig(**TINY)).init,
                             jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    n_flax = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(nn.meta.unbox(jshapes)))
    assert sum(p.numel() for p in tm.parameters()) == n_flax


@pytest.mark.parametrize("name", ["b0", "b1", "b2", "b3", "b4", "b5"])
def test_presets_match_jax(name):
    j, t = jseg.SegFormerConfig.named(name), tseg.SegFormerConfig.named(name)
    dj, dt = dataclasses.asdict(j), dataclasses.asdict(t)
    assert dj.pop("dtype") == jnp.bfloat16 and dt.pop("dtype") == torch.bfloat16
    assert dj == dt


def test_from_flax_params_rejects_missing_and_unused_keys():
    _, params, _ = _pair((64, 64))
    cfg = tseg.SegFormerConfig(**TINY, dtype=torch.float32)
    flat = convert.flatten_params(params)
    assert convert.unflatten_params(flat).keys() == params.keys()
    missing = {k: v for k, v in flat.items() if k != "fuse/bias"}
    with pytest.raises(KeyError, match="fuse.bias"):
        convert.from_flax_params(missing, cfg)
    with pytest.raises(KeyError, match="stray/kernel"):
        convert.from_flax_params({**flat, "stray/kernel": np.zeros((2, 2), np.float32)}, cfg)
    # a NAT stage has no reduction conv: the SRA tree does not fit it
    with pytest.raises(KeyError, match="sr"):
        convert.from_flax_params(flat, dataclasses.replace(cfg, nat_windows=(5, 0, 0, 0)))
    bad = dict(flat)
    bad["classifier/kernel"] = bad["classifier/kernel"][:, :7]
    with pytest.raises(ValueError, match="classifier"):
        convert.from_flax_params(bad, cfg)


def test_create_model_is_seeded_and_refuses_cuda_without_card():
    cfg = tseg.SegFormerConfig(**TINY)
    a = tseg.create_model(cfg, 3, device="cpu").state_dict()
    b = tseg.create_model(cfg, 3, device="cpu").state_dict()
    c = tseg.create_model(cfg, 4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tseg.create_model(cfg, 0)


def test_shipped_b1_bf16_matches_jax_on_textured_frames():
    """The shipped snapshot in bfloat16 at its trained 256x256 on two
    textured frames: the port's argmax agrees with JAX on >= 0.98 of pixels
    and the logits within SHIPPED_LOGIT_DIFF."""
    ckpt = convert.shipped_checkpoint("b1")
    assert ckpt == jget.shipped_checkpoint("b1") and ckpt is not None
    assert convert.checkpoint_input_hw(ckpt) == (256, 256)
    import cv2

    # frames as the held-out evaluation makes them: 96x72, resized to the
    # model's input
    sess = jsynthetic.make_session(
        nframes=2, depth_hw=(96, 72), appearance="textured",
        room=jsynthetic.RoomSpec(seed=(1 << 30) + 990_000))
    x = np.stack([cv2.resize(im, (256, 256), interpolation=cv2.INTER_LINEAR)
                  for im in sess.colors]).astype(np.float32) / 255.0
    params = convert.load_params_npz(ckpt)
    jmodel = jseg.SegFormer(jseg.SegFormerConfig.b1())
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    tcfg = tseg.SegFormerConfig.b1()
    tm = tseg.SegFormer(tcfg).eval()
    tm.load_state_dict(convert.from_flax_params(params, tcfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.98, agree
    gt = np.stack([cv2.resize(m, (256, 256), interpolation=cv2.INTER_NEAREST)
                   for m in sess.gt_mask])
    acc = (got.argmax(-1) == gt).mean()
    assert acc >= 0.95, acc
    diff = np.abs(got - want).max()
    assert diff < SHIPPED_LOGIT_DIFF, diff


# found on those two frames: largest logit difference 0.082 on logits spanning
# [-7.2, 10.5] (bfloat16 rounding through 8 blocks), argmax agreement 0.9998,
# pixel accuracy 0.9905; the bar is the difference found with margin
SHIPPED_LOGIT_DIFF = 0.25
