"""float16 through the port's attention kernels (K3, K2) and its segmenter,
against the JAX package on the CPU. The same numpy inputs go through the
plain PyTorch versions (what the wrappers run on CPU tensors) and through
the JAX kernels in interpret mode and their XLA paths; then float16
SegFormers through both packages, and a snapshot whose metadata says
"float16" through both packages' Segmenter2D. Mirrors
tests/test_torch_attention.py and tests/test_torch_segformer.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.io import synthetic as jsynthetic
from fusion3dseg_tpu.models import segformer as jseg
from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu.pipeline import get2dseg as jget
from fusion3dseg_tpu_torch.models import convert, segformer as tseg
from fusion3dseg_tpu_torch.ops import attention as tattn
from fusion3dseg_tpu_torch.pipeline import get2dseg as tget

# Bars, on unit-normal inputs (outputs below 4, where a float16 step is at
# most 2^-9, 1.95e-3). Against the JAX kernels in interpret mode, which round
# where the plain versions do (q * scale, K3's p, the output): the two
# frameworks sum the float32 scores in different orders, so K3's p and
# either output may land a float16 step apart: one step, 2e-3 (found: at
# most 4.9e-4 for either kernel). Against the XLA paths, which also round
# the scores to float16 (q . k in float16, then the scale): two steps, 4e-3
# (found: 9.8e-4 for K3, 1.5e-3 for K2).
F16_KERNEL, F16_XLA = 2e-3, 4e-3
# SegFormer logits: float16 activations through the blocks, rounded at
# different places in the two frameworks (a Dense or Conv bias added after
# the product's rounding in JAX, in one rounding here; GELU step by step in
# float16 in JAX, in one rounding here), a few float16 steps of the logits:
# toy models (found: at most 0.0031 on logits up to 1.8) and the shipped B1
# (found: at most 0.0128 on logits up to 9.8).
TOY_LOGITS, B1_LOGITS = 0.02, 0.05
# argmax agreement: the toy models' random weights leave near-ties between
# classes, where float16 rounding decides (found 0.9965-0.9998); the shipped
# B1's logits are decisive (found 0.99976-0.99988)
TOY_ARGMAX, B1_ARGMAX = 0.99, 0.999

TINY = dict(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
            num_heads=(1, 2, 3, 4), decoder_dim=32)
VARIANTS = {"default": ((64, 64), {}),
            "sr_kernel": ((128, 128), {"use_pallas_attention": True}),  # stage 0: N = 1024
            "nat_stage": ((64, 64), {"nat_windows": (7, 0, 0, 0)})}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one CPU thread while this module runs: beside the other
    test workers, torch's OpenMP regions over every core wait on descheduled
    threads (under five busy processes on 8 cores this module took 147 s on
    all threads, 105 s on one; alone 53 s either way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(rng, shape_q, shape_kv):
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv))
    return ([jnp.asarray(a, jnp.float16) for a in (q, k, v)],
            [torch.from_numpy(a).half() for a in (q, k, v)])


def _err(got, want):
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())


# ---------------------------------------------------------------- K3

@pytest.mark.parametrize("B,N,H,D,M", [
    (1, 1024, 2, 32, 64), (2, 512, 1, 64, 16),  # tests/test_torch_attention.py's
    (1, 512, 1, 160, 64),  # a head past 128 (the card's DP = 192 instance)
    (1, 512, 1, 64, 1000),  # more keys than mma.sync's shared memory holds at D = 64
])
def test_sr_plain_matches_pallas_interpret(rng, B, N, H, D, M):
    (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (B, N, H, D), (B, M, H, D))
    want = jattn.sr_attention(qj, kj, vj, q_tile=512, interpret=True)
    got = tattn.sr_attention(qt, kt, vt)  # CPU tensors: the plain version
    assert got.shape == (B, N, H, D) and tattn.sr_attention.launches == 0
    assert _err(got, want) <= F16_KERNEL


@pytest.mark.parametrize("B,N,H,D,M", [(2, 1024, 2, 32, 64), (1, 512, 1, 160, 1000)])
def test_sr_plain_matches_xla_path(rng, B, N, H, D, M):
    (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (B, N, H, D), (B, M, H, D))
    assert _err(tattn.sr_attention_reference(qt, kt, vt), jattn.sr_attention(qj, kj, vj)) \
        <= F16_XLA


def test_sr_rounds_as_the_jax_kernel(rng):
    """The plain version's float16 roundings, step by step: q * scale with the
    scale rounded to float16 first, scores and softmax in float32, p rounded
    to float16, the second product in float32, the output in float16."""
    _, (q, k, v) = _qkv(rng, (1, 64, 1, 48), (1, 16, 1, 48))
    scale = torch.tensor(1 / 48 ** 0.5).half()
    qs = (q.float() * scale.float()).half()  # one rounding of the float32 product
    assert torch.equal(tattn._scaled(q), qs)
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qs.float(), k.float()), -1).half()
    want = torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).half()
    assert torch.equal(tattn.sr_attention_reference(q, k, v), want)


# ---------------------------------------------------------------- K2

@pytest.mark.parametrize("B,Hh,D,H,W,K,rt", [
    (2, 2, 16, 16, 24, 5, 8), (1, 1, 8, 8, 8, 3, 4),  # tests/test_torch_attention.py's
    (1, 1, 32, 16, 16, 7, 8), (1, 2, 24, 12, 20, 9, 4),  # odd windows 7 and 9
    (1, 1, 160, 8, 16, 7, 8),  # a head past 128 (the card's wide kernel)
])
def test_nat_plain_matches_pallas_interpret(rng, B, Hh, D, H, W, K, rt):
    (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (B, H * W, Hh, D), (B, H * W, Hh, D))
    want = jattn.neighborhood_attention(qj, kj, vj, H, W, window=K, row_tile=rt,
                                        interpret=True)
    got = tattn.neighborhood_attention(qt, kt, vt, H, W, window=K)
    assert tattn.neighborhood_attention.launches == 0
    assert _err(got, want) <= F16_KERNEL


@pytest.mark.parametrize("H,W,K,D", [(9, 11, 5, 8), (13, 10, 9, 160)])
def test_nat_plain_matches_xla_reference_odd_grid(rng, H, W, K, D):
    (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (1, H * W, 2, D), (1, H * W, 2, D))
    want = jattn.neighborhood_attention_reference(qj, kj, vj, H, W, K)
    assert _err(tattn.neighborhood_attention_reference(qt, kt, vt, H, W, K), want) <= F16_XLA


def test_nat_plan_of_float16_is_bfloat16s():
    # two bytes an element: the launcher stages float16 as it does bfloat16
    for D in (8, 64, 128, 160, 320):
        for window in (3, 7, 23):
            for width in (8, 64):
                assert tattn._nat_plan(window, D, torch.float16, width) == \
                    tattn._nat_plan(window, D, torch.bfloat16, width)


def test_float16_routes_as_bfloat16():
    # the wgmma kernel on TMA layouts, mma.sync on others while it holds the
    # keys, wgmma on a copy past that; never the float32 kernel
    for M, D, route in ((64, 64, "wgmma"), (40, 20, "mma"), (1601, 20, "wgmma")):
        q, k = torch.zeros((1, 300, 2, D)), torch.zeros((1, M, 2, D))
        for dtype in (torch.float16, torch.bfloat16):
            assert tattn._sr_route(q.to(dtype), k.to(dtype), k.to(dtype)) == route
    with pytest.raises(ValueError, match="route"):
        tattn.launch_sr_attention(q.half(), k.half(), k.half(), "f32")


# ---------------------------------------------------------------- SegFormer

@pytest.fixture(scope="module")
def toy_params():
    """Flax-layout parameters of the tiny model, the port's seeded init (the
    Flax initialisers' distributions) carried across by `to_flax_params`, so
    that no Flax init compiles, perturbed off their init values; the same
    for each variant's input size (the weights do not depend on it)."""
    tm = tseg.SegFormer(tseg.SegFormerConfig(**TINY, dtype=torch.float32),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    return convert.unflatten_params({
        k: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        for k, v in convert.to_flax_params(tm.state_dict()).items()})


def _without_reduction(params, stage):
    """Flax parameters less stage `stage`'s reduction conv and its norm (what a
    neighbourhood stage does not have)."""
    flat = convert.flatten_params(params)
    return convert.unflatten_params({
        k: v for k, v in flat.items() if not (k.startswith(f"stage{stage}_") and (
            "/sr/" in k or "EfficientAttention_0/LayerNorm_0" in k))})


def _logits_both(jcfg, tcfg, params, x):
    want = np.asarray(jax.jit(jseg.SegFormer(jcfg).apply)({"params": params}, jnp.asarray(x)))
    tm = tseg.SegFormer(tcfg).eval()
    tm.load_state_dict(convert.from_flax_params(params, tcfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_toy_segformer_float16_matches_jax(toy_params, variant):
    hw, kw = VARIANTS[variant]
    params = _without_reduction(toy_params, 0) if "nat_windows" in kw else toy_params
    jcfg = jseg.SegFormerConfig(**TINY, dtype=jnp.float16, **kw)
    tcfg = tseg.SegFormerConfig(**TINY, dtype=torch.float16, **kw)
    x = np.random.default_rng(0).random((2, *hw, 3)).astype(np.float32)
    got, want = _logits_both(jcfg, tcfg, params, x)
    assert got.shape == want.shape == (2, *hw, 134) and got.dtype == np.float32
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() <= TOY_LOGITS
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= TOY_ARGMAX


@pytest.fixture(scope="module")
def textured_128():
    """Two held-out textured frames (96x72) and the same resized to 128x128."""
    import cv2

    sess = jsynthetic.make_session(nframes=2, depth_hw=(96, 72), appearance="textured",
                                   room=jsynthetic.RoomSpec(seed=(1 << 30) + 990_000))
    x = np.stack([cv2.resize(im, (128, 128), interpolation=cv2.INTER_LINEAR)
                  for im in sess.colors]).astype(np.float32) / 255.0
    return sess.colors, x


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_shipped_b1_float16_matches_jax(textured_128, variant):
    """The shipped B1 snapshot in float16 at 128x128 (stage 0: 1024 tokens,
    the K3 branch), whose trained logits are decisive: argmax agreement >=
    0.999 in each attention variant (the neighbourhood stage runs the
    weights less stage 0's reduction)."""
    _, x = textured_128
    kw = VARIANTS[variant][1]
    params = convert.load_params_npz(convert.shipped_checkpoint("b1"))
    if "nat_windows" in kw:
        params = _without_reduction(params, 0)
    jcfg = dataclasses.replace(jseg.SegFormerConfig.b1(), dtype=jnp.float16, **kw)
    tcfg = dataclasses.replace(tseg.SegFormerConfig.b1(), dtype=torch.float16, **kw)
    got, want = _logits_both(jcfg, tcfg, params, x)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert np.abs(got - want).max() <= B1_LOGITS
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= B1_ARGMAX


def test_float16_snapshot_gives_the_same_masks(tmp_path, textured_128):
    """A snapshot whose metadata says "float16" (and the fused
    spatial-reduction branch): both packages' Segmenter2D read the config
    from it and give the same masks."""
    frames, _ = textured_128
    params = convert.load_params_npz(convert.shipped_checkpoint("b1"))
    cfg = dataclasses.replace(jseg.SegFormerConfig.b1(), dtype=jnp.float16,
                              use_pallas_attention=True)
    path = tmp_path / "b1_float16.npz"
    jget.save_params_npz(path, params, input_hw=(128, 128), config=cfg)
    assert convert.load_npz_meta(path)["config"] == jget.load_npz_meta(path)["config"]
    js = jget.Segmenter2D(checkpoint_dir=path, batch_size=2)
    ts = tget.Segmenter2D(checkpoint_dir=path, batch_size=2, device="cpu")
    assert js.config.dtype == jnp.float16 and ts.config.dtype == torch.float16
    assert ts.config.use_pallas_attention and ts.input_hw == js.input_hw == (128, 128)
    want, got = js.predict_batch(frames), ts.predict_batch(frames)
    assert got.shape == want.shape == frames.shape[:3] and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
