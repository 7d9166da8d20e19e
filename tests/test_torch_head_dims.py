"""K3 and K2 above D = 128 and at any batch x heads, on the CPU: the JAX
kernels in interpret mode against the port's plain versions (what the
wrappers run on CPU tensors), the route and the chunk plan the CUDA
launchers take at those widths (decided from shapes and strides alone), and
a tiny SegFormer whose last two stages have single heads of 160 and 136
channels against the Flax model. The kernels themselves are held to their
plain versions on the card in tests/test_torch_cuda.py and chip_smoke.py."""

import flax.linen as nn
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.models import segformer as jseg
from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.models import convert
from fusion3dseg_tpu_torch.models import segformer as tseg
from fusion3dseg_tpu_torch.ops import attention as tattn

# float32: both sides accumulate in float32 in other orders (found: 7e-7 at
# D = 320). bfloat16: the bar of tests/test_torch_attention.py
F32, BF16 = 1e-5, 3e-2
WIDE_DIMS = (129, 160, 256, 320, 512)
# a tiny SegFormer whose stages 2 and 3 have one head of 160 and of 136
WIDE = dict(num_classes=134, embed_dims=(16, 32, 160, 136), depths=(1, 1, 1, 1),
            num_heads=(1, 1, 1, 1), decoder_dim=32)


def _qkv(seed, shape_q, shape_kv, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv))
    tj = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, tj) for a in (q, k, v)],
            [torch.from_numpy(a).to(tt) for a in (q, k, v)])


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype,atol", [("f32", F32), ("bf16", BF16)])
@pytest.mark.parametrize("D", [129, 200, 256, 320])
def test_sr_attention_wide_matches_pallas_interpret(D, dtype, atol):
    (qj, kj, vj), (qt, kt, vt) = _qkv(D, (1, 512, 1, D), (1, 64, 1, D), dtype)
    want = jattn.sr_attention(qj, kj, vj, q_tile=256, interpret=True)
    got = tattn.sr_attention(qt, kt, vt)  # CPU tensors: the plain version
    assert got.dtype == qt.dtype and got.shape == (1, 512, 1, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("dtype,atol", [("f32", F32), ("bf16", BF16)])
@pytest.mark.parametrize("D", [160, 320])
def test_neighborhood_attention_wide_matches_pallas_interpret(D, dtype, atol):
    (qj, kj, vj), (qt, kt, vt) = _qkv(D, (1, 256, 1, D), (1, 256, 1, D), dtype)
    want = jattn.neighborhood_attention(qj, kj, vj, 16, 16, 7, row_tile=8, interpret=True)
    got = tattn.neighborhood_attention(qt, kt, vt, 16, 16, 7)
    assert got.dtype == qt.dtype and got.shape == (1, 256, 1, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


def _layouts(shape):
    """bfloat16 [B, T, H, D] tensors in layouts TMA can and cannot describe:
    contiguous, a base 2 and 8 bytes past a 16-byte boundary, a token stride
    of D + 1 elements, and a head-major transpose."""
    B, T, H, D = shape
    flat = torch.zeros(16 + B * T * H * (D + 1), dtype=torch.bfloat16)
    base = (16 - flat.data_ptr() % 16) % 16 // 2
    yield "contiguous", torch.zeros(shape, dtype=torch.bfloat16)
    for off in (1, 4):
        yield f"offset {2 * off} bytes", flat[base + off:base + off + B * T * H * D].view(shape)
    row = H * (D + 1)
    yield "token stride D + 1", flat.as_strided(shape, (T * row, row, D + 1, 1), base)
    yield "head-major", torch.zeros((B, H, T, D), dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("D", [129, 136, 160, 200, 256, 320, 512])
def test_route_never_takes_mma_above_128(D):
    # the mma.sync kernel's domain is D <= 128: every bfloat16 layout of a
    # wider head goes to wgmma, on a copy where TMA cannot describe it
    for M in (1, 64, 200, 1000):
        for name, t in _layouts((2, 64, 2, D)):
            k = torch.zeros((2, M, 2, D), dtype=torch.bfloat16)
            assert not tattn._mma_fits(M, D)
            assert tattn._sr_route(t, k, k) == "wgmma", (name, M)
            assert tattn._sr_route(t, t, t) == "wgmma", (name, M)


def test_launch_on_the_mma_route_refuses_above_128():
    q = torch.zeros((1, 64, 1, 160), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mma route takes D <= 128"):
        tattn.launch_sr_attention(q, q, q, "mma")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_nat_plan_fits_every_window_and_width(D, dtype):
    """The wide kernels' chunks: no odd window from 1 to 63 at any width
    from 1 to 256 asks for more than the staging budget, and none is
    refused. A chunk is cut from the halo clamped to the width in pieces of
    whole groups of 8 columns or its whole width. Both kernels give a block
    a strip of 2 x 8 queries. float32: at most 128 positions a chunk, 16
    rows of p and a ring of two to four units of the strip's q and the
    chunk's positions, 64 columns each, within half an SM's shared memory.
    bfloat16: at most 16 slots of 8 columns a chunk
    (the registers of the eight warps' scores, two slots each), its 16
    score rows, q and p, and a ring of two to four units of 64 columns."""
    for window in range(1, 64, 2):
        halo = 8 + window - 1
        for width in range(1, 257):
            p = tattn._nat_plan(window, D, dtype, width)
            wide = min(halo, width)
            nsx = -(-p.cols // 8)
            budget = tattn._NAT_F32_WIDE_BUDGET if dtype == torch.float32 else tattn._NAT_BUDGET
            assert 0 < p.smem <= budget, (window, width, p)
            assert p.cols == wide or (p.cols % 8 == 0 and p.cols < wide), (window, width, p)
            npos = p.rows * p.cols
            if dtype == torch.float32:
                # 16 rows of p (npos floats, up to 4 mod 8) beside the ring
                # of units of 16 + npos rows of 68 floats
                assert 2 <= p.stages <= 4 and 1 <= p.rows <= window + 1, (window, width, p)
                assert npos <= 128 and p.cols <= 64, (window, width, p)
                ld = npos + (12 - npos % 8) % 8
                assert p.smem == 16 * ld * 4 + p.stages * (16 + npos) * 68 * 4, (window, width, p)
            else:
                # a strip of 2 x 8 queries a block: 16 score rows of the
                # window's (up to window 11) or the chunk's entries rounded
                # up to 4 mod 8 floats and the corrections, the strip's q
                # (D in units of 64, and 8), p twice in rows of 136, 2 to 4
                # ring buffers of rows of 72 bfloat16
                assert 2 <= p.stages <= 4 and 1 <= p.rows <= window + 1, (window, width, p)
                assert p.rows * nsx <= 16, (window, width, p)
                n = window * window if window <= 11 else npos
                ld, qld = n + (12 - n % 8) % 8, -(-D // 64) * 64 + 8
                assert p.smem == 16 * ((ld + 1) * 4 + qld * 2 + 2 * 136 * 2) + \
                    p.stages * npos * 72 * 2, (window, width, p)


@pytest.mark.parametrize("height,width,window", [(16, 16, 7), (13, 19, 7), (9, 70, 41),
                                                 (12, 30, 15), (5, 3, 63), (30, 27, 23),
                                                 (20, 24, 1), (33, 40, 11), (64, 64, 7),
                                                 (17, 100, 63)])
def test_wide_chunks_tile_each_clamped_halo(height, width, window):
    """The kernel's walk over the wide plan's chunks covers every key
    position of each tile's clamped halo once."""
    r, p = window // 2, tattn._nat_plan(window, 320, torch.bfloat16, width)
    for ty0 in range(0, height, 8):
        for tx0 in range(0, width, 8):
            y0, y1 = max(ty0 - r, 0), min(ty0 + 8 + r, height)
            x0, x1 = max(tx0 - r, 0), min(tx0 + 8 + r, width)
            ncx = -(-(x1 - x0) // p.cols)
            seen = np.zeros((height, width), int)
            for c in range(-(-(y1 - y0) // p.rows) * ncx):
                cy0, cx0 = y0 + c // ncx * p.rows, x0 + c % ncx * p.cols
                seen[cy0:min(y1, cy0 + p.rows), cx0:min(x1, cx0 + p.cols)] += 1
            want = np.zeros_like(seen)
            want[y0:y1, x0:x1] = 1
            np.testing.assert_array_equal(seen, want)


@pytest.mark.parametrize("kw", [{}, {"nat_windows": (0, 0, 7, 0)},
                                {"use_pallas_attention": True}],
                         ids=["native", "nat_stage_2", "sr_kernel_branch"])
def test_segformer_with_wide_heads_matches_flax(kw):
    hw = (128, 128)
    jcfg = jseg.SegFormerConfig(**WIDE, dtype=jnp.float32, **kw)
    tcfg = tseg.SegFormerConfig(**WIDE, dtype=torch.float32, **kw)
    model = jseg.SegFormer(jcfg)
    params = nn.meta.unbox(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3), jnp.float32))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    if "bn_var" in params:
        params["bn_var"] = np.abs(params["bn_var"]) + 0.5
    tm = tseg.SegFormer(tcfg).eval()
    tm.load_state_dict(convert.from_flax_params(params, tcfg))
    x = np.random.default_rng(0).random((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *hw, 134)
    # the bars of tests/test_torch_segformer.py
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert np.abs(got - want).max() < 5e-5
