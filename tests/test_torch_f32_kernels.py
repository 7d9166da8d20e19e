"""The float32 kernels of K3 and K2 on the CPU: the launch plans the CUDA
launchers choose (`_sr_f32_shape`, `_nat_plan`'s float32 branch and
`_nat_f32_rows`, mirrors of `F32Tile`, `f32_wide_plan` and `f32_wide_rows`
in csrc/) against hand-worked cases, and the order of arithmetic the
one-pass kernels use, emulated here in float64 (key tiles or halo chunks of
the kernels' sizes, a running max and sum, the division by the row sum at
the end), held to the JAX kernels in interpret mode in float32.

The kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py (phase 6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.ops import attention as tattn

# float32 against float64 emulation: float32 accumulation in the JAX
# kernels (measured: at most 2e-6 here)
F32 = 1e-5


# ---------------------------------------------------------------- K3 plan

# D -> (DP, keys a unit, units of the ring, shared bytes). DP = 64 DJ, DJ =
# D / 64 rounded up, at most 5; rows of DP + 8 floats; fixed: q (64 rows),
# p^T (32 rows of 68 floats), 2 x 64 statistics; then units of 32 rows, at
# most 4, within 232,448 bytes. DP = 320: (64 * 328 + 32 * 68 + 128) * 4 =
# 93,184, a unit 32 * 328 * 4 = 41,984, three units: 219,136.
SR_SHAPES = {
    7: (64, 32, 4, 27648 + 4 * 9216),
    64: (64, 32, 4, 27648 + 4 * 9216),
    128: (128, 32, 4, 44032 + 4 * 17408),
    160: (192, 32, 4, 60416 + 4 * 25600),
    256: (256, 32, 4, 76800 + 4 * 33792),
    320: (320, 32, 3, 93184 + 3 * 41984),
    321: (320, 32, 3, 93184 + 3 * 41984),  # past 320: column chunks of 320
    512: (320, 32, 3, 93184 + 3 * 41984),
}


@pytest.mark.parametrize("D", sorted(SR_SHAPES))
def test_sr_f32_shape_hand_worked(D):
    s = tattn._sr_f32_shape(D)
    assert tuple(s) == SR_SHAPES[D]
    assert s.smem <= 232448 and s.stages >= 2


# ---------------------------------------------------------------- K2 plans

# up to D = 128 the narrow kernel (unchanged): rows of 4 DPL floats (8, 64,
# 128 at D = 7, 64, 128), the whole clamped halo in one buffer where it fits
# 57,344 bytes, else two buffers of bands or row pieces
NARROW = {
    7: {(1, 16): (8, 8, 1, 4096), (1, 64): (8, 8, 1, 4096), (1, 256): (8, 8, 1, 4096),
        (7, 16): (14, 14, 1, 12544), (7, 64): (14, 14, 1, 12544),
        (7, 256): (14, 14, 1, 12544), (23, 16): (30, 16, 1, 30720),
        (23, 64): (14, 30, 2, 53760), (23, 256): (14, 30, 2, 53760),
        (63, 16): (28, 16, 2, 57344), (63, 64): (7, 64, 2, 57344),
        (63, 256): (6, 70, 2, 53760)},
    64: {(1, 16): (8, 8, 1, 32768), (1, 64): (8, 8, 1, 32768), (1, 256): (8, 8, 1, 32768),
         (7, 16): (4, 14, 2, 57344), (7, 64): (4, 14, 2, 57344), (7, 256): (4, 14, 2, 57344),
         (23, 16): (3, 16, 2, 49152), (23, 64): (1, 30, 2, 30720),
         (23, 256): (1, 30, 2, 30720), (63, 16): (3, 16, 2, 49152),
         (63, 64): (1, 56, 2, 57344), (63, 256): (1, 56, 2, 57344)},
    128: {(1, 16): (3, 8, 2, 49152), (1, 64): (3, 8, 2, 49152), (1, 256): (3, 8, 2, 49152),
          (7, 16): (2, 14, 2, 57344), (7, 64): (2, 14, 2, 57344), (7, 256): (2, 14, 2, 57344),
          (23, 16): (1, 16, 2, 32768), (23, 64): (1, 24, 2, 49152),
          (23, 256): (1, 24, 2, 49152), (63, 16): (1, 16, 2, 32768),
          (63, 64): (1, 24, 2, 49152), (63, 256): (1, 24, 2, 49152)},
}
# past D = 128, any D: a strip of 2 x 8 queries, its halo (window + 1 rows,
# window + 7 columns) clamped to the width in pieces of at most 64 columns,
# as many rows as keep a chunk at 128 positions; 16 rows of p (npos floats
# up to 4 mod 8), then 2-4 units of (16 + npos) rows of 68 floats within
# 115,200 bytes. Window 7 at width 16: 8 x 14 = 112 positions, p rows of
# 116: 7,424 + 3 * 128 * 272 = 111,872.
WIDE = {(1, 5): (2, 5, 4, 29056), (1, 16): (2, 8, 4, 36096), (1, 64): (2, 8, 4, 36096),
        (1, 256): (2, 8, 4, 36096), (7, 5): (8, 5, 4, 63744), (7, 16): (8, 14, 3, 111872),
        (7, 64): (8, 14, 3, 111872), (7, 256): (8, 14, 3, 111872),
        (23, 5): (24, 5, 2, 81920), (23, 16): (8, 16, 2, 86784),
        (23, 64): (4, 30, 2, 81920), (23, 256): (4, 30, 2, 81920),
        (63, 5): (25, 5, 2, 85152), (63, 16): (8, 16, 2, 86784),
        (63, 64): (2, 64, 2, 86784), (63, 256): (2, 64, 2, 86784)}


@pytest.mark.parametrize("window", [1, 7, 23, 63])
@pytest.mark.parametrize("D", [7, 64, 128, 160, 256, 320, 321, 512])
def test_nat_plan_f32_hand_worked(D, window):
    table = NARROW[D] if D in NARROW else WIDE
    for (w, width), want in table.items():
        if w == window:
            assert tuple(tattn._nat_plan(window, D, torch.float32, width)) == want, width


def test_nat_f32_rows_hand_worked():
    """A strip's chunk rows: the plan's positions over the widest piece its
    clamped halo allows, within its rows."""
    p7 = tattn._nat_plan(7, 320, torch.float32, 16)  # 8 x 14
    assert tattn._nat_f32_rows(p7, 8, 14) == 8
    assert tattn._nat_f32_rows(p7, 5, 11) == 5  # a corner strip: one chunk
    p63 = tattn._nat_plan(63, 320, torch.float32, 256)  # 2 x 64
    assert tattn._nat_f32_rows(p63, 33, 70) == 2
    assert tattn._nat_f32_rows(p63, 33, 20) == 6  # 128 // 20
    assert tattn._nat_f32_rows(p63, 4, 20) == 4
    assert tattn._nat_f32_rows(tattn._nat_plan(1, 320, torch.float32, 256), 2, 8) == 2


# ------------------------------------------------- one-pass order, emulated

def _scaled64(q):
    """q * (1 / sqrt(D) rounded to float32), rounded to float32 (the
    kernels' and the JAX kernels' q), as float64."""
    scale = np.float32(1.0 / q.shape[-1] ** 0.5)
    return (q * scale).astype(np.float32).astype(np.float64)


def sr_one_pass(q, k, v, keys=tattn._SR_F32_KT):
    """K3's float32 kernel in float64: key tiles of `keys`, the running row
    max and sum, O rescaled at each tile, O / l at the end."""
    qs = _scaled64(q)
    k64, v64 = k.astype(np.float64), v.astype(np.float64)
    B, N, H, D = q.shape
    m = np.full((B, H, N), -np.inf)
    l = np.zeros((B, H, N))
    o = np.zeros((B, H, N, D))
    for k0 in range(0, k.shape[1], keys):
        s = np.einsum("bnhd,bmhd->bhnm", qs, k64[:, k0:k0 + keys])
        m_new = np.maximum(m, s.max(-1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + np.einsum("bhnm,bmhd->bhnd", p, v64[:, k0:k0 + keys])
        m = m_new
    return (o / l[..., None]).transpose(0, 2, 1, 3)


def _chunks(y0, y1, x0, x1, rows, cols):
    """`Walk` in csrc/neighborhood_attention.cu: bands of rows outer, pieces
    of columns inner."""
    ncx = -(-(x1 - x0) // cols)
    for c in range(-(-(y1 - y0) // rows) * ncx):
        cy0, cx0 = y0 + c // ncx * rows, x0 + c % ncx * cols
        yield cy0, min(y1, cy0 + rows), cx0, min(x1, cx0 + cols)


def nat_one_pass(q, k, v, height, width, window):
    """K2's float32 wide kernel in float64: each strip of 2 x 8 queries
    walks its clamped halo in the plan's chunks; a query takes the keys of
    its window in each chunk, the running max and sum carried from chunk to
    chunk, O / l at the end."""
    qs = _scaled64(q)
    k64, v64 = k.astype(np.float64), v.astype(np.float64)
    B, N, H, D = q.shape
    r = window // 2
    plan = tattn._nat_plan(window, D, torch.float32, width)
    out = np.zeros((B, N, H, D))
    for ty0 in range(0, height, 2):
        for tx0 in range(0, width, 8):
            Y0, Y1 = max(ty0 - r, 0), min(ty0 + 2 + r, height)
            X0, X1 = max(tx0 - r, 0), min(tx0 + 8 + r, width)
            rows = tattn._nat_f32_rows(plan, Y1 - Y0, X1 - X0)
            for qy in range(ty0, min(ty0 + 2, height)):
                for qx in range(tx0, min(tx0 + 8, width)):
                    n = qy * width + qx
                    m = np.full((B, H), -np.inf)
                    l = np.zeros((B, H))
                    o = np.zeros((B, H, D))
                    for cy0, cy1, cx0, cx1 in _chunks(Y0, Y1, X0, X1, rows, plan.cols):
                        ys = range(max(cy0, qy - r), min(cy1, qy + r + 1))
                        xs = range(max(cx0, qx - r), min(cx1, qx + r + 1))
                        keys = [y * width + x for y in ys for x in xs]
                        if not keys:
                            continue
                        s = np.einsum("bhd,bkhd->bhk", qs[:, n], k64[:, keys])
                        m_new = np.maximum(m, s.max(-1))
                        alpha = np.exp(m - m_new)
                        p = np.exp(s - m_new[..., None])
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[..., None] + np.einsum("bhk,bkhd->bhd", p, v64[:, keys])
                        m = m_new
                    out[:, n] = o / l[..., None]
    return out


def _qkv(seed, shape_q, shape_kv):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("B,N,H,D,M", [
    (1, 128, 2, 64, 33),   # one key past a tile of 32
    (2, 128, 1, 160, 70),  # D padded to 192; a last tile of 6 keys
    (1, 128, 1, 320, 100),
    (1, 128, 1, 384, 1),   # past 320: column chunks and blocks; one key
])
def test_sr_one_pass_order_matches_jax(B, N, H, D, M):
    q, k, v = _qkv(D + M, (B, N, H, D), (B, M, H, D))
    want = np.asarray(jattn.sr_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         q_tile=128, interpret=True))
    got = sr_one_pass(q, k, v)
    np.testing.assert_allclose(got, want, atol=F32)
    # and the port's plain version, which the wrappers run on CPU tensors
    plain = tattn.sr_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(plain, want, atol=F32)


@pytest.mark.parametrize("height,width,D,window,row_tile", [
    (9, 11, 160, 7, 9),     # ragged strips and tiles; one chunk a strip
    (20, 40, 136, 23, 10),  # bands of 4 rows of 30 columns
    (6, 70, 320, 63, 6),    # pieces of 64 columns and 6
])
def test_nat_one_pass_order_matches_jax(height, width, D, window, row_tile):
    q, k, v = _qkv(D + window, (1, height * width, 1, D), (1, height * width, 1, D))
    want = np.asarray(jattn.neighborhood_attention(
        *(jnp.asarray(a) for a in (q, k, v)), height, width, window, row_tile=row_tile,
        interpret=True))
    got = nat_one_pass(q, k, v, height, width, window)
    np.testing.assert_allclose(got, want, atol=F32)
    plain = tattn.neighborhood_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                         height, width, window).numpy()
    np.testing.assert_allclose(plain, want, atol=F32)
