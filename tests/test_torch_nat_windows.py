"""K2 (neighbourhood attention) at windows wider than its shared memory
once held: the plain version against the JAX package's Pallas kernel in
interpret mode at windows 15, 23 and 41, and the kernel's chunk plan
(`_nat_plan`, the mirror of `nat_plan` in csrc/neighborhood_attention.cu)
over every odd window up to 255. The kernel itself is held to the plain
version at these windows in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.ops import attention as tattn

# float32: both sides accumulate in float32 in another order (measured
# under 1e-6); bfloat16: the bar of tests/test_torch_attention.py
F32, BF16 = 1e-5, 3e-2
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90


@pytest.mark.parametrize("dtype,atol", [("f32", F32), ("bf16", BF16)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window", [15, 23, 41])
def test_plain_matches_pallas_interpret_wide_windows(dtype, atol, window, D):
    """On a 16 x 16 grid every query's window reaches past the image (41
    covers it whole from any query): the masking at the borders is all the
    difference between queries."""
    rng = np.random.default_rng(window * 1000 + D)
    H = W = 16
    q, k, v = (rng.normal(size=(1, H * W, 1, D)).astype(np.float32) for _ in range(3))
    tj = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = jattn.neighborhood_attention(*(jnp.asarray(a, tj) for a in (q, k, v)), H, W,
                                        window=window, row_tile=8, interpret=True)
    got = tattn.neighborhood_attention(*(torch.from_numpy(a).to(tt) for a in (q, k, v)), H, W,
                                       window=window)
    assert got.dtype == tt and tuple(got.shape) == (1, H * W, 1, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 24, 32, 64, 128])
def test_plan_fits_every_window_and_width(D, dtype):
    """No odd window from 1 to 255 at any width from 1 to 256 asks for more
    shared memory than a block has, and none is refused. A one-buffer plan
    holds the whole halo clamped to the width; a streamed plan cuts rows
    into pieces of whole groups of 8 columns or takes the whole width."""
    for window in range(1, 256, 2):
        halo = 8 + window - 1
        for width in range(1, 257):
            p = tattn._nat_plan(window, D, dtype, width)
            wide = min(halo, width)
            assert 0 < p.smem <= MAX_SMEM and p.rows >= 1, (window, width, p)
            if p.stages == 1:
                assert (p.rows, p.cols) == (halo, wide), (window, width, p)
            else:
                assert p.stages == 2 and p.rows <= halo, (window, width, p)
                assert p.cols == wide or (p.cols % 8 == 0 and p.cols < wide), (window, width, p)


def test_plan_keeps_window_7_in_one_buffer():
    """SegFormer's NAT stage (window 7, D = 64, bfloat16) stages its whole
    14 x 14 halo once, 56,448 bytes: four blocks an SM, as before the
    halo was streamed. Window 23 streams bands of three rows."""
    assert tattn._nat_plan(7, 64, torch.bfloat16, 64) == (14, 14, 1, 2 * 196 * 72 * 2)
    assert tattn._nat_plan(23, 64, torch.bfloat16, 64) == (3, 30, 2, 2 * 2 * 3 * 30 * 72 * 2)


@pytest.mark.parametrize("height,width,window,D,dtype", [
    (16, 16, 15, 64, torch.bfloat16), (13, 30, 23, 128, torch.float32),
    (9, 70, 41, 128, torch.bfloat16), (5, 3, 63, 128, torch.bfloat16)])
def test_plan_chunks_tile_each_clamped_halo(height, width, window, D, dtype):
    """The kernel's walk (`Walk` in the CUDA source): the halo of each 8 x 8
    tile, clamped to the image, cut into chunks of at most rows x cols,
    rows outer. The chunks cover every key position of the halo once and
    a one-buffer plan has a single chunk."""
    r, p = window // 2, tattn._nat_plan(window, D, dtype, width)
    for ty0 in range(0, height, 8):
        for tx0 in range(0, width, 8):
            y0, y1 = max(ty0 - r, 0), min(ty0 + 8 + r, height)
            x0, x1 = max(tx0 - r, 0), min(tx0 + 8 + r, width)
            ncx = -(-(x1 - x0) // p.cols)
            count = -(-(y1 - y0) // p.rows) * ncx
            seen = np.zeros((height, width), int)
            for c in range(count):
                cy0, cx0 = y0 + c // ncx * p.rows, x0 + c % ncx * p.cols
                seen[cy0:min(y1, cy0 + p.rows), cx0:min(x1, cx0 + p.cols)] += 1
            want = np.zeros_like(seen)
            want[y0:y1, x0:x1] = 1
            np.testing.assert_array_equal(seen, want)
            assert p.stages == 2 or count == 1
