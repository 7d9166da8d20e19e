"""The wide-head paths of K3 and K2 on the CPU: the shapes the CUDA launchers
choose past D = 128 (decided from D, the window and the width alone), held
to their limits, and the JAX kernels in interpret mode against the port's
plain versions (what the wrappers run on CPU tensors) at D = 192 and 384.
The kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.ops import attention as tattn

# the bars of tests/test_torch_head_dims.py
F32, BF16 = 1e-5, 3e-2
WIDE_DIMS = (129, 160, 192, 200, 256, 320, 384, 512)
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
SIZES = (1, 2, 7, 8, 9, 15, 16, 17, 23, 31, 64, 100, 256)


def _walk(y0, y1, x0, x1, rows, cols):
    """The chunks `Walk` in csrc/neighborhood_attention.cu cuts a clamped
    halo into: bands of `rows` rows outer, pieces of `cols` columns inner."""
    ncx = -(-(x1 - x0) // cols)
    for c in range(-(-(y1 - y0) // rows) * ncx):
        cy0, cx0 = y0 + c // ncx * rows, x0 + c % ncx * cols
        yield cy0, min(y1, cy0 + rows), cx0, min(x1, cx0 + cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_wide_plan_fits_every_window_and_width(D, dtype):
    """Every odd window from 1 to 63 at every width from 1 to 256 plans
    within the 57,344-byte staging budget. A chunk is a band of the halo
    clamped to the width, cut into pieces of whole groups of 8 columns (at
    most 64) or its whole width. bfloat16 (a block owns a strip of 2 x 8
    queries, its halo window + 1 rows): a chunk holds at most 16 slots of 8
    columns, with as many rows as that and the budget allow at two ring
    buffers, and then as many buffers (2 to 4) as fit; float32 (the same
    strips, within half an SM's shared memory): as many rows as keep a chunk
    at 128 positions, then as many buffers (2 to 4) as fit."""
    for window in range(1, 64, 2):
        halo = 8 + window - 1
        for width in range(1, 257):
            p = tattn._nat_plan(window, D, dtype, width)
            wide, nsx = min(halo, width), -(-p.cols // 8)
            budget = tattn._NAT_F32_WIDE_BUDGET if dtype == torch.float32 else tattn._NAT_BUDGET
            assert 0 < p.smem <= budget and 1 <= p.rows <= halo, (window, width, p)
            assert p.cols == min(wide, 64) and (p.cols == wide or p.cols % 8 == 0), (window, p)
            if dtype == torch.float32:
                npos = p.rows * p.cols
                assert 2 <= p.stages <= 4 and npos <= 128, (window, width, p)
                assert p.rows == min(window + 1, 128 // p.cols), (window, width, p)
                assert p.smem == tattn._f32_wide_smem(npos, p.stages), (window, width, p)
                assert p.stages == 4 or tattn._f32_wide_smem(
                    npos, p.stages + 1) > tattn._NAT_F32_WIDE_BUDGET, (window, width, p)
                continue
            npos = p.rows * p.cols
            assert 2 <= p.stages <= 4 and p.rows <= window + 1 and p.rows * nsx <= 16, (window, p)
            assert p.smem == tattn._mma_wide_smem(window, D, npos, p.stages), (window, width, p)
            more = p.rows + 1
            assert p.rows == min(window + 1, 16 // nsx) or tattn._mma_wide_smem(
                window, D, more * p.cols, 2) > tattn._NAT_BUDGET, (window, width, p)
            assert p.stages == 4 or tattn._mma_wide_smem(
                window, D, npos, p.stages + 1) > tattn._NAT_BUDGET, (window, width, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("windows", [range(1, 16, 2), range(17, 32, 2), range(33, 64, 2)],
                         ids=["1-15", "17-31", "33-63"])
def test_wide_chunks_tile_every_clamped_halo(windows, dtype):
    """The walk over a wide plan's chunks covers every key position of each
    block's halo clamped to the image exactly once (2 x 8 strips, whose
    chunks take more rows where the clamped halo is narrower than the plan's
    pieces), on images no tile divides and on ones smaller than the window,
    for every odd window. A chunk fits the plan's buffers and holds at most
    16 slots (float32: at most 128 positions)."""
    rows_a_block = 2
    for window in windows:
        r = window // 2
        for width in SIZES:
            p = tattn._nat_plan(window, 320, dtype, width)
            for height in (1, 9, 20):
                for ty0 in range(0, height, rows_a_block):
                    for tx0 in range(0, width, 8):
                        y0, y1 = max(ty0 - r, 0), min(ty0 + rows_a_block + r, height)
                        x0, x1 = max(tx0 - r, 0), min(tx0 + 8 + r, width)
                        rows = (tattn._nat_f32_rows if dtype == torch.float32 else
                                tattn._nat_tile_rows)(p, y1 - y0, x1 - x0)
                        seen = np.zeros((height, width), int)
                        for cy0, cy1, cx0, cx1 in _walk(y0, y1, x0, x1, rows, p.cols):
                            nsx = -(-(cx1 - cx0) // 8)
                            assert (cy1 - cy0) * (cx1 - cx0) <= p.rows * p.cols
                            if dtype == torch.float32:
                                assert (cy1 - cy0) * (cx1 - cx0) <= 128
                            else:
                                assert (cy1 - cy0) * nsx <= 16
                            seen[cy0:cy1, cx0:cx1] += 1
                        want = np.zeros_like(seen)
                        want[y0:y1, x0:x1] = 1
                        np.testing.assert_array_equal(seen, want, err_msg=f"{window} {width}")


def test_bf16_wide_plan_at_window_7():
    """B2 re-headed (stage 2 at 256x256: 16 x 16 tokens, D = 320) keeps each
    query's 49 scores (rows of 52 floats) and takes a strip's 8 x 14 halo in
    one chunk through two ring buffers, beside q (rows of 328) and p (rows
    of 136, twice); a corner strip's halo clamped to 5 x 11 is one chunk.
    Windows past 11 keep a chunk's scores."""
    assert [w for w in range(1, 64, 2) if tattn._window_scores(w)] == list(range(1, 12, 2))
    p = tattn._nat_plan(7, 320, torch.bfloat16, 16)
    assert p == (8, 14, 2, 16 * (53 * 4 + 328 * 2 + 2 * 136 * 2) + 2 * 112 * 72 * 2)
    assert tattn._nat_tile_rows(p, 5, 11) == 5
    assert len(list(_walk(0, 5, 0, 11, 5, p.cols))) == 1
    assert tattn._nat_plan(7, 256, torch.bfloat16, 16)[:3] == (8, 14, 2)


@pytest.mark.parametrize("dp", sorted(tattn.WG_SHAPES) + ["columns"])
def test_sr_shape_gives_every_head_dim_an_instance(dp):
    """Every D from 129 to 512 gets a wgmma instance: D padded to 192, 256
    or 320 (no longer to 256 from 129 on), past 320 the column-block kernel.
    Each instance fits an SM's shared memory with at least two K, V stages,
    and its warpgroups' registers under setmaxnreg lie within the launch's
    pool (threads x the most ptxas gives a thread at that launch bound); a
    consumer holds O, a key tile's scores and p within its share."""
    for D in range(1, 513):
        for M in (1, 64, 65, 256, 1024):
            s = tattn._sr_shape(D, M)
            if dp != (s.dp if D <= 320 else "columns"):
                continue
            assert s.smem <= MAX_SMEM and s.stages >= 2, (D, M, s)
            if dp == "columns":
                assert s == (256, 64, 1, 4, 1024 + 4 * 16384), (D, M, s)
                continue
            assert s.dp - 64 < D <= s.dp or (s.dp == 64 and D <= 64), (D, s)
            consumers, producer_regs, consumer_regs, q_stages, o_in_q = tattn.WG_SHAPES[s.dp]
            threads = 128 * (consumers + 1)
            pool = min(255, 65536 // threads) // 8 * 8
            assert 128 * (producer_regs + consumers * consumer_regs) <= threads * pool, (D, s)
            assert s.dp // 2 + s.kt // 2 + s.kt // 4 <= consumer_regs - 32, (D, s)
            tile = 64 * s.dp * 2
            fixed = 1024 + (q_stages + (0 if o_in_q else 2)) * consumers * tile
            assert s.smem == fixed + s.stages * 2 * s.kt * s.dp * 2, (D, s)
    assert tattn._sr_shape(160, 256) == (192, 64, 2, 3, 197632)
    assert tattn._sr_shape(320, 256) == (320, 32, 2, 3, 205824)
    assert tattn._sr_shape(256, 64) == (256, 64, 2, 2, 197632)


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
@pytest.mark.parametrize("D", [192, 384])
def test_sr_attention_at_192_and_384_matches_pallas_interpret(D, dtype, atol):
    # D = 192 fills WgShape<192>; 384 lies past the cut, in column blocks
    (qj, kj, vj), (qt, kt, vt) = _qkv(D, (1, 512, 1, D), (1, 100, 1, D), dtype)
    want = jattn.sr_attention(qj, kj, vj, q_tile=256, interpret=True)
    got = tattn.sr_attention(qt, kt, vt)  # CPU tensors: the plain version
    assert got.dtype == qt.dtype and got.shape == (1, 512, 1, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


@pytest.mark.parametrize("dtype,atol", [("f32", F32), ("bf16", BF16)])
@pytest.mark.parametrize("D", [192, 384])
def test_neighborhood_attention_at_192_and_384_matches_pallas_interpret(D, dtype, atol):
    # D = 384 takes two column blocks of the bfloat16 wide kernel
    (qj, kj, vj), (qt, kt, vt) = _qkv(D + 1, (1, 16 * 16, 1, D), (1, 16 * 16, 1, D), dtype)
    want = jattn.neighborhood_attention(qj, kj, vj, 16, 16, 7, row_tile=8, interpret=True)
    got = tattn.neighborhood_attention(qt, kt, vt, 16, 16, 7)
    assert got.dtype == qt.dtype and got.shape == (1, 256, 1, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
