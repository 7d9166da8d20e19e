"""What surrounds kernel K1 on the host: the row pitch the label lifter
allocates its winner matrix with, the alignment test that selects the
kernel, and the wrapper on strided views.

The CUDA kernels run only on the card (tests/test_torch_cuda.py). Here the
same NumPy inputs go through the port on the CPU and through the JAX
package (the Pallas kernel in interpret mode, as its own tests run it) and
must agree exactly: the pitch must change no result.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import label_fuse as J
from fusion3dseg_tpu.ops.histogram import histogram_classify_tpu
from fusion3dseg_tpu_torch.ops import histogram as th
from fusion3dseg_tpu_torch.ops import label_fuse as T

HW = (32, 24)
NC = 10
TILE = 256  # the Pallas kernel needs N % tile_n == 0


# ------------------------------------------------------------- the pitch rule

@pytest.mark.parametrize("npts", [1, 15, 16, 127, 128, 1000, 2 ** 20])
def test_row_pitch_is_aligned_and_holds_the_trash_column(npts):
    pitch = th.row_pitch(npts + 1)
    assert pitch % th.ROW_ALIGN == 0 and th.ROW_ALIGN % 16 == 0
    assert npts + 1 <= pitch < npts + 1 + th.ROW_ALIGN


def test_row_pitch_edges():
    assert th.row_pitch(0) == 0
    assert th.row_pitch(th.ROW_ALIGN) == th.ROW_ALIGN
    with pytest.raises(ValueError):
        th.row_pitch(-1)


@pytest.mark.parametrize("ptr,stride,nrows,want", [
    (4096, 1_000_064, 300, True),   # the label lifter's layout
    (4096, 1_000_001, 300, False),  # rows npts + 1 bytes apart
    (4097, 1_000_064, 300, False),  # a base offset by one byte
    (4096 + 16, 128, 2, True),
    (4096, 1_000_001, 1, True),     # one row: its pitch does not matter
    (4096, 8, 2, False),
])
def test_rows_aligned(ptr, stride, nrows, want):
    assert th.rows_aligned(ptr, stride, nrows) is want


@pytest.mark.parametrize("npts", [1, 127, 128, 1000])
def test_winner_matrix_layout(npts):
    C = T._winner_matrix(npts, 5, torch.device("cpu"))
    assert C.shape == (5, npts + 1) and C.dtype == torch.uint8
    assert C.stride() == (th.row_pitch(npts + 1), 1)
    assert th.rows_aligned(C.data_ptr(), C.stride(0), 5)
    assert th.rows_aligned(C[:, :npts].data_ptr(), C.stride(0), 5)  # what K1 is given
    assert bool((C == T.INVALID).all())
    C[2, npts] = 7  # the trash slot is writable and outside [:, :npts]
    assert bool((C[:, :npts] == T.INVALID).all())


# ------------------------------------- the label lifter with the aligned pitch

def _rotating(N, F=12, seed=0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(N, 3)) + [0, 0, 3.0]).astype(np.float32)
    K = np.array([[20.0, 0, 12], [0, 20.0, 16], [0, 0, 1]], np.float32)
    masks = rng.integers(0, NC, (F, HW[0] * HW[1])).astype(np.uint8)
    ang = np.linspace(0, 2 * np.pi, F, endpoint=False)
    trans = np.stack([np.cos(ang) * 0.3, np.zeros(F), np.sin(ang) * 0.3], -1).astype(np.float32)
    quats = np.stack(
        [np.cos(ang / 2), np.zeros(F), np.sin(ang / 2), np.zeros(F)], -1
    ).astype(np.float32)
    return pts, K, quats, trans, masks


# 2943 + 1 is a multiple of the alignment (no padding beyond the trash
# column), 2944 is one itself (a whole row of padding), 3000 is neither
@pytest.fixture(scope="module", params=[2943, 2944, 3000])
def session_and_jax(request):
    session = _rotating(request.param)
    (tot, vmax), cls = J.tpu_label_fuse(len(session[0]), NC, HW)(
        *[jnp.asarray(a) for a in session])
    return session, [np.asarray(a) for a in (tot, vmax, cls)]


def _eq(want, got):
    (tot, vmax), cls = got
    for w, g in zip(want, (tot, vmax, cls)):
        np.testing.assert_array_equal(w, g.numpy())


def test_unculled_equal_with_aligned_pitch(session_and_jax):
    session, want = session_and_jax
    _eq(want, T.tpu_label_fuse(len(session[0]), NC, HW, device="cpu")(*session))


@pytest.mark.parametrize("id_bits", [20, 10])  # single-sub and gid-range-sharded
def test_cells_equal_with_aligned_pitch(session_and_jax, id_bits):
    (pts, K, quats, trans, masks), want = session_and_jax
    cells_table, cell_lists, counts = T.build_cell_index(pts, K, quats, trans, HW, cell_size=64)
    perm, sizes, Ks = T.plan_window_buckets(counts, nbuckets=3, round_to=2,
                                            max_window=cell_lists.shape[1])
    run = T.tpu_label_fuse_cells(len(pts), NC, HW, Ks, sizes, id_bits=id_bits, device="cpu")
    _eq(want, run(cells_table, cell_lists[perm], K, quats[perm], trans[perm], masks[perm]))


def test_session_equal_with_aligned_pitch(session_and_jax):
    session, want = session_and_jax
    _eq(want, T.label_fuse_session(*session, HW, nclasses=NC, cell_size=64, nbuckets=3,
                                   device="cpu"))


# ----------------------------------------- the wrapper on strided views, on CPU

@pytest.mark.parametrize("pitch_of", ["aligned", "odd"])
@pytest.mark.parametrize("nclasses", [5, 133, 254])
@pytest.mark.parametrize("F", [1, 13, 301])
def test_wrapper_on_strided_views_matches_pallas(F, nclasses, pitch_of):
    N = 500
    rng = np.random.default_rng(F * 1000 + nclasses)
    # ids up to nclasses + 3 where that stays below 255: they count toward
    # total only
    C = rng.integers(0, min(nclasses + 4, 255), (F, N)).astype(np.uint8)
    C[rng.random((F, N)) < 0.4] = 255
    C[:, 7] = 255  # an empty column
    C[:, 8] = nclasses  # the last class wins
    pitch = th.row_pitch(N + 1) if pitch_of == "aligned" else N + 1
    wide = torch.full((F, pitch), 255, dtype=torch.uint8)
    view = wide[:, :N]
    view.copy_(torch.from_numpy(C))
    assert view.stride() == (pitch, 1)
    if pitch_of == "aligned":  # what would select the tiled kernel on the card
        assert th.rows_aligned(view.data_ptr(), pitch, F)
    (tot, vmax), cls = th.histogram_classify(view, nclasses, 0.5)
    Cp = np.full((F, -(-N // TILE) * TILE), 255, np.uint8)
    Cp[:, :N] = C
    (jt, jv), jc = histogram_classify_tpu(jnp.asarray(Cp), nclasses, 0.5, tile_n=TILE,
                                          interpret=True)
    for w, g in zip((jt, jv, jc), (tot, vmax, cls)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(w)[:N], g.numpy())
    assert int(cls[7]) == nclasses and int(tot[7]) == 0
    assert int(cls[8]) == nclasses and int(vmax[8]) == F
