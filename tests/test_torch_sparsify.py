"""The port's voxel sparsifier and geometric predicates against the JAX
package on the CPU. Counts and cell ids exact; means within 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.geometry import intersections as ji
from fusion3dseg_tpu.ops import sparsify as js
from fusion3dseg_tpu_torch.geometry import intersections as ti
from fusion3dseg_tpu_torch.ops import sparsify as ts

RADIUS, MIN_COS = 0.1, 0.5
SHIFT = (0.01, 0.04, 0.07)


def _cloud(seed, n=4000, extent=2.0, outlier=False):
    """Points in a box with unit normals (half of them near one direction,
    so that voxels split), weights > 1 and a fifth of the rows invalid."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * extent).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[: n // 2] = np.float32([0, 0, 1]) + 0.3 * nrm[: n // 2]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    clr = rng.random((n, 3)).astype(np.float32)
    w = rng.integers(1, 6, n).astype(np.int32)
    occ = rng.integers(1, 4, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if outlier:  # one valid point far past a packed key's extent
        pts[0] = -50.0
        valid[0] = True
    return pts, nrm, clr, w, occ, valid


CASES = {
    "3key": dict(extent_cells=None),
    "3key_shift": dict(extent_cells=None, origin_shift=SHIFT),
    "packed": dict(extent_cells=64),
    "packed_shift": dict(extent_cells=64, origin_shift=SHIFT),
    "packed_too_wide": dict(extent_cells=3000),  # 3 * 12 bits > 31: the 3-key sort
    "out_of_extent": dict(extent_cells=40, outlier=True),  # recentre, drop the outlier
}


def _both(case, seed=0, **bounds):
    kw = dict(CASES[case])
    arrays = _cloud(seed, outlier=kw.pop("outlier", False))
    shift = kw.pop("origin_shift", None)
    want = js.voxel_merge(*map(jnp.asarray, arrays), RADIUS, MIN_COS,
                          origin_shift=None if shift is None else jnp.asarray(shift),
                          **kw, **bounds)
    got = ts.voxel_merge(*map(torch.from_numpy, arrays), RADIUS, MIN_COS, origin_shift=shift,
                         **kw)
    return want, got


@pytest.mark.parametrize("case", list(CASES))
def test_voxel_merge_matches_jax(case):
    want, got = _both(case)
    assert got.num_cells == want.num_cells == 8000
    for name in ("counts", "occurences", "cell_of_input"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for name in ("points", "normals", "colors"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    cells = got.cell_of_input.numpy()
    assert (cells >= 0).sum() > 1000 and (cells % 2 == 1).any()  # secondary cells occur
    if case == "out_of_extent":
        assert cells[0] == -1  # dropped, not clamped into a boundary voxel


@pytest.mark.parametrize("case,bounds", [
    ("packed", dict(max_cells=2048)),
    ("packed", dict(max_cells=2048, max_rows=3500)),
    ("3key", dict(max_rows=1000)),  # more valid rows than the bound: the exact tail
], ids=["cells", "cells_rows", "rows_overflow"])
def test_voxel_merge_matches_jax_bounded_path(case, bounds):
    # the TPU table-height bounds give the same grouping; the port ignores them
    want, got = _both(case, seed=1, **bounds)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.cell_of_input.numpy(), np.asarray(want.cell_of_input))


def test_patch_sparsify_and_compact_slots_match_jax():
    pts, nrm, clr, _, _, valid = _cloud(2, n=48 * 36)
    want = js.patch_sparsify(*map(jnp.asarray, (pts, nrm, clr, valid)), 48, 36, RADIUS, MIN_COS,
                             extent_cells=80)
    got = ts.patch_sparsify(*map(torch.from_numpy, (pts, nrm, clr, valid)), 48, 36, RADIUS,
                            MIN_COS, extent_cells=80)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.cell_of_pixel.numpy(), np.asarray(want.cell_of_pixel))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=1e-6, atol=1e-6)
    dest_w, total_w = js.compact_slots(want.counts)
    dest_g, total_g = ts.compact_slots(got.counts)
    np.testing.assert_array_equal(dest_g.numpy(), np.asarray(dest_w))
    assert int(total_g) == int(total_w) > 0 and total_g.dtype == torch.int32


def test_sort_orders_ties_by_input_id():
    # the port sorts with stable=True; XLA's CPU sort orders ties the same
    # way (the reference's _prefix sums depend on it)
    import jax

    k = np.random.default_rng(3).integers(0, 40, 50_000).astype(np.int32)
    ids = np.arange(len(k), dtype=np.int32)
    _, order = jax.lax.sort((jnp.asarray(k), jnp.asarray(ids)), num_keys=1)
    np.testing.assert_array_equal(np.asarray(order),
                                  torch.sort(torch.from_numpy(k), stable=True)[1].numpy())


def test_points_inside_polyhedra_matches_jax(rng):
    pts = rng.normal(size=(20000, 3)).astype(np.float32) * 3
    pp = rng.normal(size=(5, 3)).astype(np.float32)
    pn = rng.normal(size=(5, 3)).astype(np.float32)
    pn /= np.linalg.norm(pn, axis=1, keepdims=True)
    want = np.asarray(ji.points_inside_polyhedra(*map(jnp.asarray, (pts, pp, pn))))
    got = ti.points_inside_polyhedra(*map(torch.from_numpy, (pts, pp, pn))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_other_predicates_match_jax(rng):
    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    o, d, o2, d2 = f32(50, 3), f32(50, 3), f32(50, 3), f32(50, 3)
    pp, pn, poly = f32(3), f32(3), f32(4, 3)
    pns = np.tile(pn, (4, 1))
    d[0] = [1.0, 0.0, 0.0]
    pn_par = np.float32([0.0, 1.0, 0.0])  # parallel to ray 0
    T = torch.from_numpy
    pairs = [
        (ji.ray_plane_intersections(*map(jnp.asarray, (o, d, pp, pn_par))),
         ti.ray_plane_intersections(T(o), T(d), T(pp), T(pn_par))),
        (ji.lines_planes_intersections(*map(jnp.asarray, (o, d, poly, pns))),
         ti.lines_planes_intersections(T(o), T(d), T(poly), T(pns))),
        (ji.project_points_to_plane(*map(jnp.asarray, (o, pp, pn))),
         ti.project_points_to_plane(T(o), T(pp), T(pn))),
        (ji.ray_ray_closest_points(*map(jnp.asarray, (o, d, o2, d2))),
         ti.ray_ray_closest_points(T(o), T(d), T(o2), T(d2))),
        ((ji.plane_plane_direction(jnp.asarray(d), jnp.asarray(d2)),),
         (ti.plane_plane_direction(T(d), T(d2)),)),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert np.isinf(ti.ray_plane_intersections(T(o), T(d), T(pp), T(pn_par))[1][0].item())
    # a square on z = 0 and points on its plane
    sq = np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    q = np.concatenate([rng.random((40, 2)) * 2 - 0.5, np.zeros((40, 1))], 1).astype(np.float32)
    n = np.float32([0, 0, 1])
    want = np.asarray(ji.points_in_polygon_sign(*map(jnp.asarray, (q, sq, n))))
    np.testing.assert_array_equal(ti.points_in_polygon_sign(T(q), T(sq), T(n)).numpy(), want)
    assert 0 < want.sum() < len(want)
