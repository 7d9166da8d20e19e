"""The port's host tail against the JAX package on the CPU: the native
neighbour graph, the instance split, the OBBs (both backends) and
merge_bb. Given the same points and classes, ids, info and the artifacts
are identical."""

import filecmp
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.io import native as jnative
from fusion3dseg_tpu.ops import components as jcomp, obb as jobb
from fusion3dseg_tpu.pipeline.merge_bb import merge_bb as jmerge_bb
from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import native as tnative
from fusion3dseg_tpu_torch.ops import components as tcomp, obb as tobb
from fusion3dseg_tpu_torch.pipeline import merge_bb as tmerge


def _labelled_cloud(seed=0, n=3000):
    """Boxes of points in a few classes, some touching, plus scattered
    points that form small components, and unclassified points (133)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((8, 3)) * 1.6
    cls_of_box = rng.integers(0, 6, 8)
    box = rng.integers(0, 8, n)
    pts = centers[box] + rng.random((n, 3)) * 0.6
    classes = cls_of_box[box].copy()
    stray = rng.random(n) < 0.05
    pts[stray] = rng.random((stray.sum(), 3)) * 6
    classes[rng.random(n) < 0.04] = 133
    return pts.astype(np.float32), classes.astype(np.int32)


def test_native_library_is_built_into_the_port_build_dir():
    path = tnative.build()
    assert path.parent == cuda.build_dir() and path.exists()
    assert path.name.startswith("libneighbor_graph-")


def test_native_graphs_match_jax():
    pts, classes = _labelled_cloud(1, n=1500)
    np.testing.assert_array_equal(tnative.connected_components(pts, 0.1, labels=classes),
                                  jnative.connected_components(pts, 0.1, labels=classes))
    np.testing.assert_array_equal(tnative.connected_components(pts, 0.1),
                                  jnative.connected_components(pts, 0.1))
    adj = tnative.radius_graph(pts, 0.1, k=8)
    np.testing.assert_array_equal(adj, jnative.radius_graph(pts, 0.1, k=8))
    np.testing.assert_array_equal(tnative.components_from_adjacency(adj, classes),
                                  jnative.components_from_adjacency(adj, classes))
    lists = tnative.radius_graph_lists(pts, 0.1)
    want = jnative.radius_graph_lists(pts, 0.1)
    assert all(np.array_equal(a, b) for a, b in zip(lists, want))
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    flat = np.concatenate(lists)
    np.testing.assert_array_equal(tnative.components_from_csr(offsets, flat),
                                  jnative.components_from_csr(offsets, flat))
    assert tnative.connected_components(np.zeros((0, 3), np.float32), 0.1).shape == (0,)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    # no silent fall-back: a library that cannot be built is an error
    monkeypatch.setenv("F3S_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tnative, "_LIB", {})
    with pytest.raises((RuntimeError, OSError)):
        tnative.connected_components(np.zeros((3, 3), np.float32), 0.1)


@pytest.mark.parametrize("instance_classes,minimum_points", [
    (None, 1), (None, 40), ([0, 1, 2], 20)], ids=["all", "min40", "some_classes"])
def test_split_into_instances_matches_jax(instance_classes, minimum_points):
    pts, classes = _labelled_cloud()
    want = jcomp.split_into_instances_by_radius(classes, pts, 0.12, 133, instance_classes,
                                                minimum_points)
    got = tcomp.split_into_instances_by_radius(classes, pts, 0.12, 133, instance_classes,
                                               minimum_points)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert len(got[2]) > 5


@pytest.fixture(scope="module")
def split():
    pts, classes = _labelled_cloud()
    _, ids, info, _ = jcomp.split_into_instances_by_radius(classes, pts, 0.12, 133, None, 30)
    parent = {c: c % 3 for c in range(134)}  # shared parents, so that boxes merge
    for inf in info:
        inf["parent_id"] = parent.get(int(inf["category_id"])) if inf["id"] else None
    return pts, ids, info


def test_host_obbs_match_jax(split):
    pts, ids, info = split
    K = len(info)
    for fn in ("instance_obbs_np", "obb_intersection_matrix_np", "instance_obb_corners_np"):
        for g, w in zip(getattr(tobb, fn)(pts, ids, K), getattr(jobb, fn)(pts, ids, K)):
            assert g.dtype == w.dtype, fn
            np.testing.assert_array_equal(g, w, err_msg=fn)
    members = pts[ids == 2]
    for g, w in zip(tobb.pca_obb_np(members), jobb.pca_obb_np(members)):
        np.testing.assert_array_equal(g, w)
    inter = jobb.obb_intersection_matrix_np(pts, ids, K)[0]
    parents = np.asarray([i["parent_id"] if i["parent_id"] is not None else -1 for i in info])
    mergeable = np.arange(K) > 0
    np.testing.assert_array_equal(
        tobb.merge_intersecting_instances(inter, parents, mergeable),
        jobb.merge_intersecting_instances(inter, parents, mergeable))
    assert tobb.HOST_OBB_MAX_KN == jobb.HOST_OBB_MAX_KN


def _sorted_corners(c):
    return np.sort(np.asarray(c).reshape(-1, 8 * 3), axis=1)


def test_device_obbs_match_jax(split):
    # float32 on both sides; eigenvector signs may differ, so compare what
    # does not depend on them: intersections, counts, extents, corner sets
    pts, ids, _ = split
    ids = np.where(np.arange(len(ids)) % 17 == 0, -1, ids).astype(np.int32)  # ignored points
    K = int(ids.max()) + 2  # one empty instance
    want = jobb.obb_intersection_matrix(jnp.asarray(pts), jnp.asarray(ids), K)
    got = tobb.obb_intersection_matrix(torch.from_numpy(pts), torch.from_numpy(ids), K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(np.sort(got[3].numpy(), axis=1),
                               np.sort(np.asarray(want[3]), axis=1), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    gc, gn = tobb.instance_obb_corners(torch.from_numpy(pts), torch.from_numpy(ids), K)
    wc, wn = jobb.instance_obb_corners(jnp.asarray(pts), jnp.asarray(ids), K)
    np.testing.assert_allclose(_sorted_corners(gc.numpy()), _sorted_corners(wc), atol=1e-4)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    inside = tobb.points_inside_obbs(torch.from_numpy(pts), *got[1:4])
    assert inside.shape == (K, len(pts)) and not bool(inside[-1].any())  # empty box


@pytest.mark.parametrize("backend", ["host", "device"])
def test_merge_bb_matches_jax(split, tmp_path, backend):
    pts, ids, info = split
    jinfo, jids = jmerge_bb(tmp_path / "jax", json.loads(json.dumps(info)), ids, pts,
                                  verbose=False, backend=backend)
    tinfo, tids = tmerge.merge_bb(tmp_path / "port", json.loads(json.dumps(info)), ids, pts,
                                  verbose=False, backend=backend, device="cpu")
    assert len(tinfo) < len(info)  # some boxes merged
    np.testing.assert_array_equal(tids, jids)
    out = "panoptic_segmentation"
    if backend == "host":
        assert tinfo == jinfo
        for name in ("final_info.json", "ids.npy"):
            assert filecmp.cmp(tmp_path / "jax" / out / name, tmp_path / "port" / out / name,
                               shallow=False), name
    else:  # float32 boxes on both sides, eigenvector signs free
        assert [{k: v for k, v in i.items() if k != "bbox"} for i in tinfo] == \
            [{k: v for k, v in i.items() if k != "bbox"} for i in jinfo]
        for t, j in zip(tinfo, jinfo):
            if "bbox" in j:
                np.testing.assert_allclose(_sorted_corners(t["bbox"]), _sorted_corners(j["bbox"]),
                                           atol=1e-4)


def test_merge_bb_empty_and_refusals(tmp_path):
    info, ids = tmerge.merge_bb(tmp_path, [], np.zeros(0, np.int32), np.zeros((0, 3)),
                                verbose=False)
    assert info == [] and (tmp_path / "panoptic_segmentation" / "ids.npy").exists()
    with pytest.raises(ValueError, match="backend"):
        tmerge.merge_bb(tmp_path, [{"id": 0, "area": 1}], np.zeros(1, np.int32),
                        np.zeros((1, 3)), verbose=False, backend="gpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmerge.merge_bb(tmp_path, [{"id": 0, "area": 1}], np.zeros(1, np.int32),
                            np.zeros((1, 3)), verbose=False, backend="device")
