"""The port's graph ops against the JAX package's on the CPU, all exact:
`propagate_labels`, the device instance split (against JAX's device split
and the port's native one), `floodfill_level` with and without classes,
and the host helpers (`cluster_boundaries`, `merge_instances_by_classes`,
`instance_separate`, `color_segment`). The graph is the device radius
graph of a labelled room-like cloud, so both packages see one adjacency."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion3dseg_tpu.ops import components as jcomp
from fusion3dseg_tpu_torch.ops import components as tcomp, neighbors as tnb


@pytest.fixture(scope="module")
def graph():
    """20,000 points on a floor and a wall at 1 cm, four classes in
    rectangles plus 3% unclassified, and their k=12 graph at r 0.05."""
    rng = np.random.default_rng(4)
    n = 20_000
    floor = np.c_[rng.uniform(0, 4, n // 2), np.zeros(n // 2), rng.uniform(0, 3, n // 2)]
    wall = np.c_[rng.uniform(0, 4, n // 2), rng.uniform(0, 2.5, n // 2), np.zeros(n // 2)]
    pts = np.round(np.vstack([floor, wall]), 2).astype(np.float32)
    classes = np.where(pts[:, 0] < 1.3, 3, np.where(pts[:, 0] < 2.6, 7, 9)).astype(np.int32)
    classes[(pts[:, 1] > 1.5)] = 86
    classes[rng.random(n) < 0.03] = 133
    adj = tnb.radius_graph(pts, 0.05, k=12, device="cpu").numpy()
    return pts, classes, adj


@pytest.mark.parametrize("masked", [False, True])
def test_propagate_labels(graph, masked):
    _, classes, adj = graph
    valid = np.random.default_rng(5).random(len(classes)) > 0.1 if masked else None
    want = np.asarray(jcomp.propagate_labels(
        jnp.asarray(adj), jnp.asarray(classes), None if valid is None else jnp.asarray(valid)))
    got, sweeps = tcomp.propagate_labels(adj, classes, valid, device="cpu", return_sweeps=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 < sweeps < 512
    # the cap stops the relaxation where the reference's does
    cut = np.asarray(jcomp.propagate_labels(jnp.asarray(adj), jnp.asarray(classes), max_iters=2))
    np.testing.assert_array_equal(
        tcomp.propagate_labels(torch.from_numpy(adj), classes, max_iters=2).numpy(), cut)


def test_symmetrize_on_the_device_path_equals_the_host(graph):
    _, _, adj = graph
    capped = adj[:, :5].copy()
    capped[::7, 2:] = -1
    for a in (adj, capped, np.full((4, 3), -1, np.int32), np.zeros((0, 2), np.int32)):
        want = jcomp.symmetrize_adjacency(a)
        got = tcomp.symmetrize_adjacency(torch.from_numpy(a))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tcomp.symmetrize_adjacency(a), want)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_device_split_equals_jax_and_native(graph, layout):
    _, classes, adj = graph
    lists = tnb.adjacency_to_lists(adj)
    arg = tnb.lists_to_csr(lists) if layout == "csr" else adj
    for kw in ({}, {"instance_classes": [3, 7, 86], "minimum_points": 30}):
        want = jcomp.split_into_instances(classes, arg, 133, backend="device", **kw)
        got = tcomp.split_into_instances(classes, arg, 133, backend="device", device="cpu",
                                         **kw)
        nat = tcomp.split_into_instances(classes, arg, 133, backend="native", **kw)
        for t in (want, nat):
            for a, b in zip((got[0], got[1], got[3]), (t[0], t[1], t[3])):
                np.testing.assert_array_equal(a, b)
            assert got[2] == t[2]
    with pytest.raises(ValueError, match="backend"):
        tcomp.split_into_instances(classes, adj, backend="gpu")


@pytest.mark.parametrize("with_classes", [False, True])
def test_floodfill_level(graph, with_classes):
    _, classes, adj = graph
    seeds = np.zeros(len(classes), bool)
    seeds[[10, 5000, 15_000]] = True
    cls = classes if with_classes else None
    want = jcomp.floodfill_level(adj, seeds, 9, cls)
    got = tcomp.floodfill_level(torch.from_numpy(adj), seeds, 9, cls)
    assert got.dtype == bool and got.sum() > 3
    np.testing.assert_array_equal(got, want)


def test_host_helpers(graph):
    _, classes, adj = graph
    uids, ids, info, _ = tcomp.split_into_instances(classes, adj, 133, minimum_points=20)
    np.testing.assert_array_equal(tcomp.cluster_boundaries(ids, adj),
                                  jcomp.cluster_boundaries(ids, adj))
    cats = sorted({e["category_id"] for e in info})
    for merge in ([3], cats[:2], [86, 999]):
        tinfo, jinfo = copy.deepcopy(info), copy.deepcopy(info)
        t_ids, t_info = tcomp.merge_instances_by_classes(ids, tinfo, merge)
        j_ids, j_info = jcomp.merge_instances_by_classes(ids, jinfo, merge)
        np.testing.assert_array_equal(t_ids, j_ids)
        assert t_info == j_info and tinfo == jinfo
    t = tcomp.instance_separate(classes, adj, 133, None, 20)
    j = jcomp.instance_separate(classes, adj, 133, None, 20)
    for a, b in zip(t[:2] + t[3:4] + t[5:], j[:2] + j[3:4] + j[5:]):
        np.testing.assert_array_equal(a, b)
    assert t[2] == j[2] and t[4].keys() == j[4].keys()
    assert all(np.array_equal(t[4][k], j[4][k]) for k in t[4])
    for kw in ({}, {"num_instances": 5, "seed": 3}):
        np.testing.assert_array_equal(tcomp.color_segment(ids, **kw),
                                      jcomp.color_segment(ids, **kw))
