"""The port's device radius graph against the JAX package's on the CPU:
every id equal.

The cloud is three orthogonal planes (a 4 x 3 m floor and walls of 4 x 2.5
and 3 x 2.5 m) rounded to 1 cm: distances tie often, and cells hold more
points than cap_per_cell=8, so the cap decides which candidates a point
sees. Equal ids need the stable cell sort, the float32 FMA chain of the
squared distance, the stable choice of the k nearest and a true division
by the radius (ops/neighbors.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion3dseg_tpu.ops import neighbors as jnb
from fusion3dseg_tpu_torch.ops import neighbors as tnb

N = 60_000


def three_planes(n, seed=1):
    rng = np.random.default_rng(seed)
    a = b = n // 3
    c = n - a - b
    floor = np.c_[rng.uniform(0, 4, a), np.zeros(a), rng.uniform(0, 3, a)]
    wall1 = np.c_[rng.uniform(0, 4, b), rng.uniform(0, 2.5, b), np.zeros(b)]
    wall2 = np.c_[np.zeros(c), rng.uniform(0, 2.5, c), rng.uniform(0, 3, c)]
    return np.round(np.vstack([floor, wall1, wall2]), 2).astype(np.float32)


@pytest.fixture(scope="module")
def cloud():
    return three_planes(N)


@pytest.mark.parametrize("radius,k", [(0.05, 16), (0.1, 32)])
def test_radius_graph_equals_jax(cloud, radius, k):
    want = np.asarray(jnb.radius_graph(jnp.asarray(cloud), radius, k=k, cap_per_cell=8))
    got = tnb.radius_graph(cloud, radius, k=k, cap_per_cell=8, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (N, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # the cap binds: cells hold more candidates than a point sees of them
    cells = np.floor((cloud - cloud.min(0)) / np.float32(radius)).astype(np.int64)
    _, counts = np.unique(cells, axis=0, return_counts=True)
    assert (counts > 8).sum() > 100


def test_radius_graph_tensor_input_and_valid_mask(cloud):
    pts = cloud[:20_000]
    valid = np.random.default_rng(2).random(len(pts)) > 0.2
    want = np.asarray(jnb.radius_graph(jnp.asarray(pts), 0.05, valid=jnp.asarray(valid), k=16))
    got = tnb.radius_graph(torch.from_numpy(pts), 0.05, valid=torch.from_numpy(valid), k=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[~valid] == -1).all()
    assert not np.isin(got.numpy()[valid], np.nonzero(~valid)[0]).any()


def test_radius_graph_duplicated_points(cloud):
    pts = np.concatenate([cloud[:8000], cloud[:8000], cloud[4000:6000]])
    want = np.asarray(jnb.radius_graph(jnp.asarray(pts), 0.05, k=16))
    got = tnb.radius_graph(pts, 0.05, k=16, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_sparse_path_and_chunk_sizes(cloud):
    pts = cloud[:15_000]
    want = np.asarray(jnb._radius_graph_jit(jnp.asarray(pts), 0.05, k=16, cap_per_cell=8,
                                            chunk=4096))
    for chunk in (1000, 4096):
        sparse = tnb._radius_graph_impl(torch.from_numpy(pts), 0.05, k=16, chunk=chunk,
                                        ncap=None)
        dense = tnb.radius_graph(pts, 0.05, k=16, chunk=chunk, device="cpu")
        np.testing.assert_array_equal(sparse.numpy(), want)
        np.testing.assert_array_equal(dense.numpy(), want)


def test_query_rows_is_the_chunk_function(cloud):
    pts = torch.from_numpy(cloud[:12_000])
    full = tnb.radius_graph(pts, 0.05, k=16)
    grid = tnb.build_grid(pts, 0.05, ncap=1 << 20)
    rows = torch.tensor([0, 11_999, 5000, 5001, 7])
    np.testing.assert_array_equal(tnb.query_rows(grid, rows, 16, 8).numpy(),
                                  full[rows].numpy())


def test_guards_raise_as_jax():
    big = np.broadcast_to(np.zeros(3, np.float32), (1 << 24, 3))
    with pytest.raises(ValueError, match="2\\^24"):
        jnb.radius_graph(big, 0.05)
    with pytest.raises(ValueError, match="2\\^24"):
        tnb.radius_graph(big, 0.05, device="cpu")
    far = np.array([[0, 0, 0], [1e4, 1e4, 1e4]], np.float32)
    with pytest.raises(ValueError, match="overflow"):
        jnb.radius_graph(far, 0.05)
    with pytest.raises(ValueError, match="overflow"):
        tnb.radius_graph(far, 0.05, device="cpu")
    with pytest.raises(ValueError, match="candidates"):
        tnb.radius_graph(far[:1], 0.05, k=300, device="cpu")


def test_wide_scene_takes_the_sparse_path_and_equals_jax():
    rng = np.random.default_rng(3)
    # two clusters 300 m apart: more than 2^24 cells at r 0.05, under 2^31
    pts = np.concatenate([rng.random((3000, 3)), rng.random((3000, 3)) + [300, 0, 0]])
    pts = np.round(pts, 2).astype(np.float32)
    want = np.asarray(jnb.radius_graph(jnp.asarray(pts), 0.05, k=16))
    got = tnb.radius_graph(pts, 0.05, k=16, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_empty_and_all_invalid():
    assert tnb.radius_graph(np.zeros((0, 3), np.float32), 0.1, device="cpu").shape == (0, 16)
    got = tnb.radius_graph(np.zeros((4, 3), np.float32), 0.1, valid=np.zeros(4, bool),
                           k=4, device="cpu")
    assert (got.numpy() == -1).all()
