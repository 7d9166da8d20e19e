"""The port's sharded voting and label lifters over 4 gloo ranks on the CPU,
against the JAX package's over 4 of the 8 virtual CPU devices
(`fusion3dseg_tpu/parallel/{voting,label_fuse}.py`), and the launcher's
failure handling.

One `launch.spawn` runs every case of the module in one group of 4 ranks
(`torch_parallel_ranks.label_cases`); the JAX side is built once. Votes,
classes and the cell plan are integers: all exact."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fusion3dseg_tpu.ops import label_fuse as jlabel
from fusion3dseg_tpu.ops import voting as jvoting
from fusion3dseg_tpu.parallel import label_fuse as jplabel
from fusion3dseg_tpu.parallel import voting as jpvoting
from fusion3dseg_tpu_torch.ops import label_fuse as tlabel
from fusion3dseg_tpu_torch.parallel import label_fuse as tplabel
from fusion3dseg_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks

D = 4
HW = (32, 24)
SPAWN_TIMEOUT = 120.0


def _workload(rng, N=800, F=16, hw=HW):
    """tests/test_label_fuse.py's workload."""
    pts = (rng.normal(size=(N, 3)) + [0, 0, 3.0]).astype(np.float32)
    K = np.array([[20.0, 0, 12], [0, 20.0, 16], [0, 0, 1]], np.float32)
    quats = np.tile([1.0, 0, 0, 0], (F, 1)).astype(np.float32)
    trans = (rng.normal(size=(F, 3)) * 0.1).astype(np.float32)
    masks = rng.integers(0, 10, (F, hw[0] * hw[1])).astype(np.uint8)
    return pts, K, quats, trans, masks


def _cells_workload(rng):
    """tests/test_label_fuse.py's cell-sharded workload: a circular
    trajectory, 4 points a pixel a frame (ties of equal quantized depth
    occur)."""
    pts, K, quats, trans, masks = _workload(rng, N=3000, F=12)
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    trans = np.stack([np.cos(ang) * 0.3, np.zeros(12), np.sin(ang) * 0.3], -1).astype(np.float32)
    quats = np.stack([np.cos(ang / 2), np.zeros(12), np.sin(ang / 2), np.zeros(12)],
                     -1).astype(np.float32)
    cells_table, cell_lists, counts = jlabel.build_cell_index(pts, K, quats, trans, HW,
                                                              cell_size=64)
    return pts, K, quats, trans, masks, cells_table, cell_lists, counts


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    F, hwn, npts, nc = 16, 64, 8 * 25, 9  # tests/test_model_parallel.py's voting case
    vote = dict(uv2pt=rng.integers(-1, npts, (F, hwn)).astype(np.int32),
                masks=rng.integers(0, nc, (F, hwn)).astype(np.uint8), npts=npts, nc=nc)
    pts, K, quats, trans, masks = _workload(rng)
    label = dict(pts=pts, K=K, quats=quats, trans=trans, masks=masks, hw=HW)
    cpts, cK, cq, ct, cm, table, lists, counts = _cells_workload(rng)
    dev_lists, valid = jplabel.plan_cell_shards(table, lists, counts, D)
    cells = dict(pts=cpts, cells_table=table, cell_lists=lists, counts=counts,
                 dev_lists=dev_lists, valid=valid, K=cK, quats=cq, trans=ct, masks=cm, hw=HW,
                 npts=len(cpts))
    return dict(vote=vote, label=label, cells=cells)


@pytest.fixture(scope="module")
def jax_out(inputs):
    mesh = Mesh(np.array(jax.devices()[:D]), ("dp",))
    v, w, c = inputs["vote"], inputs["label"], inputs["cells"]
    out = {}
    uv, m = jnp.asarray(v["uv2pt"]), jnp.asarray(v["masks"])
    out["votes_one"] = np.asarray(jvoting.vote_all_frames(uv, m, v["npts"], v["nc"], dedup=True))
    out["votes_frames"] = np.asarray(jpvoting.vote_sharded_frames(mesh, uv, m, v["npts"],
                                                                  v["nc"]))
    vp, cp = jpvoting.vote_sharded_points(mesh, uv, m, v["npts"], v["nc"])
    out["votes_points"], out["classes_points"] = np.asarray(vp), np.asarray(cp)
    args = [jnp.asarray(w[k]) for k in ("pts", "K", "quats", "trans", "masks")]
    out["label_frames"] = np.asarray(jplabel.label_fuse_sharded(mesh, *args, HW, nclasses=10))
    out["label_points"] = np.asarray(jplabel.label_fuse_sharded_points(mesh, *args, HW,
                                                                       nclasses=10))
    out["label_one"] = np.asarray(jlabel.tpu_label_fuse(len(w["pts"]), 10, HW)(*args)[1])
    out["label_cells"] = np.asarray(jplabel.label_fuse_sharded_cells(
        mesh, c["cells_table"], c["dev_lists"], c["valid"], jnp.asarray(c["K"]),
        jnp.asarray(c["quats"]), jnp.asarray(c["trans"]), jnp.asarray(c["masks"]), HW,
        npts=c["npts"], nclasses=10))
    cargs = [jnp.asarray(c[k]) for k in ("pts", "K", "quats", "trans", "masks")]
    out["cells_one"] = np.asarray(jlabel.tpu_label_fuse(c["npts"], 10, HW)(*cargs)[1])
    return out


@pytest.fixture(scope="module")
def port(inputs):
    return launch.spawn(ranks.label_cases, D, (inputs,), device_type="cpu",
                        timeout=SPAWN_TIMEOUT)


def _cat(port, key):
    return np.concatenate([r[key].numpy() for r in port])


class TestVoting:
    def test_frame_sharded_votes_exact_and_replicated(self, port, jax_out):
        np.testing.assert_array_equal(jax_out["votes_frames"], jax_out["votes_one"])
        for r in port:
            np.testing.assert_array_equal(r["votes_frames"].numpy(), jax_out["votes_frames"])

    def test_point_sharded_votes_exact(self, port, jax_out):
        assert port[0]["votes_points"].shape[0] == 200 // D  # each rank its own shard
        np.testing.assert_array_equal(_cat(port, "votes_points"), jax_out["votes_points"])

    def test_point_sharded_classes_exact(self, port, jax_out):
        np.testing.assert_array_equal(_cat(port, "classes_points"), jax_out["classes_points"])


class TestLabelLifters:
    def test_frame_sharded_exact(self, port, jax_out, inputs):
        got = _cat(port, "label_frames")
        np.testing.assert_array_equal(got, jax_out["label_frames"])
        w = inputs["label"]
        one = tlabel.tpu_label_fuse(len(w["pts"]), 10, HW, device="cpu")(
            w["pts"], w["K"], w["quats"], w["trans"], w["masks"])[1]
        np.testing.assert_array_equal(got, one.numpy())

    def test_point_sharded_exact(self, port, jax_out):
        got = _cat(port, "label_points")
        np.testing.assert_array_equal(got, jax_out["label_points"])
        np.testing.assert_array_equal(got, jax_out["label_one"])  # no tie on this workload

    def test_cell_sharded_exact_and_replicated(self, port, jax_out):
        for r in port:
            np.testing.assert_array_equal(r["label_cells"].numpy(), jax_out["label_cells"])
        # the JAX test's bar against the one-device lifter (ties break apart)
        assert (jax_out["label_cells"] == jax_out["cells_one"]).mean() >= 0.995

    def test_k1_gets_aligned_rows(self, port):
        """Every classification hands K1 rows on 16-byte boundaries (the
        tiled kernel on the card): 3 lifters on every rank."""
        for r in port:
            assert r["k1_rows_aligned"] == [True, True, True]

    def test_collectives_counted(self, port):
        # frames: psum + all_gather; points: 2 pmin a frame (16); cells: 2
        # a frame (12) + pmax
        assert [r["collectives"]["calls"] for r in port] == [2 + 32 + 25] * D


def test_plan_cell_shards_exact(inputs):
    c = inputs["cells"]
    got = tplabel.plan_cell_shards(c["cells_table"], c["cell_lists"], c["counts"], D)
    for g, w in zip(got, (c["dev_lists"], c["valid"])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


class TestLaunch:
    def test_ranks_see_their_group(self):
        got = launch.spawn(ranks.identity, 2, device_type="cpu", timeout=SPAWN_TIMEOUT)
        assert [g[:4] for g in got] == [(0, 2, "cpu", "gloo"), (1, 2, "cpu", "gloo")]
        assert all(g[4] == 1 for g in got)  # one thread a CPU rank

    def test_a_failing_rank_fails_the_call(self):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="fails on purpose"):
            launch.spawn(ranks.failing, 2, (1,), device_type="cpu", timeout=SPAWN_TIMEOUT)
        assert time.monotonic() - t0 < 60

    def test_a_hanging_group_is_stopped_at_its_deadline(self):
        t0 = time.monotonic()
        with pytest.raises((TimeoutError, RuntimeError)):
            launch.spawn(ranks.hanging, 2, (120,), device_type="cpu", timeout=8)
        assert time.monotonic() - t0 < 40

    def test_cuda_ranks_refuse_without_a_card(self):
        with pytest.raises(RuntimeError, match="is_available"):
            launch.spawn(ranks.identity, 1, device_type="cuda", timeout=SPAWN_TIMEOUT)
