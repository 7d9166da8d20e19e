"""The port's bench (`fusion3dseg_tpu_torch/tools/bench.py`) on the CPU,
held to the repository's `bench.py` (the JAX package) on the same seeds.

The headline at 20k points x 8 frames: the same label agreement with the
oracle and the same culled window share, and the port's classes equal to
JAX's `tpu_label_fuse_cells` classes exactly. Config 5 at 1,100,000 points
x 2 frames, past 2^20 ids, so that the gid-range-sharded z-buffer runs with
nsub = 2: classes equal to JAX's exactly and to the oracle's on >= 0.9995 of
the points (PERF.md §2's bar). The fusion blocks run on small sessions and
config 4 with a tiny random segmenter (whose loop bar fails, as it
should), for the result's keys: a superset of the JAX record's
(`BENCH_r05.json`) but for those named in PLATFORM_ONLY.
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
from fusion3dseg_tpu_torch.ops import label_fuse as lf
from fusion3dseg_tpu_torch.tools import bench as tbench
from fusion3dseg_tpu_torch.models import SegFormerConfig
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from torch_seg_pair import TINY

ROOT = Path(__file__).resolve().parent.parent
ARGV = ["--device", "cpu", "--npts", "20000", "--frames", "8", "--repeat", "1",
        "--tenm-npts", "1100000", "--tenm-frames", "2"]  # 1.1M ids: nsub = 2
SIZES = tbench.FusionSizes(frames=8, hw=(64, 48), vga_frames=3, vga_hw=(96, 128), ref_frames=2,
                           ref_hw=(120, 90))
# keys of the JAX record that a run without them is allowed: present only
# when a loop-closure run fills its buffer (bench.py:646), which the small
# sessions here do not
PLATFORM_ONLY = {"loopclosure_saturated"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one CPU thread while this module runs. Its engine makes
    hundreds of small torch calls a frame, and each opens an OpenMP region
    over every core: with the other test workers on the same cores those
    regions wait on descheduled threads (the engine ran at 0.5 frames/s
    beside five busy processes on 8 cores, 22 frames/s on one thread), which
    cost this module 286 s of its worker in a six-worker run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tmp_module(tmp_path_factory):
    """The temporary directory of both benches' workload and index caches."""
    old, tempfile.tempdir = tempfile.tempdir, str(tmp_path_factory.mktemp("bench"))
    yield Path(tempfile.tempdir)
    tempfile.tempdir = old


def _spy(factory, outs):
    """`factory` whose returned program records each call's classes."""
    def make(*a, **k):
        prog = factory(*a, **k)

        def run(*args):
            out = prog(*args)
            outs.append(np.asarray(out[1]))
            return out
        return run
    return make


@pytest.fixture(scope="module")
def jax_runs(tmp_module):
    args, factory = tbench.parse_args(ARGV), jbench.tpu_label_fuse_cells
    result, outs = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in (("headline", jbench.headline_1m), ("tenm", jbench.config5_10m)):
            outs[name] = []
            mp.setattr(jbench, "tpu_label_fuse_cells", _spy(factory, outs[name]))
            fn(args, result)
    return result, {k: v[-1] for k, v in outs.items()}


@pytest.fixture(scope="module")
def port_run(tmp_module):
    # config 4 with a tiny random segmenter in place of the shipped B2 (a
    # B2 forward takes seconds on the CPU)
    tseg = Segmenter2D(SegFormerConfig(**TINY, dtype=torch.float32), input_hw=(64, 64),
                       batch_size=8, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbench, "Segmenter2D", lambda **kw: tseg)
        return tbench.run(tbench.parse_args(ARGV), sizes=SIZES)


def test_headline_matches_jax_bench(port_run, jax_runs):
    (res, out), (jres, jout) = port_run, jax_runs
    assert res["npts"] == jres["npts"] == 20000 and res["frames"] == 8
    assert res["label_agreement"] == jres["label_agreement"] >= tbench.AGREEMENT_BAR
    assert res["view_index_window_frac"] == jres["view_index_window_frac"]
    np.testing.assert_array_equal(out["headline"]["classes"], jout["headline"])


def test_nsub2_matches_jax_bench(port_run, jax_runs):
    (res, out), (jres, jout) = port_run, jax_runs
    assert res["tenm_nsub"] == 2 and res["tenm_npts"] == jres["tenm_npts"] == 1_100_000
    np.testing.assert_array_equal(out["10m"]["classes"], jout["tenm"])
    agree = float(np.mean(out["10m"]["classes"] == out["10m"]["classes_oracle"]))
    assert agree >= tbench.AGREEMENT_BAR
    assert res["tenm_label_agreement"] == jres["tenm_label_agreement"] == round(agree, 6)


def test_cached_cell_index_is_loaded_and_reported_so(port_run):
    # config 5's index was built by the run and cached: the record names it
    # built, and a second use loads it, says so, and lifts the same classes
    res, out = port_run
    assert res["tenm_view_index_build_seconds"] >= 0
    assert res["tenm_view_index_load_seconds"] is None
    args = tbench.parse_args(ARGV)
    npts, frames, hw = args.tenm_npts, args.tenm_frames, (args.height, args.width)
    cache = tbench.cells_cache(npts, frames, hw, 256)
    assert cache.exists()
    build, dev_args, _, index_s = tbench.cells_run(
        npts, args.nclasses, hw, *tbench.cached_workload(npts, frames, hw), 256,
        torch.device("cpu"), cache)
    assert list(index_s) == ["load"]
    np.testing.assert_array_equal(build()(*dev_args)[1].numpy(), out["10m"]["classes"])


def test_result_keys_cover_the_jax_record(port_run):
    res, out = port_run
    parsed = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    assert set(parsed) - PLATFORM_ONLY <= set(res), sorted(set(parsed) - set(res))
    assert res["platform"] == "cpu" and "name" not in res  # no card, no card name
    assert res["k1_launches"] == 0  # no kernel on the CPU
    # every bar holds but the model in the loop's: the tiny segmenter is
    # untrained, and the bench says so
    assert [b.split()[0] for b in res["failed_bars"]] == ["model_in_loop_3d_agreement"]
    # the reference-resolution state of the last engine run, and its n
    state, uv2pt = out["fusion/e2e"]["ref_res"]
    assert uv2pt.shape == (SIZES.ref_frames, SIZES.ref_hw[0] * SIZES.ref_hw[1])
    assert 0 < int(state.n) <= 1 << 18


def test_failed_bar_exits_nonzero(tmp_module, monkeypatch, capsys):
    monkeypatch.setattr(tbench, "AGREEMENT_BAR", 1.5)  # no run can reach it
    rc = tbench.main(ARGV + ["--no-fusion-stat", "--no-seg2d", "--no-10m"])
    out, err = capsys.readouterr()
    record = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and len(record["failed_bars"]) == 1
    assert "label_agreement" in record["failed_bars"][0] and "FAIL: label_agreement" in err


def test_cell_ids_past_2_24_decode_exactly():
    # the cell table stores ids as int32 bits in a float32 column; ids past
    # 2^24 (no longer exact as float values) must come back bit for bit
    hw, n = (48, 64), 3000
    points, K, quats, trans, masks = tbench.make_workload(n, 3, hw)
    table, lists, counts = lf.build_cell_index(points, K, quats, trans, hw, cell_size=64)
    perm, sizes, Ks = lf.plan_window_buckets(counts, nbuckets=2, round_to=8,
                                             max_window=lists.shape[1])
    args = (lists[perm], K, quats[perm], trans[perm], masks[perm])
    small = lf.tpu_label_fuse_cells(n, 133, hw, Ks, sizes, device="cpu").winners(table, *args)

    big = (1 << 25) + 3 * table[..., 3].view(np.int32)  # order kept: ties resolve alike
    table_big = table.copy()
    table_big[..., 3] = big.view(np.float32)
    npts = (1 << 25) + 3 * n
    run = lf.tpu_label_fuse_cells(npts, 133, hw, Ks, sizes, device="cpu")
    wide = run.winners(table_big, *args)
    ids = torch.as_tensor((1 << 25) + 3 * np.arange(n))
    assert torch.equal(wide[:, ids], small[:, :n])
    assert int((wide[:, :npts] != lf.INVALID).sum()) == int((small[:, :n] != lf.INVALID).sum())
