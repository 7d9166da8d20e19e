"""The port's tracing module (`utils/timing.py`) on the CPU: the stage
record of `segment_session_fast` on both label paths (each stage's dispatch
and wait adding up to it, every value a float), every operation that makes
the host wait for the card inside a wait, the profiler ranges and their
clock, no profiler range without a profiler, the bounded aggregates and
`total` / `clear` as `chip_smoke.py` reads them."""

import contextlib
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from fusion3dseg_tpu_torch.io import rtab, synthetic
from fusion3dseg_tpu_torch.models import SegFormerConfig
from fusion3dseg_tpu_torch.models.mask2former import Mask2FormerConfig
from fusion3dseg_tpu_torch.ops import obb
from fusion3dseg_tpu_torch.pipeline import fast
from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from fusion3dseg_tpu_torch.utils import timing

KW = dict(radius=0.1, angle=25.0, min_pts_per_inst=20, capacity=1 << 14, window=1024,
          window_policy="split", device="cpu")
STAGES = {"masks": ("fuse", "repair", "vote", "split", "merge"),
          "segmenter": ("fuse", "repair", "stream", "split", "merge")}
# the counters each path records beside its stages
COUNTERS = ("fuse_graph.frames", "fuse_graph.captures", "fuse_match.kernel_frames")
# the waits each path passes through, whatever the data
WAITS = {"masks": ("spans", "n", "points", "classes", "masks_upload", "engine_upload",
                   "cameras", "vote_keys"),
         "segmenter": ("spans", "n", "points", "classes", "engine_upload", "cameras",
                       "vote_keys")}


def _session(F=6):
    sess = synthetic.make_session(nframes=F, depth_hw=(48, 36), appearance="textured",
                                  room=synthetic.RoomSpec(seed=31))
    sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                      sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                      device="cpu")
    return sess, sd


def _segmenter(family="segformer"):
    if family == "mask2former":
        cfg = Mask2FormerConfig(num_classes=133, embed_dim=16, depths=(2, 2, 2, 2),
                                num_heads=(1, 2, 4, 8), window_size=4, conv_dim=32, mask_dim=32,
                                norm_groups=8, enc_layers=1, enc_heads=4, enc_ffn_dim=64,
                                num_queries=8, hidden_dim=32, dec_heads=4, dec_ffn_dim=64,
                                dec_layers=1, dtype=torch.float32)
        return Segmenter2D(config=cfg, input_hw=(70, 90), batch_size=4, device="cpu")
    cfg = SegFormerConfig(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 3, 4), decoder_dim=32, dtype=torch.float32)
    return Segmenter2D(config=cfg, input_hw=(64, 64), batch_size=4, device="cpu")


def _run(path, sess, sd, **kw):
    """`path`: "masks", "segmenter" (a tiny SegFormer) or "mask2former"."""
    kw = {**KW, **kw}
    if path == "masks":
        return segment_session_fast(sd, masks=sess.gt_mask, **kw)
    family = "mask2former" if path == "mask2former" else "segformer"
    return segment_session_fast(sd, segmenter=_segmenter(family), conf_threshold=0.0, **kw)


@pytest.fixture(scope="module")
def runs():
    """Each path's result, with the aggregates of its spans and waits."""
    sess, sd = _session()
    out = {}
    for path in STAGES:
        timing.METRICS.clear()
        res = _run(path, sess, sd)
        out[path] = (res, dict(timing.METRICS.seconds))
    return out


@pytest.mark.parametrize("path", list(STAGES))
def test_stage_seconds_add_up(runs, path):
    res, seconds = runs[path]
    sec = res.stage_seconds
    assert set(sec) == ({s + part for s in STAGES[path] for part in ("", ".dispatch", ".wait")}
                        | set(COUNTERS))
    # the engine's counters: the CPU steps its frames eagerly, in the plain match
    assert all(sec[c] == 0 for c in COUNTERS)
    for s in STAGES[path]:
        assert sec[s] > 0
        assert sec[s + ".wait"] >= 0 and sec[s + ".dispatch"] >= 0
        assert sec[s + ".dispatch"] + sec[s + ".wait"] == pytest.approx(sec[s], abs=1e-9)
    # the fusion stage reads the span telemetry; the repair reads n
    assert sec[STAGES[path][0] + ".wait"] > 0 and sec["repair.wait"] > 0
    for w in WAITS[path]:
        assert "wait." + w in seconds, w


@pytest.mark.parametrize("path", list(STAGES))
def test_stage_values_are_floats(runs, path):
    res, _ = runs[path]
    assert all(type(v) is float for v in res.stage_seconds.values())
    # the harness prints each one as seconds
    assert all(f"{v:.4f}" for v in res.stage_seconds.values())


# operations after which the host reads an output's value or size, so that
# on the card each waits for the card's queue to drain
_READS = {"item", "tolist", "cpu", "numpy", "__int__", "__float__", "__bool__", "__index__",
          "__array__", "unique", "unique_consecutive", "nonzero", "argwhere", "masked_select",
          "repeat_interleave", "equal", "allclose"}


def _is_mask(idx):
    if isinstance(idx, torch.Tensor):
        return idx.dtype == torch.bool
    return isinstance(idx, (tuple, list)) and any(_is_mask(i) for i in idx)


class _Reads(TorchFunctionMode):
    """Notes each such operation, and each copy of a host array to a
    device, made inside a call's record and outside every wait."""

    def __init__(self, waits):
        super().__init__()
        self.waits, self.found = waits, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in ("__getitem__", "__setitem__", "index_put_", "index_put"):
            reads = _is_mask(args[1])
        elif name in ("as_tensor", "tensor"):
            reads = not isinstance(args[0], torch.Tensor) and kwargs.get("device") is not None
        elif name == "repeat_interleave":
            reads = "output_size" not in kwargs
        else:
            reads = name in _READS
        if reads and self.waits[0] == 0 and timing._RECORD.get() is not None:
            at = [f for f in traceback.extract_stack()[:-1] if "fusion3dseg_tpu_torch" in f.filename]
            self.found.append(f"{name} at {Path(at[-1].filename).name}:{at[-1].lineno}"
                              if at else name)
        return func(*args, **kwargs)


@pytest.fixture
def open_waits(monkeypatch):
    """[waits open now, most open at once], kept by a counting `timing.wait`."""
    depth = [0, 0]
    real = timing.wait

    @contextlib.contextmanager
    def counted(name):
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])
        try:
            with real(name) as w:
                yield w
        finally:
            depth[0] -= 1

    monkeypatch.setattr(timing, "wait", counted)
    return depth


@pytest.mark.parametrize("path", [*STAGES, "mask2former"])
@pytest.mark.parametrize("repair", [False, True], ids=["plain", "repair_device_obb"])
def test_every_device_read_sits_in_a_wait(monkeypatch, open_waits, path, repair):
    """On the card each of these operations blocks the host until the
    card's queue drains. Inside `segment_session_fast` each sits in a wait,
    or its time would count as the stage's dispatch; no wait holds another."""
    if repair:
        # a revisiting session past its merge window (the repair runs), and
        # the device backend of the box merge
        monkeypatch.setattr(obb, "HOST_OBB_MAX_KN", 0)
        monkeypatch.setattr(fast, "HOST_OBB_MAX_KN", 0)
        sess = synthetic.make_session(nframes=16, depth_hw=(48, 36),
                                      room=synthetic.RoomSpec(seed=0), turns=2.0)
        sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                          sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                          device="cpu")
        kw = dict(radius=0.08, angle=20.0, capacity=1 << 15, window=1 << 12,
                  window_policy="newest")
    else:
        (sess, sd), kw = _session(), {}
    timing.METRICS.clear()
    mode = _Reads(open_waits)
    with mode:
        res = _run(path, sess, sd, **kw)
    assert not mode.found, mode.found
    assert open_waits[1] == 1
    if repair:
        assert res.overflow_frames > 0 and res.n_instances_premerge > 0
        assert timing.METRICS.total("wait.obbs") > 0


def test_nested_spans_share_waits():
    with timing.record() as rec:
        with timing.span("outer"):
            with timing.span("inner"):
                with timing.wait("sleep"):
                    time.sleep(0.02)
            time.sleep(0.01)
        with timing.wait("alone"):  # no span open: counted in no stage
            pass
    # the outer span is the stage; the inner one and its wait count in it
    assert set(rec) == {"outer", "outer.dispatch", "outer.wait"}
    assert rec["outer.wait"] >= 0.02 and rec["outer.dispatch"] >= 0.01
    assert rec["outer.dispatch"] + rec["outer.wait"] == pytest.approx(rec["outer"], abs=1e-9)
    assert timing.METRICS.total("inner") >= 0.02
    # outside a record, a span only adds to the aggregates
    with timing.span("outer"):
        pass
    assert len(rec) == 3


def _events(prof):
    return [ev for ev in prof.profiler.kineto_results.events() if ev.name().startswith("f3s.")]


def test_profiler_ranges_and_clock():
    """The program's ranges appear by name under a CPU profiler, each span's
    range inside its `time.time_ns()` stamps."""
    sess, sd = _session(4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.span("clocked") as sp:
            torch.ones(64).sum()
        with timing.wait("clocked") as wt:
            torch.ones(64).sum()
        res = segment_session_fast(sd, masks=sess.gt_mask, **KW)
    events = _events(prof)
    names = {ev.name() for ev in events}
    stages = [f"f3s.{s}" for s in STAGES["masks"]]
    steps = [f"f3s.fuse.{s}" for s in ("seed", "frame", "cull", "zbuffer", "match", "merge",
                                       "append")]
    waits = [f"f3s.wait.{w}" for w in WAITS["masks"]]
    assert set(stages + steps + waits + ["f3s.vote"]) <= names, names
    frames = [ev for ev in events if ev.name() == "f3s.fuse.frame"]
    assert len(frames) == sess.gt_mask.shape[0] - 1
    for s, name in ((sp, "f3s.clocked"), (wt, "f3s.wait.clocked")):
        ev = next(ev for ev in events if ev.name() == name)
        assert s.start_ns <= ev.start_ns() <= ev.end_ns() <= s.end_ns
    # each stage's range lies within the seconds the stage recorded
    for s in STAGES["masks"]:
        ev = next(ev for ev in events if ev.name() == f"f3s.{s}")
        assert (ev.end_ns() - ev.start_ns()) * 1e-9 <= res.stage_seconds[s]


def test_segmenter_ranges():
    sess, sd = _session(4)
    seg = _segmenter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        segment_session_fast(sd, segmenter=seg, conf_threshold=0.0, **KW)
    names = {ev.name() for ev in _events(prof)}
    want = {"f3s.fuse", "f3s.stream", "f3s.stream.resize", "f3s.stream.model",
            "f3s.stream.vote", "f3s.stream.classify", "f3s.segformer.decoder"}
    want |= {f"f3s.segformer.stage{s}" for s in range(4)}
    assert want <= names, want - names


class _Counted:
    """`record_function`, counting its entries."""
    entered = 0

    def __init__(self, name):
        self.inner = _REAL(name)

    def __enter__(self):
        _Counted.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


_REAL = torch.profiler.record_function


def test_no_profiler_no_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counted)
    _Counted.entered = 0
    sess, sd = _session(3)
    with timing.span("a"), timing.wait("b"), timing.range("c"):
        pass
    segment_session_fast(sd, masks=sess.gt_mask, **KW)
    assert _Counted.entered == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timing.span("a"), timing.wait("b"), timing.range("c"):
            pass
    assert _Counted.entered == 3


def test_registry_stays_bounded():
    m = timing.Metrics()
    for i in range(10_000):
        m.add(f"span{i % 7}", 1e-3)
    assert len(m.seconds) == 7
    assert sum(m.seconds.values()) == pytest.approx(10.0)
    # the process-wide registry keeps per-name aggregates, not the spans
    timing.METRICS.clear()
    for i in range(10_000):
        with timing.span("bounded"), timing.wait("bounded"):
            pass
    assert set(timing.METRICS.seconds) == {"bounded", "wait.bounded"}
    assert timing.METRICS.total("bounded") >= timing.METRICS.total("wait.bounded") > 0


def test_counters_add_to_metrics_and_the_record():
    timing.METRICS.clear()
    timing.count("graphs")
    with timing.record() as rec:
        with timing.span("stage"):
            timing.count("frames", 3)
        timing.count("frames", 2)
        timing.count("graphs", 0)
    assert rec["frames"] == 5.0 and rec["graphs"] == 0.0
    assert all(type(rec[k]) is float for k in ("frames", "graphs"))
    assert {"stage", "stage.wait", "stage.dispatch"} <= set(rec)
    assert timing.METRICS.counts == {"graphs": 1, "frames": 5}
    timing.count("frames")  # no record open: the aggregates only
    assert rec["frames"] == 5.0 and timing.METRICS.counts["frames"] == 6
    timing.METRICS.clear()
    assert not timing.METRICS.counts


def test_total_and_clear_as_chip_smoke_reads_them(capsys):
    timing.METRICS.clear()
    for _ in range(3):
        with timing.span("fusion", verbose=True):
            time.sleep(0.002)
    assert capsys.readouterr().out.count("[fusion] ") == 3
    assert timing.METRICS.total("fusion") >= 0.006
    assert timing.METRICS.total("segmentation.vote") == 0.0
    timing.METRICS.clear()
    assert timing.METRICS.total("fusion") == 0.0 and not timing.METRICS.seconds
    assert isinstance(timing.METRICS.total("fusion"), float)


def test_masks_path_unchanged_by_the_profiler():
    """A profiled call gives the same answer as an unprofiled one."""
    sess, sd = _session(4)
    a = segment_session_fast(sd, masks=sess.gt_mask, **KW)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        b = segment_session_fast(sd, masks=sess.gt_mask, **KW)
    assert a.n == b.n
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.classes, b.classes)
    np.testing.assert_array_equal(a.instance_ids, b.instance_ids)
