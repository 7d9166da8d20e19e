"""`segment_session_fast` labels in one order for both label sources (fuse,
repair, vote, classify), on the device. Its outputs equal, bit for bit, the
composition it replaced: `fuse_session_and_vote` (then `dedup_and_revote`
past the merge window) with masks, and fusion, repair and `stream_segment`
over uv2pt on the host with a segmenter. The main path copies neither uv2pt
nor the vote table to the host."""

import numpy as np
import pytest
import torch

from fusion3dseg_tpu_torch.fusion import fused_pipeline, fusion as fusion_engine
from fusion3dseg_tpu_torch.io import rtab, synthetic
from fusion3dseg_tpu_torch.models import SegFormerConfig
from fusion3dseg_tpu_torch.ops import components
from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from fusion3dseg_tpu_torch.pipeline.streaming import stream_segment
from fusion3dseg_tpu_torch.utils import timing

# the unwindowed session of tests/test_torch_fast.py, and its revisiting one
# (two turns) past a 2^12-slot window
PLAIN = dict(seed=21, nframes=6, turns=1.0,
             kw=dict(radius=0.1, angle=25.0, nclasses=133, capacity=1 << 14, window=None,
                     window_policy="split", min_pts_per_inst=20))
LOOP = dict(seed=0, nframes=16, turns=2.0,
            kw=dict(radius=0.08, angle=20.0, nclasses=20, capacity=1 << 15, window=1 << 12,
                    window_policy="newest", min_pts_per_inst=20))
HOST_COPIES = ("wait.uv2pt_to_host", "wait.uv2pt_upload", "wait.votes")


def _session(seed, nframes, turns):
    sess = synthetic.make_session(nframes=nframes, depth_hw=(48, 36), appearance="textured",
                                  room=synthetic.RoomSpec(seed=seed), turns=turns)
    sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                      sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                      device="cpu")
    return sess, sd


def _segmenter():
    cfg = SegFormerConfig(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 3, 4), decoder_dim=32, dtype=torch.float32)
    return Segmenter2D(config=cfg, input_hw=(64, 64), batch_size=4, device="cpu")


def _fusion_args(sd, kw):
    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    hd, wd = sd.depth_hw
    fargs = (sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations, sd.points, sd.normals,
             sd.colors, valid)
    return fargs, dict(height=hd, width=wd, radius=kw["radius"],
                       min_cosine=float(np.cos(np.deg2rad(kw["angle"]))), max_depth=8.0,
                       capacity=kw["capacity"], window=kw["window"],
                       window_policy=kw["window_policy"])


def _composed(sd, kw, masks=None, segmenter=None):
    """(classes [n] int32, uv2pt, n, points) as the main path composed its
    calls before it labelled in one order."""
    fargs, fkw = _fusion_args(sd, kw)
    nclasses, cap = kw["nclasses"], kw["capacity"]
    dedup_kw = dict(radius=kw["radius"], min_cosine=fkw["min_cosine"])
    if masks is not None:
        fmasks = torch.as_tensor(masks).reshape(sd.nframes, -1)
        state, uv2pt, _, classes, spans = fused_pipeline.fuse_session_and_vote(
            *fargs, fmasks, nclasses=nclasses, with_stats=True, device="cpu", **fkw)
        if kw["window"] is not None and int((spans > kw["window"]).sum()):
            state, uv2pt, _, classes = fused_pipeline.dedup_and_revote(
                state, uv2pt, fmasks, capacity=cap, nclasses=nclasses, **dedup_kw)
        n = int(state.n)
        classes = classes[:n].numpy().astype(np.int32)
    else:
        state, uv2pt, spans = fusion_engine.fuse_session(*fargs, with_stats=True, device="cpu",
                                                         **fkw)
        if kw["window"] is not None and int((spans > kw["window"]).sum()):
            state, slot_map = fusion_engine.dedup_state(state, capacity=cap, **dedup_kw)
            uv2pt = fusion_engine.remap_uv2pt(uv2pt, slot_map)
        n = int(state.n)
        classes = stream_segment(sd, segmenter, uv2pt.numpy(), npts=cap, nclasses=nclasses,
                                 conf_threshold=0.0)[1][:n].astype(np.int32)
    return classes, uv2pt, n, state.points[:n].numpy()


@pytest.mark.parametrize("case,source", [(PLAIN, "masks"), (LOOP, "masks"),
                                         (PLAIN, "segmenter"), (LOOP, "segmenter")],
                         ids=["masks", "masks_overflow", "segmenter", "segmenter_overflow"])
def test_main_path_equals_the_composed_calls(case, source):
    sess, sd = _session(case["seed"], case["nframes"], case["turns"])
    kw = case["kw"]
    masks = sess.gt_mask % kw["nclasses"] if source == "masks" else None
    seg = _segmenter() if source == "segmenter" else None
    got = segment_session_fast(sd, masks=masks, segmenter=seg, conf_threshold=0.0,
                               merge_obbs=False, device="cpu", **kw)
    classes, uv2pt, n, points = _composed(sd, kw, masks, seg)
    assert (got.overflow_frames > 0) == (case is LOOP)
    assert got.n == n
    assert torch.equal(got.uv2pt, uv2pt)
    assert got.classes.dtype == np.int32 and np.array_equal(got.classes, classes)
    assert len(np.unique(classes)) > 2  # more than one class and unclassified
    np.testing.assert_array_equal(got.points, points)
    _, ids, _, _ = components.split_into_instances_by_radius(
        classes, points, 2 * kw["radius"], kw["nclasses"], None, kw["min_pts_per_inst"])
    assert np.array_equal(got.instance_ids, ids)


def test_main_path_keeps_uv2pt_and_votes_on_the_device():
    sess, sd = _session(PLAIN["seed"], 4, 1.0)
    seg, kw = _segmenter(), PLAIN["kw"]
    timing.METRICS.clear()
    res = segment_session_fast(sd, segmenter=seg, conf_threshold=0.0, merge_obbs=False,
                               device="cpu", **kw)
    assert "wait.classes" in timing.METRICS.seconds
    assert not set(HOST_COPIES) & set(timing.METRICS.seconds)
    # the public NumPy contract still makes both copies
    timing.METRICS.clear()
    stream_segment(sd, seg, res.uv2pt.numpy(), npts=kw["capacity"], conf_threshold=0.0)
    assert set(HOST_COPIES[1:]) <= set(timing.METRICS.seconds)
    timing.METRICS.clear()
