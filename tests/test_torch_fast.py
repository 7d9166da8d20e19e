"""The port's segment_session_fast against the JAX package on the CPU.
Mirrors tests/test_fast_pipeline.py. Masks branch: n within 1%, voted class
per pixel on >= 0.999, instance count within 1 of JAX; the segmenter branch
with the tiny float32 pair; the overflow repair; the refusals."""

import numpy as np
import pytest
import torch

from fusion3dseg_tpu.io import rtab as jrtab, synthetic
from fusion3dseg_tpu.pipeline.fast import segment_session_fast as jfast
from fusion3dseg_tpu_torch.io import rtab as trtab
from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast as tfast
from torch_seg_pair import segmenter_pair

KW = dict(radius=0.1, angle=25.0, min_pts_per_inst=20)


def _sessions(seed, F, **kw):
    sess = synthetic.make_session(nframes=F, depth_hw=(48, 36), room=synthetic.RoomSpec(seed=seed),
                                  **kw)
    args = (sess.colors, sess.depth, sess.K, sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations)
    return sess, jrtab.SessionData.from_arrays(*args), trtab.SessionData.from_arrays(
        *args, device="cpu")


def _pixel_agreement(j, t):
    juv, tuv = np.asarray(j.uv2pt), t.uv2pt.cpu().numpy()
    both = (juv >= 0) & (tuv >= 0)
    assert both.mean() > 0.8
    return float((j.classes[juv[both]] == t.classes[tuv[both]]).mean())


def _hold(j, t):
    assert abs(t.n - j.n) <= 0.01 * j.n
    assert _pixel_agreement(j, t) >= 0.999
    assert abs(len(t.instance_info) - len(j.instance_info)) <= 1
    assert t.points.shape == (t.n, 3) and t.classes.shape == (t.n,)
    assert t.classes.dtype == np.int32 and t.instance_ids.shape == (t.n,)
    assert t.uv2pt.dtype == torch.int32


def _hold_stages(t, *stages):
    """Each stage's seconds with its ".dispatch" and ".wait", which add up
    to it, beside the engine's graph and match-kernel counters (0 on the
    CPU)."""
    sec = t.stage_seconds
    counters = {"fuse_graph.frames", "fuse_graph.captures", "fuse_match.kernel_frames"}
    assert set(sec) == {s + part for s in stages for part in ("", ".dispatch", ".wait")} | counters
    assert all(sec[c] == 0 for c in counters)
    for s in stages:
        assert sec[s + ".dispatch"] + sec[s + ".wait"] == pytest.approx(sec[s], abs=1e-9)


@pytest.mark.parametrize("F,window,policy", [(6, None, "split"), (16, 1024, "split"),
                                             (16, 1024, "newest")],
                         ids=["F6_unwindowed", "F16_split", "F16_newest"])
def test_masks_branch_matches_jax(tmp_path, F, window, policy):
    sess, jsd, tsd = _sessions(21, F)
    kw = dict(KW, capacity=1 << 14, window=window, window_policy=policy)
    j = jfast(jsd, masks=sess.gt_mask, outdir=tmp_path / "jax", **kw)
    t = tfast(tsd, masks=sess.gt_mask, outdir=tmp_path / "port", device="cpu", **kw)
    _hold(j, t)
    assert t.overflow_frames == j.overflow_frames
    np.testing.assert_array_equal(t.spans, np.asarray(j.spans))
    assert t.n_instances_premerge >= len(t.instance_info) > 0
    for inf in t.instance_info:
        assert {"id", "category_id", "area", "parent_id"} <= set(inf)
    assert (tmp_path / "port" / "panoptic_segmentation" / "final_info.json").exists()
    np.testing.assert_array_equal(t.normals, t.state.normals[: t.n].numpy())
    assert t.colors.shape == (t.n, 3)
    _hold_stages(t, "fuse", "repair", "vote", "split", "merge")


def test_auto_window_and_no_obb_merge():
    sess, jsd, tsd = _sessions(22, 4)
    kw = dict(KW, capacity=1 << 17, window="auto", merge_obbs=False)  # auto picks 2^13
    j = jfast(jsd, masks=sess.gt_mask, **kw)
    t = tfast(tsd, masks=sess.gt_mask, device="cpu", **kw)
    _hold(j, t)
    assert t.n_instances_premerge == len(t.instance_info)


def test_segmenter_branch_matches_jax(tmp_path):
    sess, jsd, tsd = _sessions(23, 4, appearance="textured")
    jseg, tseg = segmenter_pair(tmp_path, batch_size=4)
    kw = dict(KW, capacity=1 << 13, window=None, conf_threshold=0.0)
    j = jfast(jsd, segmenter=jseg, **kw)
    t = tfast(tsd, segmenter=tseg, device="cpu", **kw)
    assert abs(t.n - j.n) <= 0.01 * j.n
    assert t.classes.dtype == np.int32 and set(np.unique(t.classes)) <= set(range(134))
    # random float32 weights: a few near-tied argmaxes flip (the streaming
    # tests' bar)
    assert _pixel_agreement(j, t) >= 0.98
    _hold_stages(t, "fuse", "repair", "stream", "split", "merge")


def test_overflow_autodedup_on_revisit():
    sess, _, tsd = _sessions(0, 16, turns=2.0)
    masks = np.minimum(sess.gt_mask, 19)
    kw = dict(radius=0.08, angle=20.0, nclasses=20, capacity=1 << 15, min_pts_per_inst=20,
              merge_obbs=False, device="cpu")
    W = 1 << 12
    raw = tfast(tsd, masks=masks, window=W, window_policy="newest", auto_dedup=False, **kw)
    fixed = tfast(tsd, masks=masks, window=W, window_policy="newest", **kw)
    full = tfast(tsd, masks=masks, window=None, **kw)
    assert raw.overflow_frames > 0
    assert fixed.overflow_frames == raw.overflow_frames
    assert raw.spans.shape == (16,) and raw.spans.max() > W
    assert full.overflow_frames == 0
    assert raw.n > full.n * 1.2
    assert fixed.n <= full.n * 1.02
    assert int(fixed.uv2pt.max()) < fixed.n
    assert set(np.unique(fixed.classes)) <= set(np.unique(raw.classes)) | {20}


def test_refusals():
    sess, _, tsd = _sessions(24, 3)
    with pytest.raises(ValueError):
        tfast(tsd, device="cpu")
    with pytest.raises(ValueError):
        tfast(tsd, masks=sess.gt_mask, segmenter=object(), device="cpu")
    with pytest.raises(ValueError, match="dedup"):
        tfast(tsd, segmenter=object(), dedup=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tfast(tsd, masks=sess.gt_mask)


def test_out_of_taxonomy_parent_is_none():
    from fusion3dseg_tpu_torch.utils import taxonomy as tax

    sess, _, tsd = _sessions(26, 4)
    tiny = tax.Taxonomy(class_names=["wall", "floor"])  # ids 0..1 only
    res = tfast(tsd, masks=sess.gt_mask, capacity=1 << 13, window=None, taxonomy=tiny,
                merge_obbs=False, device="cpu", **KW)
    cats = {int(i["category_id"]) for i in res.instance_info}
    assert any(c > 1 for c in cats)
    for inf in res.instance_info:
        assert inf["parent_id"] == (tiny.parent_ids[inf["category_id"]]
                                    if inf["category_id"] <= 1 else None), inf
