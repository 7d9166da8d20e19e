"""One-call in-memory pipeline: session -> fused cloud -> classes -> instances.

Counterpart of `fusion3dseg_tpu/pipeline/fast.py`, the main path of the
system:

  * fusion and voting on the device (`fusion.fuse_session_and_vote`) when
    masks are given, or fusion followed by the streaming voter
    (`pipeline.streaming.stream_segment`) when a 2D segmenter runs in the
    loop;
  * the overflow repair (`dedup_and_revote` / `dedup_state`) when a frame's
    visible span passed the merge window;
  * the host instance split over the full radius relation
    (`ops.components.split_into_instances_by_radius`) and the host OBB
    merge (`pipeline.merge_bb`).
"""

from __future__ import annotations

import dataclasses
import functools
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.fusion import fused_pipeline, fusion as fusion_engine
from fusion3dseg_tpu_torch.ops import components
from fusion3dseg_tpu_torch.ops.obb import HOST_OBB_MAX_KN
from fusion3dseg_tpu_torch.pipeline.merge_bb import merge_bb
from fusion3dseg_tpu_torch.pipeline.streaming import stream_segment
from fusion3dseg_tpu_torch.utils import taxonomy as tax


@dataclasses.dataclass
class FastSegmentation:
    """Result of `segment_session_fast`.

    Arrays are host NumPy, sliced to the live prefix of n points. The
    full-capacity device state stays available as `state`; `normals` and
    `colors` are copied from it on first access.
    """

    points: np.ndarray  # [n, 3] fused cloud
    classes: np.ndarray  # [n] int32 class ids (nclasses = unclassified)
    instance_ids: np.ndarray  # [n] instance ids
    instance_info: List[dict]  # per-instance dicts (id/category_id/parent_id/area)
    n: int  # live prefix length
    n_instances_premerge: int  # instance count before the OBB merge
    state: object  # fusion.FusionState (device, full capacity)
    uv2pt: object  # [F, H*W] int32 tensor on the device (pixel -> point)
    # frames whose visible span exceeded the merge window, before the
    # repair ran (0: the scan appended no window duplicates)
    overflow_frames: int = 0
    spans: Optional[np.ndarray] = None  # [F] per-frame visible slot span
    # wall seconds of the stages, each ending where the host reads the
    # device anyway: "fuse_vote" (masks) or "fuse" + "stream" (segmenter),
    # "repair", "split", "merge"
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    @functools.cached_property
    def normals(self) -> np.ndarray:  # [n, 3]
        return self.state.normals[: self.n].cpu().numpy()

    @functools.cached_property
    def colors(self) -> np.ndarray:  # [n, 3]
        return self.state.colors[: self.n].cpu().numpy()


def segment_session_fast(
    session,  # io.rtab.SessionData
    masks=None,  # [F, Hd, Wd] or [F, Hd*Wd] class ids (array or tensor)
    segmenter=None,  # pipeline.get2dseg.Segmenter2D (used when masks is None)
    *,
    radius: float = 0.05,
    angle: float = 10.0,  # max normal-vs-view angle (deg)
    min_depth: float = 0.1,
    max_depth: float = 8.0,
    valid=None,  # [F, H*W] bool; default from the depth range
    capacity: int = 1 << 17,
    window="auto",  # "auto" | int slots | None (full merge)
    window_policy: str = "split",
    nclasses: int = 133,
    threshold: float = 0.5,
    conf_threshold: float = 0.017,  # segmenter confidence rule
    filter_classes: Optional[Sequence[int]] = None,
    split_radius: Optional[float] = None,  # default 2 * radius
    min_pts_per_inst: int = 100,
    dedup: bool = True,
    auto_dedup: bool = True,  # repair window-overflow duplicates after the scan
    merge_obbs: bool = True,
    outdir: Optional[str] = None,  # where merge_bb writes its artifacts
    taxonomy: Optional[tax.Taxonomy] = None,
    device="cuda",
) -> FastSegmentation:
    """Fuse, label-lift and instance-split a session in one call.

    Exactly one of `masks` / `segmenter` drives the labels. Fusion, voting
    and the repair run on `device` (the session's tensors are moved there
    once, a no-op when they already are); the segmenter path votes on the
    segmenter's own device. The instance split and the OBB merge run on
    the host, as in the reference.
    """
    if (masks is None) == (segmenter is None):
        raise ValueError("pass exactly one of masks= or segmenter=")
    if segmenter is not None and not dedup:
        # stream_segment counts one vote per (point, frame); dedup=False
        # would silently differ from the masks path's semantics
        raise ValueError("dedup=False is only supported on the masks path")
    dev = cuda.resolve_device(device)
    seconds = {}
    t0 = time.perf_counter()

    hd, wd = session.depth_hw
    if valid is None:
        depth = torch.as_tensor(session.depth, device=dev)
        valid = (depth > min_depth) & (depth <= max_depth)
    fargs = (session.Ks.astype(np.float32), session.quats_wxyz, session.translations,
             torch.as_tensor(session.points, device=dev),
             torch.as_tensor(session.normals, device=dev),
             torch.as_tensor(session.colors, device=dev),
             torch.as_tensor(valid, device=dev))
    min_cosine = float(np.cos(np.deg2rad(angle)))
    kw = dict(height=hd, width=wd, radius=radius, min_cosine=min_cosine, max_depth=max_depth,
              capacity=capacity)
    fclasses = tuple(filter_classes) if filter_classes is not None else None

    if window == "auto":
        window = fusion_engine.auto_window(
            fusion_engine.seed_cells_for_frame(fargs[3][0], fargs[4][0], fargs[5][0],
                                               fargs[6][0], hd, wd, radius, min_cosine,
                                               max_depth=max_depth),
            capacity)

    if masks is not None:
        fmasks = torch.as_tensor(masks, device=dev).reshape(session.nframes, -1)
        state, uv2pt, _votes, classes_d, spans = fused_pipeline.fuse_session_and_vote(
            *fargs, fmasks, nclasses=nclasses, threshold=threshold, filter_classes=fclasses,
            window=window, window_policy=window_policy, dedup=dedup, with_stats=True,
            device=dev, **kw)
        overflow_frames, spans_h = _overflow(spans, window)
        seconds["fuse_vote"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if overflow_frames and auto_dedup:
            state, uv2pt, _votes, classes_d = fused_pipeline.dedup_and_revote(
                state, uv2pt, fmasks, radius, min_cosine, capacity=capacity,
                nclasses=nclasses, threshold=threshold, filter_classes=fclasses, dedup=dedup)
        n = int(state.n)
        points = state.points[:n].cpu().numpy()
        classes = classes_d[:n].cpu().numpy().astype(np.int32)
        seconds["repair"] = time.perf_counter() - t0
    else:
        state, uv2pt, spans = fusion_engine.fuse_session(
            *fargs, window=window, window_policy=window_policy, with_stats=True, device=dev,
            **kw)
        overflow_frames, spans_h = _overflow(spans, window)
        seconds["fuse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if overflow_frames and auto_dedup:
            state, slot_map = fusion_engine.dedup_state(state, radius, min_cosine,
                                                        capacity=capacity)
            uv2pt = fusion_engine.remap_uv2pt(uv2pt, slot_map)
        n = int(state.n)
        seconds["repair"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _votes, classes = stream_segment(session, segmenter, uv2pt.cpu().numpy(), npts=capacity,
                                         nclasses=nclasses, threshold=threshold,
                                         conf_threshold=conf_threshold, filter_classes=fclasses)
        classes = np.asarray(classes)[:n].astype(np.int32)
        points = state.points[:n].cpu().numpy()
        seconds["stream"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, ids, info, _ = components.split_into_instances_by_radius(
        classes, points, split_radius or 2 * radius, nclasses, None, min_pts_per_inst)
    taxonomy = taxonomy or tax.Taxonomy()
    parent_of = dict(zip(*taxonomy.as_load_csv_tuple()[:3:2]))
    for inf in info:
        # out-of-taxonomy categories get parent None: merge_bb maps None to
        # -1 (never merged), so a raw category id cannot pose as a parent
        inf["parent_id"] = parent_of.get(int(inf["category_id"]))
    seconds["split"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_premerge = len(info)
    if merge_obbs and info:
        # the device backend (above HOST_OBB_MAX_KN) takes the points
        # already on the device
        pts_dev = state.points[:n] if len(info) * n > HOST_OBB_MAX_KN else None
        if outdir is None:
            with tempfile.TemporaryDirectory() as td:
                info, ids = merge_bb(td, info, ids, points, verbose=False, points_dev=pts_dev,
                                     device=dev)
        else:
            Path(outdir).mkdir(parents=True, exist_ok=True)
            info, ids = merge_bb(outdir, info, ids, points, verbose=False, points_dev=pts_dev,
                                 device=dev)
    seconds["merge"] = time.perf_counter() - t0

    return FastSegmentation(
        points=points, classes=classes, instance_ids=np.asarray(ids),
        instance_info=list(info), n=n, n_instances_premerge=n_premerge, state=state,
        uv2pt=uv2pt, overflow_frames=overflow_frames, spans=spans_h, stage_seconds=seconds)


def _overflow(spans, window) -> Tuple[int, np.ndarray]:
    """Read the per-frame span telemetry; count the frames past the window
    (none when unwindowed)."""
    spans_h = spans.cpu().numpy()
    if window is None:
        return 0, spans_h
    return int((spans_h > int(window)).sum()), spans_h
