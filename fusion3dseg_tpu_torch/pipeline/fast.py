"""One-call in-memory pipeline: session -> fused cloud -> classes -> instances.

Counterpart of `fusion3dseg_tpu/pipeline/fast.py`, the main path of the
system. Both label sources take one order, on the device:

  * fuse (`fusion.fuse_session`), reading the per-frame visible spans;
  * repair (`dedup_state` + `remap_uv2pt`) when a frame's visible span
    passed the merge window;
  * vote the given masks (`ops.voting.vote_all_frames`) or the segmenter's
    logits (`pipeline.streaming.stream_votes`) on the repaired uv2pt, then
    classify (`ops.voting.classify`);
  * the host instance split over the full radius relation
    (`ops.components.split_into_instances_by_radius`) and the host OBB
    merge (`pipeline.merge_bb`).
"""

from __future__ import annotations

import dataclasses
import functools
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
from fusion3dseg_tpu_torch.ops import components, voting
from fusion3dseg_tpu_torch.ops.obb import HOST_OBB_MAX_KN
from fusion3dseg_tpu_torch.pipeline.merge_bb import merge_bb
from fusion3dseg_tpu_torch.pipeline.streaming import stream_votes
from fusion3dseg_tpu_torch.utils import taxonomy as tax, timing


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
    # wall seconds of the stages (`utils.timing` spans), each ending where
    # the host reads the device anyway: "fuse", "repair", "vote" (masks) or
    # "stream" (segmenter), "split", "merge"; each with its
    # ".wait" (the host blocked on the card) and ".dispatch" (the rest);
    # and the engine's counters "fuse_graph.frames" (frames replayed from
    # a CUDA graph), "fuse_graph.captures" (graphs captured) and
    # "fuse_match.kernel_frames" (frames matched by the match kernel)
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
        # stream_votes counts one vote per (point, frame); dedup=False
        # would silently differ from the masks path's semantics
        raise ValueError("dedup=False is only supported on the masks path")
    dev = cuda.resolve_device(device)
    with timing.record() as seconds:
        with timing.span("fuse"):
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
            if window == "auto":
                window = fusion_engine.auto_window(
                    fusion_engine.seed_cells_for_frame(fargs[3][0], fargs[4][0], fargs[5][0],
                                                       fargs[6][0], hd, wd, radius, min_cosine,
                                                       max_depth=max_depth),
                    capacity)
            state, uv2pt, spans = fusion_engine.fuse_session(
                *fargs, height=hd, width=wd, radius=radius, min_cosine=min_cosine,
                max_depth=max_depth, capacity=capacity, window=window,
                window_policy=window_policy, with_stats=True, device=dev)
            overflow_frames, spans_h = _overflow(spans, window)

        with timing.span("repair"):
            if overflow_frames and auto_dedup:
                state, slot_map = fusion_engine.dedup_state(state, radius, min_cosine,
                                                            capacity=capacity)
                uv2pt = fusion_engine.remap_uv2pt(uv2pt, slot_map)
            with timing.wait("n"):
                n = int(state.n)
            with timing.wait("points"):
                points = state.points[:n].cpu().numpy()

        label = "vote" if masks is not None else "stream"
        with timing.span(label):
            if masks is not None:
                with timing.wait("masks_upload"):
                    fmasks = torch.as_tensor(masks, device=dev).reshape(session.nframes, -1)
                votes = voting.vote_all_frames(uv2pt, fmasks, capacity, nclasses, dedup, dev)
            else:
                votes = stream_votes(session, segmenter, uv2pt, capacity, nclasses,
                                     conf_threshold)
            with timing.range(label + ".classify"):
                classes = voting.classify(votes, threshold, nclasses, filter_classes)
            with timing.wait("classes"):
                classes = classes[:n].cpu().numpy()

        with timing.span("split"):
            _, ids, info, _ = components.split_into_instances_by_radius(
                classes, points, split_radius or 2 * radius, nclasses, None, min_pts_per_inst)
            taxonomy = taxonomy or tax.Taxonomy()
            parent_of = dict(zip(*taxonomy.as_load_csv_tuple()[:3:2]))
            for inf in info:
                # out-of-taxonomy categories get parent None: merge_bb maps None
                # to -1 (never merged), so a raw category id cannot pose as a
                # parent
                inf["parent_id"] = parent_of.get(int(inf["category_id"]))

        with timing.span("merge"):
            n_premerge = len(info)
            if merge_obbs and info:
                # the device backend (above HOST_OBB_MAX_KN) takes the points
                # already on the device
                pts_dev = state.points[:n] if len(info) * n > HOST_OBB_MAX_KN else None
                if outdir is None:
                    with tempfile.TemporaryDirectory() as td:
                        info, ids = merge_bb(td, info, ids, points, verbose=False,
                                             points_dev=pts_dev, device=dev)
                else:
                    Path(outdir).mkdir(parents=True, exist_ok=True)
                    info, ids = merge_bb(outdir, info, ids, points, verbose=False,
                                         points_dev=pts_dev, device=dev)

    return FastSegmentation(
        points=points, classes=classes, instance_ids=np.asarray(ids),
        instance_info=list(info), n=n, n_instances_premerge=n_premerge, state=state,
        uv2pt=uv2pt, overflow_frames=overflow_frames, spans=spans_h, stage_seconds=seconds)


def _overflow(spans, window) -> Tuple[int, np.ndarray]:
    """Read the per-frame span telemetry; count the frames past the window
    (none when unwindowed)."""
    with timing.wait("spans"):
        spans_h = spans.cpu().numpy()
    if window is None:
        return 0, spans_h
    return int((spans_h > int(window)).sum()), spans_h
