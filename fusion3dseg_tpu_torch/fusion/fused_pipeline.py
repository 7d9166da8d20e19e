"""Fusion followed by voting: session -> fused cloud -> per-point classes.

Counterpart of `fusion3dseg_tpu/fusion/fused_pipeline.py`. The reference
fuses the two into one compiled program to save dispatches; here they are
two calls on the same device, and the uv2pt table never leaves it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
from fusion3dseg_tpu_torch.ops import voting


def _classes_dtype(classes: torch.Tensor, nclasses: int) -> torch.Tensor:
    # uint8 when every id, the "unclassified" id nclasses included, fits
    return classes.to(torch.uint8) if nclasses <= 255 else classes


@torch.no_grad()
def fuse_session_and_vote(Ks, quats_wxyz, translations, points, normals, colors, valid,
                          masks, *, height: int, width: int, radius: float,
                          min_cosine: float, max_depth: float, capacity: int, nclasses: int,
                          threshold: float = 0.5,
                          filter_classes: Optional[Tuple[int, ...]] = None,
                          candidate_px: int = 1, window: Optional[int] = None,
                          window_policy: str = "newest", dedup: bool = True,
                          with_stats: bool = False, device="cuda"):
    """`fuse_session(...)` then `vote_and_classify(uv2pt, masks, capacity,
    ...)` on `device`; masks are [F, H*W] class ids at depth resolution.

    Returns (state, uv2pt [F, H*W] int32, votes [capacity, nclasses+1]
    int32, classes [capacity] uint8 when nclasses <= 255 else int32[,
    spans [F] int32 with `with_stats`]). Rows >= state.n of votes and
    classes are vote-free padding, classified `nclasses`.
    """
    dev = cuda.resolve_device(device)
    out = fusion_engine.fuse_session(
        Ks, quats_wxyz, translations, points, normals, colors, valid, height=height,
        width=width, radius=radius, min_cosine=min_cosine, max_depth=max_depth,
        capacity=capacity, candidate_px=candidate_px, window=window,
        window_policy=window_policy, with_stats=with_stats, device=dev)
    state, uv2pt = out[0], out[1]
    votes, classes = voting.vote_and_classify(uv2pt, masks, capacity, nclasses,
                                              threshold=threshold,
                                              filter_classes=filter_classes, dedup=dedup,
                                              device=dev)
    classes = _classes_dtype(classes, nclasses)
    if with_stats:
        return state, uv2pt, votes, classes, out[2]
    return state, uv2pt, votes, classes


@torch.no_grad()
def dedup_and_revote(state: fusion_engine.FusionState, uv2pt, masks, radius: float,
                     min_cosine: float, *, capacity: int, nclasses: int,
                     threshold: float = 0.5,
                     filter_classes: Optional[Tuple[int, ...]] = None, dedup: bool = True):
    """The window-overflow repair: `dedup_state`, uv2pt remapped to the
    compacted slots, and a fresh vote, so that a frame voting for two
    now-merged slots counts once. Runs on the state's device. Same returns
    as `fuse_session_and_vote` without the spans."""
    dev = state.points.device
    state, slot_map = fusion_engine.dedup_state(state, radius, min_cosine, capacity=capacity)
    uv2pt = fusion_engine.remap_uv2pt(uv2pt, slot_map)
    votes, classes = voting.vote_and_classify(uv2pt, masks, capacity, nclasses,
                                              threshold=threshold,
                                              filter_classes=filter_classes, dedup=dedup,
                                              device=dev)
    return state, uv2pt, votes, _classes_dtype(classes, nclasses)
