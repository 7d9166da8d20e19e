"""Typed per-stage configuration.

Counterpart of `fusion3dseg_tpu/config.py`: one frozen dataclass a stage,
with the defaults of the stage functions, so a user gets the same
behaviour out of the box. These dataclasses are the canonical record of
the defaults; `tests/test_torch_cli.py` pins each field against the port's
stage signatures, so a default cannot drift silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# COCO-133 panoptic taxonomy used by the reference's OneFormer wrapper
# (reference get2DSeg.py:111-118: argmax over 133 classes, low-confidence
# pixels relabeled to class 133 "unclassified").
NUM_CLASSES = 133
UNCLASSIFIED = NUM_CLASSES  # = 133


@dataclasses.dataclass(frozen=True)
class Seg2DConfig:
    """2D semantic segmentation stage (reference get2DSeg.py:82-126)."""

    extension: str = "jpg"
    # Softmax-confidence threshold below which a pixel becomes class 133
    # (reference get2DSeg.py:113-118 uses 0.017).
    conf_threshold: float = 0.017
    filter_classes: Optional[Sequence[int]] = None
    num_classes: int = NUM_CLASSES
    # model inference settings
    batch_size: int = 8
    image_hw: Tuple[int, int] = (512, 512)
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Multi-view fusion stage (reference Fusion3DSeg/process3D.py:14-18)."""

    radius: float = 0.05  # merge distance threshold [m]
    angle: float = 10.0  # surface-normal merge threshold [deg]
    stride: int = 10  # sparsification patch size [px]
    point_range: Tuple[float, float] = (0.1, 4.0)  # valid depth range [m]
    decimation: int = 1
    min_occ: int = 3  # occurrence-denoise threshold (applied to nmerges)
    # far-plane distance for frustum culling [m]; None = point_range[1]
    # (the reference's far plane, process3D.py:17 — process3DSeg culls at
    # the validity range's upper bound, not an independent knob)
    max_depth: Optional[float] = None
    skip: int = 1  # frame skip
    # fixed sparse-point capacity: the running sparse cloud lives in a
    # padded buffer of this many slots
    capacity: int = 1 << 20
    # merge-window overflow policy: "split" covers the oldest and newest
    # visible slots, so loop-closure revisits merge instead of duplicating
    window_policy: str = "split"
    save_lookups: bool = True


@dataclasses.dataclass(frozen=True)
class VotingConfig:
    """Label-lifting stage (reference get3DSeg.py:18-22, voting.py:75-137)."""

    threshold: float = 0.5  # max_vote/total_votes confidence threshold
    nclasses: int = NUM_CLASSES
    filter_classes: Optional[Sequence[int]] = (86, 114, 115)
    min_pts_per_inst: int = 100
    # Reference parity: NumPy fancy-index `+=` collapses duplicate
    # (point, class) pairs within one frame (reference voting.py:98).
    # True  -> replicate exactly (per-frame presence via scatter-max).
    # False -> count every pixel (np.add.at semantics), slightly faster.
    dedup_per_frame: bool = True


@dataclasses.dataclass(frozen=True)
class InstanceConfig:
    """Connected-component instance split (reference segUtils/cv.py:402-500)."""

    min_pts_per_inst: int = 100
    # Fixed neighbor degree of the radius graph; the reference uses an
    # unbounded KDTree.query_radius list (fusion.py:374-375). 16 covers the
    # observed neighbor counts at r = 2*ds_radius on indoor scans.
    max_degree: int = 16
    # Iteration cap for label propagation (reference BFS is unbounded).
    max_iters: int = 512


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seg2d: Seg2DConfig = Seg2DConfig()
    fusion: FusionConfig = FusionConfig()
    voting: VotingConfig = VotingConfig()
    instance: InstanceConfig = InstanceConfig()
