"""Fusion stage driver: a session on disk -> the fusion artifact tree.

Counterpart of `fusion3dseg_tpu/pipeline/process3d.py`.
`process3DSeg(input_data_path, output_path, ...)` locates the session (the
reference's PointcloudMergeResults pickle cache, else an rtabmap-export
directory), fuses it on `device` (`fusion.Fusion`), applies the
occurrence filter when asked, writes fusion/fusion_data.pkl, adj.pkl, the
PLY and the uv2pt files, and returns what it reads back.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.fusion import Fusion
from fusion3dseg_tpu_torch.io import rtab
from fusion3dseg_tpu_torch.utils import timing


def load_session(input_data_path, point_range=None, *, device="cuda") -> rtab.SessionData:
    """The session under `input_data_path`: the reference's pickle cache
    when PointcloudMergeResults holds one, else an rtabmap-export directory
    (one with depth/). Its per-pixel arrays go to `device`. `point_range` is
    accepted and ignored, as in the JAX package (the fusion applies it)."""
    input_data_path = Path(input_data_path)
    merge = input_data_path / "PointcloudMergeResults"
    if merge.is_dir():
        tofs = [f for f in os.listdir(merge) if "tofsegment" in f]
        if tofs:
            sub = tofs[0][:-4].split("_", 1)[1]
            return rtab.SessionData.from_cache(merge / f"tofsegment_{sub}.pkl",
                                               merge / f"rtscameradata_{sub}.pkl", device=device)
    if (input_data_path / "depth").is_dir():
        return rtab.SessionData.from_export_dir(input_data_path, device=device)
    raise FileNotFoundError(f"no session data under {input_data_path}")


def process3DSeg(
    input_data_path,
    output_path,
    radius: float = 0.05,
    angle: float = 10.0,
    stride: int = 10,
    point_range: Tuple[float, float] = (0.1, 4.0),
    decimation: int = 1,
    min_occ: Optional[int] = 3,
    capacity: Optional[int] = 1 << 20,
    verbose: bool = False,
    session: Optional[rtab.SessionData] = None,
    apply_min_occ: bool = False,
    adjacency_degree: int = 32,
    device="cuda",
):
    """Fuse a session into a sparse cloud and write its artifacts.

    Returns (points, normals, colors, nmerges, occurences, nframes,
    depth_hw, adj), as read back from the files.

    min_occ: the reference computes the occurrence filter but dumps the
    unfiltered arrays, which keeps the uv2pt indices valid; that is the
    default. `apply_min_occ=True` applies the filter and remaps every
    uv2pt file to the filtered indices (dropped points -> -1).
    capacity=None sizes the buffer from the seed frame. A given `session`
    is used as it is, on the device that holds it.
    """
    if session is None:
        session = load_session(input_data_path, device=cuda.resolve_device(device))

    fuser = Fusion(session, point_range=point_range, decimation=decimation, capacity=capacity,
                   save_lookups=True, out_dir=output_path)
    with timing.span("fusion", verbose=verbose):
        pts, norms, clrs, nmerges, occurences = fuser.fuse(
            radius, angle, stride, max_depth=point_range[1], skip=1, verbose=verbose)
    if verbose:
        print(f"total {fuser.npts * fuser.nframes} points from {fuser.nframes} frames fused "
              f"into {len(pts)} points")

    if min_occ is not None:
        mask, _ = fuser.filter(nmerges, min_occ, None, less_than=False)
        if verbose:
            print(f"points passing nmerges >= {min_occ}: {mask.sum()}")
        if apply_min_occ:
            remap = np.full(len(pts) + 1, -1, np.int32)
            remap[:-1][mask] = np.arange(int(mask.sum()), dtype=np.int32)
            pts, norms, clrs = pts[mask], norms[mask], clrs[mask]
            nmerges, occurences = nmerges[mask], occurences[mask]
            for f in (Path(output_path) / "fusion" / "uv2pt").glob("*.npy"):
                np.save(f, remap[np.load(f)])  # -1 indexes remap[-1] == -1

    with timing.span("fusion.dump", verbose=verbose):
        fuser.dump_data(output_path, pts, norms, clrs, nmerges, occurences, True, verbose,
                        adjacency_degree=adjacency_degree)
    return (*Fusion.load_data(output_path),)
