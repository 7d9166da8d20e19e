"""Segmentation refinement: gated flood fills, door/wall alignment.

Counterpart of `fusion3dseg_tpu/pipeline/refinement.py`. An instance (a
door, say) grows over the neighbour graph while the points it admits stay
close to the cluster: in perpendicular distance to its wall plane
(`depth_floodfill`) or in colour (`color_floodfill`). Each round admits
every frontier point within `threshold` of the whole cluster's mean on
every channel, then recomputes the mean; it stops when a round admits
nothing or after `max_level` rounds, with one host read a round. The
result goes to `cv_segmentation/{pcd.ply, ids.npy}`, which later calls
resume from. `door_updation` snaps a door polygon onto its wall and
`door_floor_align` rotates a door box onto the wall's bottom edge.

The cluster mean sums in float64 and rounds once to float32: the correctly
rounded sum, on the CPU and the card alike (XLA's float32 sum gave the same
value on a 40,000-point cluster).
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.geometry import quaternion as quat
from fusion3dseg_tpu_torch.io import ply


def gated_floodfill(adj, seeds, values, threshold, max_level: int = 50, device="cuda",
                    return_rounds: bool = False):
    """Grow `seeds` [N] bool over `adj` [N, K] (-1 padded), admitting
    frontier points whose `values` ([N] or [N, C]) lie within `threshold`
    (a scalar or [C]) of the cluster mean on every channel. Tensors run on
    their own device, arrays on `device`. Returns membership [N] bool (a
    tensor), and the rounds run with `return_rounds`."""
    dev = adj.device if isinstance(adj, torch.Tensor) else cuda.resolve_device(device)
    adj = torch.as_tensor(adj, device=dev).long()
    member = torch.as_tensor(seeds, device=dev).bool()
    values = torch.as_tensor(values, device=dev).float()
    if values.ndim == 1:
        values = values[:, None]
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=dev).expand(values.shape[1])
    adj_ok = adj >= 0
    adj_safe = adj.clamp_min(0)
    grew, rounds = True, 0
    while grew and rounds < max_level:
        frontier = (member[adj_safe] & adj_ok).any(dim=-1) & ~member
        w = member.to(torch.float32)
        total = (values * w[:, None]).double().sum(dim=0).float()
        mean = total / w.double().sum().float().clamp_min(1.0)
        admit = frontier & ((values - mean).abs() <= thr).all(dim=-1)
        member = member | admit
        grew = bool(admit.any())
        rounds += 1
    return (member, rounds) if return_rounds else member


def perpendicular_distance(points, plane_point, plane_normal) -> np.ndarray:
    """|dot(p - p0, n)| per point, n normalized."""
    n = np.asarray(plane_normal, np.float64)
    n = n / np.linalg.norm(n)
    return np.abs((np.asarray(points) - np.asarray(plane_point)) @ n)


def _load_refinement_state(outputpath) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(instance ids, points, colours) from cv_segmentation/ when an earlier
    refinement wrote it, else from panoptic_segmentation/."""
    outputpath = Path(outputpath)
    cv = outputpath / "cv_segmentation"
    cv.mkdir(parents=True, exist_ok=True)
    src = cv if (cv / "ids.npy").is_file() and (cv / "pcd.ply").is_file() \
        else outputpath / "panoptic_segmentation"
    ids = np.load(src / "ids.npy")
    pts, colors, _ = ply.read_point_cloud(src / "pcd.ply")
    if colors is None:
        colors = np.zeros_like(pts)
    return ids, pts, colors


def _grow(outputpath, adj, seed_point, values, threshold, max_level, grow_from_instance, save,
          device):
    """The shared body of the two fills: seeds, gated fill, relabel, save."""
    ids, points, colors = _load_refinement_state(outputpath)
    inst = ids[seed_point]
    if grow_from_instance:
        seeds = ids == inst
    else:
        seeds = np.zeros(len(points), bool)
        seeds[seed_point] = True
    member = gated_floodfill(adj, seeds, np.asarray(values(points, colors), np.float32),
                             np.float32(threshold), max_level=max_level,
                             device=device).cpu().numpy()
    grown = member & ~seeds
    ids = ids.copy()
    ids[member] = inst
    colors = colors.copy()
    colors[member] = colors[seed_point]
    if save:
        save_ids_ply(points, colors, ids, outputpath)
    return ids, grown


def depth_floodfill(outputpath, adj, seed_point: int, wall_point, wall_normal,
                    depth_threshold: float = 0.03, max_level: int = 50,
                    grow_from_instance: bool = True, save: bool = True, device="cuda"):
    """Grow the instance at `seed_point` (its whole instance, or the point
    alone with `grow_from_instance=False`) by distance to the wall plane.
    Returns (instance ids [N], grown mask [N])."""
    return _grow(outputpath, adj, seed_point,
                 lambda pts, _: perpendicular_distance(pts, wall_point, wall_normal),
                 depth_threshold, max_level, grow_from_instance, save, device)


def color_floodfill(outputpath, adj, seed_point: int, point_colors,
                    color_threshold: float = 0.1, max_level: int = 50,
                    grow_from_instance: bool = True, save: bool = True, device="cuda"):
    """Grow by similarity of `point_colors` (the fused cloud's photometric
    colours, not the segmentation palette). Returns (ids, grown mask)."""
    return _grow(outputpath, adj, seed_point, lambda *_: point_colors, color_threshold,
                 max_level, grow_from_instance, save, device)


def save_ids_ply(points, colors, instance_ids, outputpath) -> None:
    """cv_segmentation/pcd.ply and ids.npy."""
    cv = Path(outputpath) / "cv_segmentation"
    cv.mkdir(parents=True, exist_ok=True)
    ply.write_point_cloud(cv / "pcd.ply", points, colors=colors)
    np.save(cv / "ids.npy", instance_ids)


# ----------------------------------------------------- door / wall geometry --

def closest_point_on_segment(a, b, p):
    """(distance, closest point) of p to the line through a and b (the
    reference projects onto the infinite line)."""
    a, b, p = map(np.asarray, (a, b, p))
    ab = b - a
    t = np.dot(p - a, ab) / np.dot(ab, ab)
    q = a + t * ab
    return np.linalg.norm(q - p), q


def door_updation(outer_poly, inner_poly, normal_wall, max_distance: float = 0.2):
    """Project the door's corners onto the wall plane, then pull each onto
    every wall edge within `max_distance`. The snaps compound in edge order:
    each test measures from the already-moved corner and a later edge
    overrides an earlier one, as in the reference."""
    outer_poly = np.asarray(outer_poly, np.float64)
    inner = np.asarray(inner_poly, np.float64).copy()
    n = np.asarray(normal_wall, np.float64)
    n = n / np.linalg.norm(n)
    t = outer_poly[0].dot(n) - inner @ n
    inner = inner + t[:, None] * n
    edges = [(outer_poly[i], outer_poly[i + 1]) for i in range(len(outer_poly) - 1)]
    edges.append((outer_poly[0], outer_poly[-1]))
    for z in range(len(inner)):
        for a, b in edges:
            dist, q = closest_point_on_segment(a, b, inner[z])
            if dist < max_distance:
                inner[z] = q
    return inner


def door_floor_align(door_bb, wall_bb, flip: bool = True):
    """Rotate the door box about its lowest corner so that its bottom edge
    (two lowest corners) parallels the wall's, through float32
    quaternions."""
    door_bb = np.asarray(door_bb, np.float64)
    wall_bb = np.asarray(wall_bb, np.float64)
    d_sorted = door_bb[door_bb[:, 2].argsort()]
    w_sorted = wall_bb[wall_bb[:, 2].argsort()]
    v1 = w_sorted[1] - w_sorted[0]
    v2 = d_sorted[1] - d_sorted[0]
    v1 = v1 / np.linalg.norm(v1)
    v2 = v2 / np.linalg.norm(v2)
    axis = np.cross(v1, v2)
    axis_norm = np.linalg.norm(axis)
    if axis_norm < 1e-12:
        return door_bb.copy()
    axis = axis / axis_norm
    angle = float(np.arccos(np.clip(np.dot(v1, v2), -1.0, 1.0)))
    f32 = torch.float32
    q = quat.from_axis_angle(torch.tensor(axis, dtype=f32),
                             torch.tensor(-angle if flip else angle, dtype=f32))
    pivot = d_sorted[0]
    rotated = quat.rotate(q, torch.tensor(door_bb - pivot, dtype=f32)).numpy()
    return rotated + pivot
