"""Batched geometric predicates.

Counterpart of `fusion3dseg_tpu/geometry/intersections.py`: ray, line and
plane intersections, point-in-polygon and point-in-polyhedron tests,
projections and ray-ray closest points, as batched tensor programs. The
fusion engine's frustum cull is `points_inside_polyhedra`.

Every product here is float32 and must stay so: TF32 would flip signs near
plane boundaries. No global switch is set; `allow_tf32` is off by default.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fusion3dseg_tpu_torch.geometry import quaternion as quat

_EPS = 1e-12  # normalization floor only, not a parallel test
# parallel-ray/plane guard, scaled to the operands: float32 dots of unit
# vectors carry ~1e-7 of rounding noise
_PARALLEL_EPS = 1e-6


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def points_inside_polyhedra(points: torch.Tensor, plane_points: torch.Tensor,
                            plane_normals: torch.Tensor) -> torch.Tensor:
    """Half-space sign test: inside <=> dot(p - plane_point_m, normal_m) >= 0
    for every plane m, as one float32 [N,3] @ [3,M] product minus the plane
    offsets d_m = n_m . p0_m.

    points [N, 3], plane_points [M, 3], plane_normals [M, 3] (inward).
    Returns [N] bool.
    """
    d = (plane_points * plane_normals).sum(dim=-1)  # [M]
    dp = points @ plane_normals.T - d
    return (dp >= 0.0).all(dim=-1)


def ray_plane_intersections(ray_origins, ray_dirs, plane_point, plane_normal
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N rays against one plane. Returns ([N, 3] points, [N] t; t = inf
    where a ray is parallel to the plane)."""
    denom = ray_dirs @ plane_normal
    num = (plane_point - ray_origins) @ plane_normal
    scale = _norm(ray_dirs) * _norm(plane_normal)
    t = torch.where(denom.abs() > _PARALLEL_EPS * scale, num / denom, torch.inf)
    return ray_origins + t[:, None] * ray_dirs, t


def lines_planes_intersections(line_points, line_dirs, plane_points, plane_normals
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All pairs of N lines and M planes. Returns ([N, M, 3] points,
    [N, M] t; t = inf where parallel)."""
    denom = line_dirs @ plane_normals.T
    num = ((plane_points[None] - line_points[:, None]) * plane_normals).sum(dim=-1)
    scale = _norm(line_dirs)[:, None] * _norm(plane_normals)[None]
    t = torch.where(denom.abs() > _PARALLEL_EPS * scale, num / denom, torch.inf)
    return line_points[:, None] + t[..., None] * line_dirs[:, None], t


def points_in_polygon_sign(points, polygon, normal) -> torch.Tensor:
    """Point in a convex polygon by a consistent edge-cross sign.
    points [N, 3] on the polygon's plane, polygon [V, 3] in order, normal
    [3]. Returns [N] bool."""
    edges = torch.roll(polygon, shifts=-1, dims=0) - polygon  # [V, 3]
    to_pt = points[:, None, :] - polygon[None, :, :]  # [N, V, 3]
    side = (quat.cross(edges[None].expand(to_pt.shape), to_pt) * normal).sum(dim=-1)
    return (side >= 0).all(dim=-1) | (side <= 0).all(dim=-1)


def plane_plane_direction(n1, n2) -> torch.Tensor:
    """Unit direction of the line where two planes meet."""
    d = quat.cross(n1, n2)
    return d / _norm(d, keepdim=True).clamp(min=_EPS)


def project_points_to_plane(points, plane_point, plane_normal
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perpendicular projection onto a plane. Returns ([N, 3] projected
    points, [N] signed distances)."""
    n = plane_normal / _norm(plane_normal)
    dist = (points - plane_point) @ n
    return points - dist[:, None] * n, dist


def ray_ray_closest_points(o1, d1, o2, d2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest points between two batches of rays, all [N, 3]."""
    r = o2 - o1
    a = (d1 * d1).sum(dim=-1)
    b = (d1 * d2).sum(dim=-1)
    c = (d2 * d2).sum(dim=-1)
    e = (d1 * r).sum(dim=-1)
    f = (d2 * r).sum(dim=-1)
    denom = a * c - b * b
    ok = denom.abs() > _EPS
    t1 = torch.where(ok, (e * c - b * f) / denom, 0.0)
    t2 = torch.where(ok, (e * b - a * f) / denom, 0.0)
    return o1 + t1[:, None] * d1, o2 + t2[:, None] * d2
