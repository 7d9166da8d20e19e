"""Oriented bounding boxes and intersection-driven instance merging.

Counterpart of `fusion3dseg_tpu/ops/obb.py`. PCA boxes for all K instances
at once (segment sums for the mean and 3x3 covariance, a batched
`eigh`), membership of every cloud point in every box as one rotation and
extent compare, and the criterion "two boxes intersect iff some cloud point
lies inside both" as one [K,N] @ [N,K] product. The merge of same-parent
intersecting boxes is a host union-find.

Two backends with the reference's crossover: the device path (tensors,
float32) and the host path (`*_np`, NumPy in float64). `merge_bb` picks the
host one while K * N <= HOST_OBB_MAX_KN, as the JAX package does, so both
packages compute a given merge in the same precision.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch.ops.sparsify import segment_sum

# the host/device crossover of the reference's merge_bb "auto" backend
HOST_OBB_MAX_KN = 3.0e7

_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def _segment_extreme(values, seg, K, reduce, identity):
    out = torch.full((K + 1, values.shape[1]), identity, dtype=values.dtype,
                     device=values.device)
    idx = seg.long()[:, None].expand(-1, values.shape[1])
    return out.scatter_reduce_(0, idx, values, reduce=reduce, include_self=True)[:K]


@torch.no_grad()
def instance_obbs(points: torch.Tensor, ids: torch.Tensor, num_instances: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA oriented boxes of every instance id at once, on the points' device.

    points [N, 3] float32; ids [N] int in [0, K), negative ids ignored.
    Returns centers [K, 3], axes [K, 3, 3] (rows are the box axes),
    half_extents [K, 3], counts [K] int32; empty instances get zero extents.
    """
    K = num_instances
    ok = ids >= 0
    seg = torch.where(ok, ids, K)
    w = ok.to(torch.float32)
    n = points.shape[0]
    cnt = segment_sum(w[:, None], seg, K)[:, 0]
    mean = segment_sum(points * w[:, None], seg, K) / cnt[:, None].clamp(min=1.0)
    own = seg.clamp(0, K - 1).long()
    centered = points - mean[own]
    outer = (centered[:, :, None] * centered[:, None, :] * w[:, None, None]).reshape(n, 9)
    cov = segment_sum(outer, seg, K).reshape(K, 3, 3) / cnt[:, None, None].clamp(min=1.0)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    _, vecs = torch.linalg.eigh(cov + 1e-9 * eye)
    axes = vecs.transpose(-1, -2)
    proj = torch.einsum("nc,nkc->nk", centered, axes[own])
    big = 3.0e38
    pmax = _segment_extreme(torch.where(ok[:, None], proj, -big), seg, K, "amax", -big)
    pmin = _segment_extreme(torch.where(ok[:, None], proj, big), seg, K, "amin", big)
    empty = (cnt < 1)[:, None]
    pmax = torch.where(empty, 0.0, pmax)
    pmin = torch.where(empty, 0.0, pmin)
    half = (pmax - pmin) / 2.0
    centers = mean + torch.einsum("kc,kcd->kd", (pmax + pmin) / 2.0, axes)
    return centers, axes, half, cnt.to(torch.int32)


def obb_corners(centers: torch.Tensor, axes: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """[K,3], [K,3,3], [K,3] -> [K, 8, 3] corner points."""
    signs = torch.tensor(_SIGNS, dtype=torch.float32, device=centers.device)
    return centers[:, None, :] + torch.einsum("sc,kc,kcd->ksd", signs, half, axes)


def instance_obb_corners(points, ids, num_instances):
    """(corners [K, 8, 3], counts [K]) of every instance's box."""
    centers, axes, half, cnt = instance_obbs(points, ids, num_instances)
    return obb_corners(centers, axes, half), cnt


def points_inside_obbs(points, centers, axes, half, eps: float = 1e-5) -> torch.Tensor:
    """[K, N] bool: point n lies inside box k (extents padded by eps)."""
    rel = points[None, :, :] - centers[:, None, :]
    local = torch.einsum("knc,kdc->knd", rel, axes)
    return (local.abs() <= (half[:, None, :] + eps)).all(dim=-1)


@torch.no_grad()
def obb_intersection_matrix(points, ids, num_instances):
    """Per-instance boxes and the [K, K] intersection matrix: i and j
    intersect iff some cloud point lies inside both; instances of fewer
    than 4 points intersect nothing. Returns (intersect [K,K] bool,
    centers, axes, half_extents, counts)."""
    centers, axes, half, cnt = instance_obbs(points, ids, num_instances)
    insf = points_inside_obbs(points, centers, axes, half).to(torch.float32)
    co = insf @ insf.T  # co-membership counts, exact in float32 below 2^24
    ok = cnt >= 4
    return (co > 0) & ok[:, None] & ok[None, :], centers, axes, half, cnt


def instance_obbs_np(points, ids, num_instances):
    """Host counterpart of `instance_obbs` (same returns, float64 math,
    one PCA box per instance)."""
    K = num_instances
    pts = np.asarray(points, np.float64)
    ids = np.asarray(ids)
    centers = np.zeros((K, 3), np.float32)
    axes = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    half = np.zeros((K, 3), np.float32)
    cnt = np.zeros(K, np.int32)
    for k in range(K):
        member = pts[ids == k]
        cnt[k] = len(member)
        if cnt[k] < 1:
            continue
        centers[k], axes[k], half[k] = pca_obb_np(member)
    return centers, axes, half, cnt


def instance_obb_corners_np(points, ids, num_instances):
    """Host counterpart of `instance_obb_corners`."""
    centers, axes, half, cnt = instance_obbs_np(points, ids, num_instances)
    corners = np.stack([obb_corners_np(centers[k], axes[k], half[k])
                        for k in range(num_instances)]) if num_instances \
        else np.zeros((0, 8, 3), np.float32)
    return corners.astype(np.float32), cnt


def obb_intersection_matrix_np(points, ids, num_instances):
    """Host counterpart of `obb_intersection_matrix`, NumPy end to end."""
    pts = np.asarray(points, np.float64)
    centers, axes, half, cnt = instance_obbs_np(pts, ids, num_instances)
    rel = pts[None, :, :] - centers.astype(np.float64)[:, None, :]
    local = np.einsum("knc,kdc->knd", rel, axes.astype(np.float64))
    inside = np.all(np.abs(local) <= (half[:, None, :] + 1e-5), axis=-1)
    co = inside.astype(np.float32) @ inside.astype(np.float32).T
    ok = cnt >= 4
    return (co > 0) & ok[:, None] & ok[None, :], centers, axes, half, cnt


def pca_obb_np(pts: np.ndarray):
    """PCA box of one instance's points: (center [3], axes [3, 3] rows,
    half extents [3]), float32 results of float64 math."""
    pts = np.asarray(pts, np.float64)
    mean = pts.mean(axis=0)
    c = pts - mean
    cov = (c.T @ c) / len(pts)
    _, vecs = np.linalg.eigh(cov + 1e-9 * np.eye(3))
    axes = vecs.T
    proj = c @ axes.T
    pmax, pmin = proj.max(axis=0), proj.min(axis=0)
    center = mean + ((pmax + pmin) / 2.0) @ axes
    return (center.astype(np.float32), axes.astype(np.float32),
            ((pmax - pmin) / 2.0).astype(np.float32))


def obb_corners_np(center, axes, half) -> np.ndarray:
    """Host counterpart of `obb_corners` for one box: [8, 3] corners."""
    signs = np.asarray(_SIGNS, np.float32)
    return np.asarray(center)[None, :] + (signs * np.asarray(half)) @ np.asarray(axes)


def merge_intersecting_instances(intersect: np.ndarray, parent_ids: np.ndarray,
                                 mergeable: np.ndarray) -> np.ndarray:
    """Union-find of same-parent intersecting instances (host).

    intersect [K, K] bool; parent_ids [K] (-1: never merged); mergeable [K]
    bool. Returns root [K]: each instance's representative (the smallest
    index of its group)."""
    K = len(parent_ids)
    root = np.arange(K)

    def find(a):
        while root[a] != a:
            root[a] = root[root[a]]
            a = root[a]
        return a

    ii, jj = np.nonzero(np.triu(intersect, k=1))
    for a, b in zip(ii, jj):
        if not (mergeable[a] and mergeable[b]):
            continue
        if parent_ids[a] < 0 or parent_ids[a] != parent_ids[b]:
            continue
        ra, rb = find(a), find(b)
        if ra != rb:
            root[max(ra, rb)] = min(ra, rb)
    for a in range(K):
        root[a] = find(a)
    return root
