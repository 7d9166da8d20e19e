"""Intersecting-OBB instance merging.

Counterpart of `fusion3dseg_tpu/pipeline/merge_bb.py`: two instances merge
when they share a parent class and some cloud point lies inside both
oriented boxes. Writes `panoptic_segmentation/final_info.json` and
`ids.npy` under the session directory.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import artifacts
from fusion3dseg_tpu_torch.ops import obb as obb_ops


def merge_bb(dir_name, info_sem: List[dict], id_info_per_point, pcd_points,
             verbose: bool = True, points_dev=None, backend: str = "auto", device="cuda"):
    """Merge same-parent instances whose oriented boxes intersect.

    Args:
      dir_name: session directory (panoptic_segmentation/ is written there).
      info_sem: per-instance dicts with 'id', 'parent_id', 'area'.
      id_info_per_point: [N] instance id per point.
      pcd_points: [N, 3] points (an array or an object with `.points`).
      points_dev: the same points as a tensor on the device, for the device
        backend (saves a copy).
      backend: "auto" | "host" | "device" for the boxes and the
        intersection matrix; "auto" takes the host while K * N <=
        `obb.HOST_OBB_MAX_KN`.
      device: where the device backend runs.

    Returns (info_sem, id_info_per_point) after merging; merged roots get a
    fresh box ("bbox", 8 corners) from their members, others keep theirs.
    """
    points = np.asarray(getattr(pcd_points, "points", pcd_points), np.float32)
    ids = np.asarray(id_info_per_point).copy()
    len_before = len(info_sem)
    t0 = time.perf_counter()
    if len(info_sem) == 0 or len(points) == 0:
        _dump(dir_name, info_sem, ids)
        return info_sem, ids

    inst_ids = np.asarray([int(i["id"]) for i in info_sem])
    K = len(inst_ids)
    lut = np.full(int(max(ids.max(), inst_ids.max())) + 2, -1, np.int32)
    lut[inst_ids] = np.arange(K, dtype=np.int32)
    dense = lut[ids]  # dense instance index per point, -1 unlisted

    if backend not in ("auto", "host", "device"):
        raise ValueError(f"unknown merge_bb backend {backend!r}")
    if backend == "host" or (backend == "auto" and K * len(points) <= obb_ops.HOST_OBB_MAX_KN):
        intersect, centers, axes, half, cnts = obb_ops.obb_intersection_matrix_np(points, dense, K)
    else:
        dev = cuda.resolve_device(device)
        pts_d = points_dev if points_dev is not None else torch.as_tensor(points, device=dev)
        out = obb_ops.obb_intersection_matrix(pts_d, torch.as_tensor(dense, device=pts_d.device),
                                              K)
        intersect, centers, axes, half, cnts = (t.cpu().numpy() for t in out)

    parents = np.asarray([i.get("parent_id") if i.get("parent_id") is not None else -1
                          for i in info_sem])
    mergeable = np.ones(K, bool)
    mergeable[0] = False  # the first (semantic) entry is never merged
    root = obb_ops.merge_intersecting_instances(intersect, parents, mergeable)

    new_info, kept_orig, changed = [], [], set()
    for k, info in enumerate(info_sem):
        if root[k] == k:
            new_info.append(info)
            kept_orig.append(k)
        else:
            r = int(root[k])
            info_sem[r]["area"] = int(info_sem[r]["area"]) + int(info["area"])
            ids[ids == inst_ids[k]] = inst_ids[r]
            changed.add(r)

    # boxes of roots that absorbed points are fitted anew on the host
    for k, info in enumerate(new_info):
        if k == 0:
            continue
        ko = kept_orig[k]
        if ko in changed:
            members = points[ids == inst_ids[ko]]
            if len(members) > 4:
                info["bbox"] = obb_ops.obb_corners_np(*obb_ops.pca_obb_np(members)).tolist()
        elif cnts[ko] > 4:
            info["bbox"] = obb_ops.obb_corners_np(centers[ko], axes[ko], half[ko]).tolist()

    if verbose:
        print(f"Time taken for merging {len_before} to {len(new_info)} "
              f"Bounding boxes = {time.perf_counter() - t0} seconds")
    _dump(dir_name, new_info, ids)
    return new_info, ids


def _dump(dir_name, info, ids):
    out = Path(dir_name) / "panoptic_segmentation"
    out.mkdir(parents=True, exist_ok=True)
    artifacts.write_info_json(out / "final_info.json", info)
    np.save(out / "ids.npy", ids)
