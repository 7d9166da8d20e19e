"""Class-constrained connected components of a labelled cloud.

Counterpart of `fusion3dseg_tpu/ops/components.py`: points of one class
join when they are neighbours (a stored adjacency, as CSR or a padded
table, or every pair within `radius`); components smaller than
`minimum_points` are pooled into one "small disjoint" instance of category
`nclasses`, and each non-instance class gets one id.

Two ways to label the components, with the same result (root = the
minimum member index): the native union-find on the host (`io/native.py`)
and, for `backend="device"`, `propagate_labels` on the device: min-label
relaxation over same-class edges with two pointer jumps a sweep, one host
read of "changed" a sweep. `floodfill_level` grows seeds a fixed number of
hops on the device. The bookkeeping (ids, info, boundaries, merges) is
host NumPy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import native
from fusion3dseg_tpu_torch.ops import neighbors
from fusion3dseg_tpu_torch.utils import palette as pal


def _to(x, dev, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=dev).to(dtype)


def propagate_labels(adj, classes, valid=None, max_iters: int = 512, device="cuda",
                     return_sweeps: bool = False):
    """Min-label propagation restricted to same-class edges.

    `adj` [N, K] int32 neighbour indices, -1 padded; `classes` [N] int;
    `valid` [N] bool (invalid points stay singletons). Tensors run on their
    own device, NumPy arrays on `device`. Each sweep takes the minimum label
    over a point's same-class neighbours and then jumps twice (label of the
    label); it stops when a sweep changes nothing or after `max_iters`.

    Returns labels [N] int32 (the minimum point index of each component),
    and the number of sweeps with `return_sweeps`."""
    dev = adj.device if isinstance(adj, torch.Tensor) else cuda.resolve_device(device)
    adj = _to(adj, dev, torch.int64)
    classes = _to(classes, dev, torch.int32)
    n = adj.shape[0]
    labels = torch.arange(n, dtype=torch.int64, device=dev)
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else _to(valid, dev, torch.bool))
    sweeps = 0
    if adj.shape[1] and n:
        adj_safe = adj.clamp_min(0)
        same = (adj >= 0) & valid[:, None] & (classes[adj_safe] == classes[:, None]) \
            & valid[adj_safe]
        changed = True
        while changed and sweeps < max_iters:
            neigh = torch.where(same, labels[adj_safe], n).amin(dim=-1)
            new = torch.minimum(labels, neigh)
            new = new[new]
            new = new[new]
            changed = bool((new != labels).any())
            labels = new
            sweeps += 1
    elif max_iters > 0:
        sweeps = 1  # one sweep that changes nothing, as the reference's loop
    labels = labels.to(torch.int32)
    return (labels, sweeps) if return_sweeps else labels


def symmetrize_adjacency(adj):
    """The symmetric closure of a fixed-degree [N, K] adjacency: [N, K']
    int32 (-1 padded), rows sorted by neighbour index, duplicate edges
    collapsed, K' the largest resulting degree: one sort of the 2NK edge
    keys, on a tensor's own device (a NumPy array in, NumPy out, on the
    CPU)."""
    if not isinstance(adj, torch.Tensor):
        return symmetrize_adjacency(torch.as_tensor(np.asarray(adj))).numpy()
    n, k = adj.shape if adj.ndim == 2 else (len(adj), 0)
    if n == 0 or k == 0:
        return torch.zeros((n, 0), dtype=torch.int32, device=adj.device)
    src = torch.arange(n, device=adj.device).repeat_interleave(k)
    dst = adj.long().reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    key = torch.unique(torch.cat([src * n + dst, dst * n + src]))  # sorted
    a, b = key // n, key % n
    counts = torch.bincount(a, minlength=n)
    out = torch.full((n, int(counts.max())), -1, dtype=torch.int32, device=adj.device)
    row_start = torch.cumsum(counts, 0) - counts
    out[a, torch.arange(len(a), device=adj.device) - row_start[a]] = b.to(torch.int32)
    return out


def _class_sets(classes, nclasses, instance_classes):
    allclasses = np.unique(classes)
    if instance_classes is None:
        instance = allclasses[allclasses != nclasses]
        semantic = [nclasses] if (allclasses == nclasses).any() else []
    else:
        instance = np.asarray(list(instance_classes))
        semantic = np.setdiff1d(allclasses, instance).tolist()
    return instance, semantic


def split_into_instances(
    classes: np.ndarray,
    adj,
    nclasses: int = 133,
    instance_classes: Optional[Sequence[int]] = None,
    minimum_points: int = 1,
    max_iters: int = 512,
    backend: str = "auto",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, List[Dict], np.ndarray]:
    """Instances as connected components over a stored adjacency: an
    [N, K] table (-1 padded, a tensor or an array) or a CSR pair (offsets
    [N+1], flat), e.g. `ops.neighbors.lists_to_csr` of `adj.pkl`. Every
    stored edge counts in both directions.

    `backend` "auto" and "native" run the native union-find on the host;
    "device" moves the adjacency to `device` (a CSR pair is densified
    first), symmetrizes it there and runs `propagate_labels` (at most
    `max_iters` sweeps). Both give the same components.

    Same returns as `split_into_instances_by_radius`.
    """
    if backend not in ("auto", "native", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    classes = np.asarray(classes)
    instance, semantic = _class_sets(classes, nclasses, instance_classes)
    is_csr = isinstance(adj, tuple) and len(adj) == 2
    if backend == "device":
        dense = neighbors.csr_to_adjacency(*adj) if is_csr else adj
        dense = torch.as_tensor(dense, device=cuda.resolve_device(device))
        labels = propagate_labels(symmetrize_adjacency(dense), classes.astype(np.int32),
                                  max_iters=max_iters).cpu().numpy()
    elif is_csr:
        labels = native.components_from_csr(adj[0], adj[1], classes.astype(np.int32))
    else:
        labels = native.components_from_adjacency(_host(adj), classes.astype(np.int32))
    return _assemble_instances(classes, labels, nclasses, instance, semantic, minimum_points)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def split_into_instances_by_radius(
    classes: np.ndarray,
    points: np.ndarray,
    radius: float,
    nclasses: int = 133,
    instance_classes: Optional[Sequence[int]] = None,
    minimum_points: int = 1,
) -> Tuple[np.ndarray, np.ndarray, List[Dict], np.ndarray]:
    """Instances as connected components of the full radius relation within
    each class.

    Returns (unique ids, ids [N] int32, info dicts with id / isthing /
    category_id / area, classes with pooled small components set to
    nclasses). Without `instance_classes` every class but `nclasses` is an
    instance class and `nclasses` the one semantic class.
    """
    classes = np.asarray(classes)
    instance, semantic = _class_sets(classes, nclasses, instance_classes)
    labels = native.connected_components(np.asarray(points, np.float32), float(radius),
                                         labels=classes.astype(np.int32))
    return _assemble_instances(classes, labels, nclasses, instance, semantic, minimum_points)


def _assemble_instances(classes, labels, nclasses, instance_classes, semantic_classes,
                        minimum_points):
    """Component roots (already restricted to same-class unions) -> instance
    ids, info dicts and updated classes. Instances are numbered by their
    representative (minimum point index)."""
    n = len(classes)
    out_classes = classes.copy()
    ids = np.zeros(n, np.int32)
    info: List[Dict] = []
    small_disjoint_id = None
    ninstances = 0

    for cls_ in semantic_classes:  # one id each
        mask = classes == cls_
        ids[mask] = ninstances
        if cls_ == nclasses:
            small_disjoint_id = ninstances
        info.append({"id": ninstances, "isthing": False, "category_id": int(cls_),
                     "area": int(mask.sum())})
        ninstances += 1

    inst_set = set(int(c) for c in np.asarray(instance_classes).ravel())
    inst_mask = np.isin(classes, list(inst_set)) if inst_set else np.zeros(n, bool)
    comp_labels = labels[inst_mask]
    comp_points = np.nonzero(inst_mask)[0]
    if len(comp_points):
        uniq, inverse, counts = np.unique(comp_labels, return_inverse=True, return_counts=True)
        order = np.argsort(inverse, kind="stable")
        groups = np.split(comp_points[order], np.cumsum(counts)[:-1])
        for rep, area, members in zip(uniq, counts, groups):
            if area < minimum_points:
                if small_disjoint_id is None:
                    small_disjoint_id = ninstances
                    info.append({"id": ninstances, "isthing": True,
                                 "category_id": int(nclasses), "area": 0})
                    ninstances += 1
                info[small_disjoint_id]["area"] += int(area)
                ids[members] = small_disjoint_id
                out_classes[members] = nclasses
            else:
                info.append({"id": ninstances, "isthing": True,
                             "category_id": int(classes[rep]), "area": int(area)})
                ids[members] = ninstances
                ninstances += 1

    return np.unique(ids), ids, info, out_classes


def floodfill_level(adj, seeds, max_level: int, classes=None, device="cuda") -> np.ndarray:
    """Hop-bounded flood fill: `max_level` rounds, each adding every point
    with a member neighbour; with `classes`, only points of a class some
    seed carries may join. `adj` [N, K] -1 padded; tensors run on their own
    device, arrays on `device`. Returns [N] bool."""
    dev = adj.device if isinstance(adj, torch.Tensor) else cuda.resolve_device(device)
    adj = _to(adj, dev, torch.int64)
    member = _to(seeds, dev, torch.bool)
    adj_ok = adj >= 0
    adj_safe = adj.clamp_min(0)
    if classes is not None:
        classes = _to(classes, dev, torch.int64)
        bound = int(classes.max()) + 1  # the one host read
        seed_hist = torch.zeros(bound, dtype=torch.int32, device=dev).scatter_reduce(
            0, classes, member.to(torch.int32), "amax")
        allowed = seed_hist[classes] > 0
    else:
        allowed = torch.ones_like(member)
    for _ in range(max_level):
        frontier = (member[adj_safe] & adj_ok).any(dim=-1)
        member = member | (frontier & allowed)
    return member.cpu().numpy()


def cluster_boundaries(ids: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """[N] bool: points with a neighbour of another instance id."""
    ids = np.asarray(ids)
    adj = _host(adj)
    ok = adj >= 0
    neigh = ids[np.where(ok, adj, 0)]
    return np.any(ok & (neigh != ids[:, None]), axis=-1)


def merge_instances_by_classes(ids: np.ndarray, info: List[Dict],
                               classes_to_merge: Sequence[int]) -> Tuple[np.ndarray, List[Dict]]:
    """Collapse the instances of each listed class into its lowest id; areas
    add up, the absorbed info entries go. `info`'s target entries are
    updated in place, as the reference does."""
    ids = np.asarray(ids).copy()
    by_class: Dict[int, List[Dict]] = {}
    for entry in info:
        by_class.setdefault(int(entry["category_id"]), []).append(entry)
    absorbed = set()
    for cls_ in classes_to_merge:
        group = sorted(by_class.get(int(cls_), []), key=lambda e: e["id"])
        if len(group) < 2:
            continue
        target = group[0]
        for entry in group[1:]:
            ids[ids == entry["id"]] = target["id"]
            target["area"] = int(target["area"]) + int(entry["area"])
            absorbed.add(entry["id"])
    return ids, [e for e in info if e["id"] not in absorbed]


def instance_separate(classes: np.ndarray, adj, nclasses: int = 133,
                      instance_classes: Optional[Sequence[int]] = None,
                      minimum_points: int = 1):
    """`split_into_instances` (native) plus each instance's point indices
    and the boundary mask. Returns (unique ids, ids, info, classes,
    {id: point indices}, boundary [N])."""
    uids, ids, info, out_classes = split_into_instances(
        classes, adj, nclasses, instance_classes, minimum_points)
    order = np.argsort(ids, kind="stable")
    uniq, counts = np.unique(ids, return_counts=True)
    groups = np.split(order, np.cumsum(counts)[:-1])
    clusters = {int(u): g for u, g in zip(uniq, groups)}
    return uids, ids, info, out_classes, clusters, cluster_boundaries(ids, adj)


def color_segment(ids: np.ndarray, num_instances: Optional[int] = None,
                  seed: int = 0) -> np.ndarray:
    """[N, 3] float colours in [0, 1], one seeded random colour an instance."""
    ids = np.asarray(ids)
    k = int(num_instances if num_instances is not None else ids.max() + 1)
    palette = pal.random_palette(max(k, 1), seed=seed)
    return palette[np.clip(ids, 0, k - 1)]
