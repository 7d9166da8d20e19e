"""Class-constrained instance split of a labelled cloud (host NumPy).

Counterpart of `symmetrize_adjacency`, `split_into_instances`,
`split_into_instances_by_radius` and `_assemble_instances` of
`fusion3dseg_tpu/ops/components.py`: points of one class join when they
are neighbours (a stored adjacency, as CSR or a padded table, or every
pair within `radius`), through the native union-find (`io/native.py`);
components smaller than `minimum_points` are pooled into one "small
disjoint" instance of category `nclasses`, and each non-instance class
gets one id. The device label propagation of the reference
(`backend="device"`) waits for the post-processing slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import native


def symmetrize_adjacency(adj: np.ndarray) -> np.ndarray:
    """The symmetric closure of a fixed-degree [N, K] adjacency: [N, K']
    int32 (-1 padded), rows sorted by neighbour index, duplicate edges
    collapsed, K' the largest resulting degree."""
    adj = np.asarray(adj)
    n, k = adj.shape if adj.ndim == 2 else (len(adj), 0)
    if n == 0 or k == 0:
        return np.zeros((n, 0), np.int32)
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = adj.astype(np.int64).ravel()
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    key = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    a = (key // n).astype(np.int32)
    b = (key % n).astype(np.int32)
    counts = np.bincount(a, minlength=n)
    k2 = int(counts.max()) if len(counts) else 0
    out = np.full((n, k2), -1, np.int32)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out[a, np.arange(len(a)) - row_start[a]] = b
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
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, List[Dict], np.ndarray]:
    """Instances as connected components over a stored adjacency: an
    [N, K] table (-1 padded) or a CSR pair (offsets [N+1], flat), e.g.
    `ops.neighbors.lists_to_csr` of `adj.pkl`. Every stored edge counts in
    both directions (union-find is undirected). `backend` "auto" and
    "native" run the native union-find; "device" waits for ROADMAP item 14.

    Same returns as `split_into_instances_by_radius`.
    """
    if backend == "device":
        raise NotImplementedError(
            "the device label propagation is not ported yet (ROADMAP item 14, "
            "post-processing and graph ops); use backend='native'")
    if backend not in ("auto", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    classes = np.asarray(classes)
    instance, semantic = _class_sets(classes, nclasses, instance_classes)
    if isinstance(adj, tuple) and len(adj) == 2:
        labels = native.components_from_csr(adj[0], adj[1], classes.astype(np.int32))
    else:
        labels = native.components_from_adjacency(np.asarray(adj), classes.astype(np.int32))
    return _assemble_instances(classes, labels, nclasses, instance, semantic, minimum_points)


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
