"""Class-constrained instance split of a labelled cloud (host NumPy).

Counterpart of `split_into_instances_by_radius` and `_assemble_instances`
of `fusion3dseg_tpu/ops/components.py`: every same-class point pair within
`radius` is joined by one native grid pass (`io/native.py`), components
smaller than `minimum_points` are pooled into one "small disjoint" instance
of category `nclasses`, and each non-instance class gets one id. The
device label propagation of the reference waits for the post-processing
slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import native


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
    allclasses = np.unique(classes)
    if instance_classes is None:
        instance_classes = allclasses[allclasses != nclasses]
        semantic_classes = [nclasses] if (allclasses == nclasses).any() else []
    else:
        instance_classes = np.asarray(list(instance_classes))
        semantic_classes = np.setdiff1d(allclasses, instance_classes).tolist()
    labels = native.connected_components(np.asarray(points, np.float32), float(radius),
                                         labels=classes.astype(np.int32))
    return _assemble_instances(classes, labels, nclasses, instance_classes, semantic_classes,
                               minimum_points)


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
