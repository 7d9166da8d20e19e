"""2D connected components on the image grid (batched, on any device).

Counterpart of `fusion3dseg_tpu/ops/components2d.py`. The segmenter is
semantic-only, so panoptic segments are derived from the semantic mask:
connected components of equal-class pixels (4-connectivity) for the "thing"
classes, one segment per present "stuff" class.

Labelling is hook + pointer-jump propagation: every pixel starts as its own
root (flat index); each iteration takes the min label over the 4 equal-class
neighbours, then two pointer jumps `lbl = lbl[lbl]`, until nothing changes.
At the fixpoint every component carries its min flat index, so any correct
algorithm gives the same labels as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_SHIFTS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def label_components_2d_batch(classes: torch.Tensor, guide: torch.Tensor | None = None,
                              guide_jump: float = 0.0) -> torch.Tensor:
    """Connected components of [B, H, W] integer class images.

    Pixels join a component only across equal-class 4-neighbour edges. With
    `guide` ([B, H, W] or [B, H, W, C] float: depth, colour, ...), an edge
    additionally requires max_c |guide[p] - guide[q]| <= guide_jump, so two
    touching same-class objects separated by a depth step or a colour
    boundary stay apart.

    Returns [B, H, W] int32 labels: the min flat pixel index of each
    component within its image.
    """
    B, H, W = classes.shape
    P = H * W
    classes = classes.to(torch.int64)
    cpad = F.pad(classes, (1, 1, 1, 1), value=-1)  # never equal to a class
    edges = []
    if guide is not None:
        g = guide.float()
        if g.dim() == 3:
            g = g[..., None]
        gpad = F.pad(g, (0, 0, 1, 1, 1, 1))
    for dy, dx in _SHIFTS:
        edge = cpad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W] == classes
        if guide is not None:
            ng = gpad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            edge &= (ng - g).abs().amax(dim=-1) <= guide_jump
        edges.append(edge)

    lbl = torch.arange(P, device=classes.device).reshape(1, H, W).expand(B, H, W)
    while True:
        lpad = F.pad(lbl, (1, 1, 1, 1), value=P)
        best = lbl
        for (dy, dx), edge in zip(_SHIFTS, edges):
            nlbl = lpad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            best = torch.minimum(best, torch.where(edge, nlbl, P))
        # pointer jumping: a pixel's label is a pixel of its own component,
        # so chasing it twice contracts chains geometrically
        flat = best.reshape(B, P)
        flat = flat.gather(1, flat)
        flat = flat.gather(1, flat)
        new = flat.reshape(B, H, W)
        if torch.equal(new, lbl):
            return new.to(torch.int32)
        lbl = new


def label_components_2d(classes: torch.Tensor, guide: torch.Tensor | None = None,
                        guide_jump: float = 0.0) -> torch.Tensor:
    """`label_components_2d_batch` for one [H, W] image."""
    return label_components_2d_batch(
        classes[None], None if guide is None else guide[None], guide_jump)[0]


def panoptic_from_semantic(sem: np.ndarray, n_thing: int = 80, unclassified: int = 133,
                           components: np.ndarray | None = None, min_area: int = 0):
    """Assemble OneFormer-style panoptic outputs from a semantic mask.

    Returns `(idimage, info)`: idimage is [H, W] int32 segment ids (0 =
    void/unclassified) and info is `[{'id', 'isthing', 'category_id',
    'area'}, ...]`. Thing classes (ids < `n_thing`) split into per-component
    segments; stuff classes get one segment each.

    Args:
      sem: [H, W] integer class-id image (may include `unclassified`).
      components: optional precomputed label_components_2d(sem) as numpy;
        computed here on the CPU when None.
      min_area: thing components smaller than this fold into void.
    """
    sem = np.asarray(sem)
    if components is None:
        components = label_components_2d(torch.from_numpy(sem.astype(np.int64))).numpy()
    else:
        components = np.asarray(components)

    idimage = np.zeros(sem.shape, np.int32)
    info = []
    next_id = 1

    thing = (sem < n_thing) & (sem != unclassified)
    if thing.any():
        roots, inverse, counts = np.unique(
            components[thing], return_inverse=True, return_counts=True)
        seg_id = np.zeros(len(roots), np.int32)  # 0 = folded into void
        for k, (root, area) in enumerate(zip(roots.tolist(), counts.tolist())):
            if area < min_area:
                continue
            seg_id[k] = next_id
            info.append({"id": next_id, "isthing": True,
                         "category_id": int(sem.flat[root]), "area": int(area)})
            next_id += 1
        idimage[thing] = seg_id[inverse]

    stuff = (~thing) & (sem != unclassified)
    if stuff.any():
        cids, inverse, counts = np.unique(sem[stuff], return_inverse=True, return_counts=True)
        seg_id = np.zeros(len(cids), np.int32)
        for k, (cid, area) in enumerate(zip(cids.tolist(), counts.tolist())):
            seg_id[k] = next_id
            info.append({"id": next_id, "isthing": False,
                         "category_id": int(cid), "area": int(area)})
            next_id += 1
        idimage[stuff] = seg_id[inverse]

    return idimage, info


def instances_from_panoptic(idimage: np.ndarray, info, conf: np.ndarray | None = None):
    """Instance outputs from a panoptic split, mirroring detectron2's
    Instances fields: `pred_classes` [K], `pred_masks` [K, H, W] bool,
    `scores` [K]; things only, score = mean per-pixel confidence over the
    mask (1.0 when no confidence map is given)."""
    idimage = np.asarray(idimage)
    things = [s for s in info if s["isthing"]]
    K = len(things)
    h, w = idimage.shape
    masks = np.zeros((K, h, w), bool)
    classes = np.zeros(K, np.int64)
    scores = np.ones(K, np.float32)
    for k, s in enumerate(things):
        m = idimage == s["id"]
        masks[k] = m
        classes[k] = s["category_id"]
        if conf is not None and m.any():
            scores[k] = float(np.asarray(conf)[m].mean())
    return {"pred_classes": classes, "pred_masks": masks, "scores": scores}
