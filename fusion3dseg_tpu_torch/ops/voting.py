"""Multi-view label voting as scatter reductions.

Counterpart of `fusion3dseg_tpu/ops/voting.py`. One frame votes
`votes[uv2pt[valid], mask[valid]] += 1` with both duplicate semantics:

* dedup=True: a (point, class) pair counts once per frame (what a NumPy
  fancy-index add does), by counting the distinct keys of the frame.
* dedup=False: every pixel counts (np.add.at semantics), one scatter-add.

`classify` is the thresholded argmax: class = argmax votes, confidence =
max / total against `threshold`, unvoted or unconfident points -> class
`nclasses` ("unclassified"), with an optional `filter_classes` restriction.
Vote counts and classes are integers and match the JAX package exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.utils import timing


def _keys(uv2pt, mask, npts, nc1):
    """Flat (point, class) keys; unmapped pixels get the trash key npts*nc1."""
    uv = uv2pt.to(torch.int64)
    cls = mask.to(torch.int64).clamp(0, nc1 - 1)
    return torch.where(uv >= 0, uv * nc1 + cls, npts * nc1)


def vote_frame(votes: torch.Tensor, uv2pt: torch.Tensor, mask: torch.Tensor,
               dedup: bool = True) -> torch.Tensor:
    """Accumulate one frame's mask votes into the running votes table, in
    place (the table is also returned).

    Args:
      votes: [npts, nclasses+1] int32 running votes (contiguous).
      uv2pt: [H*W] int pixel->point lookup (-1 = unmapped).
      mask: [H*W] integer class-id image, already at depth resolution.
      dedup: collapse duplicate (point, class) pairs within this frame.
    """
    npts, nc1 = votes.shape
    key = _keys(uv2pt, mask, npts, nc1)
    flat = votes.view(-1)
    with timing.wait("vote_keys"):  # the host reads each output's size
        if dedup:
            key = torch.unique(key)
        key = key[key < npts * nc1]
    if dedup:
        flat[key] += 1  # distinct keys: a plain indexed add is exact
    else:
        flat.index_add_(0, key, torch.ones_like(key, dtype=votes.dtype))
    return votes


def vote_all_frames(uv2pt, masks, npts: int, nclasses: int, dedup: bool = True,
                    device="cuda") -> torch.Tensor:
    """Vote a whole session.

    Args:
      uv2pt: [F, H*W] int per-frame pixel->point lookups (tensor or array).
      masks: [F, H*W] class-id images (depth resolution, flattened).
      npts: number of points.
      nclasses: number of classes excluding "unclassified".

    Returns:
      votes [npts, nclasses+1] int32 on `device`.
    """
    dev = cuda.resolve_device(device)
    uv2pt = torch.as_tensor(uv2pt, device=dev)
    masks = torch.as_tensor(masks, device=dev)
    nc1 = nclasses + 1
    trash = npts * nc1
    key = _keys(uv2pt, masks, npts, nc1)
    with timing.wait("vote_keys"):  # the host reads each output's size
        if dedup:
            # distinct (frame, point, class) triples: one sort for the session
            frame = torch.arange(len(key), device=dev)[:, None]
            key = torch.unique(frame * (trash + 1) + key) % (trash + 1)
        key = key[key < trash]
    votes = torch.zeros(trash, dtype=torch.int32, device=dev)
    votes.index_add_(0, key.reshape(-1), torch.ones(key.numel(), dtype=torch.int32, device=dev))
    return votes.view(npts, nc1)


def classify(votes: torch.Tensor, threshold: float, nclasses: int,
             filter_classes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Thresholded argmax classification of per-point votes.

      * total = sum over ALL classes (before filtering);
      * argmax over the `filter_classes` columns only, if given (ties go to
        the first column);
      * class = nclasses when total == 0, max == 0, or max/total < threshold
        (a float32 division);
      * filtered argmax indices are mapped back to original class ids.

    Returns classes [npts] int32.
    """
    votes = votes.float()
    total = votes.sum(dim=-1)
    if filter_classes is not None:
        with timing.wait("filter_upload"):
            fc = torch.as_tensor(list(filter_classes), dtype=torch.int64, device=votes.device)
        vmax, arg = votes[:, fc].max(dim=-1)
        cls = fc[arg]
    else:
        vmax, cls = votes.max(dim=-1)
    confident = (total > 0) & (vmax > 0) & (vmax / total.clamp(min=1.0) >= threshold)
    return torch.where(confident, cls, nclasses).to(torch.int32)


def vote_and_classify(uv2pt, masks, npts: int, nclasses: int, threshold: float = 0.5,
                      filter_classes: Optional[Tuple[int, ...]] = None,
                      dedup: bool = True, device="cuda"):
    """Vote + classify for a whole session: (votes, classes) on `device`."""
    with timing.range("vote"):
        votes = vote_all_frames(uv2pt, masks, npts, nclasses, dedup, device)
        return votes, classify(votes, threshold, nclasses, filter_classes)
