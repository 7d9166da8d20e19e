"""The collectives of the multi-device decompositions, over one process group.

The JAX package's `shard_map` bodies use `psum`, `pmin`, `pmax`,
`all_gather(tiled=True)` and `axis_index`; these are their counterparts on
a `torch.distributed` group: `all_reduce` with SUM, MIN and MAX, a tiled
`all_gather` along axis 0, and the rank in the group. The decompositions
use no other collective, and every call goes through this module, which
counts them (`STATS`). A group of one rank runs its collectives too, so
that a one-rank NCCL group goes through the library's real calls.

Gloo moves a CUDA tensor's collective through host memory (it copies the
tensor to the host, reduces there and copies back); it takes every
collective used here for CUDA tensors (torch 2.11, CUDA 12.8: probed by
`chip_smoke.py`'s phase 14). `STATS["host_bytes"]` counts the bytes a gloo
group moves through the host for CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

STATS = {"calls": 0, "host_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def rank(group) -> int:
    """This process's index in `group` (JAX's `axis_index`)."""
    return dist.get_rank(group)


def size(group) -> int:
    return dist.get_world_size(group)


def _count(t: torch.Tensor, group, nbytes: int) -> None:
    STATS["calls"] += 1
    if t.is_cuda and dist.get_backend(group) == "gloo":
        STATS["host_bytes"] += 2 * nbytes  # down and back up


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    out = t.contiguous().clone()
    _count(out, group, out.numel() * out.element_size())
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over the group, returned whole on every rank."""
    return _all_reduce(t, dist.ReduceOp.SUM, group)


def pmin(t: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(t, dist.ReduceOp.MIN, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(t, dist.ReduceOp.MAX, group)


def all_gather(t: torch.Tensor, group, out: torch.Tensor | None = None) -> torch.Tensor:
    """Every rank's `t` concatenated along axis 0 in rank order (JAX's
    `all_gather(..., tiled=True)`), into `out` when given (its shape must
    be [size * t.shape[0], ...] and its rows contiguous)."""
    n = size(group)
    t = t.contiguous()
    if out is None:
        out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    _count(t, group, n * t.numel() * t.element_size())
    dist.all_gather(list(out.chunk(n)), t, group=group)
    return out
