"""Sharded multi-view voting over a device mesh: frame- and point-parallel.

Counterpart of `fusion3dseg_tpu/parallel/voting.py`. Every rank calls a
function with the same global inputs and moves only what it needs to its
device (`sharding.mesh_device`):

  * `vote_sharded_frames`: frames split over the `axis` ranks; each rank
    votes its frame shard into a full [npts, nclasses+1] table, and one
    `psum` gives every rank the whole table.
  * `vote_sharded_points`: point ids split over the ranks (for tables
    beyond one card); each rank keeps the global ids of its range
    [rank*npts/D, (rank+1)*npts/D), remapped to local ids, and votes and
    classifies them with no collective. Votes and classes come back as the
    rank's own shard, as `shard_map` gives each device its block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fusion3dseg_tpu_torch.ops import voting as voting_ops
from fusion3dseg_tpu_torch.parallel import comm
from fusion3dseg_tpu_torch.parallel.sharding import mesh_device, rows_of


def vote_sharded_frames(mesh, uv2pt, masks, npts: int, nclasses: int,
                        axis: str = "dp") -> torch.Tensor:
    """Frame-parallel voting (dedup on) with one psum. uv2pt, masks [F, HW]
    with F divisible by the axis size. Returns the replicated votes
    [npts, nclasses+1] int32 on this rank's device."""
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    F = len(uv2pt)
    assert F % ndev == 0, f"frames {F} % {ndev} devices != 0"
    fd = F // ndev
    dev = mesh_device(mesh)
    votes = voting_ops.vote_all_frames(rows_of(uv2pt, slice(r * fd, (r + 1) * fd), dev),
                                       rows_of(masks, slice(r * fd, (r + 1) * fd), dev),
                                       npts, nclasses, dedup=True, device=dev)
    return comm.psum(votes, group)


def vote_sharded_points(mesh, uv2pt, masks, npts: int, nclasses: int,
                        threshold: float = 0.5,
                        filter_classes: Optional[Tuple[int, ...]] = None,
                        axis: str = "dp") -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-parallel vote + classify (npts divisible by the axis size).
    Returns this rank's shards: (votes [npts/D, nclasses+1] int32, classes
    [npts/D] int32) of the point ids [rank*npts/D, (rank+1)*npts/D)."""
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    assert npts % ndev == 0, f"npts {npts} not divisible by {ndev} devices"
    local_n = npts // ndev
    dev = mesh_device(mesh)
    uv = rows_of(uv2pt, slice(None), dev)
    lo = r * local_n
    local_uv = torch.where((uv >= lo) & (uv < lo + local_n), uv - lo, -1)
    votes = voting_ops.vote_all_frames(local_uv, rows_of(masks, slice(None), dev), local_n,
                                       nclasses, dedup=True, device=dev)
    return votes, voting_ops.classify(votes, threshold, nclasses, filter_classes)
