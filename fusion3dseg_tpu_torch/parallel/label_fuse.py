"""Multi-device session-scale label fusion over a device mesh.

Counterpart of `fusion3dseg_tpu/parallel/label_fuse.py`: three ways to
split `ops/label_fuse.py`'s lifter over the ranks of a mesh axis. Every
rank calls a function with the same global inputs and moves only its shard
to its device; each rank's classification goes through kernel K1's
wrapper (`ops/histogram.histogram_classify`: the CUDA kernel on the card),
on a winner matrix whose rows start on 16-byte boundaries (`row_pitch`),
so that K1 takes its tiled kernel.

  * `label_fuse_sharded`: frames split over the ranks. Each rank z-buffers
    its frames against the whole cloud into [F/D, N] uint8 winner rows;
    one tiled `all_gather` gives every rank [F, N], and each classifies
    its own N/D columns (copied into a pitched buffer: a column slice of
    the gathered matrix would not be aligned). Classes come back as the
    rank's shard.
  * `label_fuse_sharded_points`: points split over the ranks. Per frame
    each rank z-buffers its points into a packed [H*W] buffer; one `pmin`
    gives the global z-buffer, and a second `pmin` over the ranks that hold
    the winning packed value gives a tie to the lowest rank. Classes come
    back as the rank's shard.
  * `plan_cell_shards` (host) + `label_fuse_sharded_cells`: each rank owns
    a contiguous range of KD cells (`ops/label_fuse.build_cell_index`) and
    gathers only its visible cells per frame; the same two `pmin`s, then
    one `pmax` assembles the classes, replicated on every rank.

Ties: where the one-device lifter gives a tie of equal quantized depth to
the lowest global point id, the point-sharded lifter gives it to the
lowest rank-local id (then the lowest rank) and the cell-sharded one to the
lowest gather slot, exactly as the JAX package does. On a room whose walls
tie often this moves classes (`chip_smoke.py` phase 14 measures it).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch.geometry import camera
from fusion3dseg_tpu_torch.ops.histogram import histogram_classify
from fusion3dseg_tpu_torch.ops.label_fuse import _Session, _set_row, _winner_matrix
from fusion3dseg_tpu_torch.ops.zbuffer import INT32_MAX, packed_pmin
from fusion3dseg_tpu_torch.parallel import comm
from fusion3dseg_tpu_torch.parallel.sharding import mesh_device, rows_of

ID_BITS = 20


def label_fuse_sharded(mesh, points, K, quats, trans, masks, hw: Tuple[int, int],
                       nclasses: int = 133, threshold: float = 0.5,
                       axis: str = "dp") -> torch.Tensor:
    """Frame-sharded lifting (F and N divisible by the axis size, N <
    2^20). Returns this rank's classes [N/D] int32, of points [rank*N/D,
    (rank+1)*N/D): the one-device `tpu_label_fuse`'s, exactly."""
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    npts, nframes = len(points), len(quats)
    assert npts % ndev == 0, f"npts {npts} % {ndev} devices != 0"
    assert nframes % ndev == 0, f"frames {nframes} % {ndev} devices != 0"
    assert npts < (1 << ID_BITS)
    dev = mesh_device(mesh)
    fd, nd = nframes // ndev, npts // ndev
    lo = r * fd
    pts = rows_of(points, slice(None), dev, torch.float32)
    ids = torch.arange(npts, dtype=torch.int32, device=dev)
    sess = _Session(K, quats[lo:lo + fd], trans[lo:lo + fd], masks[lo:lo + fd], dev)
    # column npts is the trash slot of pixels without a winner
    C_local = torch.full((fd, npts + 1), 255, dtype=torch.uint8, device=dev)
    for f in range(fd):
        win, has = sess.winners(f, pts, ids, hw, 1, ID_BITS, 11)
        _set_row(C_local, f, win, has, sess.masks[f], npts)
    C = comm.all_gather(C_local, group)  # [F, N + 1]
    mine = _winner_matrix(nd, nframes, dev)[:, :nd]
    mine.copy_(C[:, r * nd:(r + 1) * nd])
    return histogram_classify(mine, nclasses, threshold)[1]


def _owned_winners(pmin_local, r: int, ndev: int, group):
    """The global z-buffer from the ranks' packed buffers, and where this
    rank won it: (pmin [H*W], mine [H*W] bool). A packed value held by
    several ranks goes to the lowest of them."""
    pmin = comm.pmin(pmin_local, group)
    owner = (pmin == pmin_local) & (pmin != INT32_MAX)
    first = comm.pmin(torch.where(owner, r, ndev).to(torch.int32), group)
    return pmin, owner & (first == r)


def label_fuse_sharded_points(mesh, points, K, quats, trans, masks, hw: Tuple[int, int],
                              nclasses: int = 133, threshold: float = 0.5,
                              axis: str = "dp") -> torch.Tensor:
    """Point-sharded lifting (N divisible by the axis size, N/D < 2^20: the
    packed id limit becomes 2^20 a rank). Returns this rank's classes
    [N/D] int32, of points [rank*N/D, (rank+1)*N/D)."""
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    h, w = hw
    npts = len(points)
    assert npts % ndev == 0
    local_n = npts // ndev
    assert local_n < (1 << ID_BITS)
    dev = mesh_device(mesh)
    pts = rows_of(points, slice(r * local_n, (r + 1) * local_n), dev, torch.float32)
    ids = torch.arange(local_n, dtype=torch.int32, device=dev)
    ones = torch.ones(local_n, dtype=torch.bool, device=dev)
    sess = _Session(K, quats, trans, masks, dev)
    C = _winner_matrix(local_n, sess.nframes, dev)
    for f in range(sess.nframes):
        u, v, z = camera.project_with_matrices(pts, sess.M[f], sess.R[f], sess.trans[f])
        pmin, mine = _owned_winners(packed_pmin(u, v, z, ids, ones, h, w, id_bits=ID_BITS),
                                    r, ndev, group)
        _set_row(C, f, pmin & ((1 << ID_BITS) - 1), mine, sess.masks[f], local_n)
    return histogram_classify(C[:, :local_n], nclasses, threshold)[1]


def plan_cell_shards(cells_table, cell_lists, counts, ndev: int):
    """Host plan for `label_fuse_sharded_cells` (the JAX package's, in
    NumPy). Cells go to ranks in contiguous KD-order ranges; per frame each
    rank keeps its owned visible cells, padded to one Kmax with local cell
    0 (a duplicate candidate is a no-op of the min z-buffer).

    Returns (dev_lists [ndev, F, Kmax] int32 rank-local cell ids, valid
    [ndev, NCd*cs] bool: the first occurrence of each point in its cell;
    padding slots repeat the cell's first member)."""
    NC, cs, _ = cells_table.shape
    assert NC % ndev == 0, f"ncells {NC} % {ndev} devices != 0"
    NCd = NC // ndev
    F = cell_lists.shape[0]
    owner = cell_lists // NCd
    Kmax = 1
    per_dev = []
    for d in range(ndev):
        rows = []
        for f in range(F):
            vis = cell_lists[f, : counts[f]]
            loc = vis[owner[f, : counts[f]] == d] - d * NCd
            rows.append(loc)
            Kmax = max(Kmax, len(loc))
        per_dev.append(rows)
    dev_lists = np.zeros((ndev, F, Kmax), np.int32)
    for d in range(ndev):
        for f in range(F):
            dev_lists[d, f, : len(per_dev[d][f])] = per_dev[d][f]
    ids = np.ascontiguousarray(np.asarray(cells_table)[..., 3], dtype=np.float32).view(np.int32)
    valid = np.ones((NC, cs), bool)
    valid[:, 1:] = ids[:, 1:] != ids[:, :1]
    return dev_lists, valid.reshape(ndev, NCd * cs)


def label_fuse_sharded_cells(mesh, cells_table, dev_lists, valid_slots, K, quats, trans, masks,
                             hw: Tuple[int, int], npts: int, nclasses: int = 133,
                             threshold: float = 0.5, axis: str = "dp") -> torch.Tensor:
    """Cell-sharded lifting: rank r owns cells [r*NCd, (r+1)*NCd) of
    `cells_table` ([NC, cs, 4], NC divisible by the axis size) and the
    plan's `dev_lists[r]`, `valid_slots[r]`. Per frame it z-buffers its
    owned visible cells keyed by gather slot; the winning slot maps to a
    stable local row (owned cell * cs + offset) of its [F, NCd*cs] winner
    matrix. Returns classes [npts] int32, replicated."""
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    h, w = hw
    NC, cs, _ = cells_table.shape
    NCd = NC // ndev
    Kmax = dev_lists.shape[2]
    lb = max(1, int(Kmax * cs - 1).bit_length())
    # more id bits would shrink the packed depth below the z-buffer spec
    assert lb <= 20, (f"per-frame candidate volume {Kmax * cs} needs {lb} id bits; > 20 "
                      "would degrade z-buffer depth resolution below the spec")
    local_rows = NCd * cs
    dev = mesh_device(mesh)
    cells = rows_of(cells_table, slice(r * NCd, (r + 1) * NCd), dev, torch.float32)
    xyz = cells[..., :3].contiguous()
    gids = cells[..., 3].contiguous().view(torch.int32).reshape(-1)
    lists = rows_of(dev_lists, r, dev, torch.int64)
    valid = rows_of(valid_slots, r, dev, torch.bool)
    sess = _Session(K, quats, trans, masks, dev)
    slot = torch.arange(Kmax * cs, dtype=torch.int32, device=dev)
    ones = torch.ones(Kmax * cs, dtype=torch.bool, device=dev)
    C = _winner_matrix(local_rows, sess.nframes, dev)
    for f in range(sess.nframes):
        cl = lists[f]
        u, v, z = camera.project_with_matrices(xyz[cl].reshape(-1, 3), sess.M[f], sess.R[f],
                                               sess.trans[f])
        pmin, mine = _owned_winners(packed_pmin(u, v, z, slot, ones, h, w, id_bits=lb,
                                                drop_invalid=True), r, ndev, group)
        win = pmin & ((1 << lb) - 1)
        # an empty pixel's slot bits point past the list; it is not `mine`
        win_row = cl[(win // cs).clamp(max=Kmax - 1).long()] * cs + win % cs
        _set_row(C, f, win_row, mine, sess.masks[f], local_rows)
    classes = histogram_classify(C[:, :local_rows], nclasses, threshold)[1]
    # non-owned points stay -1; one pmax assembles the replicated classes
    out = torch.full((npts + 1,), -1, dtype=torch.int32, device=dev)
    out[torch.where(valid, gids.long(), npts)] = classes
    return comm.pmax(out[:npts], group)
