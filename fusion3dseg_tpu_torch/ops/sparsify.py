"""Deterministic voxel sparsification and weighted voxel merge.

Counterpart of `fusion3dseg_tpu/ops/sparsify.py`. Valid rows are grouped by
world voxel of side `radius` (the grid anchors at the valid-point minimum,
moved by `origin_shift`), each voxel's normal-cone outliers go to a
secondary cell (`cos <= min_cosine` against the voxel's weighted mean
normal), and every cell gets weighted means and summed counters.

One exact path. The reference's `max_cells` / `max_rows` bounds shrink
scatter tables on the TPU and give the same grouping; they are accepted and
ignored here. Sorting is `torch.sort(stable=True)`, so rows of one voxel keep
their input order (XLA's CPU sort orders such ties the same way).

Sums are deterministic: `segment_sum` adds each segment's rows in row
order, the order in which XLA's scatter-add adds them on the CPU, and a
run repeats bit for bit on either device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fusion3dseg_tpu_torch.geometry.camera import _floor_to_int32
from fusion3dseg_tpu_torch.ops.zbuffer import INT32_MAX


class SparsifyResult(NamedTuple):
    """Padded per-cell sparsified frame. Cells with count == 0 are empty."""

    points: torch.Tensor  # [C, 3] cell mean positions
    normals: torch.Tensor  # [C, 3] cell mean unit normals
    colors: torch.Tensor  # [C, 3] cell mean colors
    counts: torch.Tensor  # [C] int32 points merged per cell (= nmerges)
    cell_of_pixel: torch.Tensor  # [H*W] int32 cell per pixel, -1 invalid
    num_cells: int  # C = 2 * H * W


class MergeResult(NamedTuple):
    """Padded weighted voxel merge of an arbitrary point set."""

    points: torch.Tensor  # [C, 3] weighted cell mean positions
    normals: torch.Tensor  # [C, 3] cell mean unit normals
    colors: torch.Tensor  # [C, 3] weighted cell mean colors
    counts: torch.Tensor  # [C] int32 total weight per cell
    occurences: torch.Tensor  # [C] int32 summed occurrence counters
    cell_of_input: torch.Tensor  # [N] int32 cell per input row, -1 invalid
    num_cells: int  # C = 2 * N


def segment_sum(values: torch.Tensor, segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Row sums of `values` [N, ...] per segment id in [0, num_segments],
    each segment summed in row order; id `num_segments` drops the row.

    The same order on either device, by two calls: on the card
    `index_put_(accumulate=True)` sorts the ids stably and adds each
    segment's rows in turn (`index_add_` would use float atomics there, in
    an order that changes from run to run); on the CPU `index_add_` adds
    the rows in turn (`index_put_` splits them over threads there). On the
    card one thread adds all rows of a segment, so dropped rows go to trash
    rows of their own, not to one shared row that would serialize them."""
    n = values.shape[0]
    keep = segments < num_segments
    idx = torch.where(keep, segments.long(), num_segments + torch.arange(n, device=values.device))
    out = values.new_zeros((num_segments + n, *values.shape[1:]))
    if values.is_cuda:
        out.index_put_((idx,), values, accumulate=True)
    else:
        out.index_add_(0, idx, values)
    return out[:num_segments]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def _sort_rows(valid, vox, extent_cells):
    """Sort valid rows by voxel. Returns (sidx [N] row order, newrun [N]
    bool: the sorted row starts a voxel run, valid [N] after dropping rows
    outside a packed key's extent)."""
    n = vox.shape[0]
    bits = 0
    if extent_cells is not None and extent_cells > 0:
        bits = max(1, (int(extent_cells) - 1).bit_length())
        if 3 * bits > 31:
            bits = 0  # too wide for a packed int32 key
    first = torch.ones(1, dtype=torch.bool, device=vox.device)
    if bits:
        # recentre an axis on the integer mean of the valid voxel coords
        # only where it overflows the bound: a whole number of cells, so an
        # in-contract input gets shift 0 and the 3-key grouping
        nvalid = valid.float().sum().clamp(min=1.0)
        vsum = torch.where(valid[:, None], vox, 0).float().sum(dim=0)
        vmean = (vsum / nvalid).clamp(0, float(1 << 30)).to(torch.int32)
        vmax = torch.where(valid[:, None], vox, 0).amax(dim=0)
        shift = torch.where(vmax < (1 << bits), 0, (vmean - (1 << (bits - 1))).clamp(min=0))
        rel = vox - shift[None, :]
        in_extent = ((rel >= 0) & (rel < (1 << bits))).all(dim=1)
        rel = rel.clamp(0, (1 << bits) - 1)
        packed = (rel[:, 0] << (2 * bits)) | (rel[:, 1] << bits) | rel[:, 2]
        valid = valid & in_extent
        packed = torch.where(valid, packed, INT32_MAX)
        sp, sidx = torch.sort(packed, stable=True)
        newrun = torch.cat([first, sp[1:] != sp[:-1]]) & (sp != INT32_MAX)
        return sidx, newrun, valid
    # 3-key lexicographic order by stable sorts, last key first
    keys = [torch.where(valid, vox[:, a], INT32_MAX) for a in range(3)]
    sidx = torch.arange(n, device=vox.device)
    for k in reversed(keys):
        sidx = sidx[torch.sort(k[sidx], stable=True)[1]]
    sk = [k[sidx] for k in keys]
    diff = (sk[0][1:] != sk[0][:-1]) | (sk[1][1:] != sk[1][:-1]) | (sk[2][1:] != sk[2][:-1])
    newrun = torch.cat([first, diff]) & (sk[0] != INT32_MAX)
    return sidx, newrun, valid


def voxel_merge(points, normals, colors, weights, occurences, valid, radius: float,
                min_cosine: float, extent_cells: Optional[int] = None,
                max_cells: Optional[int] = None, max_rows: Optional[int] = None,
                origin_shift=None, const_radius: bool = False) -> MergeResult:
    """Weight-aware voxel merge of an arbitrary point set.

    Args:
      points, normals, colors: [N, 3] float32; weights, occurences: [N] int
        (weights carry merge multiplicity, so re-merging keeps running means
        exact); valid: [N] bool.
      extent_cells: a promised per-axis voxel extent; when 3 * bits of it
        fit 31 bits the three voxel keys pack into one int32 (an axis that
        overflows is recentred; a valid row outside the extent is dropped,
        not clamped). Otherwise the 3-key lexicographic sort.
      max_cells, max_rows: accepted for the reference's signature; the
        grouping they bound is the same, so they are ignored.
      origin_shift: [3] shift of the grid anchor in [0, radius) per axis.
      const_radius: the radius is a compile-time constant of the
        reference's program (its fusion frame step), where XLA divides by
        it as a product with float32(1 / radius); otherwise (its overflow
        repair, its eager calls) a true division.

    Returns a MergeResult with C = 2 * N padded cells: run r of the sorted
    voxels owns cells 2r (primary) and 2r + 1 (normal outliers).
    """
    del max_cells, max_rows  # table-height bounds of the TPU path
    n = points.shape[0]
    C = 2 * n
    pmin = torch.where(valid[:, None], points, 3.0e38).amin(dim=0)
    if origin_shift is not None:
        pmin = pmin - torch.as_tensor(origin_shift, dtype=torch.float32, device=points.device)
    # divide by a tensor on the points' device: CUDA divides by a Python
    # scalar as a product with its reciprocal, which can move a voxel edge.
    # `full` fills it on the device; `torch.tensor` would copy from the
    # host and wait for the device
    if const_radius:
        inv = torch.full((), np.float32(1) / np.float32(radius), dtype=torch.float32,
                         device=points.device)
        vox = _floor_to_int32((points - pmin) * inv).clamp(min=0)
    else:
        rad = torch.full((), radius, dtype=torch.float32, device=points.device)
        vox = _floor_to_int32((points - pmin) / rad).clamp(min=0)
    sidx, newrun, valid = _sort_rows(valid, vox, extent_cells)
    runid_sorted = torch.cumsum(newrun.to(torch.int32), 0, dtype=torch.int32) - 1

    w = weights.float()
    seg_of_row = torch.empty(n, dtype=torch.int32, device=points.device)
    seg_of_row[sidx] = runid_sorted
    ok = valid & (seg_of_row >= 0)
    seg0 = torch.where(ok, seg_of_row, n)
    nmean = _unit(segment_sum(normals * w[:, None], seg0, n))
    # einsum "nc,nc->n" on XLA's CPU: products rounded, then summed in order
    agree = (normals * nmean[seg0.clamp(max=n - 1).long()]).sum(dim=-1)
    secondary = (agree <= min_cosine) & ok
    seg = torch.where(ok, seg_of_row * 2 + secondary.to(torch.int32), C)
    payload = torch.cat([w[:, None], occurences.float()[:, None], points * w[:, None],
                         colors * w[:, None], normals * w[:, None]], dim=1)
    acc = segment_sum(payload, seg, C)

    cnt = acc[:, 0]
    denom = cnt[:, None].clamp(min=1e-12)
    return MergeResult(
        acc[:, 2:5] / denom, _unit(acc[:, 8:11]), acc[:, 5:8] / denom,
        torch.round(cnt).to(torch.int32), acc[:, 1].to(torch.int32),
        torch.where(seg < C, seg, -1).to(torch.int32), C,
    )


def patch_sparsify(points, normals, colors, valid, height: int, width: int, radius: float,
                   min_cosine: float, extent_cells: Optional[int] = None,
                   max_cells: Optional[int] = None,
                   max_rows: Optional[int] = None,
                   const_radius: bool = False) -> SparsifyResult:
    """Sparsify one frame (dense pixel cloud -> per-voxel means).

    points, normals, colors: [H*W, 3] row-major per-pixel data (points in
    world coordinates); valid: [H*W] bool; `const_radius` as in
    `voxel_merge`. Returns a SparsifyResult with C = 2 * H * W padded
    cells."""
    ones = torch.ones(height * width, dtype=torch.int32, device=points.device)
    m = voxel_merge(points, normals, colors, ones, ones, valid, radius, min_cosine,
                    extent_cells=extent_cells, max_cells=max_cells, max_rows=max_rows,
                    const_radius=const_radius)
    return SparsifyResult(m.points, m.normals, m.colors, m.counts, m.cell_of_input,
                          m.num_cells)


def compact_slots(counts: torch.Tensor):
    """(dest [C] int32 rank of each occupied cell among occupied cells, -1
    elsewhere; total: 0-d int32 number of occupied cells)."""
    occupied = counts > 0
    dest = torch.cumsum(occupied.to(torch.int32), 0, dtype=torch.int32) - 1
    return torch.where(occupied, dest, -1), occupied.sum(dtype=torch.int32)
