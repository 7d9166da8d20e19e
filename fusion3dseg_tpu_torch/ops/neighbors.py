"""Fixed-radius neighbour graph on the device, and the host adjacency layouts.

Counterpart of `fusion3dseg_tpu/ops/neighbors.py`.

`radius_graph` quantizes points to grid cells of side `radius`, sorts them
stably by linear cell key, and lets every point look at up to
`cap_per_cell` candidates in each of its 27 neighbouring cells (in sorted
order, so the lower point index first within a cell). The k nearest
in-radius candidates become a fixed-degree [N, k] adjacency (-1 padded),
the graph `ops/components.propagate_labels` takes. The cell lookup is a
dense start/count table indexed by the cell key when the scene's cells fit
below 2^24, else a binary search of the sorted keys (`ncap=None`).

Its ids equal the JAX package's on every row: the squared distance is the
float32 FMA chain XLA compiles `sum((c - q)**2)` into,
fma(dz, dz, fma(dy, dy, dx * dx)); the k nearest come from a stable sort
of the distances over the flattened [27 * cap] candidates (`lax.top_k`
puts the lower position first on ties); the cell index divides by the
radius as a device tensor (a true division, not a product with its
reciprocal). Rows are independent, so the result does not depend on
`chunk`; on the card the rows go in larger chunks to cut launches.

The native C++ graph (`io/native.radius_graph`) differs from this one: it has
no per-cell cap and orders rows otherwise.

The host helpers convert between the reference's `adj.pkl` artifact (an
object array of per-point neighbour-index arrays), CSR (offsets, flat) for
the native union-find, and the fixed-degree [N, K] table.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.geometry.camera import _floor_to_int32
from fusion3dseg_tpu_torch.geometry.quaternion import fma
from fusion3dseg_tpu_torch.ops.zbuffer import INT32_MAX

BIG = 3.0e38
CUDA_CHUNK = 1 << 16  # query rows a chunk on the card

# the 27-cell neighbourhood, dx-major as the reference's
_OFFSETS = np.asarray(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)], np.int64)


def radius_graph(points, radius, valid=None, k: int = 16, cap_per_cell: int = 8,
                 chunk: int = 4096, device="cuda") -> torch.Tensor:
    """[N, k] int32 neighbour indices sorted by distance, -1 padded; each
    point is its own first neighbour. `points` [N, 3]: a tensor runs on its
    own device, a NumPy array on `device`. `valid` [N] bool: invalid points
    get no neighbours and are no one's neighbour. `radius` is inclusive.

    Raises ValueError at N >= 2^24 and when the scene needs >= 2^31 grid
    cells (the linear key would overflow int32); use the native C++ graph
    there. Scenes under 2^24 cells take the dense cell table."""
    dev = points.device if isinstance(points, torch.Tensor) else cuda.resolve_device(device)
    ncap = lookup_cap(points, radius, valid)
    return _radius_graph_impl(torch.as_tensor(points, device=dev), radius, valid, k=k,
                              cap_per_cell=cap_per_cell, chunk=chunk, ncap=ncap)


def lookup_cap(points, radius, valid=None) -> Optional[int]:
    """The host guard of `radius_graph`: raises where the graph cannot be
    built, and returns the dense table's size (a power of two >= 1024
    holding every cell key) or None for the binary-search lookup. A
    tensor's extent is reduced on its device; 6 floats and a flag come to
    the host."""
    if isinstance(points, torch.Tensor):
        npts_in = points.shape[0]
        fin = torch.isfinite(points).all(dim=-1)
        if valid is not None:
            fin = fin & torch.as_tensor(valid, device=points.device)
        pmin = torch.where(fin[:, None], points, BIG).amin(dim=0)
        pmax = torch.where(fin[:, None], points, -BIG).amax(dim=0)
        ext6 = torch.cat([pmin, pmax, fin.any()[None].to(pmin.dtype)]).cpu().numpy()
        any_fin = bool(ext6[6])
        pts_minmax = (ext6[:3], ext6[3:6])
    else:
        pts_host = np.asarray(points)
        npts_in = len(pts_host)
        fin = np.isfinite(pts_host).all(axis=-1)
        if valid is not None:
            fin &= np.asarray(valid)
        any_fin = bool(fin.any())
        pts_minmax = ((pts_host[fin].min(0), pts_host[fin].max(0)) if any_fin
                      else (np.zeros(3), np.zeros(3)))
    if npts_in >= (1 << 24):
        raise ValueError(
            f"radius_graph supports < 2^24 points (got {npts_in}); "
            "use fusion3dseg_tpu_torch.io.native.radius_graph for larger clouds")
    ncells = 1.0
    if any_fin:
        ext = pts_minmax[1] - pts_minmax[0]
        cells = np.maximum(ext / float(radius) + 2, 1.0)
        ncells = float(np.prod(np.ceil(cells)))
        if ncells >= 2**31:
            raise ValueError(
                f"scene extent {ext} at radius {radius} needs {cells} grid cells: linear "
                "int32 keys would overflow; use fusion3dseg_tpu_torch.io.native.radius_graph")
    if ncells < 2**24:
        return 1 << max(int(np.ceil(np.log2(max(ncells, 2.0)))), 10)
    return None


class Grid(NamedTuple):
    """The sorted cloud and its cell lookup, shared by every query chunk."""

    points: torch.Tensor  # [N, 3] float32
    cells: torch.Tensor  # [N, 3] int64 cell of each point
    valid: torch.Tensor  # [N] bool
    skeys: torch.Tensor  # [N] int64 sorted cell keys
    cand_idx: torch.Tensor  # [N] int64 point id in sorted order, -1 invalid
    spts: torch.Tensor  # [N, 3] points in sorted order
    sc_tab: Optional[torch.Tensor]  # [ncap + 1, 2] (start, count), dense lookup only
    ny: int
    nz: int
    ncap: Optional[int]
    r2: torch.Tensor  # 0-d float32 radius squared


def build_grid(points: torch.Tensor, radius, valid=None, ncap: Optional[int] = None) -> Grid:
    """Sort the cloud by cell key and build the lookup (dense table when
    `ncap` is set, every valid key < ncap; else binary search)."""
    dev = points.device
    n = points.shape[0]
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, device=dev).bool())
    points = points.float()
    r = torch.tensor(float(radius), dtype=torch.float32, device=dev)
    pmin = torch.where(valid[:, None], points, BIG).amin(dim=0)
    cells = _floor_to_int32((points - pmin) / r).long().clamp_min(0)
    cmax = torch.where(valid[:, None], cells, -1).amax(dim=0)
    ny, nz = (int(v) + 2 for v in cmax[1:].tolist())
    keys = (cells[:, 0] * ny + cells[:, 1]) * nz + cells[:, 2]
    keys = torch.where(valid, keys, INT32_MAX if ncap is None else ncap)
    skeys, sidx = torch.sort(keys, stable=True)
    sc_tab = None
    if ncap is not None:
        counts = torch.bincount(keys, minlength=ncap + 1)[: ncap + 1]
        starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:ncap], 0)])
        sc_tab = torch.stack([starts, counts], dim=1)
    return Grid(points, cells, valid, skeys, torch.where(valid[sidx], sidx, -1), points[sidx],
                sc_tab, ny, nz, ncap, r * r)


def query_rows(grid: Grid, rows: torch.Tensor, k: int, cap_per_cell: int) -> torch.Tensor:
    """[B, k] int32 neighbours of the query points `rows` (indices into the
    cloud): the chunk function of `radius_graph`."""
    dev = grid.points.device
    n = grid.points.shape[0]
    qp, qc, qv = grid.points[rows], grid.cells[rows], grid.valid[rows]
    b = qp.shape[0]
    ncell = qc[:, None, :] + torch.as_tensor(_OFFSETS, device=dev)[None]  # [B, 27, 3]
    ncell_ok = (ncell >= 0).all(dim=-1)
    nkey = (ncell[..., 0] * grid.ny + ncell[..., 1]) * grid.nz + ncell[..., 2]
    arange_cap = torch.arange(cap_per_cell, device=dev)
    if grid.ncap is None:
        starts = torch.searchsorted(grid.skeys, nkey, side="left")
        ends = torch.searchsorted(grid.skeys, nkey, side="right")
        pos = starts[..., None] + arange_cap
        in_range = (pos < ends[..., None]) & ncell_ok[..., None]
    else:
        nkey = torch.where(ncell_ok, nkey, grid.ncap).clamp(0, grid.ncap)
        sc = grid.sc_tab[nkey]
        pos = sc[..., 0, None] + arange_cap
        in_range = (arange_cap < sc[..., 1, None]) & ncell_ok[..., None]
    pos = pos.clamp(0, n - 1)
    cand_idx = grid.cand_idx[pos]  # [B, 27, cap]
    d = grid.spts[pos] - qp[:, None, None, :]
    dx, dy, dz = d.unbind(-1)
    d2 = fma(dz, dz, fma(dy, dy, dx * dx))
    ok = in_range & (cand_idx >= 0) & (d2 <= grid.r2) & qv[:, None, None]
    d2 = torch.where(ok, d2, BIG).reshape(b, -1)
    d2s, order = torch.sort(d2, dim=-1, stable=True)
    out = torch.gather(cand_idx.reshape(b, -1), 1, order[:, :k])
    return torch.where(d2s[:, :k] < BIG, out, -1).to(torch.int32)


def _radius_graph_impl(points: torch.Tensor, radius, valid=None, k: int = 16,
                       cap_per_cell: int = 8, chunk: int = 4096,
                       ncap: Optional[int] = None) -> torch.Tensor:
    """The graph without the host guard: `ncap=None` binary-searches the
    sorted keys (any extent), `ncap` a power of two > every valid key uses
    the dense table. [N, k] int32."""
    if k > 27 * cap_per_cell:
        raise ValueError(f"k={k} exceeds the {27 * cap_per_cell} candidates a point sees")
    n = points.shape[0]
    if n == 0:
        return torch.zeros((0, k), dtype=torch.int32, device=points.device)
    grid = build_grid(points, radius, valid, ncap)
    step = max(chunk, CUDA_CHUNK) if points.is_cuda else chunk
    rows = torch.arange(n, device=points.device)
    return torch.cat([query_rows(grid, rows[i:i + step], k, cap_per_cell)
                      for i in range(0, n, step)])


def adjacency_to_lists(adj) -> np.ndarray:
    """[N, K] padded adjacency -> object array of int64 index arrays (the
    `adj.pkl` layout)."""
    adj = np.asarray(adj)
    out = np.empty(len(adj), dtype=object)
    for i, row in enumerate(adj):
        out[i] = row[row >= 0].astype(np.int64)
    return out


def lists_to_adjacency(lists, k: int) -> np.ndarray:
    """Ragged lists -> fixed-degree [N, k] int32, each row cut to its first
    k neighbours."""
    n = len(lists)
    adj = np.full((n, k), -1, np.int32)
    for i, row in enumerate(lists):
        row = np.asarray(list(row), np.int32)[:k]
        adj[i, : len(row)] = row
    return adj


def lists_to_csr(lists):
    """Ragged lists -> CSR (offsets [N+1] int32, flat int32), by one
    concatenate."""
    lengths = np.fromiter((len(r) for r in lists), np.int64, count=len(lists))
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = (np.concatenate([np.asarray(r, np.int32) for r in lists])
            if len(lists) else np.empty(0, np.int32))
    if offsets[-1] >= np.iinfo(np.int32).max:
        raise ValueError("edge count exceeds int32 CSR offsets; split the graph")
    return offsets.astype(np.int32), flat.astype(np.int32)


def csr_to_adjacency(offsets, flat) -> np.ndarray:
    """CSR -> fixed-degree [N, max degree] int32 (-1 padded)."""
    offsets = np.asarray(offsets, np.int64)
    flat = np.asarray(flat, np.int32)
    n = len(offsets) - 1
    lengths = np.diff(offsets)
    k = int(lengths.max()) if n else 0
    adj = np.full((n, max(k, 1)), -1, np.int32)
    rows = np.repeat(np.arange(n), lengths)
    cols = np.arange(len(flat)) - np.repeat(offsets[:-1], lengths)
    adj[rows, cols] = flat
    return adj
