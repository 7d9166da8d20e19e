"""Multi-view point-cloud fusion engine.

Counterpart of `fusion3dseg_tpu/fusion/fusion.py` (`fuse_session` and what
it runs, the overflow repair `dedup_state`, and the window sizing helpers).
Per-frame RGB-D point clouds fuse into one sparse world cloud under a
distance + normal-cone merge criterion; every frame gets a pixel->slot
lookup `uv2pt`. One frame step:

  1. frustum + far-plane cull of the buffer, one [N,3] @ [3,5] product;
  2. projection of the window's slots into the frame;
  3. a packed depth+slot z-buffer into the pixel-cell grid (two
     depth-ordered candidates a cell); every pixel matches the nearest of
     its 3x3 cells' 18 candidates passing dist < radius and
     cos > min_cosine;
  4. a running-mean merge of the matched pixels into their slots;
  5. the leftover pixels voxel-sparsified at the merge radius and appended
     (dropped once the buffer is full).

The session is a Python loop over frames on fixed shapes: the state is
`[capacity]` tensors and its fill `n` a 0-d tensor on the device, the
window is chosen by index gathers (`a0 + arange(Wa)`) and written back
with `index_copy`, so a frame step never waits for the device. The host
reads the device only in `seed_cells_for_frame`, the span telemetry and
the final `n`.

Scatters that the reference routes out of bounds (`mode="drop"`) go to one
trash row past the end of their table here, sliced off after. Float sums
go through `ops/sparsify.segment_sum`, which adds in one fixed order, so a
run on the card repeats bit for bit.

`fuse_chunk` continues the loop from a state (any chunking gives the same
bits), on which `fuse_session_checkpointed` commits a state file after
each chunk (`save_state` / `load_state`, the port's own `.npz` format);
`fuse_sessions_batch` loops over sessions; `Fusion` is the session-level
driver with the reference's surface (auto capacity and window, overflow
repair, uv2pt artifacts, `dump_data` / `load_data`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.geometry import camera, intersections, quaternion as quat
from fusion3dseg_tpu_torch.ops import sparsify, zbuffer
from fusion3dseg_tpu_torch.ops.sparsify import segment_sum
from fusion3dseg_tpu_torch.ops.zbuffer import INT32_MAX


class FusionState(NamedTuple):
    points: torch.Tensor  # [CAP, 3]
    normals: torch.Tensor  # [CAP, 3]
    colors: torch.Tensor  # [CAP, 3]
    nmerges: torch.Tensor  # [CAP] int32
    occurences: torch.Tensor  # [CAP] int32
    n: torch.Tensor  # 0-d int32 on the device: live prefix length


def _empty_state(capacity: int, device) -> FusionState:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FusionState(z(capacity, 3), z(capacity, 3), z(capacity, 3),
                       z(capacity, dtype=torch.int32), z(capacity, dtype=torch.int32),
                       z(dtype=torch.int32))


def state_from_arrays(points, normals, colors, nmerges, occurences, n, *,
                      device="cuda") -> FusionState:
    """A FusionState on `device` from host arrays in field order, e.g.
    `state_from_arrays(*map(np.asarray, jax_state), device="cpu")`."""
    dev = cuda.resolve_device(device)

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return FusionState(t(points, f32), t(normals, f32), t(colors, f32),
                       t(nmerges, i32), t(occurences, i32), t(n, i32).reshape(()))


def state_to_arrays(state: FusionState) -> dict:
    """The state's fields as host NumPy arrays, keyed by field name."""
    return {k: v.cpu().numpy() for k, v in state._asdict().items()}


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """`dst` with rows `idx` set to `vals`; rows sent to index len(dst) are
    dropped (they land in a trash row that is sliced off)."""
    out = torch.cat([dst, dst.new_zeros((1, *dst.shape[1:]))])
    out[idx.long()] = vals
    return out[:-1]


def _dot3_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 components as XLA's CPU code computes it in a
    fused step: fma(a2, b2, fma(a1, b1, a0 * b0)), each fma exact in
    float64 and rounded to float32 (see `camera._depth_fma`)."""
    acc = (a[..., 0] * b[..., 0]).double()
    acc = (a[..., 1].double() * b[..., 1].double() + acc).float().double()
    return (a[..., 2].double() * b[..., 2].double() + acc).float()


def _append_sparsified(state: FusionState, sp: sparsify.SparsifyResult,
                       capacity: int) -> Tuple[FusionState, torch.Tensor]:
    """Append occupied cells at [n, n + new), dropping what passes capacity.
    Returns (state, cell -> slot map [C], -1 for empty or dropped cells)."""
    dest_rank, total_new = sparsify.compact_slots(sp.counts)
    occupied = sp.counts > 0
    dest = torch.where(occupied, state.n + dest_rank, capacity)
    write = occupied & (dest < capacity)
    dest = torch.where(write, dest, capacity)
    state = FusionState(
        _set_rows(state.points, dest, sp.points),
        _set_rows(state.normals, dest, sp.normals),
        _set_rows(state.colors, dest, sp.colors),
        _set_rows(state.nmerges, dest, sp.counts),
        _set_rows(state.occurences, dest, torch.ones_like(sp.counts)),
        torch.clamp(state.n + total_new, max=capacity).to(torch.int32),
    )
    return state, torch.where(write, dest, -1).to(torch.int32)


def _frame_extent_cells(max_depth: float, radius: float) -> int:
    """Per-axis voxel bound of one frame's points (4 * max_depth / radius +
    3), which lets the sparsifier pack its sort key into one int32; valid
    points past it are dropped by the sparsifier."""
    return int(np.ceil(4.0 * max_depth / radius)) + 3


def _seed_frame(state, fpts, fnrm, fclr, fvalid, *, height, width, radius, min_cosine,
                max_depth, capacity):
    """First frame: voxel-sparsify at the merge radius and append."""
    sp = sparsify.patch_sparsify(fpts, fnrm, fclr, fvalid, height, width, radius, min_cosine,
                                 extent_cells=_frame_extent_cells(max_depth, radius),
                                 const_radius=True)
    state, cell2slot = _append_sparsified(state, sp, capacity)
    lp = sp.cell_of_pixel
    uv2pt = torch.where(lp >= 0, cell2slot[lp.clamp(0, sp.num_cells - 1).long()], -1)
    return state, uv2pt.to(torch.int32)


def _match_pixels(grid, slotg, fpts, fnrm, fvalid, *, height, width, half, radius,
                  min_cosine):
    """Match every pixel against its 3x3 cell neighbourhood's candidates.

    grid [gh, gw, 12]: two candidates x (position, normal) a cell, zeros
    where absent; slotg [gh, gw, 2] their ids, -1 absent. The candidate
    axis is candidate-major, then the 3x3 offsets row-major: that order
    breaks argmin's ties. Returns (match [P] id or -1, matched [P] bool).
    """
    P = height * width
    gh, gw = grid.shape[:2]
    padg = F.pad(grid, (0, 0, 1, 1, 1, 1)).reshape(gh + 2, gw + 2, 2, 6)
    pads = F.pad(slotg, (0, 0, 1, 1, 1, 1), value=-1)
    offsets = [(c, dy, dx) for c in range(2) for dy in range(3) for dx in range(3)]
    neigh = torch.stack([padg[dy:dy + gh, dx:dx + gw, c] for c, dy, dx in offsets], dim=2)
    nslot = torch.stack([pads[dy:dy + gh, dx:dx + gw, c] for c, dy, dx in offsets], dim=2)
    if half > 1:  # cell -> pixel upsample: pixel (v, u) reads cell (v // half, u // half)
        neigh = neigh.repeat_interleave(half, 0).repeat_interleave(half, 1)
        nslot = nslot.repeat_interleave(half, 0).repeat_interleave(half, 1)
    cpn = neigh[:height, :width].reshape(P, 18, 6)
    cand = nslot[:height, :width].reshape(P, 18)

    dist = quat.norm3_fma(fpts[:, None, :] - cpn[..., :3])[..., 0]
    cosn = _dot3_fma(fnrm[:, None, :], cpn[..., 3:])
    passes = (cand >= 0) & (dist < radius) & (cosn > min_cosine) & fvalid[:, None]
    best = torch.where(passes, dist, torch.inf).argmin(dim=-1)
    matched = passes.any(dim=-1)
    match = torch.where(matched, cand.gather(1, best[:, None])[:, 0], -1)
    return match, matched


def _cell_candidates(ok, z, cell, ncells: int, id_bits: int, max_depth: float):
    """The two nearest points of every cell (ids are row numbers, -1 none):
    [ncells] each. Depth is quantized to 31 - id_bits bits and packed with
    the id into one int32 min (ties to the lowest id); below 8 depth bits,
    two exact-depth argmin rounds instead. `cell` is ncells where not ok."""
    cell_safe = cell.clamp(0, ncells - 1).long()
    ids = torch.arange(z.shape[0], dtype=torch.int32, device=z.device)
    zbits = 31 - id_bits
    if zbits >= 8:
        mask = (1 << id_bits) - 1
        packed = (zbuffer._zq(z, zbits, max_depth) << id_bits) | ids
        pmin = zbuffer._segment_min(packed, cell, ncells + 1, INT32_MAX)[:ncells]
        is_winner = ok & (packed == pmin[cell_safe])
        pmin2 = zbuffer._segment_min(packed, torch.where(is_winner, ncells, cell), ncells + 1,
                                     INT32_MAX)[:ncells]
        return (torch.where(pmin == INT32_MAX, -1, pmin & mask),
                torch.where(pmin2 == INT32_MAX, -1, pmin2 & mask))
    zc = torch.where(ok, z, torch.inf)
    winner = zbuffer.scatter_argmin_by_segment(zc, cell, ncells + 1)[:ncells]
    cand1 = torch.where(winner == INT32_MAX, -1, winner)
    is_winner = ok & (ids == cand1[cell_safe])
    winner2 = zbuffer.scatter_argmin_by_segment(torch.where(is_winner, torch.inf, zc), cell,
                                                ncells + 1)[:ncells]
    return cand1, torch.where(winner2 == INT32_MAX, -1, winner2)


def _window(inter, slot_ids, capacity, W, window_policy):
    """(span, idx_w [W] the window's slots in ascending order, or None when
    the window is the whole buffer)."""
    minv = torch.where(inter, slot_ids, capacity).amin()
    maxv = torch.where(inter, slot_ids, -1).amax()
    span = torch.clamp(maxv - minv + 1, min=0).to(torch.int32)
    if W >= capacity:
        return span, None
    if window_policy == "split":
        # the oldest Wa visible slots and the newest Wb; b0 >= a0 + Wa keeps
        # the segments apart, and when the span fits they are contiguous
        Wa, Wb = W // 2, W - W // 2
        a0 = torch.clamp(minv, 0, capacity - W)
        b0 = torch.clamp(torch.maximum(maxv - Wb + 1, a0 + Wa), max=capacity - Wb)
    else:  # the newest W visible slots
        Wa, Wb = 0, W
        b0 = torch.clamp(torch.maximum(minv, maxv - W + 1), 0, capacity - W)
        a0 = b0
    ar = torch.arange(W, dtype=torch.int64, device=inter.device)
    idx_w = torch.where(ar < Wa, a0 + ar, b0 - Wa + ar)
    return span, idx_w


def _fuse_frame(state: FusionState, M, R, t, plane_pts, plane_ns, fpts, fnrm, fclr, fvalid, *,
                height, width, radius, min_cosine, max_depth, capacity, candidate_px,
                window: Optional[int] = None, window_policy: str = "newest"):
    """One fusion step: merge a frame into the buffer.
    Returns (state, uv2pt [H*W] int32, span 0-d int32: the frame's
    frustum-visible slot span, the window-overflow telemetry)."""
    dev = fpts.device
    half = candidate_px
    gh, gw = -(-height // half), -(-width // half)
    ncells = gh * gw
    slot_ids = torch.arange(capacity, dtype=torch.int32, device=dev)

    inter = intersections.points_inside_polyhedra(state.points, plane_pts, plane_ns)
    inter = inter & (slot_ids < state.n)
    W = capacity if (window is None or window >= capacity) else int(window)
    span, idx_w = _window(inter, slot_ids, capacity, W, window_policy)

    def take(arr):
        return arr if idx_w is None else arr[idx_w]

    pts_w, nrm_w = take(state.points), take(state.normals)
    u_w, v_w, z_w = camera.project_with_matrices(pts_w, M, R, t)
    ok_w = take(inter) & (z_w > 0) & (u_w >= 0) & (u_w < width) & (v_w >= 0) & (v_w < height)

    # candidate z-buffer over window-local ids. W.bit_length() keeps one
    # spare id, so a packed entry never reaches INT32_MAX, the empty value
    cell = (v_w // half) * gw + (u_w // half) if half > 1 else v_w * gw + u_w
    cell = torch.where(ok_w, cell, ncells)  # ncells: the trash cell
    cand1, cand2 = _cell_candidates(ok_w, z_w, cell, ncells, max(1, W.bit_length()), max_depth)

    cands = torch.stack([cand1, cand2], dim=1)  # [ncells, 2]
    has = cands >= 0
    cdata = torch.cat([pts_w, nrm_w], dim=1)[torch.where(has, cands, 0).long()]
    grid = torch.where(has[..., None], cdata, 0.0).reshape(gh, gw, 12)
    slotg = torch.where(has, cands, -1).reshape(gh, gw, 2)
    match, matched = _match_pixels(grid, slotg, fpts, fnrm, fvalid, height=height, width=width,
                                   half=half, radius=radius, min_cosine=min_cosine)

    # running-mean merge of this frame's matches into their slots
    clr_w, nm_w, occ_w = take(state.colors), take(state.nmerges), take(state.occurences)
    ones = torch.ones((fpts.shape[0], 1), dtype=torch.float32, device=dev)
    acc = segment_sum(torch.cat([ones, fpts, fclr, fnrm], dim=1),
                      torch.where(matched, match, W), W)
    cnt = acc[:, 0]
    touched = (cnt > 0)[:, None]
    denom = (cnt + 1.0)[:, None]
    new_pts = torch.where(touched, (acc[:, 1:4] + pts_w) / denom, pts_w)
    new_clr = torch.where(touched, (acc[:, 4:7] + clr_w) / denom, clr_w)
    nsum = acc[:, 7:10] + nrm_w
    nnrm = nsum / quat.norm3_fma(nsum).clamp(min=1e-12)
    new_nrm = torch.where(touched, nnrm, nrm_w)
    new_nm = nm_w + cnt.to(torch.int32)
    new_occ = occ_w + touched[:, 0].to(torch.int32)
    if idx_w is None:
        state = FusionState(new_pts, new_nrm, new_clr, new_nm, new_occ, state.n)
    else:
        def put(dst, vals):
            return dst.index_copy(0, idx_w, vals)

        state = FusionState(put(state.points, new_pts), put(state.normals, new_nrm),
                            put(state.colors, new_clr), put(state.nmerges, new_nm),
                            put(state.occurences, new_occ), state.n)
        match = torch.where(matched, idx_w.to(torch.int32)[match.clamp(min=0).long()], -1)

    # leftover pixels: voxel-sparsify at the merge radius and append
    sp = sparsify.patch_sparsify(fpts, fnrm, fclr, fvalid & ~matched, height, width, radius,
                                 min_cosine, extent_cells=_frame_extent_cells(max_depth, radius),
                                 const_radius=True)
    state, cell2slot = _append_sparsified(state, sp, capacity)
    lp = sp.cell_of_pixel
    uv2pt = torch.where(matched, match, -1)
    uv2pt = torch.where(~matched & (lp >= 0), cell2slot[lp.clamp(0, sp.num_cells - 1).long()],
                        uv2pt)
    return state, uv2pt.to(torch.int32), span


def _session_tensors(dev, Ks, quats_wxyz, translations, points, normals, colors, valid):
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return (f32(Ks), f32(quats_wxyz), f32(translations), f32(points), f32(normals),
            f32(colors), torch.as_tensor(valid, dtype=torch.bool, device=dev))


@torch.no_grad()
def fuse_session(Ks, quats_wxyz, translations, points, normals, colors, valid, *,
                 height: int, width: int, radius: float, min_cosine: float, max_depth: float,
                 capacity: int, candidate_px: int = 1, window: Optional[int] = None,
                 window_policy: str = "newest", with_stats: bool = False, device="cuda"):
    """Fuse a whole session: frame 0 seeds the buffer, frames 1..F-1 merge.

    Args:
      Ks: [3, 3] depth-scaled intrinsics; quats_wxyz [F, 4]; translations
        [F, 3]; points, normals, colors [F, H*W, 3] (world frame); valid
        [F, H*W] bool. Arrays or tensors; moved to `device` once.
      window: bound the z-buffer and merge work to W slots of the buffer
        (see `window_policy`: "newest" covers the newest W visible slots,
        "split" the oldest W//2 and the newest W - W//2); None merges
        against the whole buffer.
      with_stats: also return spans [F] int32, each frame's
        frustum-visible slot span (0 for the seed frame). A span above the
        window means the frame appended duplicates; `dedup_state` repairs
        them.

    Returns (state, uv2pt [F, H*W] int32[, spans [F] int32]) on `device`.
    Frame 0 should hold at least one valid point.
    """
    if window_policy not in ("newest", "split"):
        raise ValueError(f"unknown window_policy {window_policy!r}")
    dev = cuda.resolve_device(device)
    K, quats, trans, points, normals, colors, valid = _session_tensors(
        dev, Ks, quats_wxyz, translations, points, normals, colors, valid)
    kw = dict(height=height, width=width, radius=radius, min_cosine=min_cosine,
              max_depth=max_depth, capacity=capacity)
    state, uv0 = _seed_frame(_empty_state(capacity, dev), points[0], normals[0], colors[0],
                             valid[0], **kw)
    state, uv_rest, spans_rest = _fuse_frames(
        state, K, quats[1:], trans[1:], points[1:], normals[1:], colors[1:], valid[1:],
        candidate_px=candidate_px, window=window, window_policy=window_policy, **kw)
    uv2pt = torch.cat([uv0[None], uv_rest])
    if with_stats:
        return state, uv2pt, torch.cat([spans_rest.new_zeros(1), spans_rest])
    return state, uv2pt


def _fuse_frames(state, K, quats, trans, points, normals, colors, valid, *, height, width,
                 candidate_px, window, window_policy, **kw):
    """The frame loop over F frames from `state`: (state, uv2pt [F, H*W],
    spans [F]). The frames' matrices and frustums come from one batched
    call; each frame's entries do not depend on the batch, so any split of
    a session into calls gives the same bits."""
    dev = points.device
    nf = points.shape[0]
    uv2pt = torch.empty((nf, height * width), dtype=torch.int32, device=dev)
    spans = torch.zeros(nf, dtype=torch.int32, device=dev)
    if nf == 0:
        return state, uv2pt, spans
    M, R = camera.projection_matrices(K, quats)
    plane_pts, plane_ns = camera.frustum_world_planes(K, width, height, quats, trans,
                                                      kw["max_depth"])
    for f in range(nf):
        state, uv2pt[f], spans[f] = _fuse_frame(
            state, M[f], R[f], trans[f], plane_pts[f], plane_ns[f], points[f], normals[f],
            colors[f], valid[f], height=height, width=width, candidate_px=candidate_px,
            window=window, window_policy=window_policy, **kw)
    return state, uv2pt, spans


@torch.no_grad()
def fuse_chunk(state: FusionState, Ks, quats_wxyz, translations, points, normals, colors, valid,
               *, height: int, width: int, radius: float, min_cosine: float, max_depth: float,
               capacity: int, candidate_px: int = 1, window: Optional[int] = None,
               window_policy: str = "newest", with_stats: bool = False):
    """Continue fusion over a chunk of frames from an existing state, on
    the state's device. `fuse_session` is the seed frame followed by
    `fuse_chunk` over frames 1..F-1 in any chunking, bit for bit: the
    building block of checkpointed fusion. Returns (state, uv2pt [chunk,
    H*W][, spans [chunk]])."""
    if window_policy not in ("newest", "split"):
        raise ValueError(f"unknown window_policy {window_policy!r}")
    dev = state.points.device
    K, quats, trans, points, normals, colors, valid = _session_tensors(
        dev, Ks, quats_wxyz, translations, points, normals, colors, valid)
    state, uv2pt, spans = _fuse_frames(
        state, K, quats, trans, points, normals, colors, valid, height=height, width=width,
        radius=radius, min_cosine=min_cosine, max_depth=max_depth, capacity=capacity,
        candidate_px=candidate_px, window=window, window_policy=window_policy)
    if with_stats:
        return state, uv2pt, spans
    return state, uv2pt


def auto_window(seed_cells: int, capacity: int) -> Optional[int]:
    """A merge window from the seed frame's occupied cells: 8x the seed
    density rounded up to a power of two, at least 2^13. None (unwindowed)
    at capacity <= 2^16 or when the window would reach capacity."""
    if capacity <= (1 << 16):
        return None
    w = 1 << max(int(np.ceil(np.log2(max(8 * seed_cells, 2)))), 13)
    return None if w >= capacity else int(w)


@torch.no_grad()
def seed_cells_for_frame(points0, normals0, colors0, valid0, height: int, width: int,
                         radius: float, min_cosine: float, max_depth: Optional[float] = None
                         ) -> int:
    """Occupied-cell count of a seed frame (tensors on one device), exactly
    as `_seed_frame` sparsifies it when `max_depth` is given: the input of
    `auto_window`. One host read."""
    extent = _frame_extent_cells(max_depth, radius) if max_depth is not None else None
    sp0 = sparsify.patch_sparsify(points0, normals0, colors0, valid0, height, width, radius,
                                  min_cosine, extent_cells=extent)
    return int((sp0.counts > 0).sum())


def visible_span_from_uv2pt(uv2pt) -> np.ndarray:
    """Per-frame spread max - min + 1 of the slots a frame's pixels matched
    ([F] int64; 0 for a frame with no match): a sizing aid for `window`."""
    uv2pt = np.asarray(uv2pt.cpu() if isinstance(uv2pt, torch.Tensor) else uv2pt)
    spans = np.zeros(len(uv2pt), np.int64)
    for f, row in enumerate(uv2pt):
        hit = row[row >= 0]
        if len(hit):
            spans[f] = int(hit.max()) - int(hit.min()) + 1
    return spans


def _dedup_pass(state: FusionState, radius: float, min_cosine: float, capacity: int, shift):
    """One voxel merge of the live buffer on a grid anchored `shift` off
    the valid-point minimum. New slots are ranked by each cell's minimum
    old slot, so the buffer keeps its append order. Returns (state,
    slot_map [capacity] old slot -> new slot, -1 for dead slots)."""
    dev = state.points.device
    slot_ids = torch.arange(capacity, dtype=torch.int32, device=dev)
    live = slot_ids < state.n
    m = sparsify.voxel_merge(state.points, state.normals, state.colors, state.nmerges,
                             state.occurences, live, radius, min_cosine,
                             origin_shift=torch.tensor(shift, dtype=torch.float32, device=dev))
    C = m.num_cells
    seg = torch.where(m.cell_of_input >= 0, m.cell_of_input, C)
    rep = zbuffer._segment_min(slot_ids, seg, C + 1, INT32_MAX)[:C]
    # empty cells keep INT32_MAX and sort after every occupied one
    order = torch.argsort(rep, stable=True)
    ranks = torch.empty(C, dtype=torch.int32, device=dev)
    ranks[order] = torch.arange(C, dtype=torch.int32, device=dev)
    n_new = (m.counts > 0).sum(dtype=torch.int32)
    take = order[:capacity]
    live_new = (slot_ids < n_new)[:, None]
    wide = torch.where(live_new, torch.cat([m.points, m.normals, m.colors], dim=1)[take], 0.0)
    iwide = torch.where(live_new, torch.stack([m.counts, m.occurences], dim=1)[take], 0)
    new_state = FusionState(wide[:, 0:3], wide[:, 3:6], wide[:, 6:9], iwide[:, 0], iwide[:, 1],
                            n_new)
    slot_map = torch.where(live & (m.cell_of_input >= 0),
                           ranks[m.cell_of_input.clamp(0, C - 1).long()], -1)
    return new_state, slot_map.to(torch.int32)


@torch.no_grad()
def dedup_state(state: FusionState, radius: float, min_cosine: float, *, capacity: int,
                passes: int = 5) -> Tuple[FusionState, torch.Tensor]:
    """Merge duplicate points of a fused buffer (the window-overflow
    repair): the engine's own criterion (one voxel of side `radius`,
    normals agreeing above `min_cosine`) over the whole buffer, in up to 5
    passes on shifted grids (unshifted, all axes by radius/2, then each
    axis alone). Weighted means stay exact; slot order is kept.

    Returns (state, slot_map [capacity] int32 old slot -> new slot, -1
    for dead slots): remap uv2pt through it with `remap_uv2pt`.
    """
    h = radius / 2
    shifts = ((0.0, 0.0, 0.0), (h, h, h), (h, 0.0, 0.0), (0.0, h, 0.0),
              (0.0, 0.0, h))[: max(1, min(passes, 5))]
    slot_map = None
    for s in shifts:
        state, m = _dedup_pass(state, radius, min_cosine, capacity, s)
        if slot_map is None:
            slot_map = m
        else:
            slot_map = torch.where(slot_map >= 0, m[slot_map.clamp(0, capacity - 1).long()], -1)
    return state, slot_map.to(torch.int32)


def remap_uv2pt(uv2pt: torch.Tensor, slot_map: torch.Tensor) -> torch.Tensor:
    """A uv2pt lookup (any shape of slot ids, -1 unmatched) through a
    `dedup_state` slot map."""
    safe = uv2pt.clamp(0, slot_map.shape[0] - 1).long()
    return torch.where(uv2pt >= 0, slot_map[safe], -1).to(torch.int32)


def save_state(state: FusionState, directory) -> None:
    """Write the state's arrays to `directory/fusion_state.npz` (the port's
    own format; the reference's Orbax directories are not read)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / "fusion_state.tmp.npz"
    np.savez(tmp, **state_to_arrays(state))
    os.replace(tmp, directory / "fusion_state.npz")


def load_state(directory, device="cuda") -> FusionState:
    """The state `save_state` wrote, on `device`."""
    with np.load(Path(directory) / "fusion_state.npz") as d:
        return state_from_arrays(*(d[k] for k in FusionState._fields), device=device)


@torch.no_grad()
def fuse_session_checkpointed(
    Ks, quats_wxyz, translations, points, normals, colors, valid,
    *, height: int, width: int, radius: float, min_cosine: float, max_depth: float,
    capacity: int, candidate_px: int = 1, window: Optional[int] = None,
    window_policy: str = "newest", chunk_frames: int = 64, ckpt_dir,
    max_chunks: Optional[int] = None, retries: int = 0, verbose: bool = False,
    device="cuda",
) -> Tuple[FusionState, np.ndarray]:
    """Session fusion in chunks of `chunk_frames`, the state committed to
    `ckpt_dir` after each; a rerun with the same directory resumes from the
    last commit, bit-exactly (chunked fusion is the one-shot loop).

    Commit protocol: a chunk's state goes to its own `state_<frame>`
    directory first; `progress.json` (the next frame, that directory's name
    and every parameter the result depends on) is the single commit point,
    written after; older state directories are removed after that. A
    resume under any changed parameter raises. `max_chunks` bounds the
    chunks of this call; `retries` reruns a failed chunk from its
    committed state. Returns (state, uv2pt [frames fused, H*W] int32
    NumPy).
    """
    dev = cuda.resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    marker = ckpt_dir / "progress.json"
    nf = len(quats_wxyz)
    kw = dict(height=height, width=width, radius=radius, min_cosine=min_cosine,
              max_depth=max_depth, capacity=capacity)
    params = dict(
        nframes=nf, capacity=capacity, height=height, width=width, radius=float(radius),
        min_cosine=float(min_cosine), max_depth=float(max_depth), candidate_px=candidate_px,
        window=None if window is None else int(window), window_policy=window_policy,
    )
    K, quats, trans, points, normals, colors, valid = _session_tensors(
        dev, Ks, quats_wxyz, translations, points, normals, colors, valid)

    def commit(state, next_frame):
        sdir = ckpt_dir / f"state_{next_frame:07d}"
        save_state(state, sdir)
        marker.write_text(json.dumps({"next_frame": next_frame, "state_dir": sdir.name,
                                      **params}))
        for d in ckpt_dir.glob("state_*"):
            if d.name != sdir.name:
                shutil.rmtree(d, ignore_errors=True)

    def committed_state():
        prog = json.loads(marker.read_text())
        return load_state(ckpt_dir / prog["state_dir"], device=dev)

    if marker.is_file():
        prog = json.loads(marker.read_text())
        bad = {k: (prog.get(k), v) for k, v in params.items() if k in prog and prog[k] != v}
        if bad:
            detail = ", ".join(f"{k} {old!r} vs {new!r}" for k, (old, new) in bad.items())
            raise ValueError(f"checkpoint at {ckpt_dir} is for a different session or "
                             f"parameterization ({detail}); clear it first")
        nxt = int(prog["next_frame"])
        state = load_state(ckpt_dir / prog["state_dir"], device=dev)
        if verbose:
            print(f"resuming fusion at frame {nxt}/{nf}")
    else:
        state, uv0 = _seed_frame(_empty_state(capacity, dev), points[0], normals[0], colors[0],
                                 valid[0], **kw)
        np.save(ckpt_dir / "uv2pt_0000000.npy", uv0[None].cpu().numpy())
        commit(state, 1)
        nxt = 1

    chunks_run = 0
    while nxt < nf and (max_chunks is None or chunks_run < max_chunks):
        end = min(nxt + chunk_frames, nf)
        sl = slice(nxt, end)
        attempt = 0
        while True:
            try:
                state_next, uv_c, _ = _fuse_frames(
                    state, K, quats[sl], trans[sl], points[sl], normals[sl], colors[sl],
                    valid[sl], candidate_px=candidate_px, window=window,
                    window_policy=window_policy, **kw)
                uv_c = uv_c.cpu().numpy()  # waits: a failure shows here
                break
            except Exception as e:
                attempt += 1
                if attempt > retries:
                    raise
                if verbose:
                    print(f"chunk [{nxt}, {end}) failed ({type(e).__name__}: {e}); retry "
                          f"{attempt}/{retries} from the last commit")
                state = committed_state()
        state = state_next
        np.save(ckpt_dir / f"uv2pt_{nxt:07d}.npy", uv_c)
        commit(state, end)
        if verbose:
            print(f"fused frames [{nxt}, {end}) -> n={int(state.n)}")
        nxt = end
        chunks_run += 1

    rows = [np.load(f) for f in sorted(ckpt_dir.glob("uv2pt_*.npy"))]
    uv2pt = np.concatenate(rows, axis=0) if rows else np.zeros((0,), np.int32)
    # a crash between a chunk's uv2pt file and its commit leaves rows past
    # the committed frame count
    return state, uv2pt[:nxt]


@torch.no_grad()
def fuse_sessions_batch(Ks, quats_wxyz, translations, points, normals, colors, valid, *,
                        height: int, width: int, radius: float, min_cosine: float,
                        max_depth: float, capacity: int, candidate_px: int = 1,
                        window: Optional[int] = None, window_policy: str = "newest",
                        device="cuda"):
    """Fuse a batch of sessions, each independently: every argument has a
    leading session axis (Ks [S,3,3], poses [S,F,...], frame data
    [S,F,HW,...]). A loop over the sessions. Returns (FusionState with a
    leading S axis on every field, uv2pt [S, F, HW])."""
    kw = dict(height=height, width=width, radius=radius, min_cosine=min_cosine,
              max_depth=max_depth, capacity=capacity, candidate_px=candidate_px, window=window,
              window_policy=window_policy, device=device)
    outs = [fuse_session(*(a[s] for a in (Ks, quats_wxyz, translations, points, normals,
                                          colors, valid)), **kw)
            for s in range(len(Ks))]
    state = FusionState(*(torch.stack([o[0][i] for o in outs])
                          for i in range(len(FusionState._fields))))
    return state, torch.stack([o[1] for o in outs])


@dataclasses.dataclass
class Fusion:
    """Session-level fusion driver with the reference's surface: `fuse`,
    `filter`, `dump_data`, `load_data`, and the uv2pt artifact files. It
    runs on the device that holds the session's tensors.

    `capacity=None` sizes the buffer from the seed frame; `window="auto"`
    sizes the merge window from it (`auto_window`), None merges against
    the whole buffer; `window_policy` "split" merges revisited geometry
    against its original slots at loop closure; `auto_dedup` repairs the
    duplicates a frame past the window appended (`dedup_state`)."""

    session: object  # io.rtab.SessionData
    point_range: Optional[Tuple[float, float]] = None
    decimation: int = 1
    capacity: Optional[int] = 1 << 20
    window: object = "auto"
    window_policy: str = "split"
    auto_dedup: bool = True
    save_lookups: bool = True
    out_dir: Optional[str] = None

    ds_radius: Optional[float] = None
    ds_angle: Optional[float] = None

    @property
    def nframes(self) -> int:
        return self.session.nframes

    @property
    def npts(self) -> int:
        h, w = self.session.depth_hw
        return h * w

    def _valid_mask(self) -> torch.Tensor:
        """Depth range and decimation validity [F, H*W], on the session's
        device."""
        depth = self.session.depth
        h, w = self.session.depth_hw
        if self.point_range is not None:
            lo, hi = self.point_range
            valid = (depth > lo) & (depth <= hi)
        else:
            valid = torch.ones_like(depth, dtype=torch.bool)
        if self.decimation > 1:
            keep = torch.zeros((h, w), dtype=torch.bool, device=depth.device)
            keep[:: self.decimation, :: self.decimation] = True
            valid = valid & keep.reshape(1, -1)
        return valid

    def fuse(self, radius: float = 0.05, angle: float = 10.0, stride: Optional[int] = None,
             max_depth: float = 10.0, skip: int = 1, verbose: bool = False):
        """Fuse the session; returns (points, normals, colors, nmerges,
        occurences uint32) NumPy arrays of the live prefix. `stride` is
        accepted for the reference's signature and has no effect (the voxel
        sparsifier has no patch stride). The host reads the device before
        the frame loop (the first frame with a valid point, the seed
        frame's cells when a knob is automatic) and after it (the spans,
        n), never inside it."""
        del stride
        self.ds_radius, self.ds_angle = radius, angle
        min_cosine = float(np.cos(np.deg2rad(angle)))
        h, w = self.session.depth_hw
        s = self.session
        if self.point_range is not None and self.point_range[1] > 2 * max_depth:
            print(f"warning: point_range max {self.point_range[1]} exceeds 2*max_depth = "
                  f"{2 * max_depth}; points beyond the frame-extent bound are dropped by the "
                  "sparsifier")

        valid = self._valid_mask()
        dev = valid.device
        # start at the first frame with any valid point
        start = int(valid.any(dim=1).to(torch.uint8).argmax())
        sel = np.r_[start, np.arange(start + 1, self.nframes, skip)]
        sel_d = torch.as_tensor(sel, device=dev)

        n0 = None
        if self.capacity is None or self.window == "auto":
            n0 = max(seed_cells_for_frame(s.points[start], s.normals[start], s.colors[start],
                                          valid[start], h, w, float(radius), min_cosine,
                                          max_depth=max_depth), 256)
        if self.capacity is None:
            # seed density x a generous growth allowance; the saturation
            # warning below is the backstop
            est = n0 * (2 + len(sel) // 2)
            self.capacity = int(min(max(1 << (est - 1).bit_length(), 1 << 14), 1 << 21))
            if verbose:
                print(f"auto capacity: seed {n0} cells -> {self.capacity}")
        window = self.window
        if window == "auto":
            window = auto_window(n0, self.capacity)
            if verbose and window is not None:
                print(f"auto window: seed {n0} cells -> {window}")

        state, uv2pt, spans = fuse_session(
            s.Ks.astype(np.float32), s.quats_wxyz[sel], s.translations[sel], s.points[sel_d],
            s.normals[sel_d], s.colors[sel_d], valid[sel_d], height=h, width=w,
            radius=float(radius), min_cosine=min_cosine, max_depth=float(max_depth),
            capacity=self.capacity, window=window, window_policy=self.window_policy,
            with_stats=True, device=dev)
        spans = spans.cpu().numpy()
        self.last_spans = spans
        self.last_overflow_frames = int((spans > window).sum()) if window is not None else 0
        if self.last_overflow_frames and self.auto_dedup:
            state, slot_map = dedup_state(state, float(radius), min_cosine,
                                          capacity=self.capacity)
            uv2pt = remap_uv2pt(uv2pt, slot_map)
            if verbose:
                print(f"window overflow on {self.last_overflow_frames} frames (max span "
                      f"{int(spans.max())} > window {window}); deduplicated to "
                      f"{int(state.n)} points")
        n = int(state.n)
        if n >= self.capacity:
            warnings.warn(f"fusion buffer saturated at capacity={self.capacity}; points "
                          "beyond it were dropped; rerun with a larger Fusion(capacity=...)",
                          RuntimeWarning)
        if verbose:
            print(f"fused {len(sel)} frames into {n} sparse points")

        uv2pt_h = uv2pt.cpu().numpy()
        if self.save_lookups and self.out_dir is not None:
            from fusion3dseg_tpu_torch.io import artifacts

            artifacts.save_uv2pt_batch(self.out_dir, [str(s.frame_numbers[i]) for i in sel],
                                       uv2pt_h)
        self._last_uv2pt = uv2pt_h
        self._last_frames = sel
        return (
            state.points[:n].cpu().numpy(),
            state.normals[:n].cpu().numpy(),
            state.colors[:n].cpu().numpy(),
            state.nmerges[:n].cpu().numpy(),
            state.occurences[:n].cpu().numpy().astype(np.uint32),
        )

    @staticmethod
    def filter(values, threshold, data=None, less_than=False):
        """(mask of values >= threshold, or <= with `less_than`; the
        `data` arrays masked, or None)."""
        values = np.asarray(values)
        mask = values <= threshold if less_than else values >= threshold
        if data is None:
            return mask, None
        return mask, [np.asarray(d)[mask] for d in data]

    def dump_data(self, dirname, points, normals=None, colors=None, nmerges=None,
                  occurences=None, compute_adjacency=True, verbose=False,
                  adjacency_degree: int = 32):
        """Write the fusion artifacts, with the full neighbour lists within
        2 * ds_radius from the native library as `adj.pkl`.
        `adjacency_degree` is accepted for the reference's signature (its
        device graph's degree cap); the native lists are uncapped."""
        from fusion3dseg_tpu_torch.io import artifacts, native

        del adjacency_degree, verbose
        adj = None
        if compute_adjacency and self.ds_radius is not None and len(points):
            adj = native.radius_graph_lists(np.asarray(points, np.float32), 2 * self.ds_radius)
        artifacts.dump_fusion_data(
            dirname, points, normals, colors, nmerges, occurences, nframes=self.nframes,
            depth_hw=tuple(self.session.depth_hw), adjacency=adj, ds_radius=self.ds_radius,
            ds_angle=self.ds_angle)

    @classmethod
    def load_data(cls, dirname):
        from fusion3dseg_tpu_torch.io import artifacts

        return artifacts.load_fusion_data(dirname)
