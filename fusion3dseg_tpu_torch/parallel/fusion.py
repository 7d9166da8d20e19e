"""The fusion engine over a device mesh: frame-sharded and spatially sharded.

Counterpart of `fusion3dseg_tpu/parallel/fusion.py`. Every rank calls a
function with the same global session; both engines return the whole
compacted `FusionState` and `uv2pt` [F, H*W] on every rank.

  1. `fuse_session_sharded`: frames split in contiguous chunks of F/D.
     Each rank fuses its chunk through the one-device frame step
     (`fusion._fuse_frame`) into a buffer of its own, after a warm start
     on the previous chunk's last `halo_frames` frames (rank 0's halo is
     frame 0 marked invalid: a no-op step). Halo uv2pt rows are dropped,
     local slots become global as rank * capacity, and one `all_gather`
     of the chunk buffers feeds one replicated weighted voxel merge
     (`sparsify.voxel_merge` + `compact_slots`) that reconciles the chunks
     and remaps uv2pt. Parity with the sequential scan is statistical.
  2. `fuse_session_spatial_sharded`: the buffer itself is split by a
     spatial hash of each slot's creation position (`_owner_hash`). Per
     frame, mirroring `fusion._fuse_frame` stage by stage: each rank culls,
     windows and projects its own slots; two `pmin`s of packed (depth,
     rank * W + window id) entries give the global two candidates a cell;
     one `psum` of owner-masked candidate rows gives every rank the
     candidate grid (exact: every other rank adds zeros); the pixel match
     is replicated; each rank merges only its own matches and appends only
     the leftover cells it owns (one `psum` of the cell -> slot map), and
     one `psum` of the [D, 2] window bases maps matches to global slots.
     At the end the ranks' live prefixes are gathered and compacted
     exactly. On one rank it is `fusion.fuse_session` bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch.fusion import fusion
from fusion3dseg_tpu_torch.fusion.fusion import FusionState
from fusion3dseg_tpu_torch.geometry import camera, intersections
from fusion3dseg_tpu_torch.geometry.camera import _floor_to_int32
from fusion3dseg_tpu_torch.ops import sparsify, zbuffer
from fusion3dseg_tpu_torch.ops.zbuffer import INT32_MAX
from fusion3dseg_tpu_torch.parallel import comm
from fusion3dseg_tpu_torch.parallel.sharding import mesh_device, rows_of


def _gather_state(state: FusionState, group):
    """Every rank's buffer, rank after rank: (float rows [D*cap, 9] of
    points, normals, colors; int rows [D*cap, 2] of nmerges, occurences;
    n [D])."""
    f = comm.all_gather(torch.cat([state.points, state.normals, state.colors], dim=1), group)
    i = comm.all_gather(torch.stack([state.nmerges, state.occurences], dim=1), group)
    return f, i, comm.all_gather(state.n.reshape(1), group)


def _compact(cells, cell_slot, cap_out: int, total) -> FusionState:
    """A FusionState of `cap_out` slots from per-cell rows (points, normals,
    colors, nmerges, occurences), cell c landing in slot `cell_slot[c]`
    (cap_out: dropped, into a trash row sliced off)."""
    def rows(v):
        out = v.new_zeros((cap_out + 1, *v.shape[1:]))
        out[cell_slot.long()] = v
        return out[:-1]

    return FusionState(*(rows(v) for v in cells), total.to(torch.int32))


def _remap(uv2pt: torch.Tensor, slot_of_row: torch.Tensor) -> torch.Tensor:
    safe = uv2pt.clamp(0, slot_of_row.shape[0] - 1).long()
    return torch.where(uv2pt >= 0, slot_of_row[safe], -1).to(torch.int32)


@torch.no_grad()
def fuse_session_sharded(mesh, Ks, quats_wxyz, translations, points, normals, colors, valid, *,
                         height: int, width: int, radius: float, min_cosine: float,
                         max_depth: float, capacity: int, candidate_px: int = 1,
                         axis: str = "dp", halo_frames: int = 2) -> Tuple[FusionState,
                                                                          torch.Tensor]:
    """Fuse a session with its frames split over `axis` (F divisible by
    the axis size); `capacity` is each chunk's. Returns (merged state of
    2 * D * capacity slots, uv2pt [F, H*W] int32 into it) on every rank.
    Each chunk's first frame should hold a valid point."""
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    nframes = len(quats_wxyz)
    assert nframes % ndev == 0, f"frames {nframes} % {ndev} devices != 0"
    fd, k = nframes // ndev, int(halo_frames)
    dev = mesh_device(mesh)
    # the halo [r*fd - k, r*fd) clipped into the session, then the chunk
    idx = np.r_[np.clip(r * fd - k + np.arange(k), 0, nframes - 1),
                np.arange(r * fd, (r + 1) * fd)]
    K, q, t, p, n, c, v = fusion._session_tensors(
        dev, Ks, *(rows_of(x, idx, dev) for x in (quats_wxyz, translations, points, normals, colors,
                                            valid)))
    if r == 0:
        v[:k] = False  # rank 0's halo: frame 0, a no-op step
    # every frame, halo and own, through the one frame step: on the empty
    # buffer the leftover append voxel-sparsifies the whole frame (a seed)
    state, uv2pt, _ = fusion._fuse_frames(
        fusion._empty_state(capacity, dev), K, q, t, p, n, c, v, height=height, width=width,
        candidate_px=candidate_px, window=None, window_policy="newest", radius=radius,
        min_cosine=min_cosine, max_depth=max_depth, capacity=capacity)
    uv2pt = torch.where(uv2pt[k:] >= 0, uv2pt[k:] + r * capacity, -1).to(torch.int32)
    live = torch.arange(capacity, device=dev) < state.n
    bf, bi, _ = _gather_state(state, group)
    blive = comm.all_gather(live.to(torch.uint8), group).bool()
    uv2pt = comm.all_gather(uv2pt, group)

    # one weighted voxel merge of all chunks, replicated (an eager call in
    # the reference: a true division by the radius)
    m = sparsify.voxel_merge(bf[:, 0:3], bf[:, 3:6], bf[:, 6:9], bi[:, 0], bi[:, 1], blive,
                             radius, min_cosine)
    dest, total = sparsify.compact_slots(m.counts)
    cap_out = m.num_cells
    merged = _compact((m.points, m.normals, m.colors, m.counts, m.occurences),
                      torch.where(m.counts > 0, dest, cap_out), cap_out, total)
    remap = torch.where(m.cell_of_input >= 0,
                        dest[m.cell_of_input.clamp(0, cap_out - 1).long()], -1)
    return merged, _remap(uv2pt, remap)


def _owner_hash(pos: torch.Tensor, region: float, ndev: int) -> torch.Tensor:
    """The rank that owns a position: the 3-prime hash of its region-grid
    cell, mod ndev (int32 arithmetic, wrapping as XLA's does). The division
    by the constant region is a product with its float32 reciprocal, as
    XLA computes it in the reference's program."""
    inv = torch.full((), np.float32(1) / np.float32(region), dtype=torch.float32,
                     device=pos.device)
    cell = _floor_to_int32(pos * inv)
    h = (cell[..., 0] * 73856093) ^ (cell[..., 1] * 19349663) ^ (cell[..., 2] * 83492791)
    return (h & 0x7FFFFFFF) % ndev


@torch.no_grad()
def fuse_session_spatial_sharded(mesh, Ks, quats_wxyz, translations, points, normals, colors,
                                 valid, *, height: int, width: int, radius: float,
                                 min_cosine: float, max_depth: float, capacity: int,
                                 candidate_px: int = 1, window: Optional[int] = None,
                                 window_policy: str = "newest", region_factor: float = 8.0,
                                 axis: str = "dp") -> Tuple[FusionState, torch.Tensor]:
    """Fuse a session with the sparse buffer split spatially over `axis`;
    `capacity` and `window` are each rank's (choose window about the
    one-device window / D to match a one-device run's merges). Returns the
    compacted state of D * capacity slots and uv2pt [F, H*W] int32 into
    it, on every rank.

    Mirrors `fusion._fuse_frame` stage by stage with the collectives in
    between; a change to the frame step must come here too (the tests
    hold one rank bit-identical to `fusion.fuse_session`). Its packing is
    the reference's own: (ndev * W).bit_length() id bits and the depth in
    the rest (at least 6 bits), always the packed min (the one-device
    step's exact-depth rounds below 8 depth bits quantise differently)."""
    if window_policy not in ("newest", "split"):
        raise ValueError(f"unknown window_policy {window_policy!r}")
    group = mesh.get_group(axis)
    ndev, r = comm.size(group), comm.rank(group)
    dev = mesh_device(mesh)
    half = candidate_px
    gh, gw = -(-height // half), -(-width // half)
    ncells = gh * gw
    W = capacity if (window is None or window >= capacity) else int(window)
    Wa = W // 2 if (W < capacity and window_policy == "split") else 0
    bits = max(1, (ndev * W).bit_length())
    zbits = 31 - bits
    assert zbits >= 6, (f"ndev*window = {ndev * W} needs {bits} id bits, leaving {zbits} "
                        "depth bits (< 6); lower `window` or per-device `capacity`")
    idmask = (1 << bits) - 1
    region = float(region_factor) * float(radius)
    extent = fusion._frame_extent_cells(max_depth, radius)

    K, quats, trans, fps, fns, fcs, fvs = fusion._session_tensors(
        dev, Ks, quats_wxyz, translations, points, normals, colors, valid)
    M, R = camera.projection_matrices(K, quats)
    plane_pts, plane_ns = camera.frustum_world_planes(K, width, height, quats, trans, max_depth)
    slot_ids = torch.arange(capacity, dtype=torch.int32, device=dev)
    lw = torch.arange(W, dtype=torch.int32, device=dev)
    ranks = torch.arange(ndev, dtype=torch.int32, device=dev)

    # this rank's buffer, written in place by the steps; `state` its view
    buf = fusion._buffer(fusion._empty_state(capacity, dev))
    state = fusion._live(buf)

    def append_owned(sp):
        """Append the leftover cells this rank owns; the global cell -> slot
        map [C] through one psum."""
        owned = (_owner_hash(sp.points, region, ndev) == r) & (sp.counts > 0)
        c2s = fusion._append_sparsified(
            buf, sp._replace(counts=torch.where(owned, sp.counts, 0)), capacity)
        gslot = torch.where(c2s >= 0, r * capacity + c2s + 1, 0)
        return comm.psum(gslot, group) - 1

    def pixel_slots(sp, c2s, matched, matched_slot):
        """uv2pt of a frame: a matched pixel's slot, else its leftover
        cell's slot (-1 for a dropped cell or an invalid pixel)."""
        lp = sp.cell_of_pixel
        return torch.where(~matched & (lp >= 0), c2s[lp.clamp(0, sp.num_cells - 1).long()],
                           matched_slot).to(torch.int32)

    def sparsify_frame(f, keep):
        return sparsify.patch_sparsify(fps[f], fns[f], fcs[f], keep, height, width, radius,
                                       min_cosine, extent_cells=extent, const_radius=True)

    sp = sparsify_frame(0, fvs[0])
    c2s = append_owned(sp)
    uv2pt = torch.empty((len(quats), height * width), dtype=torch.int32, device=dev)
    uv2pt[0] = pixel_slots(sp, c2s, torch.zeros_like(fvs[0]), -1)

    for f in range(1, len(quats)):
        # 1-2. cull this rank's slots; window from the frustum test alone
        inter = intersections.points_inside_polyhedra(state.points, plane_pts[f], plane_ns[f])
        inter = inter & (slot_ids < state.n)
        _, idx_w = fusion._window(inter, slot_ids, capacity, W, window_policy)
        if idx_w is None:
            pts_w, nrm_w, inter_w = state.points, state.normals, inter
            bases_mine = torch.zeros(2, dtype=torch.int64, device=dev)
        else:
            pts_w, nrm_w, inter_w = state.points[idx_w], state.normals[idx_w], inter[idx_w]
            bases_mine = torch.stack([idx_w[0], idx_w[Wa]])  # (a0, b0)
        u_w, v_w, z_w = camera.project_with_matrices(pts_w, M[f], R[f], trans[f])
        ok_w = inter_w & (z_w > 0) & (u_w >= 0) & (u_w < width) & (v_w >= 0) & (v_w < height)

        # 3a. packed z-buffer into the cell grid, then the global nearest
        # and second candidates of every cell by two pmins
        cell = (v_w // half) * gw + (u_w // half) if half > 1 else v_w * gw + u_w
        cell_t = torch.where(ok_w, cell, ncells)  # ncells: the trash cell
        packed = (zbuffer._zq(z_w, zbits, max_depth) << bits) | (r * W + lw)
        gmin1 = comm.pmin(zbuffer._segment_min(packed, cell_t, ncells + 1, INT32_MAX)[:ncells],
                          group)
        is_winner = ok_w & (packed == gmin1[cell.clamp(0, ncells - 1).long()])
        gmin2 = comm.pmin(zbuffer._segment_min(packed, torch.where(is_winner, ncells, cell_t),
                                               ncells + 1, INT32_MAX)[:ncells], group)
        wids = torch.stack([torch.where(g != INT32_MAX, g & idmask, -1) for g in (gmin1, gmin2)],
                           dim=1)  # [ncells, 2]

        # 3b. owners contribute their candidates' rows, zeros elsewhere:
        # one psum gives every rank the [ncells, 2, 6] grid
        mine_c = (wids >= 0) & (wids // W == r)
        rows = torch.cat([pts_w, nrm_w], dim=1)[(wids % W).clamp(0, W - 1).long()]
        grid = comm.psum(torch.where(mine_c[..., None], rows, 0.0), group).reshape(gh, gw, 12)
        match, matched = fusion._match_pixels(
            grid, wids.reshape(gh, gw, 2), fps[f], fns[f], fvs[f], height=height, width=width,
            half=half, radius=radius, min_cosine=min_cosine)

        # 4. merge this rank's matches into its window
        mine = matched & (match // W == r)
        fusion._merge_window(state, idx_w, pts_w, nrm_w,
                             fusion._match_sums(fps[f], fns[f], fcs[f], mine, match % W, W))

        # 5. leftovers: replicated sparsify, owned append
        sp = sparsify_frame(f, fvs[f] & ~matched)
        c2s = append_owned(sp)

        # window-global candidate id -> global slot, from every rank's
        # window bases (a0, b0) through one psum
        bases = comm.psum(torch.where((ranks == r)[:, None], bases_mine[None], 0), group)
        r_of = (match // W).clamp(0, ndev - 1).long()
        lw_of = match % W
        seg = torch.where(lw_of < Wa, bases[r_of, 0] + lw_of, bases[r_of, 1] - Wa + lw_of)
        uv2pt[f] = pixel_slots(sp, c2s, matched, torch.where(matched, r_of * capacity + seg, -1))

    # exact compaction of the ranks' live prefixes (no reconciliation)
    bf, bi, n_per = _gather_state(state, group)
    total_cap = ndev * capacity
    live = (slot_ids[None] < n_per[:, None]).reshape(total_cap)
    dest = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    merged = _compact((bf[:, 0:3], bf[:, 3:6], bf[:, 6:9], bi[:, 0], bi[:, 1]),
                      torch.where(live, dest, total_cap), total_cap, live.sum())
    return merged, _remap(uv2pt, torch.where(live, dest, -1))
