"""Plain reference of the main path: one RGB-D session -> fused cloud ->
per-point classes -> instances -> OBB merge.

Written from the semantics of the reference flow (process3D's fusion with
its merge radius and normal cone, one vote per (point, class, frame), the
thresholded argmax, same-class radius components, intersecting same-parent
OBBs merged), in plain PyTorch, NumPy and SciPy. It imports nothing of the
program. Where the program's fusion engine makes a choice that the
semantics leave open (the merge window, the candidate z-buffer, voxel
order, the overflow repair), this follows the same rule, so that the two
agree up to rounding; the arithmetic is the straightforward one (matrix
products for the camera, plain sums and norms), not the program's.

`mode` is "float32" (TF32 off, the configuration's) or "tf32" (the control:
every matrix product's operands rounded to TF32 first, one step below).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

INT32_MAX = 2147483647


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to even):
    what a TF32 product does to its operands, on any device."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b in float32, its operands first rounded to TF32 in "tf32" mode
    (the control)."""
    if mode == "tf32":
        a, b = tf32(a), tf32(b)
    elif mode != "float32":
        raise ValueError(f"unknown precision {mode!r}")
    return a @ b


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz unit quaternions -> [..., 3, 3] rotation matrices."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def seg_sum(values: torch.Tensor, seg: torch.Tensor, nseg: int) -> torch.Tensor:
    """Row sums per segment id in [0, nseg); ids >= nseg are dropped. Each
    dropped row gets a trash row of its own, and on the card the sums are
    `index_put_` with accumulate (deterministic)."""
    n = values.shape[0]
    idx = torch.where(seg < nseg, seg.long(), nseg + torch.arange(n, device=values.device))
    out = values.new_zeros((nseg + n, *values.shape[1:]))
    if values.is_cuda:
        out.index_put_((idx,), values, accumulate=True)
    else:
        out.index_add_(0, idx, values)
    return out[:nseg]


def seg_min(values: torch.Tensor, seg: torch.Tensor, nseg: int, identity) -> torch.Tensor:
    out = torch.full((nseg,), identity, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg.long(), values, reduce="amin", include_self=True)


def session_geometry(depth, rgb, K, quats_wxyz, trans, device, mode):
    """Back-projection of every pixel: world points and camera-facing world
    normals [F, H*W, 3], colours in [0, 1] and camera depth [F, H*W]."""
    F_, H, W = depth.shape
    d = torch.as_tensor(depth, dtype=torch.float32, device=device)
    Kinv = torch.as_tensor(np.linalg.inv(np.asarray(K, np.float64)), dtype=torch.float32,
                           device=device)
    u = torch.arange(W, dtype=torch.float32, device=device).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    pix = torch.stack([u, v, torch.ones_like(u)], -1).reshape(-1, 3)
    rays = mm(pix, Kinv.T, mode)  # z = 1
    cam = (rays[None] * d.reshape(F_, -1, 1)).reshape(F_, H, W, 3)
    R = quat_matrix(torch.as_tensor(quats_wxyz, dtype=torch.float32, device=device))
    t = torch.as_tensor(trans, dtype=torch.float32, device=device)
    world = mm(cam.reshape(F_, -1, 3), R.transpose(1, 2), mode) + t[:, None, :]
    # central differences on the pixel grid, edge-replicated borders
    p = torch.cat([cam[:, :1], cam, cam[:, -1:]], dim=1)
    p = torch.cat([p[:, :, :1], p, p[:, :, -1:]], dim=2)
    du = p[:, 1:-1, 2:] - p[:, 1:-1, :-2]
    dv = p[:, 2:, 1:-1] - p[:, :-2, 1:-1]
    n = unit(torch.cross(du, dv, dim=-1))
    n = torch.where(((n * cam).sum(-1) > 0)[..., None], -n, n)
    normals = mm(n.reshape(F_, -1, 3), R.transpose(1, 2), mode)
    colors = torch.as_tensor(rgb, device=device).reshape(F_, -1, 3).float() / 255.0
    return world, normals, colors, d.reshape(F_, -1)


def voxel_merge(points, normals, colors, weights, occ, valid, radius, min_cosine,
                shift=(0.0, 0.0, 0.0)):
    """Weighted voxel merge: rows grouped by voxel of side `radius` (grid
    anchored at the valid minimum less `shift`), voxels in (x, y, z) order,
    rows in input order; each voxel's rows whose normal disagrees with the
    voxel's weighted mean normal (cos <= min_cosine) form a second cell.
    Returns (points, normals, colors, counts, occ) [2V] cells and the cell of
    each row [N] (-1 invalid)."""
    n = points.shape[0]
    dev = points.device
    pmin = torch.where(valid[:, None], points, 3.0e38).amin(dim=0)
    pmin = pmin - torch.tensor(shift, dtype=torch.float32, device=dev)
    vox = torch.floor((points - pmin) / radius).clamp(min=0).to(torch.int64)
    key = (vox[:, 0] << 42) | (vox[:, 1] << 21) | vox[:, 2]
    key = torch.where(valid, key, torch.iinfo(torch.int64).max)
    sk, order = torch.sort(key, stable=True)
    newrun = torch.ones(n, dtype=torch.bool, device=dev)
    newrun[1:] = sk[1:] != sk[:-1]
    newrun &= sk != torch.iinfo(torch.int64).max
    run_sorted = torch.cumsum(newrun.long(), 0) - 1
    run = torch.empty(n, dtype=torch.int64, device=dev)
    run[order] = run_sorted
    run = torch.where(valid, run, n)
    w = weights.float()
    mean_n = unit(seg_sum(normals * w[:, None], run, n))
    agree = (normals * mean_n[run.clamp(max=n - 1)]).sum(-1)
    cell = torch.where(valid, 2 * run + (agree <= min_cosine).long(), 2 * n)
    acc = seg_sum(torch.cat([w[:, None], occ.float()[:, None], points * w[:, None],
                             colors * w[:, None], normals * w[:, None]], 1), cell, 2 * n)
    cnt = acc[:, 0]
    den = cnt[:, None].clamp(min=1e-12)
    return (acc[:, 2:5] / den, unit(acc[:, 8:11]), acc[:, 5:8] / den,
            torch.round(cnt).to(torch.int64), acc[:, 1].round().to(torch.int64),
            torch.where(valid, cell, -1))


class Engine:
    """The fused cloud of a session, frame by frame."""

    def __init__(self, capacity, radius, min_cosine, max_depth, K, hw, device, mode):
        self.mode = mode
        self.cap, self.r, self.mc, self.maxd = capacity, radius, min_cosine, max_depth
        self.H, self.W = hw
        self.dev = device
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=device)
        self.P = torch.zeros((capacity, 3), device=device)
        self.N = torch.zeros((capacity, 3), device=device)
        self.C = torch.zeros((capacity, 3), device=device)
        self.cnt = torch.zeros(capacity, dtype=torch.int64, device=device)
        self.occ = torch.zeros(capacity, dtype=torch.int64, device=device)
        self.n = 0

    def append(self, pts, nrm, clr, valid):
        """Voxel-sparsify the valid pixels and append the cells; returns the
        slot of each pixel (-1 none)."""
        ones = torch.ones(pts.shape[0], dtype=torch.int64, device=self.dev)
        cp, cn, cc, ccnt, _, cell = voxel_merge(pts, nrm, clr, ones, ones, valid, self.r,
                                                self.mc)
        occupied = ccnt > 0
        slot = self.n + torch.cumsum(occupied.long(), 0) - 1
        keep = occupied & (slot < self.cap)
        s = slot[keep]
        self.P[s], self.N[s], self.C[s] = cp[keep], cn[keep], cc[keep]
        self.cnt[s], self.occ[s] = ccnt[keep], 1
        self.n = min(self.n + int(occupied.sum()), self.cap)
        slot = torch.where(keep, slot, -1)
        return torch.where(cell >= 0, slot[cell.clamp(min=0)], -1)

    def frustum(self, R, t):
        """Five inward planes (points, normals) of the frame's view volume."""
        Kinv = torch.linalg.inv(self.K.double()).float()
        H, W = self.H, self.W
        pix = torch.tensor([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1], [W / 2, H / 2, 1]],
                           dtype=torch.float32, device=self.dev)
        c = mm(mm(pix, Kinv.T, self.mode), R.T, self.mode) + t
        corners, look = c[:4], unit(c[4] - t)
        nrm = unit(torch.cross(corners - t, torch.roll(corners, -1, 0) - t, dim=-1))
        pts = torch.cat([t.expand(4, 3), (t + self.maxd * look)[None]])
        return pts, torch.cat([nrm, -look[None]])

    def fuse_frame(self, R, t, pts, nrm, clr, valid, window: Optional[int]):
        dev, cap = self.dev, self.cap
        H, W = self.H, self.W
        slots = torch.arange(cap, device=dev)
        pp, pn = self.frustum(R, t)
        inside = (mm(self.P, pn.T, self.mode) - (pn * pp).sum(-1) >= 0).all(-1) & (slots < self.n)
        has = bool(inside.any())
        minv = int(slots[inside].min()) if has else cap
        maxv = int(slots[inside].max()) if has else -1
        span = max(maxv - minv + 1, 0)
        Wn = cap if window is None or window >= cap else window
        if Wn >= cap:
            idx = slots
        else:  # the oldest Wn // 2 visible slots and the newest rest
            Wa, Wb = Wn // 2, Wn - Wn // 2
            a0 = min(max(minv, 0), cap - Wn)
            b0 = min(max(maxv - Wb + 1, a0 + Wa), cap - Wb)
            ar = torch.arange(Wn, device=dev)
            idx = torch.where(ar < Wa, a0 + ar, b0 - Wa + ar)
        pw, nw, cw = self.P[idx], self.N[idx], self.C[idx]
        rel = pw - t
        cam = mm(rel, R, self.mode)  # world -> camera: R^T (p - t)
        pr = mm(cam, self.K.T, self.mode)
        z = cam[:, 2]
        u = torch.floor(pr[:, 0] / pr[:, 2] + 1e-4)
        v = torch.floor(pr[:, 1] / pr[:, 2] + 1e-4)
        ok = inside[idx] & (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        ncell = H * W
        cell = torch.where(ok, v * W + u, ncell).long()
        # the two nearest window slots of every pixel cell: depth quantized
        # to 31 - id_bits bits, packed with the window index, ties to the lowest
        id_bits = max(1, Wn.bit_length())
        zb = 31 - id_bits
        zq = torch.clamp(z * float(1 << zb) / self.maxd, 0, (1 << zb) - 1).to(torch.int64)
        packed = (zq << id_bits) | torch.arange(Wn, device=dev)
        packed = torch.where(ok, packed, INT32_MAX)
        m1 = seg_min(packed, cell, ncell + 1, INT32_MAX)
        win = ok & (packed == m1[cell])
        m2 = seg_min(packed, torch.where(win, ncell, cell), ncell + 1, INT32_MAX)
        mask = (1 << id_bits) - 1
        cands = torch.stack([torch.where(m1[:ncell] == INT32_MAX, -1, m1[:ncell] & mask),
                             torch.where(m2[:ncell] == INT32_MAX, -1, m2[:ncell] & mask)], 1)
        cands = cands.reshape(H, W, 2)
        # every pixel against the 18 candidates of its 3x3 cells, candidate
        # major, then offsets row-major; the nearest passing one wins
        padded = torch.full((H + 2, W + 2, 2), -1, dtype=torch.int64, device=dev)
        padded[1:-1, 1:-1] = cands
        cand = torch.stack([padded[dy:dy + H, dx:dx + W, c] for c in range(2)
                            for dy in range(3) for dx in range(3)], -1).reshape(-1, 18)
        safe = cand.clamp(min=0)
        dist = torch.linalg.vector_norm(pts[:, None, :] - pw[safe], dim=-1)
        cos = (nrm[:, None, :] * nw[safe]).sum(-1)
        passes = (cand >= 0) & (dist < self.r) & (cos > self.mc) & valid[:, None]
        best = torch.where(passes, dist, torch.inf).argmin(-1)
        matched = passes.any(-1)
        local = torch.where(matched, cand.gather(1, best[:, None])[:, 0], -1)
        # running means of the matched pixels into their slots
        ones = torch.ones((pts.shape[0], 1), device=dev)
        acc = seg_sum(torch.cat([ones, pts, clr, nrm], 1), torch.where(matched, local, Wn), Wn)
        c = acc[:, 0]
        touched = (c > 0)[:, None]
        den = (c + 1)[:, None]
        self.P[idx] = torch.where(touched, (acc[:, 1:4] + pw) / den, pw)
        self.N[idx] = torch.where(touched, unit(acc[:, 7:10] + nw), nw)
        self.C[idx] = torch.where(touched, (acc[:, 4:7] + cw) / den, cw)
        self.cnt[idx] += c.round().long()
        self.occ[idx] += touched[:, 0].long()
        slot = torch.where(matched, idx[local.clamp(min=0)], -1)
        new = self.append(pts, nrm, clr, valid & ~matched)
        return torch.where(matched, slot, new), span

    def dedup(self):
        """Merge duplicates of the live buffer in five passes on shifted
        grids; slots keep their append order. Returns old slot -> new slot."""
        h = self.r / 2
        cap, dev = self.cap, self.dev
        slot_map = None
        for shift in ((0, 0, 0), (h, h, h), (h, 0, 0), (0, h, 0), (0, 0, h)):
            live = torch.arange(cap, device=dev) < self.n
            mp, mn, mc, mcnt, mocc, cell = voxel_merge(self.P, self.N, self.C, self.cnt,
                                                       self.occ, live, self.r, self.mc, shift)
            C = mp.shape[0]
            rep = seg_min(torch.arange(cap, device=dev), torch.where(cell >= 0, cell, C),
                          C + 1, INT32_MAX)[:C]
            order = torch.argsort(rep, stable=True)
            rank = torch.empty(C, dtype=torch.int64, device=dev)
            rank[order] = torch.arange(C, device=dev)
            n_new = int((mcnt > 0).sum())
            take = order[:n_new]
            self.P.zero_(), self.N.zero_(), self.C.zero_(), self.cnt.zero_(), self.occ.zero_()
            self.P[:n_new], self.N[:n_new], self.C[:n_new] = mp[take], mn[take], mc[take]
            self.cnt[:n_new], self.occ[:n_new] = mcnt[take], mocc[take]
            self.n = n_new
            m = torch.where(live & (cell >= 0), rank[cell.clamp(min=0)], -1)
            slot_map = m if slot_map is None else torch.where(
                slot_map >= 0, m[slot_map.clamp(min=0)], -1)
        return slot_map


def vote_classify(uv2pt, masks, npts, nclasses, threshold, filter_classes=None):
    """One vote per distinct (point, class) of a frame; the argmax over the
    `filter_classes` columns (all classes when None; ties to the first),
    kept where it holds at least `threshold` of all the point's votes.
    Returns classes [npts] int64."""
    nc1 = nclasses + 1
    votes = torch.zeros(npts * nc1, dtype=torch.int64, device=uv2pt.device)
    for f in range(uv2pt.shape[0]):
        uv = uv2pt[f].long()
        cls = masks[f].long().clamp(0, nc1 - 1)
        key = torch.unique((uv * nc1 + cls)[uv >= 0])
        votes[key] += 1
    votes = votes.reshape(npts, nc1)
    total = votes.sum(-1)
    if filter_classes is None:
        vmax, arg = votes.max(-1)
    else:
        fc = torch.as_tensor(list(filter_classes), device=votes.device)
        vmax, col = votes[:, fc].max(-1)
        arg = fc[col]
    ok = (total > 0) & (vmax > 0) & (vmax.float() / total.clamp(min=1).float() >= threshold)
    return torch.where(ok, arg, nclasses)


def instances(points: np.ndarray, classes: np.ndarray, radius: float, nclasses: int,
              min_pts: int):
    """Same-class components of every pair within `radius`: ids [n] and
    info dicts (id, category_id, area), the unclassified class first, then
    components by their smallest point index; components below `min_pts`
    points are pooled into the unclassified entry."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    n = len(points)
    pairs = cKDTree(points.astype(np.float64)).query_pairs(radius, output_type="ndarray")
    pairs = pairs[classes[pairs[:, 0]] == classes[pairs[:, 1]]]
    inst = classes != nclasses
    pairs = pairs[inst[pairs[:, 0]]]
    g = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    ids = np.zeros(n, np.int64)
    info = []
    pool = None
    if (~inst).any():
        pool = 0
        info.append({"id": 0, "category_id": nclasses, "area": int((~inst).sum())})
    members = np.nonzero(inst)[0]
    if len(members):
        roots = np.full(comp.max() + 1, n, np.int64)
        np.minimum.at(roots, comp[members], members)
        groups = {}
        for m in members:
            groups.setdefault(int(roots[comp[m]]), []).append(m)
        for root in sorted(groups):
            g_ = np.asarray(groups[root])
            if len(g_) < min_pts:
                if pool is None:
                    pool = len(info)
                    info.append({"id": pool, "category_id": nclasses, "area": 0})
                info[pool]["area"] += len(g_)
                ids[g_] = pool
            else:
                ids[g_] = len(info)
                info.append({"id": len(info), "category_id": int(classes[root]),
                             "area": len(g_)})
    return ids, info


def _pca_box(pts):
    mean = pts.mean(0)
    c = pts - mean
    _, vecs = np.linalg.eigh(c.T @ c / len(pts) + 1e-9 * np.eye(3))
    axes = vecs.T
    proj = c @ axes.T
    lo, hi = proj.min(0), proj.max(0)
    return mean + ((hi + lo) / 2) @ axes, axes, (hi - lo) / 2


def merge_boxes(points: np.ndarray, ids: np.ndarray, info: list, parents: dict):
    """Instances of one parent class whose PCA boxes (of >= 4 points) share
    a cloud point merge into the earliest; the first entry never merges.
    Returns the merged ids."""
    K = len(info)
    pts = points.astype(np.float64)
    inside = np.zeros((K, len(pts)), bool)
    ok = np.zeros(K, bool)
    for k, inf in enumerate(info):
        m = pts[ids == inf["id"]]
        if len(m) >= 4:
            ok[k] = True
            ctr, axes, half = _pca_box(m)
            inside[k] = np.all(np.abs((pts - ctr) @ axes.T) <= half + 1e-5, axis=1)
    co = (inside.astype(np.float32) @ inside.T.astype(np.float32)) > 0
    par = [parents.get(str(int(i["category_id"]))) for i in info]
    root = list(range(K))

    def find(a):
        while root[a] != a:
            a = root[a]
        return a

    for a in range(1, K):
        for b in range(a + 1, K):
            if co[a, b] and ok[a] and ok[b] and par[a] is not None and par[a] == par[b]:
                ra, rb = find(a), find(b)
                if ra != rb:
                    root[max(ra, rb)] = min(ra, rb)
    out = ids.copy()
    for k in range(K):
        r = find(k)
        if r != k:
            out[ids == info[k]["id"]] = info[r]["id"]
    return out


def auto_window(seed_cells: int, capacity: int) -> Optional[int]:
    if capacity <= (1 << 16):
        return None
    w = 1 << max(int(math.ceil(math.log2(max(8 * seed_cells, 2)))), 13)
    return None if w >= capacity else w


@torch.no_grad()
def run_session(depth, rgb, masks, K, quats_wxyz, trans, cfg: dict, device, mode="float32",
                frames=None, segment=None):
    """The whole flow on one session, its labels from `masks` [F, H, W], or,
    where `masks` is None, from `segment` (colours [F, H, W, 3] in [0, 1] ->
    masks [F, H*W]). Returns a dict: n, classes [n], instance ids [n] after
    the merge, and, for the frames `frames`, the back-projected points and
    normals [f, H*W, 3] and uv2pt [f, H*W]."""
    F_, H, W = depth.shape
    pts, nrm, clr, d = session_geometry(depth, rgb, K, quats_wxyz, trans, device, mode)
    valid = (d > cfg["min_depth"]) & (d <= cfg["max_depth"])
    mc = float(np.cos(np.deg2rad(cfg["angle_deg"])))
    eng = Engine(cfg["capacity"], cfg["radius"], mc, cfg["max_depth"], K, (H, W), device,
                 mode)
    R = quat_matrix(torch.as_tensor(quats_wxyz, dtype=torch.float32, device=device))
    t = torch.as_tensor(trans, dtype=torch.float32, device=device)
    uv2pt = torch.empty((F_, H * W), dtype=torch.int64, device=device)
    uv2pt[0] = eng.append(pts[0], nrm[0], clr[0], valid[0])
    window = auto_window(eng.n, cfg["capacity"]) if cfg["window"] == "auto" \
        else cfg["window"]
    overflow = 0
    for f in range(1, F_):
        uv2pt[f], span = eng.fuse_frame(R[f], t[f], pts[f], nrm[f], clr[f], valid[f], window)
        overflow += window is not None and span > window
    if masks is None:
        masks_d = segment(clr.reshape(F_, H, W, 3))
    else:
        masks_d = torch.as_tensor(masks, device=device).reshape(F_, -1)
    if overflow and cfg["auto_dedup"]:
        slot_map = eng.dedup()
        uv2pt = torch.where(uv2pt >= 0, slot_map[uv2pt.clamp(min=0)], -1)
    n = eng.n
    classes = vote_classify(uv2pt, masks_d, cfg["capacity"], cfg["nclasses"],
                            cfg["threshold"], cfg.get("filter_classes"))[:n].cpu().numpy()
    points = eng.P[:n].cpu().numpy()
    frames = list(range(F_)) if frames is None else list(frames)
    out = {"n": n, "classes": classes, "points": points, "overflow_frames": int(overflow),
           "geom_points": pts[frames].cpu().numpy(), "geom_normals": nrm[frames].cpu().numpy(),
           "valid": valid[frames].cpu().numpy(), "uv2pt": uv2pt[frames].cpu().numpy()}
    ids, info = instances(points, classes, cfg["split_radius"], cfg["nclasses"],
                          cfg["min_pts_per_inst"])
    out["instance_ids"] = merge_boxes(points, ids, info, cfg["parents"]) \
        if cfg["merge_obbs"] and info else ids
    return out
