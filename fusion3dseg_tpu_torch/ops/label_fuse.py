"""Session-scale label fusion: project + z-buffer + vote + classify.

Counterpart of `fusion3dseg_tpu/ops/label_fuse.py`, the path that lifts 2D
masks onto a session-wide point cloud. Per frame, each point wins at most
its nearest visible pixel (z-buffer spec: nearest at max_depth/2^11
resolution, ties -> lowest id) and takes that pixel's mask class as one
vote. The votes land in a [F, N] uint8 winner-class matrix C, and one
histogram pass (kernel K1, `ops/histogram.py`) classifies every point by
the thresholded argmax.

The host builders (`build_cell_index`, `plan_window_buckets`,
`build_view_index`) are NumPy copies of the JAX package's, so both packages
take the same arrays. The device paths run eagerly: a Python loop over the
frames, each frame writing its row of C in place. The `tpu_` names are kept
so that a test calls each function's counterpart by the same name; each
builder returns a `run` callable as the JAX one returns its jitted program.
"""

from __future__ import annotations

import numpy as np
import torch

from fusion3dseg_tpu_torch.cuda import resolve_device
from fusion3dseg_tpu_torch.geometry import camera
from fusion3dseg_tpu_torch.ops.histogram import (
    histogram_classify,
    histogram_classify_reference,
    row_pitch,
)
from fusion3dseg_tpu_torch.ops.zbuffer import (
    INT32_MAX,
    lex_combine_gid_sharded,
    packed_pmin,
    packed_pmin_gid_sharded,
)
from fusion3dseg_tpu_torch.utils import timing

INVALID = 255


def build_view_index(points, K, quats, trans, hw, nbuckets=512, subsample=16, pad=3,
                     round_to=32768):
    """View-coherent point index: points sorted by azimuth around the
    trajectory centroid so each frame's visible set is one contiguous slice
    of a static length M (dilated by `pad` buckets; the sorted order is
    extended so circular windows become contiguous slices).

    Returns (order_ext [N+wrap] original ids, starts [F] int32, M).
    """
    c = trans.mean(0)
    az = np.arctan2(points[:, 2] - c[2], points[:, 0] - c[0])
    bucket = ((az + np.pi) / (2 * np.pi) * nbuckets).astype(np.int64) % nbuckets
    order = np.argsort(bucket, kind="stable")
    bsorted = bucket[order]
    offsets = np.searchsorted(bsorted, np.arange(nbuckets + 1))

    h, w = hw
    sub = points[::subsample]
    sub_bucket = bucket[::subsample]
    windows = []
    for f in range(len(quats)):
        q = quats[f]
        qc = np.array([q[0], -q[1], -q[2], -q[3]])
        rel = sub - trans[f]
        vq = qc[1:]
        vxp = np.cross(vq, rel)
        cam = rel + 2.0 * (qc[0] * vxp + np.cross(vq, vxp))
        z = cam[:, 2]
        with np.errstate(all="ignore"):
            u = (K[0, 0] * cam[:, 0] + K[0, 2] * z) / z
            v = (K[1, 1] * cam[:, 1] + K[1, 2] * z) / z
        ok = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        vis = np.unique(sub_bucket[ok])
        if len(vis) == 0:
            windows.append((0, 1))
            continue
        present = np.zeros(nbuckets, bool)
        present[vis] = True
        idx = np.nonzero(present)[0]
        gaps = np.diff(np.r_[idx, idx[0] + nbuckets])
        big = int(np.argmax(gaps))
        start_b = (int(idx[(big + 1) % len(idx)]) - pad) % nbuckets
        width_b = min(nbuckets, nbuckets - int(gaps.max()) + 1 + 2 * pad)
        windows.append((start_b, width_b))

    def window_count(start_b, width_b):
        end_b = start_b + width_b
        if end_b <= nbuckets:
            return offsets[end_b] - offsets[start_b]
        return (offsets[nbuckets] - offsets[start_b]) + offsets[end_b - nbuckets]

    counts = np.asarray([window_count(s, wd) for s, wd in windows])
    M = int(counts.max())
    n = len(points)
    M = int(-(-M // round_to) * round_to)  # round up
    # cap near the cloud size, keeping M % round_to == 0
    M = min(M, int(-(-n // round_to) * round_to))
    # extend the sorted order so every circular window is a contiguous slice
    # and slices of length M stay in bounds even when M > n
    reps = -(-(M + n) // n)
    order_ext = np.tile(order, reps)[: max(n + min(M, n), M)].astype(np.int32)
    starts = np.asarray([offsets[s] for s, _ in windows], np.int32)
    starts = np.minimum(starts, len(order_ext) - M)
    build_view_index.last_window_counts = counts  # diagnostic
    return order_ext, starts, M


def build_cell_index(points, K, quats, trans, hw, cell_size=256, margin=2e-3):
    """Frustum-culling cell index: equal-count KD cells + per-frame visible
    cell lists from a conservative AABB-vs-frustum test.

    Points are split into 2^d equal-count cells by recursive median cuts;
    each frame keeps the cells whose AABB passes every frustum half-space
    (p-vertex test, planes dilated by `margin` meters). Padding is exact,
    not masked: cells shorter than cell_size repeat their first member and
    frame lists pad with cell 0, and duplicates are no-ops under the min
    z-buffer and the per-pixel winner vote.

    Returns (cells_table [NC, cell_size, 4] f32 (xyz + int32 id bits),
    cell_lists [F, Kmax] int32, counts [F] int32 true visible-cell counts).
    """
    n = len(points)
    h, w = hw
    depth = max(0, int(np.floor(np.log2(max(n // cell_size, 1)))))
    ncells = 1 << depth

    order = np.arange(n)
    segs = [(0, n)]
    for _ in range(depth):
        nxt = []
        for a, b in segs:
            idx = order[a:b]
            P = points[idx]
            ax = int(np.argmax(P.max(0) - P.min(0)))
            m = (b - a) // 2
            part = np.argpartition(P[:, ax], m)
            order[a:b] = idx[part]
            nxt += [(a, a + m), (a + m, b)]
        segs = nxt
    segs = np.asarray(segs)

    ps = points[order]
    cs = int((segs[:, 1] - segs[:, 0]).max())
    cells_table = np.empty((ncells, cs, 4), np.float32)
    lo = np.empty((ncells, 3)); hi = np.empty((ncells, 3))
    for ci, (a, b) in enumerate(segs):
        take = np.r_[np.arange(a, b), np.full(cs - (b - a), a)]
        cells_table[ci, :, :3] = ps[take]
        cells_table[ci, :, 3] = order[take].astype(np.int32).view(np.float32)
        lo[ci] = ps[a:b].min(0); hi[ci] = ps[a:b].max(0)

    # frustum planes in world space, the same inequalities as the
    # projection's bounds test, dilated by `margin` meters
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ncam = np.array([
        [fx, 0, cx], [-fx, 0, w - cx], [0, fy, cy], [0, -fy, h - cy],
        [0, 0, 1.0],
    ])
    F = len(quats)
    counts = np.empty(F, np.int32)
    lists = []
    for f in range(F):
        q = quats[f]
        wq, x, y, zz = q[0], -q[1], -q[2], -q[3]  # conj: world->camera
        R = np.array([
            [1 - 2 * (y * y + zz * zz), 2 * (x * y - wq * zz), 2 * (x * zz + wq * y)],
            [2 * (x * y + wq * zz), 1 - 2 * (x * x + zz * zz), 2 * (y * zz - wq * x)],
            [2 * (x * zz - wq * y), 2 * (y * zz + wq * x), 1 - 2 * (x * x + y * y)],
        ])
        m = ncam @ R
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        d = -(m @ trans[f]) + margin
        pv = np.where(m[:, None, :] > 0, hi[None], lo[None])  # [5, NC, 3]
        s = np.einsum("pc,pkc->pk", m, pv) + d[:, None]
        vis = np.nonzero((s >= 0).all(0))[0]
        counts[f] = len(vis)
        lists.append(vis)
    Kmax = max(1, int(counts.max()))
    cell_lists = np.zeros((F, Kmax), np.int32)  # pad with cell 0 (harmless)
    for f, vis in enumerate(lists):
        cell_lists[f, : len(vis)] = vis
    build_cell_index.last_cell_size = cs  # diagnostic
    return cells_table, cell_lists, counts


def plan_window_buckets(counts, nbuckets=8, round_to=8192, max_window=None):
    """Group frames into window-size classes for right-sized frame loops.

    Sorts frames by window count, splits them into `nbuckets` equal-frame
    groups, and sizes each group's window to its own maximum (rounded up to
    `round_to`, clamped to `max_window`).

    Returns:
      perm: [F] int64 frame permutation (frames grouped by bucket).
      sizes: per-bucket frame counts (sum == F).
      Ms: per-bucket window lengths (same length as sizes).
    """
    counts = np.asarray(counts)
    F = len(counts)
    order = np.argsort(counts, kind="stable")
    edges = [round(i * F / nbuckets) for i in range(nbuckets + 1)]
    perm, sizes, Ms = [], [], []
    for a, b in zip(edges[:-1], edges[1:]):
        if a >= b:
            continue
        grp = order[a:b]
        Mk = int(-(-int(counts[grp].max()) // round_to) * round_to)
        if max_window is not None:
            Mk = min(Mk, int(max_window))
        perm.extend(grp.tolist())
        if Ms and Ms[-1] == Mk:
            sizes[-1] += len(grp)
        else:
            Ms.append(Mk)
            sizes.append(len(grp))
    return np.asarray(perm, np.int64), sizes, Ms


# --------------------------------------------------------------- device paths


def _histogram_classify(C, nclasses, threshold, use_cuda_hist=True):
    """Classify the [F, N] winner-class matrix: through kernel K1's wrapper
    (the CUDA kernel on the card, its plain version on the CPU), or, with
    use_cuda_hist=False, through the plain version on any device."""
    if use_cuda_hist:
        return histogram_classify(C, nclasses, threshold)
    return histogram_classify_reference(C, nclasses, threshold)


def _dev(x, dev, dtype=None):
    """A host array or a tensor, as a tensor on `dev`."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=dev, dtype=dtype)


class _Session:
    """A session's per-frame arrays on the device, with every frame's
    projection matrices built in one batched product."""

    def __init__(self, K, quats, trans, masks, dev):
        with timing.range("wait.lift_upload"):  # the host arrays among them
            K = _dev(K, dev, torch.float32)
            quats = _dev(quats, dev, torch.float32)
            self.trans = _dev(trans, dev, torch.float32)
            self.masks = _dev(masks, dev, torch.uint8)
        self.M, self.R = camera.projection_matrices(K, quats)
        self.nframes = len(quats)

    def winners(self, f, pts, ids, hw, nsub, id_bits, z_bits):
        """Frame f's z-buffer: (win_id [H*W] int32, has [H*W] bool)."""
        h, w = hw
        u, v, z = camera.project_with_matrices(pts, self.M[f], self.R[f], self.trans[f])
        ones = torch.ones_like(z, dtype=torch.bool)
        if nsub == 1:
            pmin = packed_pmin(u, v, z, ids, ones, h, w, id_bits=id_bits,
                               z_bits=z_bits, drop_invalid=True)
            return pmin & ((1 << id_bits) - 1), pmin != INT32_MAX
        pmin_sub = packed_pmin_gid_sharded(u, v, z, ids, ones, h, w, nsub,
                                           id_bits=id_bits, z_bits=z_bits,
                                           drop_invalid=True)
        return lex_combine_gid_sharded(pmin_sub, id_bits=id_bits, z_bits=z_bits)


def _winner_matrix(npts, nframes, dev):
    """C [F, npts + 1] uint8 filled with INVALID; column npts is the trash
    slot that pixels without a winner write to. A view of an allocation
    whose rows lie `row_pitch(npts + 1)` bytes apart, so that every row
    starts on a 16-byte boundary and `histogram_classify` takes its fast
    kernel; the padding beyond column npts is never read."""
    wide = torch.full((nframes, row_pitch(npts + 1)), INVALID, dtype=torch.uint8, device=dev)
    return wide[:, :npts + 1]


def _set_row(C, f, win_id, has, mask, npts):
    # a point id wins at most one pixel, and cell-padding duplicates carry
    # the same id to the same pixel, so the live writes never collide
    idx = torch.where(has, win_id, npts).long()
    C[f].index_put_((idx,), mask)


def _z_bits(id_bits):
    return min(11, 31 - id_bits)


def tpu_label_fuse_cells(npts, nclasses, hw, Ks, sizes, threshold=0.5,
                         use_cuda_hist=True, id_bits=20, device="cuda"):
    """Cell-culled bucketed label fusion (the 1M headline path).

    Frames arrive grouped by visible-cell count (plan_window_buckets over
    build_cell_index's counts); bucket k gathers Ks[k] candidate cells per
    frame. Per frame: gather the cells' points and ids, project, packed
    z-buffer (gid-range-sharded when npts > 2^id_bits), and write the
    winners' mask classes into the frame's row of C. Then one histogram
    classification over C. Bit-identical to tpu_label_fuse (unculled): the
    cell lists are conservative supersets and padding duplicates are no-ops.

    Returns run(cells_table, cell_lists, K, quats, trans, masks) ->
    ((total [N], vmax [N]) int32, classes [N] int32) on `device`;
    `run.winners` takes the same arguments and returns the winner matrix C
    [F, N + 1] uint8 (column N the trash slot) that `run` classifies.
    """
    dev = resolve_device(device)
    nsub = -(-npts // (1 << id_bits))
    z_bits = _z_bits(id_bits)

    def winners(cells_table, cell_lists, K, quats, trans, masks):
        table = _dev(cells_table, dev, torch.float32)
        xyz = table[..., :3].contiguous()
        # the ids are int32 bits stored in a float32 column; reinterpret
        # before copying, so that no float operation touches them
        ids = table.view(torch.int32)[..., 3].contiguous()
        lists = _dev(cell_lists, dev, torch.int64)
        sess = _Session(K, quats, trans, masks, dev)
        C = _winner_matrix(npts, sess.nframes, dev)
        o = 0
        for Kb, sz in zip(Ks, sizes):
            Kb = min(Kb, lists.shape[1])  # bucket round-up can pass Kmax
            for f in range(o, o + sz):
                with timing.range("lift.frame"):
                    cl = lists[f, :Kb]
                    win, has = sess.winners(f, xyz[cl].reshape(-1, 3), ids[cl].reshape(-1),
                                            hw, nsub, id_bits, z_bits)
                    _set_row(C, f, win, has, sess.masks[f], npts)
            o += sz
        return C

    def run(*args):
        C = winners(*args)
        with timing.range("lift.classify"):
            return _histogram_classify(C[:, :npts], nclasses, threshold, use_cuda_hist)

    run.winners = winners
    return run


def label_fuse_session(points, K, quats, trans, masks, hw, nclasses=133,
                       threshold=0.5, cell_size=128, nbuckets=12, id_bits=20,
                       use_cuda_hist=True, device="cuda"):
    """One-call culled label fusion for a whole session.

    Builds the KD-cell frustum-culling index on the host, plans the frame
    buckets, and runs `tpu_label_fuse_cells`. Bit-identical to
    `tpu_label_fuse` (unculled).

    Args:
      points: [N,3] float host array (world).
      K: [3,3] intrinsics at the mask resolution.
      quats, trans: [F,4] wxyz world-from-camera rotations, [F,3] camera
        centers.
      masks: [F, H*W] uint8 per-frame class images.
      hw: (H, W) of the masks.
      use_cuda_hist: classify through kernel K1's wrapper (default); False
        runs the plain PyTorch version instead, on any device.
      device: "cuda" (default) or "cpu".

    Returns ((total_votes, max_votes), classes) as tensors on `device`,
    classes [N] int32 with `nclasses` = unclassified.
    """
    points = np.asarray(points)
    cells_table, cell_lists, counts = build_cell_index(
        points, K, quats, trans, hw, cell_size=cell_size
    )
    perm, sizes, Ks = plan_window_buckets(
        counts, nbuckets=nbuckets, round_to=8, max_window=cell_lists.shape[1],
    )
    run = tpu_label_fuse_cells(
        len(points), nclasses, hw, Ks, sizes, threshold=threshold,
        use_cuda_hist=use_cuda_hist, id_bits=id_bits, device=device,
    )
    return run(
        cells_table, cell_lists[perm], K, np.asarray(quats)[perm],
        np.asarray(trans)[perm], np.asarray(masks)[perm],
    )


def _slice_runner(npts, nclasses, hw, Ms, sizes, threshold, use_cuda_hist,
                  id_bits, z_bits, device):
    """Shared body of the view-index paths: frame f z-buffers the window
    points_ext[starts[f] : starts[f] + M] of its bucket. sizes=None puts
    every frame in one bucket."""
    dev = resolve_device(device)
    nsub = -(-npts // (1 << id_bits))

    def run(points_ext, ids_ext, starts, K, quats, trans, masks):
        pts_all = _dev(points_ext, dev, torch.float32)
        ids_all = _dev(ids_ext, dev, torch.int32)
        starts = np.asarray(starts)  # host ints: slicing needs no device sync
        sess = _Session(K, quats, trans, masks, dev)
        C = _winner_matrix(npts, sess.nframes, dev)
        o = 0
        for M, sz in zip(Ms, sizes or [sess.nframes]):
            for f in range(o, o + sz):
                # clamp like lax.dynamic_slice
                s = min(max(int(starts[f]), 0), len(pts_all) - M)
                win, has = sess.winners(f, pts_all[s:s + M], ids_all[s:s + M],
                                        hw, nsub, id_bits, z_bits)
                _set_row(C, f, win, has, sess.masks[f], npts)
            o += sz
        return _histogram_classify(C[:, :npts], nclasses, threshold, use_cuda_hist)

    return run


def tpu_label_fuse_culled_bucketed(npts, nclasses, hw, Ms, sizes, threshold=0.5,
                                   use_cuda_hist=True, id_bits=20, device="cuda"):
    """Bucketed view-index label fusion: bucket k's frames z-buffer windows
    of Ms[k] points, then ONE classification over C (the histogram is
    frame-order-invariant, so the bucket permutation needs no undo). Call
    with frame arrays permuted by plan_window_buckets' perm. Clouds beyond
    2^id_bits points use the gid-range-sharded z-buffer.

    Returns run(points_ext, ids_ext, starts, K, quats, trans, masks).
    """
    return _slice_runner(npts, nclasses, hw, Ms, sizes, threshold, use_cuda_hist,
                         id_bits, _z_bits(id_bits), device)


def tpu_label_fuse_culled(npts, nclasses, hw, M, threshold=0.5, device="cuda"):
    """View-index label fusion: each frame z-buffers its slice of M points
    (see build_view_index). Winners pack ORIGINAL point ids, so tie-breaks
    and vote attribution match the unculled spec exactly.

    Returns run(points_ext, ids_ext, starts, K, quats, trans, masks).
    """
    if npts >= 1 << 20:
        raise ValueError(f"{npts} points exceed the 20-bit packed id; "
                         "use tpu_label_fuse_culled_big")
    return _slice_runner(npts, nclasses, hw, [M], None, threshold, True, 20, 11,
                         device)


def tpu_label_fuse_culled_big(npts, nclasses, hw, M, threshold=0.5, shard_bits=20,
                              z_bits=None, use_cuda_hist=True, device="cuda"):
    """View-index label fusion for clouds beyond the 2^20 packed-id limit:
    the z-buffer is sharded by gid range (packed_pmin_gid_sharded), so depth
    ties still resolve by global point id exactly.

    Returns run(points_ext, ids_ext, starts, K, quats, trans, masks).
    """
    zb = min(z_bits if z_bits is not None else 11, 31 - shard_bits)
    return _slice_runner(npts, nclasses, hw, [M], None, threshold, use_cuda_hist,
                         shard_bits, zb, device)


def tpu_label_fuse(npts, nclasses, hw, threshold=0.5, use_cuda_hist=True, device="cuda"):
    """Unculled label fusion: every frame z-buffers all npts points. The
    exactness reference for the culled paths.

    Returns run(points, K, quats, trans, masks).
    """
    if npts >= 1 << 20:
        raise ValueError("the packed z-buffer supports < 2^20 points; shard beyond")
    dev = resolve_device(device)

    def run(points, K, quats, trans, masks):
        pts = _dev(points, dev, torch.float32)
        ids = torch.arange(npts, dtype=torch.int32, device=dev)
        sess = _Session(K, quats, trans, masks, dev)
        C = _winner_matrix(npts, sess.nframes, dev)
        for f in range(sess.nframes):
            win, has = sess.winners(f, pts, ids, hw, 1, 20, 11)
            _set_row(C, f, win, has, sess.masks[f], npts)
        return _histogram_classify(C[:, :npts], nclasses, threshold, use_cuda_hist)

    return run
