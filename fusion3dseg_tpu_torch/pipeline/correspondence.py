"""2D <-> 3D correspondence lookups (host NumPy).

Counterpart of `fusion3dseg_tpu/pipeline/correspondence.py`: a pixel of any
frame -> its sparse point (the uv2pt artifact itself), a sparse point ->
every (frame, pixel) observing it (one stable argsort of the observations,
grouped as CSR), the projection and reprojection views, pickle save and
load, and the radius variant `PointCorrespondence`, whose pairs come from
a grid hash over the sparse cloud. The projection view writes PNGs through
the port's codec (`io/image.py`).
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import image, ply


class Correspondence:
    """Bidirectional pixel <-> sparse-point lookup for a fused session."""

    def __init__(self, uv2pt: np.ndarray, depth_hw: Tuple[int, int], frame_names=None):
        """uv2pt: [F, H*W] int32 (-1 invalid) — the fusion artifact."""
        self.uv2pt = np.asarray(uv2pt, np.int32)
        self.depth_hw = tuple(depth_hw)
        self.nframes = len(self.uv2pt)
        self.frame_names = (
            list(frame_names) if frame_names is not None else list(range(self.nframes))
        )
        self._build_inverse()

    def _build_inverse(self):
        h, w = self.depth_hw
        F = self.nframes
        flat = self.uv2pt.reshape(-1)
        valid = flat >= 0
        obs = np.nonzero(valid)[0]
        pts = flat[obs]
        order = np.argsort(pts, kind="stable")
        self._obs_sorted = obs[order]  # linear (frame*H*W + pixel) ids
        pts_sorted = pts[order]
        npts = int(pts_sorted.max()) + 1 if len(pts_sorted) else 0
        self._offsets = np.searchsorted(pts_sorted, np.arange(npts + 1))
        self.npts = npts

    @classmethod
    def from_session_dir(cls, dirname, depth_hw) -> "Correspondence":
        """Load from the fusion/uv2pt artifact directory."""
        uvdir = Path(dirname) / "fusion" / "uv2pt"
        files = sorted(uvdir.glob("*.npy"), key=lambda p: _numeric_key(p.stem))
        uv2pt = np.stack([np.load(f) for f in files])
        return cls(uv2pt, depth_hw, [f.stem for f in files])

    def get_point(self, images: Sequence[int], coords: np.ndarray) -> np.ndarray:
        """Pixel -> sparse point index.

        coords: [K, 2] (x, y) per query; images: [K] frame indices.
        """
        h, w = self.depth_hw
        coords = np.asarray(coords)
        x, y = coords[:, 0], coords[:, 1]
        return self.uv2pt[np.asarray(images), y * w + x]

    def get_pixel(self, idx) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse point -> (frame ids [n], (x, y) coords [n, 2])."""
        h, w = self.depth_hw
        if np.isscalar(idx):
            idx = [idx]
        # valid cloud ids above the max OBSERVED id (a point that lost
        # every z-buffer tie appears in no uv2pt map) have no observations
        # — return empty instead of indexing past _offsets
        chunks = [
            self._obs_sorted[self._offsets[i] : self._offsets[i + 1]]
            if i < self.npts else np.zeros(0, np.int64)
            for i in idx
        ]
        lin = np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
        imgids = lin // (h * w)
        pix = lin % (h * w)
        coords = np.stack([pix % w, pix // w], axis=-1)
        return imgids, coords

    def save(self, filename) -> None:
        with open(filename, "wb") as fp:
            pickle.dump(
                {"uv2pt": self.uv2pt, "depth_hw": self.depth_hw, "frame_names": self.frame_names},
                fp,
            )

    @classmethod
    def load(cls, filename) -> "Correspondence":
        with open(filename, "rb") as fp:
            d = pickle.load(fp)
        return cls(d["uv2pt"], d["depth_hw"], d["frame_names"])

    # ------------------------- visualization -------------------------------

    @staticmethod
    def viz_proj(ids, coords, images, names=None, clr=(0, 0, 255), outdir="./proj"):
        """Paint the query pixels onto their frames ([F, H, W, 3] uint8, in
        the channel order `clr` is given in) and write each touched frame
        as a PNG, `names[fid]` or "<fid + 1>.png"."""
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        images = np.array(images, copy=True)
        coords = np.asarray(coords)
        for fid, (x, y) in zip(ids, coords):
            images[fid, y, x] = clr
        for fid in np.unique(ids):
            name = names[fid] if names is not None else f"{fid + 1}.png"
            image.write(outdir / name, images[fid])

    @staticmethod
    def viz_reproj(points, colors, indices, clr=(1, 0, 0), save=None):
        """Recolour the queried points; write a PLY to `save` when given."""
        colors = np.array(colors, copy=True)
        colors[indices] = clr
        if save is not None:
            ply.write_point_cloud(save, points, colors=colors)
        return colors


def _numeric_key(stem: str):
    try:
        return (0, int(stem))
    except ValueError:
        return (1, stem)


def _two_cloud_radius_pairs(sparse, dense, radius, chunk=1 << 17):
    """All (dense_id, sparse_id) pairs within `radius`, via a grid hash
    over the SPARSE cloud only; dense points query it in chunks. Returns
    (pd [P] int64 dense ids, ps [P] int64 sparse ids)."""
    if len(sparse) == 0 or len(dense) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    inv_r = 1.0 / radius
    vs = np.floor(sparse * inv_r).astype(np.int64)
    lo = vs.min(0) - 1
    vs -= lo
    M = int(vs.max()) + 3  # per-axis key range incl. +-1 query dilation
    key_s = (vs[:, 0] * M + vs[:, 1]) * M + vs[:, 2]
    order_s = np.argsort(key_s, kind="stable")
    ksort = key_s[order_s]
    offs27 = np.asarray(
        [(dx * M + dy) * M + dz
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        np.int64,
    )
    r2 = np.float64(radius) ** 2
    out_d, out_s = [], []
    for c0 in range(0, len(dense), chunk):
        dch = dense[c0 : c0 + chunk]
        # clamp into the (dilated) sparse grid: a dense point with a true
        # neighbor is always in range; out-of-range points clamp to border
        # cells and their spurious candidates fail the distance test
        vd = np.clip(np.floor(dch * inv_r).astype(np.int64) - lo, 1, M - 2)
        kd = (vd[:, 0] * M + vd[:, 1]) * M + vd[:, 2]
        for off in offs27:
            k = kd + off
            a = np.searchsorted(ksort, k, "left")
            b = np.searchsorted(ksort, k, "right")
            cnt = b - a
            nz = np.nonzero(cnt)[0]
            if len(nz) == 0:
                continue
            reps = cnt[nz]
            did = np.repeat(nz, reps)
            # expand [a, b) ranges: base + intra-range offset
            base = np.repeat(a[nz], reps)
            first = np.repeat(np.cumsum(reps) - reps, reps)
            cand = order_s[base + (np.arange(len(base)) - first)]
            diff = sparse[cand].astype(np.float64) - dch[did].astype(np.float64)
            ok = np.einsum("ij,ij->i", diff, diff) <= r2
            out_d.append((c0 + did[ok]).astype(np.int64))
            out_s.append(cand[ok].astype(np.int64))
    pd = np.concatenate(out_d) if out_d else np.zeros(0, np.int64)
    ps = np.concatenate(out_s) if out_s else np.zeros(0, np.int64)
    return pd, ps


class PointCorrespondence:
    """Radius-NN sparse <-> dense correspondence: dense points laid out as
    nframes x H x W row-major images, each paired with every sparse point
    within the radius (a grid hash over the sparse cloud)."""

    def __init__(self, sparse_points, dense_points, radius, nframes, depth_hw):
        self.depth_hw = tuple(depth_hw)
        self.nframes = nframes
        h, w = depth_hw
        hw = h * w
        n_dense = len(dense_points)
        assert n_dense == nframes * hw

        # dense id -> sparse ids within radius, as CSR; only the sparse
        # cloud is hashed, so no dense-dense pair is ever formed
        pd, ps = _two_cloud_radius_pairs(
            np.asarray(sparse_points, np.float32),
            np.asarray(dense_points, np.float32), float(radius),
        )
        order = np.argsort(pd, kind="stable")
        self._sp_sorted = ps[order]
        self._offsets = np.searchsorted(pd[order], np.arange(n_dense + 1))

    def get_point(self, images, coords):
        """Pixel -> all sparse points within radius of its dense point.

        Returns (indices [p], frequency [K]).
        """
        h, w = self.depth_hw
        coords = np.asarray(coords)
        dense_ids = np.asarray(images) * (h * w) + coords[:, 1] * w + coords[:, 0]
        chunks = [self._sp_sorted[self._offsets[d] : self._offsets[d + 1]] for d in dense_ids]
        freq = np.asarray([len(c) for c in chunks])
        idx = np.concatenate(chunks).astype(np.int32) if chunks else np.zeros(0, np.int32)
        return idx, freq

    def vote(self, masks: np.ndarray, num_sparse: int, nclasses: int) -> np.ndarray:
        """Radius-NN voting over all frames — the deprecated reference
        PointVotingSegmentation.vote semantics (voting.py:224-265): every
        depth pixel votes its mask class onto EVERY sparse point within
        radius of its dense point, with a dedicated total-votes column.

        masks: [F, H, W] or [F, H*W] class ids at depth resolution.
        Returns votes [num_sparse, nclasses + 1] (last column = totals).
        """
        h, w = self.depth_hw
        masks = np.asarray(masks).reshape(self.nframes, h * w)
        votes = np.zeros((num_sparse, nclasses + 1), np.int64)
        for f in range(self.nframes):
            lo = f * h * w
            # CSR rows for this frame's dense points; pixels whose mask id
            # is out of range (>= nclasses — e.g. a 255 ignore label, or
            # the 'unclassified' id itself) don't vote: the last column is
            # a dedicated TOTALS column here, so an unclipped id would
            # corrupt it (or raise) and a clipped one would miscount as
            # the top real class
            votable = masks[f] < nclasses
            starts = self._offsets[lo : lo + h * w]
            ends = self._offsets[lo + 1 : lo + h * w + 1]
            freq = np.where(votable, ends - starts, 0)
            if freq.sum() == 0:
                continue
            sel = freq > 0
            idx = np.concatenate(
                [self._sp_sorted[s:e]
                 for s, e, ok in zip(starts, ends, sel) if ok]
            )
            cls = np.repeat(masks[f][sel], freq[sel])
            # fancy-index += like the reference (voting.py:257-258):
            # duplicate (point, class) pairs within one frame collapse
            votes[idx, cls] += 1
            votes[idx, nclasses] += 1
        return votes
