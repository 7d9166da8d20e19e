"""Plain reference of the label lifter: a point cloud, a camera trajectory
and per-frame class masks -> per-point classes.

The semantics of the reference's multi-view vote (the oracle of the
repository's `bench.py`): every point projects through the pinhole camera
(floor of the perspective division); per pixel the nearest point wins, at
10 m / 2^11 depth resolution with ties to the lowest point index; a point
gets one vote for the mask class of the pixel it wins; its class is the
thresholded argmax of its votes (ties to the lowest class), else
`nclasses`. Plain PyTorch, imports nothing of the program.

`mode` "float64" is the reference; "tf32" is the control (float32, the
projection's operands rounded to TF32), one step below the configuration's
float32.
"""

from __future__ import annotations

import math

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest, ties to even):
    what a TF32 product does to its operands, on any device."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


@torch.no_grad()
def lift(points, K, quats_wxyz, trans, masks, hw, nclasses: int, threshold: float = 0.5,
         mode: str = "float64"):
    """points [N, 3], K [3, 3], quats_wxyz [F, 4], trans [F, 3], masks
    [F, H*W] integer classes (tensors, any one device). Returns (total
    votes [N] int64, classes [N] int64)."""
    if mode not in ("float64", "tf32"):
        raise ValueError(f"unknown mode {mode!r}")
    dt = torch.float64 if mode == "float64" else torch.float32
    dev = points.device
    h, w = hw
    n = points.shape[0]
    nc1 = nclasses + 1
    P = points.to(dt)
    K = torch.as_tensor(K, dtype=dt, device=dev)
    R = quat_matrix(torch.as_tensor(quats_wxyz, device=dev).to(dt))
    T = torch.as_tensor(trans, device=dev).to(dt)
    id_bits = max(20, math.ceil(math.log2(max(n, 2))))
    ids = torch.arange(n, device=dev)
    empty = torch.iinfo(torch.int64).max
    votes = torch.zeros(n * nc1, dtype=torch.int32, device=dev)
    for f in range(len(R)):
        rel, Rf = P - T[f], R[f]
        if mode == "tf32":
            rel, Rf = tf32(rel), tf32(Rf)
        cam = rel @ Rf  # R^T (p - t)
        z = cam[:, 2]
        u = torch.floor((K[0, 0] * cam[:, 0] + K[0, 2] * z) / z)
        v = torch.floor((K[1, 1] * cam[:, 1] + K[1, 2] * z) / z)
        ok = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = torch.where(ok, v * w + u, h * w).long()
        zq = torch.clamp(z * (2048.0 / 10.0), 0, 2047).long()
        packed = torch.where(ok, (zq << id_bits) | ids, empty)
        best = torch.full((h * w + 1,), empty, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, pix, packed, reduce="amin")
        best = best[:h * w]
        won = best != empty
        win = best[won] & ((1 << id_bits) - 1)
        cls = masks[f].reshape(-1)[won].long().clamp(0, nclasses)
        votes.index_put_((win * nc1 + cls,), torch.ones_like(win, dtype=torch.int32),
                         accumulate=True)
    votes = votes.view(n, nc1)
    total = votes.sum(-1, dtype=torch.int64)
    vmax, arg = votes.max(-1)
    ok = (total > 0) & (vmax > 0) & (vmax.double() / total.clamp(min=1).double() >= threshold)
    return total, torch.where(ok, arg, nclasses)
