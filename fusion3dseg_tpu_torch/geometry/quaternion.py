"""Batched quaternion math on torch tensors.

Counterpart of `fusion3dseg_tpu/geometry/quaternion.py`: the same pure
functions over (..., 4) wxyz tensors, in the same operation order. XLA's
CPU code contracts some products of `rotate` and `normalize` into fused
multiply-adds; `fma` reproduces each one (the product of two float32 values
is exact in float64, the sum is rounded to float32), so on the CPU every
function here agrees with the JAX package bit for bit where the session
path uses it (`frames_to_world`).

Convention: quaternions are (w, x, y, z).
"""

from __future__ import annotations

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add: the
    product of two float32 values is exact in float64. Gives the same bits
    on the CPU and the card."""
    return (a.double() * b.double() + c.double()).float()


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, each product rounded; unlike
    torch.linalg.cross, a and b broadcast against each other."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def cross_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b as XLA's CPU code contracts `jnp.cross` inside the session
    program: fma(a1, b2, -(a2 * b1)) and its rotations, the second product
    rounded. Broadcasts like `cross`."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)), fma(a0, b1, -(a1 * b0))], dim=-1
    )


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. torch's CPU kernel is not
    (it differed on 15 of 5184 normals); in float64 and rounded once it is,
    on both devices."""
    return torch.sqrt(x.double()).float()


def norm3_fma(n: torch.Tensor) -> torch.Tensor:
    """|n| over a last axis of 3 as a forward FMA chain of the squares,
    sqrt(fma(n2, n2, fma(n1, n1, n0 * n0))). Shape (..., 1)."""
    n0, n1, n2 = n.unbind(-1)
    return _sqrt(fma(n2, n2, fma(n1, n1, n0 * n0)))[..., None]


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit length. q: (..., 4). The squares sum
    as a forward FMA chain, as XLA's CPU code computes the norm."""
    q0, q1, q2, q3 = q.unbind(-1)
    nrm = _sqrt(fma(q3, q3, fma(q2, q2, fma(q1, q1, q0 * q0))))
    return q / nrm[..., None]


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions). q: (..., 4) wxyz."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


inverse = conjugate  # unit quaternions throughout


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2. Broadcasts over leading dims. (..., 4)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points by unit quaternion(s): p' = p + 2 w (v × p) + 2 v × (v × p).

    q: (..., 4) wxyz; p: (..., N, 3), q's leading dims broadcast against p's.
    Both cross products and the sum w * (v × p) + v × (v × p) contract
    into FMAs, as in XLA's CPU code for the session program.
    """
    w = q[..., None, :1]  # (..., 1, 1)
    v = q[..., None, 1:]  # (..., 1, 3)
    vxp = cross_fma(v, p)
    return p + 2.0 * fma(w.expand(vxp.shape), vxp, cross_fma(v, vxp))


def rotate_inverse(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points by the inverse of q (world -> camera)."""
    return rotate(conjugate(q), p)


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion rotating by `angle` around `axis`. (...,3),(...) -> (...,4)."""
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def between_vectors(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v1 onto v2: q = [1 + v1·v2, v1 × v2], normalized.

    Antiparallel vectors give the zero quaternion; they get a 180-degree
    rotation about an axis orthogonal to v1 instead.
    """
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    v2 = v2 / torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    w = 1.0 + torch.sum(v1 * v2, dim=-1, keepdim=True)
    xyz = cross(v1, v2)
    q = torch.cat([w, xyz], dim=-1)
    degenerate = torch.linalg.vector_norm(q, dim=-1, keepdim=True) < 1e-6
    ex = torch.zeros_like(v1)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(v1)
    ez[..., 2] = 1.0
    alt = torch.where(v1[..., :1].abs() < 0.9, cross(v1, ex), cross(v1, ez))
    alt = alt / torch.clamp(torch.linalg.vector_norm(alt, dim=-1, keepdim=True), min=1e-12)
    q180 = torch.cat([torch.zeros_like(w), alt], dim=-1)
    return normalize(torch.where(degenerate, q180, q))


def from_euler(roll: torch.Tensor, pitch: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Euler (roll, pitch, yaw) -> wxyz quaternion."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )
