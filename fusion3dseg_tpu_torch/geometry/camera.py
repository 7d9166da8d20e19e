"""Camera geometry: projection, back-projection, frustums.

Counterpart of `fusion3dseg_tpu/geometry/camera.py`. The world->pixel
transform is one [N,3] @ [3,3] float32 product with the pose rotation and
the intrinsics folded into a single matrix.

Precision: every 3-wide product here is float32 and must stay float32.
TF32 (the GPU's reduced-precision matmul mode, the counterpart of the TPU's
bf16 default) would move whole pixels and depth bins. This module sets no
global switch: `torch.backends.cuda.matmul.allow_tf32` is False by default,
and callers that turn it on do not get the reference's pixels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fusion3dseg_tpu_torch.geometry import quaternion as quat

_INT32_MAX = 2147483647


def _floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32 with XLA's and CUDA's conversion rule: values past
    the int32 range saturate and NaN becomes 0. A plain `.to(torch.int32)`
    on x86 turns all of those into INT32_MIN, so the cast would differ
    between the CPU and the card for points at near-zero depth (which the
    bounds test masks either way)."""
    x = torch.floor(x)
    big = x >= 2147483648.0
    xi = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, 2147483520.0)
    return xi.to(torch.int32).masked_fill(big, _INT32_MAX)


def _depth_fma(rel: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """rel · r in the order XLA's CPU dot computes it: a forward chain of
    fused multiply-adds, fma(x2, r2, fma(x1, r1, x0 * r0)).

    A product of two float32 values is exact in float64, so adding it to the
    float32 accumulator in float64 and rounding to float32 after each step
    reproduces the fused operation (up to a double rounding that needs a
    53-bit carry and has not been seen to occur). A 1-ulp depth change can
    move a point across an 11-bit depth bin and change a z-buffer winner, so
    `mv`, `einsum` or multiply-then-sum, which round differently on 28% of
    points, would not reproduce the reference's winners.
    """
    x = rel.double()
    rd = r.double()
    acc = (rel[:, 0] * r[0]).double()
    acc = (x[:, 1] * rd[1] + acc).float().double()
    return (x[:, 2] * rd[2] + acc).float()


def projection_matrices(
    K: torch.Tensor, q_wxyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M = K R, R) with R the world->camera rotation of pose q_wxyz.
    q may carry leading frame dims ([..., 4] -> [..., 3, 3] each), so a
    whole session's matrices come from one batched product."""
    R = quat.to_rotation_matrix(quat.conjugate(q_wxyz))
    return K @ R, R


def project_with_matrices(
    points: torch.Tensor, M: torch.Tensor, R: torch.Tensor, translation: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`project_points` for one frame whose matrices are already built."""
    rel = points - translation
    p = rel @ M.T
    z = _depth_fma(rel, R[2])
    uv = p[:, :2] / p[:, 2:3]
    # +1e-4 px guards the floor() against f32 round-down at exact-integer
    # boundaries (back-projected pixels land exactly on integers; without the
    # nudge a third of them floor to u-1)
    uv = _floor_to_int32(uv + 1e-4)
    return uv[:, 0], uv[:, 1], z


def project_points(
    points: torch.Tensor,
    K: torch.Tensor,
    q_wxyz: torch.Tensor,
    translation: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points -> integer pixel coordinates + camera-frame depth.

    Subtract the camera translation, rotate by the inverse pose quaternion,
    apply K, perspective-divide, floor to int32.

    Args:
      points: [N, 3] float32 world xyz.
      K: [3, 3] intrinsics.
      q_wxyz: [4] camera pose rotation (camera->world), wxyz.
      translation: [3] camera position.

    Returns:
      u, v: [N] int32 pixel coords (floor, unclamped).
      z:    [N] float32 camera-frame depth (positive in front of the camera).
    """
    M, R = projection_matrices(K, q_wxyz)
    return project_with_matrices(points, M, R, translation)


def backproject_depth(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Depth images [..., H, W] -> camera-frame points [..., H*W, 3],
    row-major pixels: x = (u - cx) * depth / fx, y = (v - cy) * depth / fy,
    z = depth."""
    h, w = depth.shape[-2:]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device).expand(h, w)
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None].expand(h, w)
    x = (u - K[0, 2]) * depth / K[0, 0]
    y = (v - K[1, 2]) * depth / K[1, 1]
    return torch.stack([x, y, depth], dim=-1).reshape(*depth.shape[:-2], h * w, 3)


def camera_to_world(
    points: torch.Tensor, q_wxyz: torch.Tensor, translation: torch.Tensor
) -> torch.Tensor:
    """Camera-frame points -> world frame: R p + t.
    points [..., N, 3], q [..., 4], t [..., 3]."""
    return quat.rotate(q_wxyz, points) + translation[..., None, :]


def camera_frustum_corners(K: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Camera-frame frustum pyramid [eye, bl, br, tr, tl, lookat] at unit
    depth, by K^-1 on pixel-corner homogeneous points. Returns [6, 3]."""
    Kinv = torch.linalg.inv(K)
    pix = torch.tensor(
        [
            [0.0, 0.0, 0.0],  # eye
            [0.0, 0.0, 1.0],
            [width, 0.0, 1.0],
            [width, height, 1.0],
            [0.0, height, 1.0],
            [width / 2.0, height / 2.0, 1.0],  # lookat
        ],
        dtype=K.dtype,
        device=K.device,
    )
    return pix @ Kinv.T


def frustum_world_planes(
    K: torch.Tensor,
    width: int,
    height: int,
    q_wxyz: torch.Tensor,
    translation: torch.Tensor,
    max_depth: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Five inward-facing half-space planes bounding one camera's view
    volume: four side planes through the eye (normals = cross(eye->corner_i,
    eye->corner_{i+1})) and the far plane at eye + max_depth * lookat.

    Args:
      q_wxyz: [4] or [F, 4] pose rotation; translation [3] or [F, 3].

    Returns:
      plane_points [.., 5, 3], plane_normals [.., 5, 3] (unit, inward).
    """
    cam = camera_frustum_corners(K, width, height)  # [6,3] camera frame
    world = camera_to_world(cam, q_wxyz, translation)  # [..,6,3]
    eye = world[..., 0, :]
    corners = world[..., 1:5, :]
    lookvec = world[..., 5, :] - eye
    # cross products and norms as XLA's CPU code contracts them in the
    # reference's frame step, so the planes carry the reference's bits
    lookat = lookvec / quat.norm3_fma(lookvec)

    nxt = torch.roll(corners, shifts=-1, dims=-2)
    e2a = corners - eye[..., None, :]
    e2b = nxt - eye[..., None, :]
    normals = quat.cross_fma(e2a, e2b)
    normals = normals / quat.norm3_fma(normals)

    far_pt = eye + max_depth * lookat
    far_n = -lookat
    plane_pts = torch.cat(
        [eye[..., None, :].expand(corners.shape), far_pt[..., None, :]], dim=-2
    )
    plane_ns = torch.cat([normals, far_n[..., None, :]], dim=-2)
    return plane_pts, plane_ns
