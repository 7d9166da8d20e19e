"""Session ingestion core: RGB-D frames -> device-resident session arrays.

Counterpart of the array side of `fusion3dseg_tpu/io/rtab.py`
(`_normals_from_grid`, `frames_to_world`, `SessionData.from_arrays`): the
whole session is back-projected, pose-transformed and given camera-facing
normals as batched tensor programs. Normals come from depth-image gradient
cross products and are flipped toward the camera eye. Reading an exported
session directory (calibration, poses, images, the pickle cache) belongs to
the file-API slice and is not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.geometry import camera, quaternion as quat


def scale_intrinsics(K: np.ndarray, scale_x: float, scale_y: float) -> np.ndarray:
    """Scale K from RGB to depth resolution."""
    return np.array([
        [K[0, 0] * scale_x, 0.0, K[0, 2] * scale_x],
        [0.0, K[1, 1] * scale_y, K[1, 2] * scale_y],
        [0.0, 0.0, 1.0],
    ])


def _normals_from_grid(points_cam: torch.Tensor) -> torch.Tensor:
    """Camera-facing unit normals from organized [..., H, W, 3] point images.

    Central differences along the pixel grid, n = du x dv, normalized, then
    flipped so normals point toward the camera eye (the origin of the camera
    frame). Borders use one-sided differences via edge-replicate padding: a
    roll would difference against the opposite image edge.
    """
    p = torch.cat([points_cam[..., :1, :, :], points_cam, points_cam[..., -1:, :, :]], dim=-3)
    p = torch.cat([p[..., :, :1, :], p, p[..., :, -1:, :]], dim=-2)
    du = p[..., 1:-1, 2:, :] - p[..., 1:-1, :-2, :]
    dv = p[..., 2:, 1:-1, :] - p[..., :-2, 1:-1, :]
    n = quat.cross(du, dv)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    toward_eye = (n * points_cam).sum(dim=-1, keepdim=True) > 0
    return torch.where(toward_eye, -n, n)


def frames_to_world(depth_m: torch.Tensor, Ks: torch.Tensor, quats_wxyz: torch.Tensor,
                    translations: torch.Tensor):
    """Whole-session back-projection: depth images -> world clouds + normals.

    Args:
      depth_m: [F, H, W] meters; Ks: [3, 3] depth-scaled intrinsics;
      quats_wxyz: [F, 4]; translations: [F, 3]. All float32 on one device.

    Returns (world_points [F, H*W, 3], world_normals [F, H*W, 3],
    cam_depth [F, H*W]).
    """
    nf, h, w = depth_m.shape
    pts_cam = camera.backproject_depth(depth_m, Ks)  # [F, H*W, 3]
    normals_cam = _normals_from_grid(pts_cam.reshape(nf, h, w, 3)).reshape(nf, h * w, 3)
    pts_w = camera.camera_to_world(pts_cam, quats_wxyz, translations)
    return pts_w, quat.rotate(quats_wxyz, normals_cam), pts_cam[..., 2]


def _area_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of an area (box) downscale along one axis: each
    output cell averages the input cells it covers, edge cells by the
    covered fraction. For an integer factor this is a block mean."""
    scale = n_in / n_out
    lo = torch.arange(n_out, dtype=torch.float64, device=device)[:, None] * scale
    cell = torch.arange(n_in, dtype=torch.float64, device=device)[None, :]
    overlap = (torch.minimum(lo + scale, cell + 1) - torch.maximum(lo, cell)).clamp(min=0)
    return (overlap / scale).float()


def area_resize_uint8(images: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Area-average downscale of [F, H, W, C] uint8 images to `out_hw`,
    rounded back to uint8 levels (what `cv2.resize(..., INTER_AREA)` gives,
    within one level). Upscaling is not supported."""
    _, h, w, _ = images.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return images
    if oh > h or ow > w:
        raise ValueError(f"area resize only shrinks: {(h, w)} -> {(oh, ow)}")
    wy = _area_weights(h, oh, images.device)
    wx = _area_weights(w, ow, images.device)
    out = torch.einsum("oh,fhwc,pw->fopc", wy, images.float(), wx)
    return out.round().clamp(0, 255).to(torch.uint8)


@dataclass
class SessionData:
    """Whole-session arrays. The per-pixel arrays (`points`, `normals`,
    `colors`, `depth`) are tensors on the session's device; intrinsics,
    poses and frame numbers are small host NumPy arrays."""

    frame_numbers: np.ndarray  # [F] int
    K: np.ndarray  # [3,3] RGB-resolution intrinsics
    Ks: np.ndarray  # [3,3] depth-scaled intrinsics
    quats_wxyz: np.ndarray  # [F,4] float32
    translations: np.ndarray  # [F,3] float32
    rgb_hw: Tuple[int, int]
    depth_hw: Tuple[int, int]
    points: torch.Tensor  # [F, H*W, 3] world points
    normals: torch.Tensor  # [F, H*W, 3] world normals
    colors: torch.Tensor  # [F, H*W, 3] float32 in [0,1]
    depth: torch.Tensor  # [F, H*W] camera-frame depth (m)

    @property
    def nframes(self) -> int:
        return len(self.frame_numbers)

    @classmethod
    def from_arrays(
        cls,
        rgbs: np.ndarray,  # [F, Hr, Wr, 3] uint8
        depth_m: np.ndarray,  # [F, H, W] meters
        K_rgb: np.ndarray,
        quats_xyzw: np.ndarray,
        translations: np.ndarray,
        frame_numbers: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "SessionData":
        dev = cuda.resolve_device(device)
        nf, h, w = depth_m.shape
        hr, wr = rgbs.shape[1:3]
        Ks = scale_intrinsics(K_rgb, w / wr, h / hr)
        wxyz = np.asarray(quats_xyzw)[:, [3, 0, 1, 2]].astype(np.float32)
        trans = np.asarray(translations, np.float32)
        if frame_numbers is None:
            frame_numbers = np.arange(nf)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        pts, nrm, depth = frames_to_world(f32(depth_m), f32(Ks), f32(wxyz), f32(trans))
        rgb = area_resize_uint8(torch.as_tensor(np.ascontiguousarray(rgbs), device=dev), (h, w))
        colors = rgb.float().reshape(nf, h * w, 3) / 255.0
        return cls(
            frame_numbers=np.asarray(frame_numbers), K=np.asarray(K_rgb), Ks=Ks,
            quats_wxyz=wxyz, translations=trans, rgb_hw=(hr, wr), depth_hw=(h, w),
            points=pts, normals=nrm, colors=colors, depth=depth,
        )
