"""RTAB-Map session ingestion: an exported directory -> device-resident arrays.

Counterpart of `fusion3dseg_tpu/io/rtab.py`. `SessionData.from_export_dir`
reads the directory `rtabmap-export --images --poses_format 11 --ba
--poses_camera --images_id` writes (calibration YAML, RGBD-SLAM + id pose
text, rgb/<id>.jpg, depth/<id>.png in millimetres) through the port's own
codec (`io/image.py`) and calibration reader; `from_arrays` back-projects,
pose-transforms and gives camera-facing normals to the whole session as
batched tensor programs. Normals come from depth-image gradient cross
products and are flipped toward the camera eye. The reference's pickle
cache layout (tofcameradata_segments_*.pkl, tofsegment_*.pkl,
rtscameradata_*.pkl) is read and written both ways (`from_cache`,
`write_cache`), with NumPy arrays inside, so either package reads it.

The cross products, norms, sign test and rotations reproduce the fused
multiply-adds XLA's CPU code contracts in the reference's session program
(`quaternion.fma`), so on the CPU the points and normals equal the JAX
package's bits.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.geometry import camera, quaternion as quat
from fusion3dseg_tpu_torch.io import image

DEFAULT_CALIBRATION = Path(__file__).resolve().parent / "default_calibration.yaml"


def read_calibration(path) -> np.ndarray:
    """The [3, 3] float64 intrinsics of an OpenCV-style YAML calibration
    file: the `data: [...]` list of its `camera_matrix` block (the list may
    wrap lines; a `%YAML:1.0` directive and `!!opencv-matrix` tags are
    ignored)."""
    text = Path(path).read_text()
    m = re.search(r"^\s*camera_matrix\s*:(.*?)\bdata\s*:\s*\[([^\]]*)\]", text,
                  re.MULTILINE | re.DOTALL)
    if m is None:
        raise ValueError(f"{path}: no camera_matrix data list")
    values = [float(v) for v in re.split(r"[\s,]+", m.group(2).strip()) if v]
    if len(values) != 9:
        raise ValueError(f"{path}: camera_matrix has {len(values)} values, not 9")
    return np.reshape(np.asarray(values, np.float64), (3, 3))


def read_poses(pose_file, startf: int = 0, stopf: Optional[int] = None):
    """Parse RGBD-SLAM + id poses, columns [timestamp, x, y, z, qx, qy, qz,
    qw, image_id]. Returns (img_idx [F] int64, xyz [F,3], quat_xyzw [F,4],
    timestamps [F])."""
    pose = np.genfromtxt(pose_file, delimiter=" ")
    pose = np.atleast_2d(pose)[startf:stopf]
    return (
        pose[:, 8].astype(np.int64),
        pose[:, 1:4],
        pose[:, 4:8],
        pose[:, 0],
    )


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
    # the cross product, the norm and the sign test as XLA's CPU code
    # contracts them into FMAs, so the normals equal the reference's bits
    n = quat.cross_fma(du, dv)
    n = n / quat.norm3_fma(n).clamp(min=1e-12)
    n0, n1, n2 = n.unbind(-1)
    p0, p1, p2 = points_cam.unbind(-1)
    toward_eye = (quat.fma(n2, p2, quat.fma(n1, p1, n0 * p0)) > 0)[..., None]
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


# OpenCV's INTER_AREA shrink (the reference's `cv2.resize(rgb, (W, H),
# interpolation=cv2.INTER_AREA)`), bit for bit
area_resize_uint8 = image.resize_area_uint8


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
    def from_export_dir(
        cls,
        data_path,
        rgb_dir=None,
        depth_dir=None,
        pose_file=None,
        calib_file=None,
        startf: int = 0,
        stopf: Optional[int] = None,
        stepf: int = 1,
        padding: bool = False,
        device="cuda",
    ) -> "SessionData":
        """Load an rtabmap-export directory (jpg rgb + 16-bit png depth in
        mm). Frames whose rgb or depth image is missing or unreadable are
        skipped with their poses. The calibration is the directory's
        `calibration.yaml`, else the first file of `calib/`, else the
        packaged default. padding=True zeroes a 10 px depth border."""
        data_path = Path(data_path)
        rgb_dir = Path(rgb_dir or data_path / "rgb")
        depth_dir = Path(depth_dir or data_path / "depth")
        pose_file = pose_file or data_path / "poses.txt"
        if calib_file is None:
            caldir = data_path / "calib"
            if (data_path / "calibration.yaml").is_file():
                calib_file = data_path / "calibration.yaml"
            elif caldir.is_file():
                calib_file = caldir
            elif caldir.is_dir() and any(caldir.iterdir()):
                calib_file = sorted(caldir.iterdir())[0]
            else:
                calib_file = DEFAULT_CALIBRATION
        calib = read_calibration(calib_file)

        img_idx, xyz, xyzw, _ = read_poses(pose_file, startf, stopf)
        img_idx, xyz, xyzw = img_idx[::stepf], xyz[::stepf], xyzw[::stepf]

        rgbs, depths, keep = [], [], []
        for k, i in enumerate(img_idx):
            try:
                rgb = image.read(rgb_dir / f"{int(i)}.jpg")
                d = image.read(depth_dir / f"{int(i)}.png", unchanged=True)
            except (OSError, image.ImageError):
                # real exports drop frames: skip the frame and its pose
                print(f"warning: skipping frame {int(i)}, unreadable rgb/depth image")
                continue
            rgbs.append(rgb)
            depths.append(d)
            keep.append(k)
        if len(keep) != len(img_idx):
            img_idx = img_idx[keep]
            xyz, xyzw = xyz[keep], xyzw[keep]
        if not rgbs:
            raise FileNotFoundError(
                f"no readable rgb/depth frame pairs under {data_path} for the selected "
                "pose range; is this an rtabmap export directory?")
        rgbs = np.stack(rgbs)
        depths = np.stack(depths).astype(np.float32)
        if padding:
            depths[:, :10], depths[:, -10:] = 0, 0
            depths[:, :, :10], depths[:, :, -10:] = 0, 0
        return cls.from_arrays(rgbs, depths / 1000.0, calib, xyzw, xyz, img_idx, device=device)

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
        # a 0-d device divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, which rounds apart from the CPU
        colors = rgb.float().reshape(nf, h * w, 3) / torch.tensor(255.0, device=dev)
        return cls(
            frame_numbers=np.asarray(frame_numbers), K=np.asarray(K_rgb), Ks=Ks,
            quats_wxyz=wxyz, translations=trans, rgb_hw=(hr, wr), depth_hw=(h, w),
            points=pts, normals=nrm, colors=colors, depth=depth,
        )

    # ---------------- the reference's pickle cache, both ways ----------------

    def write_cache(self, data_path) -> str:
        """Write the reference's PointcloudMergeResults pickle layout:
        per-frame tofcameradata_segments pickles, a tofsegment index and
        the rtscameradata camera pickle, all arrays NumPy. Returns the
        "0_<F>_1" tag of the file names."""
        data_path = Path(data_path)
        nf = self.nframes
        sub = f"0_{nf}_1"
        segdir = data_path / "PointcloudMergeResults" / f"Segments_{sub}"
        segdir.mkdir(parents=True, exist_ok=True)

        dev = self.points.device
        trans_d = torch.as_tensor(self.translations, device=dev)
        cam_pts = quat.rotate_inverse(torch.as_tensor(self.quats_wxyz, device=dev),
                                      self.points - trans_d[:, None, :]).cpu().numpy()
        points, normals = self.points.cpu().numpy(), self.normals.cpu().numpy()
        colors = self.colors.cpu().numpy()
        index = []
        for i in range(nf):
            frame = {
                "frameNumber": int(self.frame_numbers[i]),
                # cached in metres, as the reference caches orgPoints
                "orgPoints": cam_pts[i],
                "orgNormals": self.translations[i] - cam_pts[i],
                "modPoints": points[i],
                "modNormals": self.translations[i] - points[i],
                "orgColorPoints": colors[i],
                "modSurfaceNormals": normals[i],
            }
            rel = os.path.join("PointcloudMergeResults", f"Segments_{sub}",
                               f"tofcameradata_segments_{sub}_{i}.pkl")
            with open(data_path / rel, "wb") as fp:
                pickle.dump(frame, fp)
            index.append({"frameNumber": frame["frameNumber"], "fileName": rel})

        with open(data_path / "PointcloudMergeResults" / f"tofsegment_{sub}.pkl", "wb") as fp:
            pickle.dump(index, fp)
        rts = {
            "intrinsic": self.K,
            "intrinsicScaled": self.Ks,
            "odo_wxyz": self.quats_wxyz[:, [1, 2, 3, 0]],  # stored as xyzw
            "odo_xyz": self.translations,
            "RGB_res": (*self.rgb_hw, 3),
            "Depth_res": self.depth_hw,
        }
        with open(data_path / "PointcloudMergeResults" / f"rtscameradata_{sub}.pkl", "wb") as fp:
            pickle.dump(rts, fp)
        return sub

    @classmethod
    def from_cache(cls, tof_index_file, rts_file, device="cuda") -> "SessionData":
        """Load the reference's pickle cache; the per-pixel arrays go to
        `device`."""
        dev = cuda.resolve_device(device)
        tof_index_file = str(tof_index_file)
        dirname = Path(tof_index_file.split("PointcloudMergeResults")[0])
        with open(tof_index_file, "rb") as fp:
            index = pickle.load(fp)
        with open(rts_file, "rb") as fp:
            rts = pickle.load(fp)

        pts, nrms, clrs, depth, fnums = [], [], [], [], []
        for entry in index:
            with open(dirname / entry["fileName"].strip(), "rb") as fp:
                fr = pickle.load(fp)
            fnums.append(int(fr["frameNumber"]))
            pts.append(np.asarray(fr["modPoints"], np.float32))
            nrms.append(np.asarray(fr["modSurfaceNormals"], np.float32))
            clrs.append(np.asarray(fr["orgColorPoints"], np.float32))
            depth.append(np.asarray(fr["orgPoints"], np.float32)[:, 2])  # metres
        h, w = rts["Depth_res"][:2]
        xyzw = np.asarray(rts["odo_wxyz"], np.float32)

        def t(a):
            return torch.as_tensor(np.stack(a), device=dev)

        return cls(
            frame_numbers=np.asarray(fnums),
            K=np.asarray(rts["intrinsic"]),
            Ks=np.asarray(rts["intrinsicScaled"]),
            quats_wxyz=xyzw[:, [3, 0, 1, 2]],
            translations=np.asarray(rts["odo_xyz"], np.float32),
            rgb_hw=tuple(rts["RGB_res"][:2]),
            depth_hw=(h, w),
            points=t(pts),
            normals=t(nrms),
            colors=t(clrs),
            depth=t(depth),
        )


def perturb_poses(quats_xyzw: np.ndarray, translations: np.ndarray, rotation_xyzw,
                  translation_delta, frame_indices) -> Tuple[np.ndarray, np.ndarray]:
    """Compose a rotation (xyzw) onto the selected frames' rotations and add
    a translation delta, in float64 on the host. Returns new (quats_xyzw,
    translations) arrays."""
    quats_xyzw = np.array(quats_xyzw, copy=True)
    translations = np.array(translations, copy=True)
    idx = np.asarray(list(frame_indices), np.int64)
    if len(idx) == 0:
        return quats_xyzw, translations
    w1, x1, y1, z1 = np.asarray(rotation_xyzw, np.float64)[[3, 0, 1, 2]]
    q = quats_xyzw[idx][:, [3, 0, 1, 2]].astype(np.float64)
    w2, x2, y2, z2 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    composed = np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=1)
    quats_xyzw[idx] = composed[:, [1, 2, 3, 0]]
    translations[idx] = translations[idx] + np.asarray(translation_delta)
    return quats_xyzw, translations


def retransform_points(org_points_cam: np.ndarray, quats_xyzw: np.ndarray,
                       translations: np.ndarray, device="cuda") -> np.ndarray:
    """World points [F, N, 3] of camera-frame points under (modified) poses,
    one batched program on `device`; returns host NumPy."""
    dev = cuda.resolve_device(device)
    wxyz = np.asarray(quats_xyzw)[:, [3, 0, 1, 2]]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return camera.camera_to_world(f32(org_points_cam), f32(wxyz), f32(translations)).cpu().numpy()


def export_rtab(path_in, path_out) -> bool:
    """Run the external `rtabmap-export` tool on a database into
    `path_out`. Returns False when the tool is not installed or fails."""
    if shutil.which("rtabmap-export") is None:
        print("rtabmap-export not found on PATH; provide an exported directory instead")
        return False
    if not os.path.exists(path_in):
        print(f"Error: '{path_in}' does not exist")
        return False
    if os.path.exists(path_out):
        shutil.rmtree(path_out)
    os.makedirs(path_out)
    cmd = ["rtabmap-export", "--images", "--poses_format", "11", "--ba", "--poses_camera",
           "--images_id", "--output_dir", str(path_out), str(path_in)]
    return subprocess.run(cmd, capture_output=True, text=True).returncode == 0
