"""TUM RGB-D sequences: real captures as sessions.

Counterpart of `fusion3dseg_tpu/io/tum.py`. A sequence directory of the
TUM RGB-D benchmark (Sturm et al., IROS 2012):

    <seq>/rgb.txt          "timestamp rgb/<ts>.png" listing
    <seq>/depth.txt        "timestamp depth/<ts>.png" listing
    <seq>/groundtruth.txt  "timestamp tx ty tz qx qy qz qw" trajectory
    <seq>/rgb/*.png        8-bit colour
    <seq>/depth/*.png      16-bit depth, value/5000 = metres, 0 = missing

The three streams carry their own timestamps and are associated greedily,
nearest first within a tolerance (the dataset's associate.py). Poses are
camera-to-world position + xyzw quaternion, the RGBD-SLAM format the
reference asks rtabmap-export for, so a loaded session drops into
`SessionData`. `convert_to_export_dir` rewrites a sequence as an
rtabmap-export directory. Images go through the port's codec
(`io/image.py`), in RGB order.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import image

# Default intrinsics per TUM kinect unit (the dataset's published values;
# the benchmark states the ROS default 525/319.5/239.5 is close for all).
FREIBURG_INTRINSICS = {
    "fr1": (517.3, 516.5, 318.6, 255.3),
    "fr2": (520.9, 521.0, 325.1, 249.7),
    "fr3": (535.4, 539.2, 320.1, 247.6),
    "ros_default": (525.0, 525.0, 319.5, 239.5),
}

DEPTH_SCALE = 5000.0  # 16-bit png value -> meters divisor


def intrinsics_matrix(preset_or_fxfycxcy) -> np.ndarray:
    """[3,3] K from a freiburg preset name or an (fx, fy, cx, cy) tuple."""
    if isinstance(preset_or_fxfycxcy, str):
        key = preset_or_fxfycxcy.lower()
        for name, vals in FREIBURG_INTRINSICS.items():
            if key.startswith(name) or name in key:
                fx, fy, cx, cy = vals
                break
        else:
            raise KeyError(
                f"unknown intrinsics preset {preset_or_fxfycxcy!r}; "
                f"use one of {sorted(FREIBURG_INTRINSICS)} or pass "
                "(fx, fy, cx, cy)"
            )
    else:
        fx, fy, cx, cy = preset_or_fxfycxcy
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


def read_file_list(path) -> Dict[float, List[str]]:
    """Parse a TUM listing file: 'timestamp data...' lines, '#' comments."""
    out: Dict[float, List[str]] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out[float(parts[0])] = parts[1:]
    return out


def associate(
    ts_a: Sequence[float],
    ts_b: Sequence[float],
    max_difference: float = 0.02,
    offset: float = 0.0,
) -> List[Tuple[float, float]]:
    """Greedy nearest-timestamp association (the benchmark's associate.py
    semantics): among all |a - (b + offset)| <= max_difference pairs, take
    them best-first, each timestamp matched at most once; return pairs
    sorted by a."""
    a = sorted(ts_a)
    b = sorted(ts_b)
    candidates = []
    j0 = 0
    for ta in a:
        # advance a window over b (both sorted): only b's within tolerance
        while j0 < len(b) and b[j0] + offset < ta - max_difference:
            j0 += 1
        j = j0
        while j < len(b) and b[j] + offset <= ta + max_difference:
            candidates.append((abs(ta - (b[j] + offset)), ta, b[j]))
            j += 1
    candidates.sort()
    used_a, used_b, pairs = set(), set(), []
    for _, ta, tb in candidates:
        if ta not in used_a and tb not in used_b:
            used_a.add(ta)
            used_b.add(tb)
            pairs.append((ta, tb))
    pairs.sort()
    return pairs


def read_trajectory(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """groundtruth.txt -> (timestamps [N], xyz [N,3], quat_xyzw [N,4])."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        if len(vals) >= 8:
            rows.append(vals[:8])
    arr = np.asarray(rows, np.float64)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def load_associations(
    seq_dir,
    max_difference: float = 0.02,
    pose_max_difference: float = 0.02,
    trajectory=None,
) -> List[Tuple[float, str, float, str, float]]:
    """Associate the three streams of a TUM sequence.

    Returns a list of (rgb_ts, rgb_file, depth_ts, depth_file, pose_ts)
    tuples — one per frame that has all three. Frames lacking a depth or
    pose partner within tolerance are dropped (real sequences always lose
    a few at the start/end of the mocap volume)."""
    seq_dir = Path(seq_dir)
    rgb = read_file_list(seq_dir / "rgb.txt")
    depth = read_file_list(seq_dir / "depth.txt")
    if trajectory is None:
        trajectory = read_trajectory(seq_dir / "groundtruth.txt")
    pose_ts = trajectory[0]

    rd = associate(list(rgb), list(depth), max_difference)
    pose_of = {
        tr: tp for tr, tp in associate(
            [p[0] for p in rd], list(pose_ts), pose_max_difference
        )
    }
    out = []
    for tr, td in rd:
        tp = pose_of.get(tr)
        if tp is not None:
            out.append((tr, rgb[tr][0], td, depth[td][0], tp))
    return out


def load_session(
    seq_dir,
    intrinsics="ros_default",
    max_difference: float = 0.02,
    startf: int = 0,
    stopf: Optional[int] = None,
    stepf: int = 1,
    depth_scale: float = DEPTH_SCALE,
    device="cuda",
):
    """Load a TUM RGB-D sequence directory as a SessionData.

    intrinsics: freiburg preset name ('fr1'/'fr2'/'fr3'/'ros_default' —
    auto-matched against the directory name too) or (fx, fy, cx, cy).

    Depth value 0 means missing in the dataset; it back-projects to the
    camera origin and is culled by any point_range lower bound > 0 (use
    e.g. point_range=(0.1, 5.0) downstream, mirroring the reference's
    defaults, process3D.py:17). The session's per-pixel arrays go to
    `device`. Returns (SessionData, rgb timestamps).
    """
    from fusion3dseg_tpu_torch.io.rtab import SessionData

    seq_dir = Path(seq_dir)
    K = _resolve_intrinsics(intrinsics, seq_dir)

    # parse the (often tens-of-thousands-of-lines) trajectory ONCE and
    # share it with the association pass
    pose_ts, pose_xyz, pose_q = read_trajectory(seq_dir / "groundtruth.txt")
    assoc = load_associations(
        seq_dir, max_difference, trajectory=(pose_ts, pose_xyz, pose_q)
    )[startf:stopf:stepf]
    if not assoc:
        raise FileNotFoundError(
            f"no rgb/depth/pose associations within {max_difference}s "
            f"in {seq_dir} — is this a TUM RGB-D sequence directory?"
        )
    pose_at = {t: i for i, t in enumerate(pose_ts)}

    rgbs, depths, xyz, xyzw, stamps = [], [], [], [], []
    for tr, frgb, td, fdepth, tp in assoc:
        rgb, d = _read_pair(seq_dir / frgb, seq_dir / fdepth)
        if rgb is None:
            continue  # listed but missing on disk
        rgbs.append(rgb)
        depths.append(d.astype(np.float32))
        k = pose_at[tp]
        xyz.append(pose_xyz[k])
        xyzw.append(pose_q[k])
        stamps.append(tr)
    if not rgbs:
        raise FileNotFoundError(f"no readable frames in {seq_dir}")

    return SessionData.from_arrays(
        np.stack(rgbs),
        np.stack(depths) / depth_scale,
        K,
        np.stack(xyzw),
        np.stack(xyz),
        frame_numbers=np.arange(len(rgbs)),
        device=device,
    ), np.asarray(stamps)


def _read_pair(rgb_file, depth_file):
    """(RGB uint8, stored depth samples) of one frame, or (None, None) when
    either file is missing or unreadable."""
    try:
        return image.read(rgb_file), image.read(depth_file, unchanged=True)
    except (OSError, image.ImageError):
        return None, None


def _resolve_intrinsics(intrinsics, seq_dir):
    """Resolve "ros_default" by sniffing the freiburg unit from the sequence
    directory name (shared by load_tum_session and convert_to_export_dir)."""
    if isinstance(intrinsics, str) and intrinsics == "ros_default":
        name = Path(seq_dir).name.lower()
        for unit in ("fr1", "fr2", "fr3"):
            if f"freiburg{unit[-1]}" in name or unit in name:
                intrinsics = unit
                break
    return intrinsics_matrix(intrinsics)


def convert_to_export_dir(
    seq_dir,
    out_dir,
    intrinsics="ros_default",
    max_difference: float = 0.02,
    depth_scale: float = DEPTH_SCALE,
) -> Path:
    """Rewrite a TUM sequence as an rtabmap-export-style directory
    (rgb/<i>.jpg, depth/<i>.png in mm, poses.txt RGBD-SLAM+id format,
    calibration.yaml) — the layout SessionData.from_export_dir and the
    reference pipeline consume. The JPEGs are the port's baseline encoder at
    quality 95, the depth PNGs 16-bit."""
    seq_dir, out_dir = Path(seq_dir), Path(out_dir)
    (out_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (out_dir / "depth").mkdir(exist_ok=True)

    K = _resolve_intrinsics(intrinsics, seq_dir)

    assoc = load_associations(seq_dir, max_difference)
    pose_ts, pose_xyz, pose_q = read_trajectory(seq_dir / "groundtruth.txt")
    pose_at = {t: i for i, t in enumerate(pose_ts)}

    lines = []
    for i, (tr, frgb, td, fdepth, tp) in enumerate(assoc):
        rgb, d = _read_pair(seq_dir / frgb, seq_dir / fdepth)
        if rgb is None:
            continue
        image.write(out_dir / "rgb" / f"{i}.jpg", rgb)
        dmm = np.clip(
            d.astype(np.float64) / depth_scale * 1000.0, 0, 65535
        ).astype(np.uint16)
        image.write(out_dir / "depth" / f"{i}.png", dmm)
        k = pose_at[tp]
        t, q = pose_xyz[k], pose_q[k]
        lines.append(
            f"{tr} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]} {i}"
        )
    (out_dir / "poses.txt").write_text("\n".join(lines) + "\n")
    (out_dir / "calibration.yaml").write_text(
        "%YAML:1.0\n---\n"
        "camera_matrix:\n   rows: 3\n   cols: 3\n   data: [ "
        + ", ".join(f"{v:.6f}" for v in K.reshape(-1))
        + " ]\n"
    )
    return out_dir
