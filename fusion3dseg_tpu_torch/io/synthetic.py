"""Procedural synthetic RTAB session: a room with labeled box objects.

Counterpart of `fusion3dseg_tpu/io/synthetic.py` (NumPy, host side): it
ray-casts an axis-aligned room (floor/ceiling/4 walls) holding labeled
boxes from a circular camera trajectory and returns depth images, per-pixel
ground-truth class masks, colors, poses and intrinsics. The same seed gives
the same arrays as the JAX package's generator. `write_session_dir` writes
a session as an rtabmap-export directory through the port's own image
codec (`io/image.py`), `write_tum_dir` in the TUM RGB-D layout with
asynchronous streams, and `degrade_session` adds Kinect-style sensor
errors (the same draws as the JAX package's).

Coordinate convention: the camera looks down +z in its frame, world y is up.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import image

# default semantic ids for the room surfaces (COCO panoptic contiguous ids:
# floor-wood, ceiling-merged, wall-other-merged)
FLOOR_CLASS = 87
CEILING_CLASS = 118
WALL_CLASS = 131
# door-stuff, window-blind, window-other, couch, tv, keyboard
DEFAULT_OBJECT_CLASSES = (86, 114, 115, 57, 62, 66)


@dataclass
class RoomSpec:
    size: Tuple[float, float, float] = (6.0, 2.8, 8.0)  # x (width), y (height), z (depth)
    num_objects: int = 6
    object_classes: Tuple[int, ...] = DEFAULT_OBJECT_CLASSES
    seed: int = 0


@dataclass
class SyntheticSession:
    depth: np.ndarray  # [F, H, W] meters (0 = invalid)
    gt_mask: np.ndarray  # [F, H, W] uint8 ground-truth class ids
    colors: np.ndarray  # [F, H, W, 3] uint8
    K: np.ndarray  # [3, 3] (depth resolution)
    quats_wxyz: np.ndarray  # [F, 4]
    translations: np.ndarray  # [F, 3]
    boxes: np.ndarray  # [B, 6] (min xyz, max xyz) of objects
    box_classes: np.ndarray  # [B]
    room: RoomSpec = field(default_factory=RoomSpec)

    @property
    def nframes(self):
        return len(self.depth)

    @property
    def depth_hw(self):
        return self.depth.shape[1:3]


def _look_rotation(
    forward: np.ndarray, up=np.array([0.0, 1.0, 0.0]), upright: bool = False
) -> np.ndarray:
    """Camera->world rotation whose +z maps to `forward` (columns = axes).

    The default (upright=False) columns give a camera rolled 180° from
    the upright CV convention (y_cam maps to world UP while the pinhole
    v axis increases downward), as the JAX package's generator does; every
    consumer is self-consistent with it. `upright=True` is the upright
    convention (image right = f x up, image down = f x r)."""
    f = forward / np.linalg.norm(forward)
    if upright:
        r = np.cross(f, up)
        r = r / np.linalg.norm(r)
        d = np.cross(f, r)
        return np.stack([r, d, f], axis=1)
    r = np.cross(up, f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    return np.stack([r, u, f], axis=1)


def _mat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = np.argmax(np.diag(R))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _raycast(
    origins: np.ndarray,  # [3] shared, or [N, 3] per-ray
    dirs: np.ndarray,  # [N, 3]
    room: np.ndarray,  # [6] room min/max
    boxes: np.ndarray,  # [B, 6]
    box_classes: np.ndarray,
    max_depth: float,
    return_normals: bool = False,
):
    """Returns (t_hit [N], class [N][, normals [N,3], instance [N]]) for
    rays inside the room. Normals point back into the room (toward the eye
    side); `instance` is -1 for room surfaces, else the box index.

    This is the train data path's hottest host op (models/train.py yields
    batches from make_session), so it computes in f32 (mm-quantized depth
    pngs downstream; halves the memory traffic vs numpy's default f64) and
    slab-tests ALL boxes in one [N, B, 3] pass — nearest-valid-entry argmin
    replaces the reference-style sequential per-box update (identical
    result: both resolve to the first box attaining the minimal entry t)."""
    n = len(dirs)
    dirs = np.ascontiguousarray(dirs, np.float32)
    org = np.asarray(origins, np.float32)  # [3] shared or [N,3] per-ray
    room = np.asarray(room, np.float32)
    ar = np.arange(n)
    t_best = np.full(n, max_depth, np.float32)
    cls_best = np.zeros(n, np.uint8)
    nrm_axis = np.zeros(n, np.int8)  # hit-face axis
    nrm_sign = np.ones(n, np.float32)
    inst_best = np.full(n, -1, np.int16)

    with np.errstate(divide="ignore"):
        inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, np.float32(1e12))

    # room interior: exit-face intersection (largest t where still inside)
    rmin, rmax = room[:3], room[3:]
    # for each axis, the far slab plane in ray direction; axes the ray is
    # PARALLEL to (|d| <= 1e-12) never bound the exit — without the +inf
    # override the 1e12-inv fallback yields a huge NEGATIVE t that wins the
    # argmin and misclassifies the ray as leaving the closed room at t<=0
    t_far_axis = np.where(dirs > 0, (rmax - org) * inv, (rmin - org) * inv)
    t_far_axis = np.where(np.abs(dirs) <= 1e-12, np.float32(np.inf), t_far_axis)
    exit_axis = np.argmin(t_far_axis, axis=1)
    t_exit = t_far_axis[ar, exit_axis]
    # classify the exit face: y-axis -> floor/ceiling, else wall
    face_cls = np.where(
        exit_axis == 1,
        np.where(dirs[:, 1] > 0, CEILING_CLASS, FLOOR_CLASS),
        WALL_CLASS,
    ).astype(np.uint8)
    # the room is closed, so t_exit IS the visible surface: label every ray
    # with its exit-face class even beyond max_depth (leaving cls 0 there
    # would stamp a real COCO class — 'person' — on far pixels); the depth
    # for beyond-range rays is invalidated to 0 after the box pass below
    hit = t_exit > 0
    cls_best[hit] = face_cls[hit]
    nrm_axis[hit] = exit_axis[hit]
    # room face normal points back against the ray's axis direction
    nrm_sign[hit] = -np.sign(dirs[ar, exit_axis])[hit]
    in_range = hit & (t_exit < t_best)
    t_best[in_range] = t_exit[in_range]

    # object boxes: one batched slab-test entry intersection over all boxes.
    # Per-axis elementwise max/min chains instead of [N,B,3] axis
    # reductions: numpy's length-3 inner-axis reduce costs per-output-call
    # overhead that dominates this array size
    if len(boxes):
        bf = np.asarray(boxes, np.float32)
        per_ray = org.ndim == 2
        tmin = None  # running entry t (max over axes), [N, B]
        tmax = None  # running exit t (min over axes)
        tlo_ax = []
        for a in range(3):
            oa = org[:, a, None] if per_ray else org[a]
            ia = inv[:, a, None]  # [N, 1]
            t1 = (bf[None, :, a] - oa) * ia  # [N, B]
            t2 = (bf[None, :, 3 + a] - oa) * ia
            lo = np.minimum(t1, t2)
            hi = np.maximum(t1, t2)
            tlo_ax.append(lo)
            tmin = lo if tmin is None else np.maximum(tmin, lo)
            tmax = hi if tmax is None else np.minimum(tmax, hi)
        tmin = np.where((tmax >= tmin) & (tmin > 1e-6), tmin, np.float32(np.inf))
        b_best = np.argmin(tmin, axis=1)  # [N] first minimal-entry box
        tmin_best = tmin[ar, b_best]
        hit = tmin_best < t_best
        # entry axis recovered for the winners only ([N] vs [N,B]): the
        # axis whose slab-entry equals the winning entry t
        lo_w = np.stack([lo[ar, b_best] for lo in tlo_ax], axis=1)  # [N, 3]
        ea = np.argmax(lo_w, axis=1)
        t_best[hit] = tmin_best[hit]
        cls_best[hit] = box_classes[b_best[hit]]
        nrm_axis[hit] = ea[hit].astype(np.int8)
        nrm_sign[hit] = -np.sign(dirs[ar, ea])[hit]
        inst_best[hit] = b_best[hit].astype(np.int16)

    # rays whose nearest surface lies beyond max_depth: depth is invalid
    # (0 -> excluded by every depth-range mask); the mask keeps the true
    # surface class from above
    t_best[t_best >= max_depth] = 0.0

    if not return_normals:
        return t_best, cls_best
    normals = np.zeros((n, 3), np.float32)
    normals[ar, nrm_axis] = nrm_sign
    return t_best, cls_best, normals, inst_best


_CLASS_COLOR_CACHE = {}


def _class_color(cls: int) -> np.ndarray:
    if cls not in _CLASS_COLOR_CACHE:
        rng = np.random.default_rng(cls)
        _CLASS_COLOR_CACHE[cls] = (rng.uniform(0.2, 1.0, 3) * 255).astype(np.uint8)
    return _CLASS_COLOR_CACHE[cls]


def session_boxes(
    room: RoomSpec, rng: Optional[np.random.Generator] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """The room's object boxes + classes — the GEOMETRY half of
    make_session. Pass make_session's own rng to consume the same stream prefix it always
    did (keeping every downstream draw bit-identical); None draws a
    fresh generator from room.seed — the identical values."""
    rng = rng if rng is not None else np.random.default_rng(room.seed)
    sx, sy, sz = room.size
    boxes, bclasses = [], []
    th = 0.06  # wall-panel protrusion into the room
    for i in range(room.num_objects):
        cls = room.object_classes[i % len(room.object_classes)]
        side = i % 4
        # wall `side` runs along L = sx (sides 0/1, the z walls) or sz;
        # objects on the same wall take disjoint halves to limit overlap
        L = sx if side < 2 else sz
        j = (i // 4) % 2
        lo, hi = j * L / 2 + 0.2, (j + 1) * L / 2 - 0.2
        if cls == 86:  # door
            w = rng.uniform(0.85, 1.05)
            y0, y1 = 0.0, min(rng.uniform(1.9, 2.1), sy - 0.1)
            d = th
        elif cls == 114:  # window-blind: wide + short
            w = rng.uniform(1.4, 1.8)
            y0 = rng.uniform(0.9, 1.2)
            y1 = y0 + rng.uniform(0.55, 0.8)
            d = th
        elif cls == 115:  # window-other: square-ish
            w = rng.uniform(0.9, 1.25)
            y0 = rng.uniform(0.9, 1.3)
            y1 = y0 + w * rng.uniform(0.9, 1.1)
            d = th
        elif cls == 62:  # tv: thin, mounted high
            w = rng.uniform(0.9, 1.25)
            y0 = rng.uniform(1.4, 1.7)
            y1 = y0 + rng.uniform(0.5, 0.7)
            d = th
        elif cls == 57:  # couch: long x low, on the floor
            w = rng.uniform(1.6, 2.2)
            y0, y1 = 0.0, rng.uniform(0.7, 0.85)
            d = rng.uniform(0.8, 0.95)
        elif cls == 66:  # keyboard: tiny flat slab
            w = rng.uniform(0.35, 0.5)
            y0, y1 = 0.0, rng.uniform(0.035, 0.05)
            d = rng.uniform(0.12, 0.18)
        else:  # generic object (legacy behavior)
            w, h, d = rng.uniform(0.3, 1.2, 3) * np.array([1.0, 1.5, 1.0])
            y0, y1 = 0.0, min(h, sy)
        w = min(w, hi - lo - 0.01)
        a0 = rng.uniform(lo, hi - w)  # position along the wall
        gap = 0.0 if d == th else rng.uniform(0, 0.25)  # floor boxes drift
        if side == 0:
            x0, x1, z0, z1 = a0, a0 + w, gap, gap + d
        elif side == 1:
            x0, x1, z0, z1 = a0, a0 + w, sz - d - gap, sz - gap
        elif side == 2:
            x0, x1, z0, z1 = gap, gap + d, a0, a0 + w
        else:
            x0, x1, z0, z1 = sx - d - gap, sx - gap, a0, a0 + w
        boxes.append([x0, y0, z0, x1, min(y1, sy), z1])
        bclasses.append(cls)
    boxes = np.asarray(boxes) if boxes else np.zeros((0, 6))
    return boxes, np.asarray(bclasses, np.uint8)


def session_appearance(room: RoomSpec, nboxes: int) -> dict:
    """The per-session "textured" appearance tables of make_session."""
    app = np.random.default_rng(room.seed + 7777)
    out = {}
    out["base_color"] = app.uniform(0.15, 0.95, (256, 3)).astype(np.float32)
    out["tex_k1"] = (app.uniform(2.0, 10.0, (256, 3))
                     * app.choice([-1.0, 1.0], (256, 3))).astype(np.float32)
    out["tex_p1"] = app.uniform(0, 2 * np.pi, 256).astype(np.float32)
    out["tex_k2"] = (app.uniform(12.0, 35.0, (256, 3))
                     * app.choice([-1.0, 1.0], (256, 3))).astype(np.float32)
    out["tex_p2"] = app.uniform(0, 2 * np.pi, 256).astype(np.float32)
    out["tex_amp"] = app.uniform(0.10, 0.35, 256).astype(np.float32)
    # per-box-instance tint (row B = room surfaces: no jitter)
    out["inst_tint"] = np.vstack(
        [app.uniform(-0.10, 0.10, (max(nboxes, 1), 3)), np.zeros((1, 3))]
    ).astype(np.float32)
    lite = app.uniform(-1, 1, 3)
    lite[1] = app.uniform(0.5, 1.0)  # light from above
    out["lite"] = (lite / np.linalg.norm(lite)).astype(np.float32)
    out["ambient"] = np.float32(app.uniform(0.35, 0.55))
    return out


def session_poses(
    room: RoomSpec, nframes: int, turns: float = 1.0, upright: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Circular outward-looking trajectory: (eyes [F,3] f64, Rs [F,3,3]
    f64, quats_wxyz [F,4]) — make_session's pose loop."""
    sx, sy, sz = room.size
    center = np.array([sx / 2, sy * 0.55, sz / 2])
    r_traj = 0.25 * min(sx, sz)
    eyes = np.zeros((nframes, 3))
    Rs = np.zeros((nframes, 3, 3))
    quats = np.zeros((nframes, 4))
    for fidx in range(nframes):
        ang = 2 * np.pi * turns * fidx / max(nframes, 1)
        eyes[fidx] = center + r_traj * np.array([np.cos(ang), 0.0, np.sin(ang)])
        fwd = np.array([np.cos(ang), -0.1, np.sin(ang)])  # outward, slightly down
        Rs[fidx] = _look_rotation(fwd, upright=upright)
        quats[fidx] = _mat_to_quat_wxyz(Rs[fidx])
    return eyes, Rs, quats


def make_session(
    nframes: int = 10,
    depth_hw: Tuple[int, int] = (256, 192),
    room: Optional[RoomSpec] = None,
    max_depth: float = 10.0,
    noise: float = 0.0,
    appearance: str = "flat",
    turns: float = 1.0,
    upright: bool = False,
) -> SyntheticSession:
    """Generate a session: circular trajectory inside the room, cameras
    looking outward, depth + ground-truth class mask per frame. `turns`
    laps the circle that many times (> 1 produces repeated loop closures —
    the long-session soak's windowing stress case).

    appearance:
      * "flat" — one fixed color per class across ALL sessions (fast; fine
        for geometry/fusion work, but a 2D model trained on it partly
        reduces to a color lookup).
      * "textured" — per-SESSION random palette (a class's color is not
        stable across sessions), procedural sine-field textures per class,
        per-instance tint jitter, one directional light with Lambertian
        shading off the true surface normals, and lens vignetting. A model
        trained across many textured sessions cannot bind color->class and
        must use spatial context.
    """
    room = room or RoomSpec()
    rng = np.random.default_rng(room.seed)
    H, W = depth_hw
    sx, sy, sz = room.size
    room_box = np.array([0.0, 0.0, 0.0, sx, sy, sz])

    # objects: class-conditional shape priors along the walls (never blocking
    # the center). With textured appearance the palette is random per
    # session, so GEOMETRY is the only session-stable class cue — each class
    # gets a characteristic placement/size so a 2D model can identify it
    # from spatial context (doors reach the floor, windows sit at sill
    # height, TVs hang high and thin, couches are long and low, keyboards
    # are tiny floor slabs):
    #   86 door-stuff     flush wall panel, floor..~2.0 m
    #   114 window-blind  flush wall panel, wide+short, sill ~1 m
    #   115 window-other  flush wall panel, square-ish, sill ~1 m
    #   62 tv             thin wall panel, mounted 1.4-1.7 m
    #   57 couch          floor box against the wall, long x low
    #   66 keyboard       small flat slab on the floor
    # Other class ids fall back to the generic floor box.
    # (passing `rng` to session_boxes keeps this function's stream
    # identical)
    boxes, bclasses = session_boxes(room, rng)

    f = 0.6 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])

    # pixel ray directions in camera frame
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    # f32 end-to-end through the raycast + shading (host data-path hot
    # loop; depth is mm-quantized downstream, color is u8)
    rays_cam = np.stack(
        [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1
    ).reshape(-1, 3).astype(np.float32)

    if appearance == "textured":
        # per-session appearance, seeded independently of geometry draws
        # (f32 constants keep the per-frame shading f32 while the draws
        # stay f64 so sampled VALUES are unchanged)
        ap = session_appearance(room, len(boxes))
        base_color, tex_amp = ap["base_color"], ap["tex_amp"]
        tex_k1, tex_p1 = ap["tex_k1"], ap["tex_p1"]
        tex_k2, tex_p2 = ap["tex_k2"], ap["tex_p2"]
        inst_tint, lite, ambient = ap["inst_tint"], ap["lite"], ap["ambient"]
        r2 = (((u - K[0, 2]) / K[0, 2]) ** 2 + ((v - K[1, 2]) / K[1, 2]) ** 2).reshape(-1)
        vignette = (1.0 - 0.25 * r2 / r2.max()).astype(np.float32)
    elif appearance != "flat":
        raise ValueError(f"unknown appearance {appearance!r}")

    depths = np.zeros((nframes, H, W), np.float32)
    masks = np.zeros((nframes, H, W), np.uint8)
    colors = np.zeros((nframes, H, W, 3), np.uint8)
    quats = np.zeros((nframes, 4))
    trans = np.zeros((nframes, 3))

    eyes, Rs, quats_all = session_poses(room, nframes, turns, upright)
    for fidx in range(nframes):
        eye, R, q = eyes[fidx], Rs[fidx], quats_all[fidx]
        # world-frame ray directions (unit z-depth scaled), f32 throughout
        dirs = rays_cam @ R.T.astype(np.float32)

        if appearance == "textured":
            t, cls, nrm, inst = _raycast(
                eye, dirs, room_box, boxes, bclasses, max_depth,
                return_normals=True,
            )
        else:
            t, cls = _raycast(eye, dirs, room_box, boxes, bclasses, max_depth)
        # depth = camera z distance: t * (z-component scale). rays_cam has
        # z=1 so camera depth = t * 1 along the camera z axis... t is the ray
        # parameter for P = eye + t*dir with dir = R@[x,y,1]; camera depth of
        # P is exactly t (z-component of R^T(P-eye) = t*1).
        d = t.reshape(H, W).astype(np.float32)
        if noise > 0:
            d = d * (1.0 + rng.normal(0, noise, d.shape).astype(np.float32))
        depths[fidx] = d
        masks[fidx] = cls.reshape(H, W)
        if appearance == "textured":
            # world hit positions (f32: t, dirs already are)
            P = eye.astype(np.float32)[None] + t[:, None] * dirs
            s1 = np.sin(np.sum(P * tex_k1[cls], axis=1) + tex_p1[cls])
            s2 = np.sin(np.sum(P * tex_k2[cls], axis=1) + tex_p2[cls])
            tex = 1.0 + tex_amp[cls] * (0.7 * s1 + 0.3 * s2)
            shade = ambient + (1.0 - ambient) * np.clip(nrm @ lite, 0.0, 1.0)
            rgbf = (base_color[cls] + inst_tint[inst]) * (tex * shade * vignette)[:, None]
            colors[fidx] = np.clip(rgbf * 255.0, 0, 255).astype(np.uint8).reshape(H, W, 3)
        else:
            lut = np.zeros((256, 3), np.uint8)
            for c in np.unique(cls):
                lut[c] = _class_color(int(c))
            colors[fidx] = lut[cls].reshape(H, W, 3)
        quats[fidx] = q
        trans[fidx] = eye

    return SyntheticSession(
        depth=depths, gt_mask=masks, colors=colors, K=K,
        quats_wxyz=quats, translations=trans,
        boxes=boxes, box_classes=bclasses, room=room,
    )


def write_session_dir(session: SyntheticSession, out_dir, write_masks: bool = True) -> Path:
    """Write the session as an rtabmap-export directory: rgb/<i>.jpg
    (quality 95, 4:2:0), depth/<i>.png (16-bit millimetres), poses.txt
    (RGBD-SLAM + id), calibration.yaml and, with `write_masks`,
    masks/<i>.png (the ground-truth class ids, standing in for a 2D
    segmenter's output). The same files as the JAX package's writer, up to
    the JPEG and PNG encoders' bytes."""
    out_dir = Path(out_dir)
    (out_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (out_dir / "depth").mkdir(exist_ok=True)
    if write_masks:
        (out_dir / "masks").mkdir(exist_ok=True)

    lines = []
    for i in range(session.nframes):
        image.write(out_dir / "rgb" / f"{i}.jpg", session.colors[i])
        dmm = np.clip(session.depth[i] * 1000.0, 0, 65535).astype(np.uint16)
        image.write(out_dir / "depth" / f"{i}.png", dmm)
        if write_masks:
            image.write(out_dir / "masks" / f"{i}.png", session.gt_mask[i])
        q = session.quats_wxyz[i]
        t = session.translations[i]
        # RGBD-SLAM + id: timestamp x y z qx qy qz qw id
        lines.append(f"{float(i)} {t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]} {i}")
    (out_dir / "poses.txt").write_text("\n".join(lines) + "\n")

    K = session.K
    (out_dir / "calibration.yaml").write_text(
        "%YAML:1.0\n---\n"
        "camera_matrix:\n   rows: 3\n   cols: 3\n"
        f"   data: [{K[0,0]}, 0., {K[0,2]}, 0., {K[1,1]}, {K[1,2]}, 0., 0., 1.]\n")
    return out_dir


def degrade_session(
    session: SyntheticSession,
    *,
    seed: int = 0,
    depth_noise: bool = True,
    quantize: bool = True,
    hole_fraction: float = 0.03,
    edge_dropout: float = 0.5,
    border: int = 4,
    pose_drift: float = 0.0,
    rgb_noise: float = 5.0,
    mask_error: float = 0.0,
) -> SyntheticSession:
    """Kinect-style sensor degradation of a ray-cast session, which is
    noiseless and hole-free, unlike a real capture. The structured-light
    error model, drawn from `default_rng(seed)` in the JAX package's order:

      * axial noise     sigma_z(z) = 0.0012 + 0.0019 (z-0.4)^2 m
                        (Khoshelham & Elberink 2012 Kinect model)
      * quantization    disparity step q(z) = 2.85e-3 z^2 m, depth rounded
                        to the step (dominates past ~3 m)
      * holes           random dropout blobs (low-res noise upsampled) over
                        `hole_fraction` of pixels, plus `edge_dropout`
                        probability at depth discontinuities (grazing
                        surfaces return no IR speckle) and a `border` px
                        invalid rim — all set to depth 0 ("missing", the
                        TUM/kinect convention)
      * pose drift      per-frame random-walk translation error of step
                        `pose_drift` meters plus proportional rotation
                        jitter (SLAM trajectories are locally noisy)
      * rgb noise       additive gaussian (sensor) noise, std in 8-bit units
      * mask errors     `mask_error` fraction of mask pixels flipped to a
                        random other class (an imperfect 2D model; the
                        multi-view vote should denoise these)

    Returns a NEW SyntheticSession; gt geometry (boxes) is unchanged, so
    geometric ground-truth checks remain valid up to the injected noise.
    """
    rng = np.random.default_rng(seed)
    depth = session.depth.copy()
    colors = session.colors.copy()
    masks = session.gt_mask.copy()
    quats = session.quats_wxyz.copy()
    trans = session.translations.copy()
    F, H, W = depth.shape

    valid = depth > 0
    if depth_noise:
        sigma = 0.0012 + 0.0019 * np.square(np.maximum(depth - 0.4, 0.0))
        depth = np.where(valid, depth + rng.normal(0, 1, depth.shape) * sigma, 0.0)
    if quantize:
        step = np.maximum(2.85e-3 * np.square(depth), 1e-3)  # >= 1 mm
        depth = np.where(valid, np.round(depth / step) * step, 0.0)

    if hole_fraction > 0:
        blob = rng.random((F, max(H // 16, 1), max(W // 16, 1)))
        reps = (H + blob.shape[1] - 1) // blob.shape[1], (W + blob.shape[2] - 1) // blob.shape[2]
        blob = np.repeat(np.repeat(blob, reps[0], axis=1), reps[1], axis=2)[:, :H, :W]
        depth = np.where(blob < hole_fraction, 0.0, depth)
    if edge_dropout > 0:
        gy = np.abs(np.diff(depth, axis=1, prepend=depth[:, :1]))
        gx = np.abs(np.diff(depth, axis=2, prepend=depth[:, :, :1]))
        edges = (gy + gx) > 0.08 * np.maximum(depth, 0.5)
        drop = edges & (rng.random(depth.shape) < edge_dropout)
        depth = np.where(drop, 0.0, depth)
    if border > 0:
        depth[:, :border], depth[:, -border:] = 0.0, 0.0
        depth[:, :, :border], depth[:, :, -border:] = 0.0, 0.0

    if pose_drift > 0:
        walk = np.cumsum(rng.normal(0, pose_drift, (F, 3)), axis=0)
        trans = trans + walk
        # small-angle quaternion jitter, composed on the left
        ang = rng.normal(0, pose_drift * 0.5, (F, 3))
        half = 0.5 * ang
        dq = np.concatenate([np.ones((F, 1)), half], axis=1)
        dq /= np.linalg.norm(dq, axis=1, keepdims=True)
        w0, x0, y0, z0 = dq.T
        w1, x1, y1, z1 = quats.T
        quats = np.stack([
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
        ], axis=1)

    if rgb_noise > 0:
        noisy = colors.astype(np.float32) + rng.normal(0, rgb_noise, colors.shape)
        colors = np.clip(noisy, 0, 255).astype(np.uint8)

    if mask_error > 0:
        flip = rng.random(masks.shape) < mask_error
        masks = np.where(
            flip, rng.integers(0, 133, masks.shape, dtype=np.uint8), masks
        )

    return SyntheticSession(
        depth=depth.astype(np.float32), gt_mask=masks, colors=colors,
        K=session.K, quats_wxyz=quats, translations=trans,
        boxes=session.boxes, box_classes=session.box_classes,
        room=session.room,
    )


def write_tum_dir(
    session: SyntheticSession,
    out_dir,
    *,
    fps: float = 30.0,
    rgb_depth_offset: float = 0.008,
    ts_jitter: float = 0.002,
    pose_rate: float = 3.0,
    drop_depth: Tuple[int, ...] = (),
    seed: int = 0,
) -> Path:
    """Materialize the session in the TUM RGB-D benchmark layout
    (rgb.txt/depth.txt/groundtruth.txt + 16-bit depth pngs at 1/5000 m) with
    realistically ASYNCHRONOUS streams: depth timestamps offset from rgb by
    `rgb_depth_offset` s, per-stamp jitter, a `pose_rate`x-rate trajectory,
    and optional dropped depth frames — exercising io/tum.py's association
    exactly the way a real capture does. Images go through the port's
    codec: 8-bit RGB PNGs and 16-bit depth PNGs."""
    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    (out_dir / "rgb").mkdir(parents=True, exist_ok=True)
    (out_dir / "depth").mkdir(exist_ok=True)
    t0 = 1305031100.0  # epoch-style base stamp like the real sequences
    dt = 1.0 / fps

    rgb_lines, depth_lines, gt_lines = [], [], []
    for i in range(session.nframes):
        tr = t0 + i * dt + rng.uniform(-ts_jitter, ts_jitter)
        name = f"{tr:.6f}"
        image.write(out_dir / "rgb" / f"{name}.png", session.colors[i])
        rgb_lines.append(f"{name} rgb/{name}.png")
        if i not in drop_depth:
            td = tr + rgb_depth_offset + rng.uniform(-ts_jitter, ts_jitter)
            dname = f"{td:.6f}"
            d = np.clip(session.depth[i] * 5000.0, 0, 65535).astype(np.uint16)
            image.write(out_dir / "depth" / f"{dname}.png", d)
            depth_lines.append(f"{dname} depth/{dname}.png")

    # trajectory at a higher rate with linear interpolation between frames
    nposes = int(session.nframes * pose_rate)
    for k in range(nposes):
        ft = k / pose_rate
        i0 = min(int(ft), session.nframes - 1)
        i1 = min(i0 + 1, session.nframes - 1)
        a = ft - i0
        t = (1 - a) * session.translations[i0] + a * session.translations[i1]
        q = (1 - a) * session.quats_wxyz[i0] + a * session.quats_wxyz[i1]
        q = q / np.linalg.norm(q)
        tp = t0 + ft * dt + rng.uniform(-ts_jitter, ts_jitter) * 0.5
        gt_lines.append(
            f"{tp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}"
        )

    hdr = "# synthetic TUM-format session\n# timestamp data\n"
    (out_dir / "rgb.txt").write_text(hdr + "\n".join(rgb_lines) + "\n")
    (out_dir / "depth.txt").write_text(hdr + "\n".join(depth_lines) + "\n")
    (out_dir / "groundtruth.txt").write_text(
        "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n"
        + "\n".join(gt_lines) + "\n"
    )
    return out_dir
