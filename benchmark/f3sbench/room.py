"""The benchmark's traffic generator: synthetic rooms rendered on the card.

A frozen copy of the port's synthetic room (`io/synthetic.py`: the room,
its boxes, the textured appearance, the circular outward-looking
trajectory) and of its device renderer (`io/synthetic_device.py`), widened
to any pinhole intrinsics and to a depth output, and of `io/workload`'s
room cloud. It imports nothing of the program, so that a change to the
program cannot move the yardstick.

Everything is float32 with TF32 off: the slab test compares ray parameters,
and a rounded product would move hits between surfaces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

FLOOR_CLASS, CEILING_CLASS, WALL_CLASS = 87, 118, 131
# door-stuff, window-blind, window-other, couch, tv, keyboard
OBJECT_CLASSES = (86, 114, 115, 57, 62, 66)
MAX_DEPTH = 10.0  # the sensor's range: no return past it
CHUNK = 16  # frames rendered at a time


@dataclass(frozen=True)
class Room:
    seed: int
    num_objects: int = 8
    size: Tuple[float, float, float] = (6.0, 2.8, 8.0)  # x, y (up), z


def room_boxes(room: Room) -> Tuple[np.ndarray, np.ndarray]:
    """[B, 6] boxes (min xyz, max xyz) against the walls and [B] classes."""
    rng = np.random.default_rng(room.seed)
    sx, sy, sz = room.size
    boxes, classes = [], []
    th = 0.06
    for i in range(room.num_objects):
        cls = OBJECT_CLASSES[i % len(OBJECT_CLASSES)]
        side = i % 4
        L = sx if side < 2 else sz
        j = (i // 4) % 2
        lo, hi = j * L / 2 + 0.2, (j + 1) * L / 2 - 0.2
        if cls == 86:  # door
            w = rng.uniform(0.85, 1.05)
            y0, y1, d = 0.0, min(rng.uniform(1.9, 2.1), sy - 0.1), th
        elif cls == 114:  # window-blind
            w = rng.uniform(1.4, 1.8)
            y0 = rng.uniform(0.9, 1.2)
            y1, d = y0 + rng.uniform(0.55, 0.8), th
        elif cls == 115:  # window-other
            w = rng.uniform(0.9, 1.25)
            y0 = rng.uniform(0.9, 1.3)
            y1, d = y0 + w * rng.uniform(0.9, 1.1), th
        elif cls == 62:  # tv
            w = rng.uniform(0.9, 1.25)
            y0 = rng.uniform(1.4, 1.7)
            y1, d = y0 + rng.uniform(0.5, 0.7), th
        elif cls == 57:  # couch
            w = rng.uniform(1.6, 2.2)
            y0, y1 = 0.0, rng.uniform(0.7, 0.85)
            d = rng.uniform(0.8, 0.95)
        else:  # keyboard
            w = rng.uniform(0.35, 0.5)
            y0, y1 = 0.0, rng.uniform(0.035, 0.05)
            d = rng.uniform(0.12, 0.18)
        w = min(w, hi - lo - 0.01)
        a0 = rng.uniform(lo, hi - w)
        gap = 0.0 if d == th else rng.uniform(0, 0.25)
        if side == 0:
            x0, x1, z0, z1 = a0, a0 + w, gap, gap + d
        elif side == 1:
            x0, x1, z0, z1 = a0, a0 + w, sz - d - gap, sz - gap
        elif side == 2:
            x0, x1, z0, z1 = gap, gap + d, a0, a0 + w
        else:
            x0, x1, z0, z1 = sx - d - gap, sx - gap, a0, a0 + w
        boxes.append([x0, y0, z0, x1, min(y1, sy), z1])
        classes.append(cls)
    return np.asarray(boxes, np.float64).reshape(-1, 6), np.asarray(classes, np.int64)


def room_appearance(room: Room, nboxes: int) -> dict:
    """The per-room textured appearance tables."""
    app = np.random.default_rng(room.seed + 7777)
    out = {"base_color": app.uniform(0.15, 0.95, (256, 3))}
    out["tex_k1"] = app.uniform(2.0, 10.0, (256, 3)) * app.choice([-1.0, 1.0], (256, 3))
    out["tex_p1"] = app.uniform(0, 2 * np.pi, 256)
    out["tex_k2"] = app.uniform(12.0, 35.0, (256, 3)) * app.choice([-1.0, 1.0], (256, 3))
    out["tex_p2"] = app.uniform(0, 2 * np.pi, 256)
    out["tex_amp"] = app.uniform(0.10, 0.35, 256)
    out["inst_tint"] = np.vstack([app.uniform(-0.10, 0.10, (max(nboxes, 1), 3)),
                                  np.zeros((1, 3))])
    lite = app.uniform(-1, 1, 3)
    lite[1] = app.uniform(0.5, 1.0)
    out["lite"] = lite / np.linalg.norm(lite)
    out["ambient"] = np.float64(app.uniform(0.35, 0.55))
    return out


def _look_rotation(forward: np.ndarray) -> np.ndarray:
    """Camera->world rotation whose +z maps to `forward` (columns = axes),
    rolled 180 degrees from the upright convention, as the room sessions are."""
    f = forward / np.linalg.norm(forward)
    r = np.cross(np.array([0.0, 1.0, 0.0]), f)
    r = r / np.linalg.norm(r)
    return np.stack([r, np.cross(f, r), f], axis=1)


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion (Shepperd's method)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def trajectory(room: Room, nframes: int):
    """One turn of a circular outward-looking trajectory: (eyes [F, 3], Rs
    [F, 3, 3] camera->world, quats_wxyz [F, 4]), float64."""
    sx, sy, sz = room.size
    center = np.array([sx / 2, sy * 0.55, sz / 2])
    r = 0.25 * min(sx, sz)
    eyes, Rs, quats = [], [], []
    for f in range(nframes):
        ang = 2 * np.pi * f / max(nframes, 1)
        eyes.append(center + r * np.array([np.cos(ang), 0.0, np.sin(ang)]))
        Rs.append(_look_rotation(np.array([np.cos(ang), -0.1, np.sin(ang)])))
        quats.append(_quat_wxyz(Rs[-1]))
    return np.asarray(eyes), np.asarray(Rs), np.asarray(quats)


def _raycast(eyes, dirs, room_box, boxes, bclasses, max_depth: float):
    """Rays [F, N, 3] from eyes [F, 3]: the closed room's exit face, then the
    nearest box entry (first box on ties). Returns (t, cls, axis, sign,
    instance), each [F, N]; t is 0 past max_depth."""
    tiny = 1e-12
    inv = torch.where(dirs.abs() > tiny, 1.0 / dirs, torch.full_like(dirs, 1e12))
    org = eyes[:, None, :]
    rmin, rmax = room_box[:3], room_box[3:]
    t_far = torch.where(dirs > 0, (rmax - org) * inv, (rmin - org) * inv)
    t_far = torch.where(dirs.abs() <= tiny, torch.full_like(t_far, float("inf")), t_far)
    t_exit, exit_axis = t_far.min(dim=-1)
    d_exit = dirs.gather(-1, exit_axis[..., None])[..., 0]
    face = torch.where(exit_axis == 1,
                       torch.where(dirs[..., 1] > 0, CEILING_CLASS, FLOOR_CLASS), WALL_CLASS)
    hit = t_exit > 0
    t_best = torch.where(hit & (t_exit < max_depth), t_exit, torch.full_like(t_exit, max_depth))
    cls = torch.where(hit, face, 0)
    axis = torch.where(hit, exit_axis, 0)
    sign = torch.where(hit, -torch.sign(d_exit), torch.ones_like(d_exit))
    inst = torch.full_like(cls, -1)
    if boxes.shape[0]:
        lo_ax, tmin, tmax = [], None, None
        for a in range(3):
            ia = inv[..., a, None]
            t1 = (boxes[:, a] - org[..., a, None]) * ia
            t2 = (boxes[:, 3 + a] - org[..., a, None]) * ia
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            lo_ax.append(lo)
            tmin = lo if tmin is None else torch.maximum(tmin, lo)
            tmax = hi if tmax is None else torch.minimum(tmax, hi)
        tmin = torch.where((tmax >= tmin) & (tmin > 1e-6), tmin,
                           torch.full_like(tmin, float("inf")))
        tmin_best, b_best = tmin.min(dim=-1)
        bhit = tmin_best < t_best
        lo_w = torch.stack([lo.gather(-1, b_best[..., None])[..., 0] for lo in lo_ax], dim=-1)
        ea = lo_w.argmax(dim=-1)
        d_ea = dirs.gather(-1, ea[..., None])[..., 0]
        t_best = torch.where(bhit, tmin_best, t_best)
        cls = torch.where(bhit, bclasses[b_best], cls)
        axis = torch.where(bhit, ea, axis)
        sign = torch.where(bhit, -torch.sign(d_ea), sign)
        inst = torch.where(bhit, b_best, inst)
    t_best = torch.where(t_best >= max_depth, torch.zeros_like(t_best), t_best)
    return t_best, cls, axis, sign, inst


@torch.no_grad()
def render(room: Room, nframes: int, K: np.ndarray, hw: Tuple[int, int], device):
    """One session of the room, rendered on `device` with intrinsics K at
    hw = (H, W): depth [F, H, W] float32 metres (0 = no return), rgb
    [F, H, W, 3] uint8 (textured, shaded, vignetted), masks [F, H, W] uint8
    ground-truth classes, quats_wxyz [F, 4] and translations [F, 3]
    (float64, host). Pixel centres sit at (u + 0.5, v + 0.5)."""
    H, W = hw
    eyes, Rs, quats = trajectory(room, nframes)
    boxes, bclasses = room_boxes(room)
    ap = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
          for k, v in room_appearance(room, len(boxes)).items()}
    sx, sy, sz = room.size
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    room_box, boxes_d = f32([0.0, 0.0, 0.0, sx, sy, sz]), f32(boxes)
    bcls = torch.as_tensor(bclasses, device=device)
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rays = f32(np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1).reshape(-1, 3))
    r2 = (((u - cx) / cx) ** 2 + ((v - cy) / cy) ** 2).reshape(-1)
    vignette = f32(1.0 - 0.25 * r2 / r2.max())
    depth = torch.empty((nframes, H, W), dtype=torch.float32, device=device)
    rgb = torch.empty((nframes, H, W, 3), dtype=torch.uint8, device=device)
    masks = torch.empty((nframes, H, W), dtype=torch.uint8, device=device)
    eyes_d, Rs_d = f32(eyes), f32(Rs)
    for a in range(0, nframes, CHUNK):
        e, R = eyes_d[a:a + CHUNK], Rs_d[a:a + CHUNK]
        dirs = torch.matmul(rays, R.transpose(1, 2))
        t, cls, axis, sign, inst = _raycast(e, dirs, room_box, boxes_d, bcls, MAX_DEPTH)
        P = e[:, None, :] + t[..., None] * dirs
        s1 = torch.sin((P * ap["tex_k1"][cls]).sum(-1) + ap["tex_p1"][cls])
        s2 = torch.sin((P * ap["tex_k2"][cls]).sum(-1) + ap["tex_p2"][cls])
        tex = 1.0 + ap["tex_amp"][cls] * (0.7 * s1 + 0.3 * s2)
        shade = ap["ambient"] + (1.0 - ap["ambient"]) * (ap["lite"][axis] * sign).clamp(0.0, 1.0)
        nt = ap["inst_tint"].shape[0]
        tint = ap["inst_tint"][torch.where(inst < 0, nt - 1, inst)]
        col = (ap["base_color"][cls] + tint) * (tex * shade * vignette)[..., None]
        n = e.shape[0]
        depth[a:a + n] = t.reshape(n, H, W)
        rgb[a:a + n] = (col * 255.0).clamp(0, 255).to(torch.uint8).reshape(n, H, W, 3)
        masks[a:a + n] = cls.to(torch.uint8).reshape(n, H, W)
    return depth, rgb, masks, quats, eyes


def room_cloud(room: Room, npts: int, generator: torch.Generator, device) -> torch.Tensor:
    """`io/workload.make_workload`'s cloud, drawn on the card: [npts, 3]
    float32 points uniform on five room surfaces (npts // 7 each) and the
    rest on the z = depth wall, which is about twice as dense. No point lies
    on a box: the boxes appear in the masks only."""
    sx, sy, sz = room.size
    n = npts // 7
    rest = npts - 5 * n
    # (fixed axis, its value) of each surface, in make_workload's order
    faces = ((1, 0.0, n), (1, sy, n), (0, 0.0, n), (0, sx, n), (2, 0.0, n), (2, sz, rest))
    ext = torch.tensor([sx, sy, sz], dtype=torch.float32, device=device)
    out = torch.rand((npts, 3), generator=generator, device=device) * ext
    a = 0
    for axis, value, count in faces:
        out[a:a + count, axis] = value
        a += count
    return out


def pinhole(fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def room_camera(hw: Tuple[int, int]) -> np.ndarray:
    """The synthetic room sessions' camera: f = 0.6 W, centred."""
    H, W = hw
    return pinhole(0.6 * W, 0.6 * W, W / 2.0, H / 2.0)
