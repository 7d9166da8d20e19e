"""Synthetic training data rendered on the device.

Counterpart of `fusion3dseg_tpu/io/synthetic_device.py`. The trainer's host
data path (`models/train.synthetic_dataset`) raycasts every frame in NumPy;
here the raycast, the textured shading and the resize run as tensor
programs on the batch's device, and only each session's small tables
(boxes, poses, appearance; a few KB) come from the host, drawn by the same
helpers as `io/synthetic.make_session` (`session_boxes`,
`session_appearance`, `session_poses`), so the sampled values are the same.

Everything stays float32 with TF32 off (the caller's switch; `chip_smoke.py`
and the card tests set it): the slab test compares ray parameters, and a
rounded product would move hits between surfaces. Frames are quantized to
uint8 at the render size, then resized with OpenCV's rules
(`io/image.resize_linear_uint8`, nearest for masks), as the host path does.
So a device frame equals the host renderer's bit for bit when the float32
shading rounds alike, which the CPU tests check; the JAX package's device
path instead resizes in float with `jax.image.resize` and quantizes after.

`augment_batch_device` draws from an explicit `torch.Generator`: the same
distributions as `models/train.augment_batch`, not the same stream.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import image
from fusion3dseg_tpu_torch.io.synthetic import (
    CEILING_CLASS, FLOOR_CLASS, WALL_CLASS, RoomSpec, session_appearance, session_boxes,
    session_poses,
)


def _raycast(eyes, dirs, room_box, boxes, bclasses, max_depth: float):
    """All frames' rays at once: eyes [F, 3], dirs [F, N, 3] world-frame.
    The rules of `io/synthetic._raycast` (exit face of the closed room,
    then the nearest valid box entry, first box on ties). Returns (t [F, N],
    cls [F, N] int64, normal axis [F, N], normal sign [F, N], instance
    [F, N] with -1 for room surfaces)."""
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
        # per-axis running max / min, as the NumPy renderer chains them
        lo_ax, tmin, tmax = [], None, None
        for a in range(3):
            ia = inv[..., a, None]  # [F, N, 1]
            t1 = (boxes[:, a] - org[..., a, None]) * ia  # [F, N, B]
            t2 = (boxes[:, 3 + a] - org[..., a, None]) * ia
            lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
            lo_ax.append(lo)
            tmin = lo if tmin is None else torch.maximum(tmin, lo)
            tmax = hi if tmax is None else torch.minimum(tmax, hi)
        tmin = torch.where((tmax >= tmin) & (tmin > 1e-6), tmin,
                           torch.full_like(tmin, float("inf")))
        tmin_best, b_best = tmin.min(dim=-1)  # first minimal entry on ties
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


def _shade_textured(P, cls, inst, axis, sign, ap, vignette):
    """make_session's textured appearance: per-class sine-field texture,
    per-instance tint, Lambertian shade off the true normal, vignette.
    P [F, N, 3]; returns [F, N, 3] float colour, unclipped."""
    s1 = torch.sin((P * ap["tex_k1"][cls]).sum(-1) + ap["tex_p1"][cls])
    s2 = torch.sin((P * ap["tex_k2"][cls]).sum(-1) + ap["tex_p2"][cls])
    tex = 1.0 + ap["tex_amp"][cls] * (0.7 * s1 + 0.3 * s2)
    # the one-hot normal's dot with the light is the light's component
    ndotl = ap["lite"][axis] * sign
    shade = ap["ambient"] + (1.0 - ap["ambient"]) * ndotl.clamp(0.0, 1.0)
    nt = ap["inst_tint"].shape[0]
    tint = ap["inst_tint"][torch.where(inst < 0, nt - 1, inst)]  # -1: the zero row
    return (ap["base_color"][cls] + tint) * (tex * shade * vignette)[..., None]


def _camera(render_hw, device):
    """(rays [N, 3], vignette [N]) of make_session's pinhole camera, f = 0.6 W,
    computed as it does (float64, then float32)."""
    H, W = render_hw
    f = 0.6 * W
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    cx, cy = W / 2.0, H / 2.0
    rays = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1).reshape(-1, 3)
    r2 = (((u - cx) / cx) ** 2 + ((v - cy) / cy) ** 2).reshape(-1)
    vignette = 1.0 - 0.25 * r2 / r2.max()
    return (torch.as_tensor(rays.astype(np.float32), device=device),
            torch.as_tensor(vignette.astype(np.float32), device=device))


@torch.no_grad()
def render_session_device(eyes: torch.Tensor, Rs: torch.Tensor, room_box: torch.Tensor,
                          boxes: torch.Tensor, bclasses: torch.Tensor, appearance: dict, *,
                          render_hw: Tuple[int, int], model_hw: Tuple[int, int],
                          max_depth: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a whole session on the tensors' device: raycast + textured
    shading at `render_hw`, uint8 quantization (clip, truncate), then the
    resize to `model_hw` (OpenCV's INTER_LINEAR for images, INTER_NEAREST
    for masks). eyes [F, 3], Rs [F, 3, 3], room_box [6], boxes [B, 6] float32;
    bclasses [B] int64; `appearance` the `session_appearance` tables as
    float32 tensors. Returns (images [F, h, w, 3] uint8, masks [F, h, w]
    uint8)."""
    dev = eyes.device
    H, W = render_hw
    rays, vignette = _camera(render_hw, dev)
    dirs = torch.matmul(rays, Rs.transpose(1, 2))  # [F, N, 3]
    t, cls, axis, sign, inst = _raycast(eyes, dirs, room_box, boxes, bclasses, max_depth)
    P = eyes[:, None, :] + t[..., None] * dirs
    rgbf = _shade_textured(P, cls, inst, axis, sign, appearance, vignette)
    F = eyes.shape[0]
    imgs = (rgbf * 255.0).clamp(0, 255).to(torch.uint8).reshape(F, H, W, 3)
    masks = cls.to(torch.uint8).reshape(F, H, W)
    h, w = model_hw
    imgs = image.resize_linear_uint8(imgs, (h, w))
    if (h, w) != (H, W):
        sy = torch.as_tensor(image.nearest_index(H, h), device=dev)
        sx = torch.as_tensor(image.nearest_index(W, w), device=dev)
        masks = masks.index_select(1, sy).index_select(2, sx)
    return imgs, masks


@torch.no_grad()
def augment_batch_device(imgs: torch.Tensor, masks: torch.Tensor, generator: torch.Generator,
                         strength: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device form of `models/train.augment_batch`: flip, contrast /
    brightness / channel-gain jitter, gamma, sensor noise and (strength > 1)
    cutout, with the same distributions, drawn from `generator` (on the
    tensors' device). Returns uint8 (images, masks)."""
    s = float(strength)
    n, h, w, _ = imgs.shape
    dev = imgs.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    flip = torch.rand(n, generator=generator, device=dev) < 0.5
    imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
    masks = torch.where(flip[:, None, None], masks.flip(2), masks)
    contrast = uniform((n, 1, 1, 1), max(0.0, 1 - 0.3 * s), 1 + 0.3 * s)
    bright = uniform((n, 1, 1, 1), -32 * s, 32 * s)
    gains = uniform((n, 1, 1, 3), max(0.0, 1 - 0.15 * s), 1 + 0.15 * s)
    out = imgs.float() * contrast * gains + bright
    gamma = torch.exp(0.12 * s * torch.randn((n, 1, 1, 1), generator=generator, device=dev))
    out = out.clamp(0.0, 255.0)
    out = 255.0 * (out / 255.0) ** gamma
    sigma = uniform((n, 1, 1, 1), 0.0, 5.0 * s)
    out = out + sigma * torch.randn(out.shape, generator=generator, device=dev)
    if s > 1.0:
        # a rectangle of augment_batch's size law per image, pasted in a
        # random colour on a p_cut coin; labels kept
        p_cut = min(0.5, 0.25 * (s - 1.0) + 0.25)

        def randint(lo, hi):
            return torch.randint(lo, hi, (n, 1, 1), generator=generator, device=dev)

        ch = randint(h // 10 + 1, max(h * 3 // 10, h // 10 + 2))
        cw = randint(w // 10 + 1, max(w * 3 // 10, w // 10 + 2))
        y0 = randint(0, h) % (h - ch + 1)
        x0 = randint(0, w) % (w - cw + 1)
        yy = torch.arange(h, device=dev)[None, :, None]
        xx = torch.arange(w, device=dev)[None, None, :]
        inside = (yy >= y0) & (yy < y0 + ch) & (xx >= x0) & (xx < x0 + cw)
        coin = torch.rand((n, 1, 1), generator=generator, device=dev) < p_cut
        color = uniform((n, 1, 1, 3), 0.0, 255.0)
        out = torch.where((inside & coin)[..., None], color, out)
    return out.clamp(0, 255).to(torch.uint8), masks


def session_tables(room: RoomSpec, nframes: int, device):
    """One session's inputs to `render_session_device`, drawn on the host by
    make_session's own helpers: (eyes, Rs, room_box, boxes, bclasses,
    appearance) as tensors on `device`."""
    boxes, bclasses = session_boxes(room)
    ap = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
          for k, v in session_appearance(room, len(boxes)).items()}
    eyes, Rs, _ = session_poses(room, nframes)
    sx, sy, sz = room.size

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return (f32(eyes), f32(Rs), f32([0.0, 0.0, 0.0, sx, sy, sz]), f32(boxes.reshape(-1, 6)),
            torch.as_tensor(bclasses.astype(np.int64), device=device), ap)


def device_dataset(hw: Tuple[int, int], batch_size: int, seed: int = 0,
                   nframes_per_session: int = 32,
                   render_hws: Tuple[Tuple[int, int], ...] = ((96, 72),),
                   augment: bool = False, aug_strength: float = 1.0, max_depth: float = 10.0,
                   device="cuda", generator: Optional[torch.Generator] = None,
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Infinite (images [B, h, w, 3] uint8, masks [B, h, w] uint8) batches
    on `device`: the device form of `models/train.synthetic_dataset` +
    `augment_batch`, always textured. Sessions, render sizes and frame order
    come from a NumPy generator seeded with `seed` (the JAX package's draw
    order); augmentation from `generator` (default: a generator on the
    device seeded with `seed`)."""
    dev = cuda.resolve_device(device)
    rng = np.random.default_rng(seed)
    nframes_per_session = max(nframes_per_session, batch_size)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    while True:
        room = RoomSpec(seed=int(rng.integers(1 << 30)))
        tables = session_tables(room, nframes_per_session, dev)
        render_hw = render_hws[int(rng.integers(len(render_hws)))]
        imgs, masks = render_session_device(*tables, render_hw=tuple(render_hw),
                                            model_hw=tuple(hw), max_depth=max_depth)
        order = rng.permutation(nframes_per_session)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            sel = torch.as_tensor(order[i:i + batch_size], device=dev)
            bi, bm = imgs[sel], masks[sel]
            if augment:
                bi, bm = augment_batch_device(bi, bm, generator, aug_strength)
            yield bi, bm
