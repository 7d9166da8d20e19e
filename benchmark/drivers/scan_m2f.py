"""Traffic "scan_m2f": the "scan" traffic (a user scans a room and waits
for labelled instances; closed loop, one client) with a Mask2Former in the
loop: `segment_session_fast(segmenter=Segmenter2D(Mask2FormerConfig))`
labels every frame.

Everything but the segmenter is `drivers/scan.py`'s: the room pool, the
request, the kept answers and the end-to-end rate. The Mask2Former's
weights are drawn from the run's seed. On a kept request a forward hook on
the model copies the timed path's own semantic scores of the checked
frames to the host, asynchronously, into buffers pinned at set-up. They
are compared, with the back-projection and the cloud's size, against the
plain reference (`reference/mask2former_ref.py` in float32, then
`scan_ref`'s flow).

The weights are drawn here, from the seed (`draw_params`), and loaded into
the program by name (`load_state_dict(strict=True)`); the reference takes
the same float32 dict, so the program's own initialisation stays off the
comparison. The model is held by the pixel decoder's mask features
(`mask_feature_rel_gap`, the backbone and the deformable encoder, before
any attention mask) and, through the labels of all 300 frames, by the
cloud's size. The scores' gaps (`sem_score_rel_gap`, `sem_score_gap`) and
`pixel_class_mismatch` are logged and carry no limit: with random weights
the decoder's attention masks flip at their threshold under rounding, and
a flip moves its query's whole mask, so on some seeds bfloat16 moves the
scores as far as float8 does on others; near-tied scores flip the argmax.

Traffic parameters: those of "scan".
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from drivers import scan
from f3sbench import core
from reference import mask2former_ref, scan_ref

warmup, key, keeps, release, end_to_end = (scan.warmup, scan.key, scan.keeps, scan.release,
                                           scan.end_to_end)


def setup(ctx) -> scan.State:
    from fusion3dseg_tpu_torch.models import mask2former

    seg = ctx.config["segmenter"]
    base = core.Ctx(ctx.cell, {k: v for k, v in ctx.config.items() if k != "segmenter"},
                    ctx.traffic, ctx.seed, ctx.device)
    st = scan.setup(base)
    st.ctx = ctx
    st.segmenter = _segmenter(mask2former, seg, ctx.seed, st.dev)
    st.kw["conf_threshold"] = seg["conf_threshold"]
    # the weights, drawn here and loaded into the program; kept for the
    # reference after the window
    model = st.segmenter.model
    st.params = draw_params({k: tuple(v.shape) for k, v in model.state_dict().items()}, seg,
                            ctx.seed)
    model.load_state_dict(st.params, strict=True)
    # a host buffer for each kept request's scores of the checked frames,
    # pinned on the card so that their copies overlap the work
    n, (h, w) = len(st.check_frames), seg["input_hw"]
    d = seg["size_divisibility"]
    fshape = (n, -(-h // d) * d // 4, -(-w // d) * d // 4, seg["mask_dim"])
    pin = st.dev.type == "cuda"
    st.buffers = {i: (torch.empty((n, h, w, seg["num_classes"]), pin_memory=pin),
                      torch.empty(fshape, pin_memory=pin)) for i in st.sample}
    return st


def _segmenter(mask2former, seg: dict, seed: int, dev):
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    if seg["dtype"] != "bfloat16":
        raise ValueError(f"segmenter dtype {seg['dtype']!r}: only bfloat16 is configured")
    fields = {f.name for f in dataclasses.fields(mask2former.Mask2FormerConfig)} - {"dtype"}
    config = mask2former.Mask2FormerConfig(
        **{k: tuple(seg[k]) if isinstance(seg[k], list) else seg[k] for k in fields},
        dtype=torch.bfloat16)
    return Segmenter2D(config=config, input_hw=tuple(seg["input_hw"]), batch_size=seg["batch"],
                       seed=seed, device=dev)


def draw_params(shapes: dict, seg: dict, seed: int) -> dict:
    """Float32 host tensors for the parameter names and shapes `shapes`,
    drawn from `seed` by Mask2Former's rules, written out here:
    Xavier-uniform matrices and kernels (the class head's too, and the
    sampling offsets', random where Mask2Former starts them at zero);
    relative-position tables from a normal of std 0.02 (timm's
    `trunc_normal_` cuts at +-2, 100 std away); level and query
    embeddings from a unit normal; the sampling offsets' bias Mask2Former's
    direction grid; every other bias, and each norm's scale less 1, from a
    normal of std 0.05 (where Mask2Former starts them at zero, so that a
    bias the program dropped would show)."""
    rng = np.random.default_rng(np.random.SeedSequence(seed, spawn_key=(1,)))  # not the rooms'
    out = {}
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith("relative_position_bias_table"):
            a = 0.02 * rng.standard_normal(n, dtype=np.float32)
        elif name.endswith(("level_embed", "query_feat", "query_embed")):
            a = rng.standard_normal(n, dtype=np.float32)
        elif name.endswith("sampling_offsets.bias"):
            a = direction_grid(seg["enc_heads"], mask2former_ref.LEVELS, seg["enc_points"])
        elif len(shape) >= 2:  # a Dense [out, in] or Conv [out, in, kh, kw] weight
            bound = math.sqrt(6.0 / ((shape[0] + shape[1]) * math.prod(shape[2:])))
            a = (rng.random(n, dtype=np.float32) * 2.0 - 1.0) * np.float32(bound)
        elif name.endswith(".weight"):  # a LayerNorm's or GroupNorm's scale
            a = 1.0 + 0.05 * rng.standard_normal(n, dtype=np.float32)
        else:
            a = 0.05 * rng.standard_normal(n, dtype=np.float32)
        out[name] = torch.from_numpy(a.astype(np.float32).reshape(shape))
    return out


def direction_grid(heads: int, levels: int, points: int) -> np.ndarray:
    """Mask2Former's sampling-offset bias, [heads * levels * points * 2]
    (x, y): head k looks along angle 2 pi k / heads, on the square's edge,
    point p at p + 1 unit steps, the same on every level."""
    theta = np.arange(heads, dtype=np.float64) * (2.0 * math.pi / heads)
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.repeat(grid[:, None, None], levels, 1).repeat(points, 2)
    grid = grid * np.arange(1, points + 1).reshape(1, 1, points, 1)
    return grid.astype(np.float32).reshape(-1)


def request(st: scan.State, i: int, keep: bool) -> dict:
    if not keep:
        return scan.request(st, i, keep)
    slot = {int(f): n for n, f in enumerate(st.check_frames)}
    (scores, features), seen = st.buffers[i], [0, 0]

    def copier(buf, k, pick):
        def copy(module, args, out):
            out = pick(out)
            for j in range(len(out)):
                if seen[k] + j in slot:
                    buf[slot[seen[k] + j]].copy_(out[j], non_blocking=True)
            seen[k] += len(out)
        return copy

    model = st.segmenter.model
    hooks = [model.register_forward_hook(copier(scores, 0, lambda o: o)),
             model.pixel_decoder.register_forward_hook(copier(features, 1, lambda o: o[0]))]
    try:
        info = scan.request(st, i, keep)
    finally:
        for h in hooks:
            h.remove()
    if st.dev.type == "cuda":
        torch.cuda.synchronize(st.dev)
    st.kept[i]["scores"], st.kept[i]["features"] = scores.numpy(), features.numpy()
    return info


def reference(st: scan.State, key: int, control: bool = False) -> dict:
    """The plain reference's answer for pool session `key`, with the
    semantic scores of the checked frames; with `control`, the control's:
    products in TF32, the segmenter in float8."""
    s, cfg = st.sessions[key], st.ctx.config
    seg = cfg["segmenter"]
    params = {k: v.to(st.dev) for k, v in st.params.items()}
    model = mask2former_ref.Mask2FormerRef(params, seg, mode="fp8" if control else "float32")
    kept = {}

    def segment(colors):
        masks, kept["scores"], kept["features"] = mask2former_ref.masks_and_scores(
            model, colors, seg["input_hw"], seg["conf_threshold"], seg["batch"], st.check_frames)
        return masks

    out = scan_ref.run_session(s["depth"], s["rgb"], None, st.K,
                               s["quats_xyzw"][:, [3, 0, 1, 2]], s["trans"], cfg, st.dev,
                               mode="tf32" if control else "float32", frames=st.check_frames,
                               segment=segment)
    out["scores"], out["features"] = kept["scores"], kept["features"]
    return out


def compare(got: dict, ref: dict) -> dict:
    """`scan.compare`'s numbers; over the checked frames, the semantic
    scores' `sem_score_rel_gap` (the sum of the absolute differences over
    the sum of the reference's magnitudes) and `sem_score_gap` (the largest
    absolute difference), and the mask features' `mask_feature_rel_gap`
    (as the scores')."""
    out = scan.compare(got, ref)
    out["sem_score_rel_gap"], out["sem_score_gap"] = _gaps(got["scores"], ref["scores"])
    out["mask_feature_rel_gap"], _ = _gaps(got["features"], ref["features"])
    return out


def _gaps(got, ref) -> tuple:
    """(relative L1 gap, largest absolute gap) of two [frames, ...] arrays,
    a frame at a time (a frame's scores are 0.45 GB)."""
    gap = num = den = 0.0
    for g, r in zip(got, ref):
        d = np.abs(g - r)
        gap = max(gap, float(d.max()))
        num += float(d.sum(dtype=np.float64))
        den += float(np.abs(r).sum(dtype=np.float64))
    return num / den, gap


def check(st: scan.State) -> list:
    limits = st.ctx.traffic["limits"][st.ctx.config["name"]]
    worst, refs = {}, {}
    for i, got in sorted(st.kept.items()):
        k = key(st, i)
        if k not in refs:
            refs[k] = reference(st, k)
        for name, value in compare(got, refs[k]).items():
            worst[name] = max(worst.get(name, value), value)
    for name in ("sem_score_rel_gap", "sem_score_gap", "pixel_class_mismatch"):
        if name in worst:
            core.log(f"{name}: {worst[name]!r} (no limit)")
    return [{"name": n, "value": worst.get(n, float("inf")), "limit": limits[n]} for n in limits]
