"""Traffic "scan": a user scans a room and waits for labelled instances.

Closed loop, one client. A request is one RGB-D session as a reader hands
it over (depth in metres and RGB uint8 on the host, intrinsics, poses) with
its 2D masks as host arrays: `SessionData.from_arrays` ->
`segment_session_fast` -> classes, instance ids and info on the host. A
pool of sessions (distinct rooms drawn from the seed) is rendered on the
card at set-up, copied to the host and alternated.

With a configuration that names a `segmenter`, the request hands over no
masks: `segment_session_fast(segmenter=Segmenter2D(...))` runs the model on
every frame instead.

Traffic parameters: frames, hw [H, W], intrinsics [fx, fy, cx, cy],
num_objects, pool, check_frames (frames of a checked request whose pixels
are compared), limits {configuration: {number: limit}}.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from f3sbench import core, room as rooms
from reference import scan_ref, segformer_ref


class State:
    pass


def _program_kw(cfg: dict) -> dict:
    return dict(radius=cfg["radius"], angle=cfg["angle_deg"], min_depth=cfg["min_depth"],
                max_depth=cfg["max_depth"], capacity=cfg["capacity"], window=cfg["window"],
                window_policy=cfg["window_policy"], nclasses=cfg["nclasses"],
                threshold=cfg["threshold"], filter_classes=tuple(cfg["filter_classes"]),
                split_radius=cfg["split_radius"],
                min_pts_per_inst=cfg["min_pts_per_inst"], dedup=cfg["dedup"],
                auto_dedup=cfg["auto_dedup"], merge_obbs=cfg["merge_obbs"])


def setup(ctx) -> State:
    from fusion3dseg_tpu_torch.io import rtab
    from fusion3dseg_tpu_torch.pipeline import fast

    st = State()
    st.ctx, tr, cfg = ctx, ctx.traffic, ctx.config
    st.rtab, st.fast = rtab, fast
    st.dev = ctx.device
    H, W = tr["hw"]
    st.K = rooms.pinhole(*tr["intrinsics"])
    rng = np.random.default_rng(ctx.seed)
    st.sessions = []
    for room_seed in rng.integers(0, 2 ** 31, size=tr["pool"]):
        depth, rgb, masks, quats, eyes = rooms.render(
            rooms.Room(int(room_seed), tr["num_objects"]), tr["frames"], st.K, (H, W), st.dev)
        st.sessions.append({
            "depth": depth.cpu().numpy(), "rgb": rgb.cpu().numpy(),
            "masks": masks.cpu().numpy(),
            "quats_xyzw": quats[:, [1, 2, 3, 0]].astype(np.float32),
            "trans": eyes.astype(np.float32)})
        del depth, rgb, masks
    pool = tr["pool"]
    # the checked requests: one of the first two of each pool session
    st.sample = {k + pool * int(rng.integers(0, 2)) for k in range(pool)}
    F = tr["frames"]
    st.check_frames = np.unique(np.linspace(0, F - 1, tr["check_frames"]).round().astype(int))
    st.kw = _program_kw(cfg)
    st.segmenter = None
    if "segmenter" in cfg:
        st.segmenter = _segmenter(cfg["segmenter"], st.dev)
        st.kw["conf_threshold"] = cfg["segmenter"]["conf_threshold"]
    st.kept = {}
    return st


def _segmenter(seg: dict, dev):
    from fusion3dseg_tpu_torch.models.segformer import SegFormerConfig
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    if seg["dtype"] != "bfloat16":
        raise ValueError(f"segmenter dtype {seg['dtype']!r}: only bfloat16 is configured")
    config = SegFormerConfig(
        num_classes=seg["num_classes"], embed_dims=tuple(seg["embed_dims"]),
        depths=tuple(seg["depths"]), num_heads=tuple(seg["num_heads"]),
        sr_ratios=tuple(seg["sr_ratios"]), mlp_ratio=seg["mlp_ratio"],
        decoder_dim=seg["decoder_dim"], patch_strides=tuple(seg["patch_strides"]),
        patch_sizes=tuple(seg["patch_sizes"]), dtype=torch.bfloat16,
        use_pallas_attention=seg["use_pallas_attention"])
    return Segmenter2D(config=config, checkpoint_dir=core.ROOT / seg["checkpoint"],
                       input_hw=tuple(seg["input_hw"]), batch_size=seg["batch"], device=dev)


def warmup(st: State) -> None:
    """One session: every pool session runs the same kernels, and the
    program builds nothing per shape."""
    request(st, 0, keep=False)


def key(st: State, i: int) -> int:
    """The pool session that request i sends."""
    return i % len(st.sessions)


def keeps(st: State, i: int) -> bool:
    return i in st.sample


def request(st: State, i: int, keep: bool) -> dict:
    s = st.sessions[key(st, i)]
    t0 = time.perf_counter()
    with torch.profiler.record_function("SessionData.from_arrays"):
        sd = st.rtab.SessionData.from_arrays(s["rgb"], s["depth"], st.K, s["quats_xyzw"],
                                             s["trans"], device=st.dev)
    from_arrays = time.perf_counter() - t0
    labels = {"segmenter": st.segmenter} if st.segmenter else {"masks": s["masks"]}
    with torch.profiler.record_function("segment_session_fast"):
        res = st.fast.segment_session_fast(sd, device=st.dev, **labels, **st.kw)
    if keep:
        f = torch.as_tensor(st.check_frames, device=sd.points.device)
        st.kept[i] = {"n": int(res.n), "points": np.asarray(res.points),
                      "classes": np.asarray(res.classes),
                      "instance_ids": np.asarray(res.instance_ids),
                      "uv2pt": res.uv2pt[f].cpu().numpy(),
                      "geom_points": sd.points[f].cpu().numpy(),
                      "geom_normals": sd.normals[f].cpu().numpy()}
    frames = sd.nframes
    return {"key": key(st, i), "frames": frames, "work": frames,
            "stages": {"from_arrays": from_arrays, **res.stage_seconds},
            "n": int(res.n), "instances": len(res.instance_info),
            "overflow_frames": int(res.overflow_frames)}


def release(st: State) -> None:
    st.segmenter = None


def end_to_end(rec: dict) -> dict:
    frames = sum(r["frames"] for r in rec["requests"])
    return {"scan_frames_per_s": frames / rec["window_s"]}


def reference(st: State, key: int, control: bool = False) -> dict:
    """The plain reference's answer for pool session `key`; with `control`,
    the control's: products in TF32, the segmenter in float8."""
    s, cfg = st.sessions[key], st.ctx.config
    masks, segment = s["masks"], None
    if "segmenter" in cfg:
        seg = cfg["segmenter"]
        model = segformer_ref.SegFormerRef(segformer_ref.load_npz(core.ROOT / seg["checkpoint"],
                                                                  st.dev),
                                           seg, mode="fp8" if control else "float32")
        masks = None

        def segment(colors):
            return segformer_ref.masks_from_colors(model, colors, seg["input_hw"],
                                                   seg["conf_threshold"], seg["batch"])
    return scan_ref.run_session(s["depth"], s["rgb"], masks, st.K,
                                s["quats_xyzw"][:, [3, 0, 1, 2]], s["trans"], cfg, st.dev,
                                mode="tf32" if control else "float32",
                                frames=st.check_frames, segment=segment)


# a pixel's fused point counts as the reference's within a hundredth of the
# merge radius (m): the control's TF32 geometry moves 99% of the checked
# pixels' points further, the program's own runs 1-5%
POINT_TOL_M = 5e-4


def _best_match(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per element, the b-group that holds most of its a-group's elements."""
    _, ai = np.unique(a, return_inverse=True)
    bu, bi = np.unique(b, return_inverse=True)
    joint = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(joint, (ai, bi), 1)
    return bu[joint.argmax(axis=1)][ai]


def _purity_gap(a: np.ndarray, b: np.ndarray) -> float:
    """1 - (pixels in the best-matching b-group of each a-group) / pixels."""
    if len(a) == 0:
        return 0.0
    return float(np.mean(_best_match(a, b) != b))


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: back-projection gaps over the checked frames'
    valid pixels, the fused cloud's size, and over the pixels of the checked
    frames mapped on both sides, the shares whose point's class, instance,
    or whole answer (fused point, class and instance) differ. Each
    configuration's limits name the numbers it holds."""
    v = ref["valid"]
    gp = np.abs(got["geom_points"] - ref["geom_points"])[v]
    gn = np.abs(got["geom_normals"] - ref["geom_normals"])[v]
    both = (got["uv2pt"] >= 0) & (ref["uv2pt"] >= 0)
    pg, pr = got["uv2pt"][both], ref["uv2pt"][both]
    cg, cr = got["classes"][pg], ref["classes"][pr]
    ig, ir = got["instance_ids"][pg], ref["instance_ids"][pr]
    # per pixel, its answer: the fused point, its class and its instance
    dist = np.linalg.norm(got["points"][pg] - ref["points"][pr], axis=1)
    other = cg != cr
    if len(ig):
        other |= (_best_match(ig, ir) != ir) | (_best_match(ir, ig) != ig)
    wrong = (dist > POINT_TOL_M) | other
    return {
        "points_gap_m": float(gp.max()) if gp.size else 0.0,
        "normals_gap": float(gn.max()) if gn.size else 0.0,
        "cloud_size_gap": abs(got["n"] - ref["n"]) / max(ref["n"], 1),
        "pixel_class_mismatch": float(np.mean(cg != cr)) if len(cg) else 1.0,
        "pixel_instance_mismatch": float(max(_purity_gap(ig, ir), _purity_gap(ir, ig))),
        "pixel_answer_mismatch": float(np.mean(wrong)) if len(wrong) else 1.0,
    }


def check(st: State) -> list:
    limits = st.ctx.traffic["limits"][st.ctx.config["name"]]
    worst = {}
    refs = {}
    for i, got in sorted(st.kept.items()):
        k = key(st, i)
        if k not in refs:
            refs[k] = reference(st, k)
        for name, value in compare(got, refs[k]).items():
            worst[name] = max(worst.get(name, value), value)
    return [{"name": n, "value": worst.get(n, float("inf")), "limit": limits[n]} for n in limits]
