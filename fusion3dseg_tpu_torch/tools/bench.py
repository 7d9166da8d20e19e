"""Every BASELINE configuration in one command: the port's counterpart of
the repository's `bench.py`.

    python -m fusion3dseg_tpu_torch.tools.bench [--device cuda] [bench.py's flags]

The same flags, defaults, sizes, seeds and result keys as `bench.py`:

  1-3. the headline: the session label lifter `tpu_label_fuse_cells` on the
       1M-point x 300-frame workload (`io/workload.make_workload`, 256x192,
       133 classes) behind the KD-cell frustum index, timed (best of
       `--repeat` after a synchronize), held to the NumPy oracle over the
       full session; the CPU denominator is the median of four oracle rates
       (three 12-frame passes and the full pass), spread recorded;
  4.   the 2D segmenter (the best shipped checkpoint, `SegFormerConfig.named`,
       no fused attention, as `bench.py`): images/s at 8 x 256x256 held on
       the device, then the model in the loop (`tools/model_in_the_loop`);
  5.   10M points x 100 frames through the gid-range-sharded z-buffer
       (`nsub` = 10 sub-ranges of 2^20 ids), held to the oracle over the
       full session;
  and the fusion engine (48 frames at 256x192, capacity 2^17 with the auto
  window, the split policy, capacity 2^20; 12 VGA frames; 8 frames at the
  reference's 960x720 portrait capture), the loop-closure duplicate
  statistics and `segment_session_fast`'s end-to-end time (median of three).

Beside the times it checks the results, and exits 1 naming each bar that
failed (also listed under "failed_bars"): label agreement >= 0.9995 with the
oracle at 1M and at 10M; those classes equal, bit for bit, to the same run
classified by K1's plain version (`use_cuda_hist=False`); the end-to-end,
VGA and reference-resolution runs give the same n twice; the model in the
loop's 3D agreement >= 0.98.

Prints one JSON line: `bench.py`'s keys, "platform" ("gpu" on the card), the
card's "name" and "power_limit" as nvidia-smi gives them, the host's RAM,
K1's launches in the timed runs ("k1_launches") and K1 on each run's winner
matrix ("k1_rows": its largest difference from the plain version over
total, vmax and classes, which must be 0; ms in a CUDA graph beside its
bytes bound, the plain version's ms, which kernel ran). Logs go to stderr. Workload and cell-index
caches go to the temporary directory; the run writes no file into the
repository. `--profile DIR` writes a torch.profiler trace of one headline run
to DIR (on the card).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import resource
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from fusion3dseg_tpu_torch.cuda import resolve_device
from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
from fusion3dseg_tpu_torch.io import synthetic
from fusion3dseg_tpu_torch.io.rtab import SessionData
from fusion3dseg_tpu_torch.io.workload import cpu_label_fuse, make_workload
from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
from fusion3dseg_tpu_torch.ops import histogram as hist
from fusion3dseg_tpu_torch.ops import label_fuse as lf
from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from fusion3dseg_tpu_torch.tools import model_in_the_loop
from fusion3dseg_tpu_torch.tools.profiling import (bound_ms, card_line, event_ms, graph_ms,
                                                    profile_run)

HEADLINE_METRIC = "points/sec projected+label-fused (1M-pt cloud, 300 frames)"
AGREEMENT_BAR = 0.9995  # label lifting against the oracle (PERF.md §2)
LOOP_AGREE_BAR = 0.98  # model in the loop: 3D agreement with the ground-truth-mask pipeline
RADIUS, MAX_DEPTH = 0.05, 8.0
MIN_COSINE = float(np.cos(np.deg2rad(10.0)))


@dataclasses.dataclass(frozen=True)
class FusionSizes:
    """The sessions of `fusion_and_e2e` (frames, depth size): bench.py's by
    default; `chip_smoke.py` and the tests run fewer or smaller frames."""

    frames: int = 48
    hw: tuple = (256, 192)
    vga_frames: int = 12
    vga_hw: tuple = (480, 640)
    ref_frames: int = 8
    ref_hw: tuple = (960, 720)  # the reference's calibration: 720x960 portrait


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--npts", type=int, default=1_000_000)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--oracle-frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--nclasses", type=int, default=133)
    ap.add_argument("--tenm-npts", type=int, default=10_000_000)
    ap.add_argument("--tenm-frames", type=int, default=100)
    ap.add_argument("--no-view-index", action="store_true",
                    help="disable the view-coherent culling index")
    ap.add_argument("--cell-size", type=int, default=128,
                    help="KD-cell size for the frustum-culling cell index")
    ap.add_argument("--no-fusion-stat", action="store_true",
                    help="skip the secondary fusion-engine measurement")
    ap.add_argument("--no-e2e-stat", action="store_true",
                    help="skip the end-to-end pipeline measurement")
    ap.add_argument("--no-10m", action="store_true",
                    help="skip the 10M x 100 config-5 measurement")
    ap.add_argument("--no-seg2d", action="store_true",
                    help="skip the 2D-inference + model-in-the-loop stats")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one headline run to DIR")
    return ap.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bar(result, ok, text):
    """Record a correctness bar; a failed one goes to result["failed_bars"]."""
    log(f"bar {'held' if ok else 'FAILED'}: {text}")
    if not ok:
        result.setdefault("failed_bars", []).append(text)


def _add_launches(result, n):
    result["k1_launches"] = result.get("k1_launches", 0) + n


def cached_workload(npts, nframes, hw):
    """`make_workload(npts, nframes, hw)`, kept in the temporary directory."""
    cache = Path(tempfile.gettempdir()) / f"f3s_torch_bench_{npts}_{nframes}_{hw[0]}x{hw[1]}.npz"
    if cache.exists():
        log(f"loading cached workload {cache}")
        z = np.load(cache)
        return z["points"], z["K"], z["quats"], z["trans"], z["masks"]
    log(f"building workload: {npts} pts x {nframes} frames {hw} ...")
    points, K, quats, trans, masks = make_workload(npts, nframes, hw)
    np.savez(cache, points=points, K=K, quats=quats, trans=trans, masks=masks)
    return points, K, quats, trans, masks


def _on(dev, *arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in arrays)


def k1_err(C, nclasses, threshold=0.5):
    """The largest absolute difference between K1 and its plain version on
    C [F, N] over total, vmax and classes (0 when they agree)."""
    got = hist.histogram_classify(C, nclasses, threshold)
    want = hist.histogram_classify_reference(C, nclasses, threshold)
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip((*got[0], got[1]), (*want[0], want[1])))


def k1_row(C, nclasses, threshold=0.5):
    """K1 on a winner matrix C [F, N] on the card, held to its plain
    version: the largest absolute difference over total, vmax and classes
    ("max_abs_err", 0 when they agree), ms in a CUDA graph beside its bound
    (C read once, total, vmax and classes written once; one compare and one
    increment a byte at the float32 rate), the plain version's ms between
    CUDA events, and which kernel ran."""
    F, N = C.shape
    err = k1_err(C, nclasses, threshold)
    ms = graph_ms(lambda: hist.histogram_classify(C, nclasses, threshold), iters=20)
    plain_ms = event_ms(lambda: hist.histogram_classify_reference(C, nclasses, threshold))
    nbytes = F * N + 3 * 4 * N
    bound, by = bound_ms(nbytes, 2 * F * N)
    tiled = hist.rows_aligned(C.data_ptr(), C.stride(0), F)
    return {"shape": [F, N], "kernel": "tiled" if tiled else "byte", "max_abs_err": err,
            "ms": ms, "bytes": nbytes, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "plain_ms": plain_ms}


def cells_cache(npts, frames, hw, cell_size):
    """Config 5's cell-index cache in the temporary directory. hw belongs
    in the key: the visible-cell lists depend on the frustum, and an index
    for another field of view would mis-cull the timed run."""
    return (Path(tempfile.gettempdir())
            / f"f3s_torch_bench_cells_{npts}_{frames}_{hw[0]}x{hw[1]}_{cell_size}.npz")


def cells_run(npts, nclasses, hw, points, K, quats, trans, masks, cell_size, dev, cache=None):
    """The cell index (from `cache`, an npz path, where it exists, else
    built and saved there), the bucket plan, the device program and its
    inputs on `dev`. Returns (build(**kw) -> run, dev_args, mean candidates
    a frame, {"build" or "load": seconds})."""
    t0 = time.perf_counter()
    if cache is not None and cache.exists():
        z = np.load(cache)
        cells_table, cell_lists, counts = z["t"], z["l"], z["c"]
        index_s = {"load": time.perf_counter() - t0}
    else:
        cells_table, cell_lists, counts = lf.build_cell_index(points, K, quats, trans, hw,
                                                              cell_size=cell_size)
        index_s = {"build": time.perf_counter() - t0}
        if cache is not None:
            np.savez(cache, t=cells_table, l=cell_lists, c=counts)
    cs = cells_table.shape[1]
    perm, sizes, Ks = lf.plan_window_buckets(counts, nbuckets=12, round_to=8,
                                             max_window=cell_lists.shape[1])
    cand = sum(s * min(k, cell_lists.shape[1]) * cs for s, k in zip(sizes, Ks)) / len(quats)
    log(f"cell index: {len(cells_table)} cells of {cs}, mean candidate frac "
        f"{cand / npts:.3f}, {index_s}; buckets {list(zip(sizes, Ks))}")
    build = functools.partial(lf.tpu_label_fuse_cells, npts, nclasses, hw, Ks, sizes, device=dev)
    dev_args = (*_on(dev, cells_table, cell_lists[perm]),
                torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev),
                *_on(dev, quats[perm], trans[perm], masks[perm]))
    return build, dev_args, cand, index_s


def _timed_lift(build, dev_args, npts, nclasses, repeat, result, what, dev, profile=None):
    """The lifter `build()` on its inputs: one warm-up run, `repeat` timed
    runs (the best kept; K1's launches in them added to the result), the
    bar against the same run classified by K1's plain version, and, on the
    card, K1's row on the run's winner matrix (culled paths), with the bar
    that K1 and its plain version agree on it. Returns (classes as a host
    array, best seconds)."""
    run = build()

    def once(fn=run):
        out = fn(*dev_args)
        _sync(dev)
        return out[1]

    launches0 = hist.histogram_classify.launches
    t0 = time.perf_counter()
    classes_d = once()
    log(f"{what}: first run (incl. kernel build) {time.perf_counter() - t0:.2f}s")
    if profile:
        trace = Path(profile) / "headline_trace.json"
        trace.parent.mkdir(parents=True, exist_ok=True)
        with contextlib.redirect_stdout(sys.stderr):
            profile_run(once, what, trace_path=trace)
        log(f"profiler trace written to {trace}")
    best = np.inf
    for i in range(repeat):
        t0 = time.perf_counter()
        classes_d = once()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"{what}: run {i} {dt:.3f}s")
    _add_launches(result, hist.histogram_classify.launches - launches0)
    _bar(result, torch.equal(classes_d, once(build(use_cuda_hist=False))),
         f"{what}: classes equal to the run classified by K1's plain version")
    if dev.type == "cuda" and hasattr(run, "winners"):
        row = k1_row(run.winners(*dev_args)[:, :npts], nclasses)
        log(f"K1 {row}")
        _bar(result, row["max_abs_err"] == 0,
             f"{what}: K1 on the run's winner matrix {row['shape']} equal to its plain version "
             f"(total, vmax, classes; max abs err {row['max_abs_err']})")
        result.setdefault("k1_rows", []).append(row)
    return classes_d.cpu().numpy(), best


def headline_1m(args, result):
    """BASELINE configs 1-3 (`bench.py:235-376`). Returns {"classes",
    "classes_oracle"} as host arrays."""
    dev = resolve_device(args.device)
    hw = (args.height, args.width)
    points, K, quats, trans, masks = cached_workload(args.npts, args.frames, hw)

    index_s = {"build": 0.0}
    if args.no_view_index:
        build = functools.partial(lf.tpu_label_fuse, args.npts, args.nclasses, hw, device=dev)
        dev_args = (*_on(dev, points), torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                                       device=dev), *_on(dev, quats, trans, masks))
        M = args.npts
    else:
        build, dev_args, M, index_s = cells_run(
            args.npts, args.nclasses, hw, points, K, quats, trans, masks, args.cell_size, dev)
    classes_tpu, best = _timed_lift(build, dev_args, args.npts, args.nclasses, args.repeat,
                                    result, f"{args.npts} x {args.frames}", dev, args.profile)
    del dev_args
    tpu_pps = args.npts * args.frames / best

    # the CPU denominator: three passes over the first oracle_frames frames
    # and the full pass, the median of the four rates, spread recorded
    of = min(args.oracle_frames, args.frames)
    log(f"cpu oracle timing on {of} frames x3 ...")
    cpu_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        cpu_label_fuse(points, K, quats[:of], trans[:of], masks[:of], args.nclasses, hw)
        cpu_times.append(time.perf_counter() - t0)
    cpu_rates = [args.npts * of / t for t in cpu_times]
    log(f"cpu oracle FULL pass ({args.frames} frames) ...")
    t0 = time.perf_counter()
    _, classes_o = cpu_label_fuse(points, K, quats, trans, masks, args.nclasses, hw)
    cpu_full_dt = time.perf_counter() - t0
    cpu_rates.append(args.npts * args.frames / cpu_full_dt)
    cpu_pps = float(np.median(cpu_rates))
    log(f"cpu full: {cpu_full_dt:.1f}s; rates {[f'{r:.3g}' for r in cpu_rates]} -> median "
        f"{cpu_pps:.3g}")

    agree = float(np.mean(classes_tpu == classes_o))
    _bar(result, agree >= AGREEMENT_BAR,
         f"label_agreement {agree:.6f} >= {AGREEMENT_BAR} over all {args.frames} frames")
    result.update({
        "value": round(tpu_pps, 1),
        "vs_baseline": round(tpu_pps / cpu_pps, 2),
        "frames_per_sec": round(args.frames / best, 2),
        "label_agreement": round(agree, 6),
        "label_agreement_frames": args.frames,
        "npts": args.npts,
        "frames": args.frames,
        "cpu_points_per_sec": round(cpu_pps, 1),
        "cpu_points_per_sec_spread": [round(r, 1) for r in cpu_rates],
        "cpu_full_session_seconds": round(cpu_full_dt, 1),
        "oracle_frames_measured": of,
        "view_index": not args.no_view_index,
        "view_index_window_frac": round(M / args.npts, 3),
        "view_index_build_seconds": round(index_s["build"], 2),
    })
    return {"classes": classes_tpu, "classes_oracle": classes_o}


def config5_10m(args, result):
    """BASELINE config 5 (`bench.py:378-458`): 10M x 100 through the
    gid-range-sharded z-buffer. Returns {"classes", "classes_oracle"}."""
    dev = resolve_device(args.device)
    npts, frames, hw = args.tenm_npts, args.tenm_frames, (args.height, args.width)
    nsub = -(-npts // (1 << 20))
    points, K, quats, trans, masks = cached_workload(npts, frames, hw)
    cs = max(args.cell_size, 256)
    build, dev_args, _, index_s = cells_run(npts, args.nclasses, hw, points, K, quats, trans,
                                            masks, cs, dev, cells_cache(npts, frames, hw, cs))
    classes_tpu, best = _timed_lift(build, dev_args, npts, args.nclasses, 2, result,
                                    f"{npts} x {frames} (nsub {nsub})", dev)
    del dev_args
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log(f"cpu oracle FULL pass ({npts} pts x {frames} frames) ...")
    t0 = time.perf_counter()
    _, classes_o = cpu_label_fuse(points, K, quats, trans, masks, args.nclasses, hw)
    cpu_dt = time.perf_counter() - t0
    agree = float(np.mean(classes_tpu == classes_o))
    log(f"10M: {best:.3f}s on {dev} vs {cpu_dt:.1f}s CPU, agreement {agree:.6f}")
    _bar(result, agree >= AGREEMENT_BAR,
         f"tenm_label_agreement {agree:.6f} >= {AGREEMENT_BAR} at {npts} x {frames}")
    result.update({
        "tenm_npts": npts,
        "tenm_frames": frames,
        "tenm_seconds": round(best, 3),
        "tenm_points_per_sec": round(npts * frames / best, 1),
        "tenm_label_agreement": round(agree, 6),
        "tenm_cpu_seconds": round(cpu_dt, 1),
        "tenm_vs_cpu": round(cpu_dt / best, 1),
        "tenm_nsub": nsub,
        # the index is built once and cached: a later run loads it
        **{f"tenm_view_index_{k}_seconds": (round(index_s[k], 2) if k in index_s else None)
           for k in ("build", "load")},
        # ru_maxrss is KiB on Linux: the oracle's votes alone are N x 134 int32
        "host_peak_rss_gib": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2),
    })
    return {"classes": classes_tpu, "classes_oracle": classes_o}


def fusion_session(nframes, hw, device, **kw):
    """A synthetic session on `device`: (synthetic session, SessionData,
    fuse_session's positional arguments)."""
    sess = synthetic.make_session(nframes=nframes, depth_hw=hw, **kw)
    sd = SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                 sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                 device=device)
    valid = (sd.depth > 0.1) & (sd.depth <= MAX_DEPTH)
    return sess, sd, (sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations, sd.points,
                      sd.normals, sd.colors, valid)


def engine_kw(hw, capacity, window, device, **kw):
    return dict(height=hw[0], width=hw[1], radius=RADIUS, min_cosine=MIN_COSINE,
                max_depth=MAX_DEPTH, capacity=capacity, window=window, device=device, **kw)


def _engine_twice(fargs, kw, dev):
    """fuse_session twice (the first warms up): (frames/s of the second
    run, n of each run, the second run's (state, uv2pt))."""
    ns = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fusion_engine.fuse_session(*fargs, **kw)
        _sync(dev)
        dt = time.perf_counter() - t0
        ns.append(int(out[0].n))
    return len(fargs[1]) / dt, ns, out


def fusion_and_e2e(args, result, sizes=FusionSizes()):
    """The fusion engine's frames/s, the loop-closure duplicate statistics
    and the end-to-end time (`bench.py:460-711`). Returns {"ref_res":
    (state, uv2pt)} of the reference-resolution run."""
    dev = resolve_device(args.device)
    nf, hw = sizes.frames, sizes.hw
    fsess, sd, fargs = fusion_session(nf, hw, dev)
    seed_cells = fusion_engine.seed_cells_for_frame(
        fargs[3][0], fargs[4][0], fargs[5][0], fargs[6][0], *hw, RADIUS, MIN_COSINE,
        max_depth=MAX_DEPTH)

    fcap = 1 << 17
    awin128 = fusion_engine.auto_window(seed_cells, fcap)
    fkw = engine_kw(hw, fcap, awin128, dev)
    fps, _, _ = _engine_twice(fargs, fkw, dev)
    log(f"fusion engine: {fps:.1f} frames/s ({hw[0]}x{hw[1]}, cap 128k, auto window {awin128})")
    result["fusion_engine_frames_per_sec"] = round(fps, 1)
    result["fusion_engine_128k_auto_window"] = awin128

    fkw_split = dict(fkw, window_policy="split")
    fps, _, _ = _engine_twice(fargs, fkw_split, dev)
    log(f"fusion engine: {fps:.1f} frames/s (same cap/window, window_policy=split)")
    result["fusion_engine_split_frames_per_sec"] = round(fps, 1)

    awin = fusion_engine.auto_window(seed_cells, 1 << 20)
    fps, _, _ = _engine_twice(fargs, dict(fkw, capacity=1 << 20, window=awin), dev)
    log(f"fusion engine: {fps:.1f} frames/s (cap 1M, auto window {awin})")
    result["fusion_engine_1m_cap_frames_per_sec"] = round(fps, 1)
    result["fusion_engine_1m_auto_window"] = awin

    # capture resolutions: VGA 640x480 (TUM, Kinect), then the reference's
    # own calibration, 720x960 portrait, at capacity 2^18 with window 2^14
    # (appends past capacity drop, as in the reference)
    outputs = {}
    for key, nfr, rhw in (("fusion_engine_vga_frames_per_sec", sizes.vga_frames, sizes.vga_hw),
                          ("fusion_engine_ref_res_frames_per_sec", sizes.ref_frames,
                           sizes.ref_hw)):
        _, _, rargs = fusion_session(nfr, rhw, dev)
        fps, ns, out = _engine_twice(rargs, engine_kw(rhw, 1 << 18, 1 << 14, dev), dev)
        log(f"fusion engine: {fps:.1f} frames/s ({rhw[0]}x{rhw[1]}, {nfr} frames, cap 256k); "
            f"n {ns}")
        _bar(result, ns[0] == ns[1], f"{rhw[0]}x{rhw[1]} engine: n {ns} equal in two runs")
        result[key] = round(fps, 1)
        outputs["ref_res"] = out[:2]
        del rargs, out

    # loop closure: the orbit revisits its start (turns=2) and overflows the
    # window; duplicates against the full merge, after the auto-dedup repair
    _, _, largs = fusion_session(nf, hw, dev, turns=2.0)
    st_full, _ = fusion_engine.fuse_session(*largs, **dict(fkw, window=None))
    n_lfull = int(st_full.n)
    st_n, _, spans_n = fusion_engine.fuse_session(*largs, with_stats=True, **fkw)
    st_s, _, spans_s = fusion_engine.fuse_session(*largs, with_stats=True, **fkw_split)
    n_n_raw, n_s_raw = int(st_n.n), int(st_s.n)
    ovf_n = int((spans_n > awin128).sum()) if awin128 else 0
    ovf_s = int((spans_s > awin128).sum()) if awin128 else 0
    st_n_d, _ = fusion_engine.dedup_state(st_n, RADIUS, MIN_COSINE, capacity=fcap)
    st_s_d, _ = fusion_engine.dedup_state(st_s, RADIUS, MIN_COSINE, capacity=fcap)
    n_n, n_s = int(st_n_d.n), int(st_s_d.n)
    dup_n = (n_n - n_lfull) / n_lfull
    dup_s = (n_s - n_lfull) / n_lfull
    # the repair also folds the full merge's own sub-radius pairs: compare
    # with the full merge under the same repair
    st_f_d, _ = fusion_engine.dedup_state(st_full, RADIUS, MIN_COSINE, capacity=fcap)
    n_fd = int(st_f_d.n)
    dup_s_norm = (n_s - n_fd) / n_fd
    # a run that fills its buffer drops further appends, which clamps its
    # duplicate fraction: flag it
    sat = {"newest": n_n_raw >= fcap, "split": n_s_raw >= fcap, "full": n_lfull >= fcap}
    log(f"loop-closure (turns=2, window {awin128}): overflow frames newest {ovf_n} / split "
        f"{ovf_s}; duplicates after auto-dedup newest {dup_n:+.3%} vs split {dup_s:+.3%} vs "
        f"full merge {n_lfull} pts; dedup-normalized split {dup_s_norm:+.3%} vs {n_fd}"
        + (f"; SATURATED at cap {fcap}: " + ",".join(k for k, v in sat.items() if v)
           if any(sat.values()) else ""))
    result["loopclosure_overflow_frames"] = ovf_s
    result["loopclosure_dup_frac_newest"] = round(dup_n, 4)
    result["loopclosure_dup_frac_split"] = round(dup_s, 4)
    result["loopclosure_dup_frac_newest_raw"] = round((n_n_raw - n_lfull) / n_lfull, 4)
    result["loopclosure_dup_frac_split_raw"] = round((n_s_raw - n_lfull) / n_lfull, 4)
    result["loopclosure_dup_frac_split_dedup_norm"] = round(dup_s_norm, 4)
    if any(sat.values()):
        result["loopclosure_saturated"] = [k for k, v in sat.items() if v]
    del largs, st_full, st_n, st_s, st_n_d, st_s_d, st_f_d

    if args.no_e2e_stat:
        return outputs

    # end to end: fusion -> vote -> classify -> instance split -> OBB merge,
    # the session already on the device; one warm-up, then the median of
    # three passes (the host split and merge share the host's cores)
    fmasks = torch.as_tensor(fsess.gt_mask.reshape(nf, -1), device=dev)

    def e2e_once(outdir):
        res = segment_session_fast(
            sd, masks=fmasks, radius=RADIUS, angle=10.0, valid=fargs[6], max_depth=MAX_DEPTH,
            capacity=fcap, window=awin128, nclasses=args.nclasses, threshold=0.5,
            min_pts_per_inst=100, outdir=outdir, device=dev)
        return res.n, res.n_instances_premerge, len(res.instance_info)

    with tempfile.TemporaryDirectory() as td:
        ns = [e2e_once(td)[0]]
        e2e_ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            n_pts, n_inst, n_merged = e2e_once(td)
            e2e_ts.append(time.perf_counter() - t0)
            ns.append(n_pts)
    e2e_dt = float(np.median(e2e_ts))
    log(f"e2e pipeline: {e2e_dt:.2f}s for {nf} frames -> {n_pts} pts, {n_inst} instances -> "
        f"{n_merged} after bbox merge (median of {[round(t, 3) for t in e2e_ts]})")
    _bar(result, len(set(ns)) == 1, f"end to end: n {ns} equal in every run")
    result.update({
        "e2e_pipeline_seconds": round(e2e_dt, 3),
        "e2e_frames_per_sec": round(nf / e2e_dt, 2),
        "e2e_seconds_samples": [round(t, 3) for t in e2e_ts],
        "e2e_points": n_pts,
        "e2e_instances": n_inst,
    })
    return outputs


def config4_seg2d(args, result):
    """BASELINE config 4 (`bench.py:713-801`): 2D images/s and the model in
    the loop, with the best shipped checkpoint."""
    dev = resolve_device(args.device)
    model_name, ckpt = convert.best_shipped_checkpoint()
    if model_name is None:
        model_name = "b0"
    seg = Segmenter2D(config=SegFormerConfig.named(model_name), checkpoint_dir=ckpt,
                      batch_size=8, input_hw=(256, 256), device=dev)
    result["seg2d_model"] = model_name
    result["seg2d_shipped_weights"] = ckpt is not None

    # images/s with the batch already on the device: staging would measure
    # the host link, not the model
    ih, iw = seg.input_hw
    batch = torch.as_tensor(np.random.default_rng(0).random((8, ih, iw, 3)),
                            dtype=torch.float32, device=seg.device)
    seg._logits_sem_conf(batch, 0.017, (ih, iw))
    _sync(seg.device)
    reps = 8
    t0 = time.perf_counter()
    for _ in range(reps):
        seg._logits_sem_conf(batch, 0.017, (ih, iw))
    _sync(seg.device)
    fps = 8 * reps / (time.perf_counter() - t0)
    log(f"2D segmenter ({model_name} @{ih}x{iw}, device-resident): {fps:.1f} images/s")
    result["seg2d_images_per_sec"] = round(fps, 1)

    res, _, _ = model_in_the_loop.in_the_loop(seg)
    agree = res["model_in_loop_3d_agreement"]
    log(f"model-in-the-loop ({res['frames']}-frame unseen textured session): 3D agreement "
        f"{agree:.4f}, unclassified {res['model_in_loop_unclassified']:.4f}, stream "
        f"{res['model_in_loop_stream_seconds']:.2f}s")
    _bar(result, agree >= LOOP_AGREE_BAR,
         f"model_in_loop_3d_agreement {agree:.4f} >= {LOOP_AGREE_BAR}")
    result["model_in_loop_3d_agreement"] = round(agree, 4)
    result["model_in_loop_unclassified"] = round(res["model_in_loop_unclassified"], 4)
    result["model_in_loop_stream_seconds"] = round(res["model_in_loop_stream_seconds"], 2)


def run(args, *, sizes=FusionSizes()):
    """Every block `args` enables, on `args.device`. Returns (result,
    outputs by block). The headline's failure ends the run; a later block
    that raises is recorded as a failed bar and the others go on."""
    dev = resolve_device(args.device)
    result = {"metric": HEADLINE_METRIC, "unit": "points/sec",
              "platform": "gpu" if dev.type == "cuda" else dev.type}
    if dev.type == "cuda":
        result["name"], result["power_limit"] = card_line().rsplit(", ", 1)
    result["host_ram_gib"] = round(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
                                   / 2**30, 1)
    outputs = {"headline": headline_1m(args, result)}
    for name, enabled, fn, extra in (
            ("fusion/e2e", not args.no_fusion_stat, fusion_and_e2e, (sizes,)),
            ("seg2d", not args.no_seg2d, config4_seg2d, ()),
            ("10m", not args.no_10m, config5_10m, ())):
        if not enabled:
            continue
        try:
            outputs[name] = fn(args, result, *extra)
        except Exception as e:  # the record keeps the other blocks' numbers
            traceback.print_exc(file=sys.stderr)
            _bar(result, False, f"{name} block raised {type(e).__name__}: {e}")
    return result, outputs


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        raise SystemExit("--profile traces the card: needs --device cuda")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    result, _ = run(args)
    print(json.dumps(result), flush=True)
    for text in result.get("failed_bars", []):
        log(f"FAIL: {text}")
    return 1 if result.get("failed_bars") else 0


if __name__ == "__main__":
    sys.exit(main())
