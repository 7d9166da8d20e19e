#!/usr/bin/env python
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device   the card's name, count and power limit; TF32 off for the run.
2. build    every CUDA kernel from `fusion3dseg_tpu_torch/csrc/`, one nvcc
            per source, all started together.
3. kernels  the histogram kernel against its plain PyTorch version on the
            card (exact) at the main path's shape on the label lifter's own
            row pitch, sparse and dense, on an odd pitch, on ragged shapes and
            with 254 classes; timed in a CUDA graph beside its bound.
4. headline the session label lifter `label_fuse_session` on the 1M-point,
            300-frame, 256x192, 133-class workload: timed, its kernel
            launches counted, held exactly to the same run classified by
            the plain version, and to the NumPy oracle over all frames.
5. sharded  the same session with id_bits=18 (the gid-range-sharded
            z-buffer, 4 sub-ranges): exactly equal to phase 4.
6. attention  the two attention kernels (spatial-reduction and
            neighbourhood) against their plain versions at the segmenter's
            shapes, a ragged float32 case each and the neighbourhood
            kernel's backward; timed (in CUDA graphs, between CUDA events)
            beside the plain version, a bound and
            `scaled_dot_product_attention` (timed here, used nowhere else).
7. segmenter  `Segmenter2D` at SegFormer-B2 width, bfloat16, 256x256, batch 8,
            on a textured synthetic session: the shipped checkpoint through
            the fused spatial-reduction kernel (launches counted, pixel
            accuracy against ground truth, masks against the same forward
            through the plain versions, frames/s), then B2 width with a
            neighbourhood-attention first stage (the shipped weights less
            that stage's reduction conv), and `predict`'s contract.
8. stream   `stream_segment` on that session: votes' contract, run twice
            bit-identical, classes against predict_batch + vote_and_classify.
9. fusion   the main path `segment_session_fast`. Masks branch on the
            48-frame 256x192 session (capacity 2^17, auto window, split
            policy): timed by stage, two runs bit-identical, held to the
            port on the CPU (n within 1%, pixel classes >= 0.999, the same
            instance categories). Loop closure (two turns): the window
            overflows and the repair lands within 1.02x of the full merge.
            Scale: fusion alone at capacity 2^20, and 12 VGA frames.
            Segmenter branch with phase 7's shipped B2 on its 16 frames:
            the spatial-reduction kernel's launches counted, classes held
            to the masks branch fed predict_batch's masks.

Then one JSON line for the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
`--phases attention,segmenter,stream` runs a subset while iterating (device
and build always run; `stream` needs `segmenter`; `fusion` alone loads the
B2 segmenter itself; the last line then names the phases that ran).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent
NPTS, NFRAMES, HW, NCLASSES = 1_000_000, 300, (256, 192), 133
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, non-tensor float32 (the table's only non-tensor rate)
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bfloat16 on the tensor cores
AGREEMENT_BAR = 0.9995
BF16_BAR, F32_BAR = 2e-2, 1e-4  # attention kernels vs plain versions, unit-normal inputs
PIXEL_ACC_BAR, MASK_AGREE_BAR, STREAM_AGREE_BAR = 0.95, 0.999, 0.9
# the main path on the card against the port on the CPU, and the JAX bar
# of the overflow repair against the full merge
FUSION_N_BAR, FUSION_AGREE_BAR, REPAIR_BAR = 0.01, 0.999, 1.02
FUSION_KW = dict(radius=0.05, angle=10.0, max_depth=8.0, capacity=1 << 17, window="auto",
                 window_policy="split", nclasses=133, threshold=0.5, min_pts_per_inst=100)
# the neighbourhood stage runs weights that were not trained for it: its logits
# are less decisive, so more near-ties flip between kernel and plain version
NAT_MASK_AGREE_BAR = 0.995
LOGIT_DIFF_BAR = 0.25  # bfloat16 through 16 blocks, kernel path vs plain versions
KERNEL_SOURCES = ["histogram", "sr_attention", "neighborhood_attention"]
ALL_PHASES = ["label", "attention", "segmenter", "stream", "fusion"]


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def event_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, replays=5):
    """Device time of one `fn()` in ms: `iters` calls captured in one CUDA
    graph, so that no host launch cost lies between them, replayed `replays`
    times between two CUDA events. For kernels shorter than their launch."""
    import torch

    fn()  # warm-up outside the capture: builds, plans, allocations
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def label_phases(card):
    """Phases 3-5: K1 and the session label lifter. Returns K1's entry."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.io.workload import cpu_label_fuse, make_workload
    from fusion3dseg_tpu_torch.ops import histogram as hist
    from fusion3dseg_tpu_torch.ops import label_fuse as lf

    dev = torch.device("cuda")

    # ---- 3. K1 against its plain version, and timed
    gen = torch.Generator(device=dev).manual_seed(0)

    def random_c(F, N, nclasses, pitch, invalid_share=0.85):
        """[F, N] view of rows `pitch` bytes apart; 85% invalid is what a
        sparse session leaves (a point is seen in few frames), 10% a point
        seen in most."""
        C = torch.randint(0, nclasses + 1, (F, pitch), device=dev, dtype=torch.int32,
                          generator=gen)
        invalid = torch.rand((F, pitch), device=dev, generator=gen) < invalid_share
        return torch.where(invalid, 255, C).to(torch.uint8)[:, :N]

    def check(C, nclasses, threshold):
        got = hist.histogram_classify(C, nclasses, threshold)
        want = hist.histogram_classify_reference(C, nclasses, threshold)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
            err = max(err, int((g.long() - w.long()).abs().max()))
        if err != 0:
            fail(f"K1 disagrees with its plain version at {tuple(C.shape)}, "
                 f"stride {C.stride(0)}, nclasses={nclasses}: max abs err {err}")
        return err

    def timed_k1(C, name):
        k_ms = graph_ms(lambda: hist.histogram_classify(C, NCLASSES, 0.5), iters=20)
        F, N = C.shape
        bytes_moved = F * N + 3 * 4 * N
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * F * N / F32_OPS_PER_S * 1e3  # one compare + one increment per byte
        return {"shape": f"[{F}, {N}] {name}", "ms": k_ms, "plain_ms": None,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None}, bytes_moved

    max_err = 0
    # the main path's layout: the label lifter's own row pitch (rows start on
    # 16-byte boundaries: the tiled kernel), sparse and dense; then a pitch of
    # N + 1 and ragged shapes on an odd pitch (the byte kernel) and an
    # aligned one, and the largest class count
    pitch = hist.row_pitch(NPTS + 1)
    rows = []  # the first timed layout is the entry's own
    for name, make, nc, thr, time_it in (
            ("aligned pitch, 85% invalid", lambda: random_c(NFRAMES, NPTS, NCLASSES, pitch),
             NCLASSES, 0.5, True),
            ("aligned pitch, 10% invalid",
             lambda: random_c(NFRAMES, NPTS, NCLASSES, pitch, 0.10), NCLASSES, 0.5, True),
            ("odd pitch N + 1, 85% invalid",
             lambda: random_c(NFRAMES, NPTS, NCLASSES, NPTS + 1), NCLASSES, 0.5, True),
            ("ragged, odd pitch", lambda: random_c(301, 1_000_003, NCLASSES, 1_000_003),
             NCLASSES, 0.6, False),
            ("ragged, aligned pitch",
             lambda: random_c(301, 1_000_003, NCLASSES, hist.row_pitch(1_000_003)),
             NCLASSES, 0.6, False),
            ("nclasses 254, aligned pitch", lambda: random_c(NFRAMES, NPTS, 254, pitch),
             254, 0.5, False)):
        C = make()
        tiled = hist.rows_aligned(C.data_ptr(), C.stride(0), C.shape[0])
        max_err = max(max_err, check(C, nc, thr))
        log(f"kernels: histogram_classify {tuple(C.shape)} stride {C.stride(0)} ({name}; "
            f"{'tiled' if tiled else 'byte'} kernel) nclasses={nc} threshold={thr}: "
            "exact vs plain version")
        if time_it:
            row, bytes_moved = timed_k1(C, name)
            extra = ""
            if not rows:  # there also the plain version, and the time between
                # CUDA events around single calls, as earlier runs read it
                row["plain_ms"] = event_ms(
                    lambda: hist.histogram_classify_reference(C, NCLASSES, 0.5), iters=3, warmup=1)
                e_ms = event_ms(lambda: hist.histogram_classify(C, NCLASSES, 0.5), iters=50)
                extra = (f"; between events around single calls {e_ms:.4f} ms; "
                         f"plain version {row['plain_ms']:.3f} ms")
            log(f"kernels: histogram_classify {row['shape']} {card}: kernel {row['ms']:.4f} ms "
                f"(in a CUDA graph), bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{bytes_moved / 1e6:.1f} MB at 3.35 TB/s), "
                f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound, "
                f"{bytes_moved / (row['ms'] * 1e-3) / 1e12:.3f} TB/s{extra}")
            rows.append(row)
        del C
        torch.cuda.empty_cache()

    # ---- 4. the headline: 1M points x 300 frames through label_fuse_session
    t0 = time.perf_counter()
    points, K, quats, trans, masks = make_workload(NPTS, NFRAMES, HW, seed=0)
    log(f"headline: workload {NPTS} pts x {NFRAMES} frames at {HW[0]}x{HW[1]}, "
        f"{NCLASSES} classes, built in {time.perf_counter() - t0:.2f} s (host)")
    t0 = time.perf_counter()
    cells_table, cell_lists, counts = lf.build_cell_index(points, K, quats, trans, HW,
                                                          cell_size=128)
    perm, sizes, Ks = lf.plan_window_buckets(counts, nbuckets=12, round_to=8,
                                             max_window=cell_lists.shape[1])
    index_s = time.perf_counter() - t0
    cs = cells_table.shape[1]
    cand = sum(s * min(k, cell_lists.shape[1]) * cs for s, k in zip(sizes, Ks)) / NFRAMES
    log(f"headline: cell index {len(cells_table)} cells of {cs}, mean candidates/frame "
        f"{cand:.0f} ({cand / NPTS:.3f} N), built in {index_s:.2f} s (host)")

    def session(**kw):
        out = lf.label_fuse_session(points, K, quats, trans, masks, HW,
                                    nclasses=NCLASSES, cell_size=128, nbuckets=12,
                                    device="cuda", **kw)
        torch.cuda.synchronize()
        return out

    hist.histogram_classify.launches = 0  # count the main path's launches only
    (total, vmax), classes = session()  # warm-up
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        (total, vmax), classes = session()
        times.append(time.perf_counter() - t0)
    launches = hist.histogram_classify.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 4:
        fail(f"K1 launched {launches} times in 4 label_fuse_session calls (want 1 each)")
    best = min(times)
    log(f"headline: label_fuse_session {card}: runs {[round(t, 4) for t in times]} s, "
        f"best {best:.4f} s (host index build included) -> "
        f"{NPTS * NFRAMES / best:.4g} points/s; K1 launches {launches} in 4 calls; "
        f"peak device memory {peak / 2**20:.1f} MiB")

    run = lf.tpu_label_fuse_cells(NPTS, NCLASSES, HW, Ks, sizes, device="cuda")
    dev_args = (torch.as_tensor(cells_table, device=dev),
                torch.as_tensor(cell_lists[perm], device=dev),
                torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev),
                torch.as_tensor(quats[perm], device=dev),
                torch.as_tensor(trans[perm], device=dev),
                torch.as_tensor(masks[perm], device=dev))
    dtimes = []
    for _ in range(4):
        t0 = time.perf_counter()
        out = run(*dev_args)
        torch.cuda.synchronize()
        dtimes.append(time.perf_counter() - t0)
    dbest = min(dtimes[1:])
    log(f"headline: device program (index prebuilt, inputs on the card) {card}: runs "
        f"{[round(t, 4) for t in dtimes[1:]]} s, best {dbest:.4f} s -> "
        f"{NPTS * NFRAMES / dbest:.4g} points/s")
    for a, b in zip((*out[0], out[1]), (total, vmax, classes)):
        if not torch.equal(a, b):
            fail("the device program disagrees with label_fuse_session")
    del out, dev_args

    for name, t in (("total", total), ("vmax", vmax), ("classes", classes)):
        if t.shape != (NPTS,) or t.dtype != torch.int32 or t.device.type != "cuda":
            fail(f"{name}: shape {tuple(t.shape)} {t.dtype} on {t.device}")
    if int(classes.min()) < 0 or int(classes.max()) > NCLASSES:
        fail("classes outside [0, nclasses]")
    if bool((vmax > total).any()):
        fail("vmax exceeds total")

    before = hist.histogram_classify.launches
    (p_total, p_vmax), p_classes = session(use_cuda_hist=False)
    if hist.histogram_classify.launches != before:
        fail("use_cuda_hist=False launched the kernel")
    for a, b, name in ((total, p_total, "total"), (vmax, p_vmax, "vmax"),
                       (classes, p_classes, "classes")):
        if not torch.equal(a, b):
            fail(f"headline {name} differs from the plain-version run")
    log("headline: classes, total, vmax exactly equal to the run classified by "
        "the plain version (use_cuda_hist=False)")
    del p_total, p_vmax, p_classes

    t0 = time.perf_counter()
    _, classes_o = cpu_label_fuse(points, K, quats, trans, masks, NCLASSES, HW)
    oracle_s = time.perf_counter() - t0
    agree = float(np.mean(classes.cpu().numpy() == classes_o))
    labeled = float((classes != NCLASSES).float().mean())
    log(f"headline: label agreement vs the NumPy oracle over all {NFRAMES} frames: "
        f"{agree:.6f} (bar {AGREEMENT_BAR}); labeled share {labeled:.4f}; "
        f"oracle pass {oracle_s:.1f} s (host)")
    if agree < AGREEMENT_BAR:
        fail(f"label agreement {agree} below {AGREEMENT_BAR}")

    # ---- 5. gid-range-sharded z-buffer: id_bits=18 -> 4 sub-ranges
    t0 = time.perf_counter()
    (s_total, s_vmax), s_classes = session(id_bits=18)
    log(f"sharded: label_fuse_session id_bits=18 (nsub={-(-NPTS // (1 << 18))}) "
        f"{card}: {time.perf_counter() - t0:.4f} s")
    for a, b, name in ((total, s_total, "total"), (vmax, s_vmax, "vmax"),
                       (classes, s_classes, "classes")):
        if not torch.equal(a, b):
            fail(f"id_bits=18 {name} differs from the id_bits=20 headline")
    log("sharded: classes, total, vmax exactly equal to the id_bits=20 headline")

    return {
        "name": "histogram_classify",
        "route": "cuda",
        "source": "fusion3dseg_tpu_torch/csrc/histogram.cu",
        "replaces": "fusion3dseg_tpu/ops/histogram.py:33",
        "launches": launches,
        "max_abs_err": max_err,
        **rows[0],
        "other_shapes": rows[1:],
    }


def _bound(nbytes, ops, dtype_name):
    """(bound_ms, bound_by): bytes over the memory rate against operations
    over the peak rate of the inputs' type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (BF16_OPS_PER_S if dtype_name == "bf16" else F32_OPS_PER_S) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _window_pairs(n, r):
    """Number of (query, key) index pairs along one axis of length n with
    |query - key| <= r, both inside [0, n)."""
    return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))


def attention_phase(card):
    """Phase 6: K3 and K2 against their plain versions. Returns their
    entries for the kernels line (`launches` still 0: phase 7 counts them)."""
    import torch
    import torch.nn.functional as F

    from fusion3dseg_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    def qkv(shape_q, shape_kv, dtype):
        return [torch.randn(s, device=dev, generator=gen).to(dtypes[dtype])
                for s in (shape_q, shape_kv, shape_kv)]

    def held(name, got, want, dtype, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        bar = BF16_BAR if dtype == "bf16" else F32_BAR
        if got.shape != want.shape or got.dtype != want.dtype or not err <= bar:
            fail(f"{name} {what}: max abs err {err} against its plain version (bar {bar})")
        return err

    def timed(entry, name, shape, dtype, kernel, plain, library, nbytes, ops):
        # these kernels are shorter than a launch from Python: time them in
        # CUDA graphs (with events around single calls the host's launch
        # rate, about 0.05 ms a call, is what shows)
        k_ms = graph_ms(kernel, iters=50)
        p_ms = graph_ms(plain, iters=5)
        l_ms = graph_ms(library, iters=50)
        b_ms, by = _bound(nbytes, ops, dtype)
        log(f"attention: {name} {shape} {dtype} {card}: kernel {k_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop), "
            f"{100 * b_ms / k_ms:.1f}% of bound; plain version {p_ms:.4f} ms; "
            f"scaled_dot_product_attention {l_ms:.4f} ms")
        row = {"shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
               "bound_by": by, "library_ms": l_ms}
        if "ms" not in entry:  # the first timed shape is the entry's own
            entry.update(row)
        else:
            entry.setdefault("other_shapes", []).append(row)

    # ---- K3, spatial-reduction attention
    sra = {"name": "sr_attention", "route": "cuda",
           "source": "fusion3dseg_tpu_torch/csrc/sr_attention.cu",
           "replaces": "fusion3dseg_tpu/ops/attention.py:30", "launches": 0,
           "max_abs_err": 0.0}
    for B, N, H, D, M, dtype, time_it in (
            (8, 4096, 1, 64, 64, "bf16", True), (8, 1024, 2, 64, 64, "bf16", True),
            (2, 16384, 1, 64, 256, "bf16", True), (1, 1000, 3, 32, 37, "f32", False)):
        q, k, v = qkv((B, N, H, D), (B, M, H, D), dtype)
        shape = f"[{B},{N},{H},{D}]x[{B},{M},{H},{D}]"
        err = held("sr_attention", attn.sr_attention(q, k, v),
                   attn.sr_attention_reference(q, k, v), dtype, shape)
        sra["max_abs_err"] = max(sra["max_abs_err"], err)
        log(f"attention: sr_attention {shape} {dtype}: max abs err {err:.3e} vs plain version")
        if time_it:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            timed(sra, "sr_attention", shape, dtype,
                  lambda: attn.sr_attention(q, k, v),
                  lambda: attn.sr_attention_reference(q, k, v),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt),
                  nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
                  ops=4 * B * H * N * M * D)

    # ---- K2, neighbourhood attention
    nat = {"name": "neighborhood_attention", "route": "cuda",
           "source": "fusion3dseg_tpu_torch/csrc/neighborhood_attention.cu",
           "replaces": "fusion3dseg_tpu/ops/attention.py:151", "launches": 0,
           "max_abs_err": 0.0}
    for B, h, w, H, D, window, dtype, time_it in (
            (8, 64, 64, 1, 64, 7, "bf16", True), (2, 128, 128, 1, 64, 7, "bf16", True),
            (1, 9, 11, 2, 8, 5, "f32", False),
            # windows 3, 9, 13 on grids no tile divides; head dims 24 and 128;
            # head dims that rule out 16-byte (20) and 4-byte (7) accesses
            (1, 20, 23, 2, 32, 3, "bf16", False), (2, 17, 19, 1, 64, 9, "bf16", False),
            (1, 12, 30, 1, 64, 13, "bf16", False), (1, 13, 9, 1, 16, 13, "f32", False),
            (1, 20, 7, 2, 24, 3, "bf16", False), (2, 10, 12, 2, 128, 5, "bf16", False),
            (1, 11, 10, 1, 20, 5, "bf16", False), (1, 9, 9, 3, 7, 3, "bf16", False),
            (1, 9, 9, 3, 7, 3, "f32", False)):
        N = h * w
        q, k, v = qkv((B, N, H, D), (B, N, H, D), dtype)
        shape = f"[{B},{h}*{w},{H},{D}] window {window}"
        err = held("neighborhood_attention", attn.neighborhood_attention(q, k, v, h, w, window),
                   attn.neighborhood_attention_reference(q, k, v, h, w, window), dtype, shape)
        nat["max_abs_err"] = max(nat["max_abs_err"], err)
        log(f"attention: neighborhood_attention {shape} {dtype}: max abs err {err:.3e} "
            "vs plain version")
        if time_it:
            r = window // 2
            iy, ix = torch.arange(h, device=dev), torch.arange(w, device=dev)
            near = ((iy[:, None] - iy[None, :]).abs() <= r)[:, None, :, None] & \
                   ((ix[:, None] - ix[None, :]).abs() <= r)[None, :, None, :]
            mask = near.reshape(N, N)  # [query, key] window membership
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask).transpose(1, 2)
            held("scaled_dot_product_attention with the window mask", lib,
                 attn.neighborhood_attention_reference(q, k, v, h, w, window), dtype, shape)
            timed(nat, "neighborhood_attention", shape, dtype,
                  lambda: attn.neighborhood_attention(q, k, v, h, w, window),
                  lambda: attn.neighborhood_attention_reference(q, k, v, h, w, window),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                  nbytes=4 * q.numel() * q.element_size(),
                  ops=4 * B * H * D * _window_pairs(h, r) * _window_pairs(w, r))
            del mask, near, lib

    # q, k, v as slices of one fused projection [B, N, 3, H, D]: token and
    # head strides differ from the shapes', bases are offset
    for dtype in ("bf16", "f32"):
        B, h, w, H, D, window = 2, 24, 20, 3, 32, 7
        fused = torch.randn((B, h * w, 3, H, D), device=dev, generator=gen).to(dtypes[dtype])
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        err = held("neighborhood_attention", attn.neighborhood_attention(q, k, v, h, w, window),
                   attn.neighborhood_attention_reference(q.contiguous(), k.contiguous(),
                                                         v.contiguous(), h, w, window),
                   dtype, "slices of a fused projection")
        nat["max_abs_err"] = max(nat["max_abs_err"], err)
        log(f"attention: neighborhood_attention [{B},{h}*{w},{H},{D}] window {window} {dtype}, "
            f"q, k, v slices of one [B,N,3,H,D] tensor: max abs err {err:.3e} vs plain version")

    # K2's backward: through the kernel's autograd.Function against the
    # plain version's own autograd
    for h, w, H, D, window, dtype in ((9, 11, 2, 8, 5, "f32"), (32, 32, 1, 64, 7, "bf16")):
        q, k, v = qkv((2, h * w, H, D), (2, h * w, H, D), dtype)
        wgt = torch.randn(q.shape, device=dev, generator=gen)
        grads = []
        for fn in (attn.neighborhood_attention, attn.neighborhood_attention_reference):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (fn(*leaves, h, w, window).float() * wgt).sum().backward()
            grads.append([t.grad for t in leaves])
        err = max(held("neighborhood_attention backward", g, p, dtype, f"d{n}")
                  for g, p, n in zip(*grads, "qkv"))
        log(f"attention: neighborhood_attention backward [2,{h}*{w},{H},{D}] window "
            f"{window} {dtype}: max abs err {err:.3e} vs the plain version's autograd")
    return [sra, nat]


def textured_session(nframes):
    from fusion3dseg_tpu_torch.io import synthetic

    return synthetic.make_session(nframes=nframes, depth_hw=(96, 72), appearance="textured",
                                  room=synthetic.RoomSpec(seed=(1 << 30) + 990_000))


def shipped_b2(batch):
    """(Segmenter2D on the card with the shipped B2 checkpoint and the fused
    spatial-reduction kernel, its config, the checkpoint's path)."""
    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.models import convert
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    cfg = dataclasses.replace(SegFormerConfig.b2(), use_pallas_attention=True)
    ckpt = convert.shipped_checkpoint("b2")
    if ckpt is None:
        fail("checkpoints/shipped_b2_textured.npz is missing")
    return Segmenter2D(cfg, ckpt, batch_size=batch, device="cuda"), cfg, ckpt


def segmenter_phase(card):
    """Phase 7: Segmenter2D at B2 width on the card. Returns the session,
    the kernel-path segmenter and (K3, K2) launches of the main-path runs."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.models import convert
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    nframes, batch = 16, 8
    t0 = time.perf_counter()
    session = textured_session(nframes)
    log(f"segmenter: textured session, {nframes} frames at 96x72, built in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    frames, gts = session.colors, session.gt_mask

    def masks_of(seg):
        return np.concatenate([seg.predict_batch(frames[i:i + batch], 0.017)
                               for i in range(0, nframes, batch)])

    def logits_of(seg):
        x = seg._model_input(frames[:batch])
        return seg._logits_sem_conf(x, 0.017, frames.shape[1:3])[0]

    def compare(name, seg, plain, per_forward, counter, bar):
        """Masks and logits of the kernel path against the plain versions."""
        counter.launches = 0
        got = masks_of(seg)
        torch.cuda.synchronize()
        launches = counter.launches
        forwards = nframes // batch
        if launches != per_forward * forwards:
            fail(f"{name}: {counter.__name__} launched {launches} times in {forwards} "
                 f"forwards (want {per_forward} each)")
        want = masks_of(plain)
        if counter.launches != launches:
            fail(f"{name}: use_cuda_attention=False launched the kernel")
        agree = float((got == want).mean())
        diff = float((logits_of(seg) - logits_of(plain)).abs().max())
        log(f"segmenter: {name}: {counter.__name__} launches {launches} in {forwards} "
            f"forwards; masks agree with the plain-version forward on {agree:.6f} of "
            f"pixels (bar {bar}); max logit difference {diff:.4f} (bar {LOGIT_DIFF_BAR})")
        if got.shape != gts.shape or got.dtype != np.uint8 or agree < bar \
                or not diff <= LOGIT_DIFF_BAR:
            fail(f"{name}: mask agreement {agree}, max logit difference {diff} against "
                 "the plain-version forward")
        return got, launches

    # the shipped B2 checkpoint through the fused spatial-reduction kernel
    t0 = time.perf_counter()
    seg, cfg, ckpt = shipped_b2(batch)
    plain = Segmenter2D(cfg, ckpt, batch_size=batch, device="cuda", use_cuda_attention=False)
    nparams = sum(p.numel() for p in seg.model.parameters())
    log(f"segmenter: SegFormer-B2 {nparams / 1e6:.2f}M parameters, {cfg.dtype}, input "
        f"{seg.input_hw}, batch {batch}, loaded twice in {time.perf_counter() - t0:.2f} s")
    if seg.input_hw != (256, 256):
        fail(f"the checkpoint's input size resolved to {seg.input_hw}")
    masks_of(seg)  # warm-up: cuDNN/cuBLAS plans
    got, sra_launches = compare("shipped B2, use_pallas_attention", seg, plain, 7,
                                attn.sr_attention, MASK_AGREE_BAR)
    acc = float((got == gts).mean())
    log(f"segmenter: pixel accuracy against ground truth {acc:.4f} (bar {PIXEL_ACC_BAR})")
    if acc < PIXEL_ACC_BAR:
        fail(f"pixel accuracy {acc} below {PIXEL_ACC_BAR}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        masks_of(seg)  # ends in a copy to the host
        times.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    masks_of(seg)
    log(f"segmenter: predict_batch {card}: {nframes} frames in "
        f"{[round(t, 4) for t in times]} s, best {nframes / min(times):.1f} frames/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # B2 width with a neighbourhood-attention first stage. The weights are the
    # shipped checkpoint's without the first stage's reduction conv and its
    # norm, which a neighbourhood stage does not have: not trained for this
    # attention, but decisive logits, so that masks can be compared (seeded
    # random weights give near-flat logits whose argmax flips on rounding)
    cfg_nat = dataclasses.replace(SegFormerConfig.b2(), nat_windows=(7, 0, 0, 0))
    flat = {k: v for k, v in convert.flatten_params(convert.load_params_npz(ckpt)).items()
            if not (k.startswith("stage0_") and ("/sr/" in k or
                                                 "EfficientAttention_0/LayerNorm_0" in k))}
    state = convert.from_flax_params(flat, cfg_nat)
    seg_nat, plain_nat = (Segmenter2D(cfg_nat, input_hw=(256, 256), batch_size=batch,
                                      device="cuda", use_cuda_attention=use)
                          for use in (True, False))
    for s in (seg_nat, plain_nat):
        s.model.load_state_dict(state)
    _, nat_launches = compare("B2 width, nat_windows=(7,0,0,0), shipped weights less the "
                              "first stage's reduction", seg_nat, plain_nat, 3,
                              attn.neighborhood_attention, NAT_MASK_AGREE_BAR)
    del seg_nat, plain_nat, plain

    # predict: the reference predictor's output contract
    out = seg.predict(frames[0][:, :, ::-1])
    sem, (idimage, info), inst = out.values()
    h, w = frames.shape[1:3]
    ok = (sem.shape == (133, h, w) and sem.dtype == np.float32 and np.isfinite(sem).all()
          and idimage.shape == (h, w) and idimage.dtype == np.int32
          and sorted(s["id"] for s in info) == list(range(1, len(info) + 1))
          and set(inst) == {"pred_classes", "pred_masks", "scores"}
          and inst["pred_masks"].shape[1:] == (h, w)
          and (sem.argmax(0) == got[0])[got[0] != 133].all())
    if not ok:
        fail("Segmenter2D.predict broke its output contract")
    log(f"segmenter: predict: sem_seg {sem.shape} {sem.dtype}, {len(info)} panoptic "
        f"segments, {len(inst['pred_classes'])} instances")
    return session, seg, (sra_launches, nat_launches)


def _session_on(sess, device):
    from fusion3dseg_tpu_torch.io.rtab import SessionData

    return SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                   sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                   device=device)


def stream_phase(card, session, seg):
    """Phase 8: stream_segment on the card against predict_batch + voting."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.ops.voting import vote_and_classify
    from fusion3dseg_tpu_torch.pipeline.streaming import stream_segment

    sd = _session_on(session, "cuda")
    nf, (hd, wd) = sd.nframes, sd.depth_hw
    if sd.points.shape != (nf, hd * wd, 3) or sd.points.device.type != "cuda" \
            or not bool(torch.isfinite(sd.normals).all()):
        fail("SessionData.from_arrays: wrong shapes, device or values")
    # injective random pixel -> point maps: a real z-buffer lets a point win
    # at most one pixel per frame
    rng = np.random.default_rng(0)
    npts, npix = 5000, hd * wd
    uv2pt = np.full((nf, npix), -1, np.int32)
    for f in range(nf):
        uv2pt[f, rng.choice(npix, size=npts, replace=False)] = rng.permutation(npts)

    attn.sr_attention.launches = 0
    t0 = time.perf_counter()
    votes, classes = stream_segment(sd, seg, uv2pt, npts=npts, nclasses=133,
                                    batch_size=seg.batch_size)
    dt = time.perf_counter() - t0
    launches = attn.sr_attention.launches
    if launches != 7 * -(-nf // seg.batch_size):
        fail(f"stream_segment launched the spatial-reduction kernel {launches} times")
    if votes.shape != (npts, 134) or votes.dtype != np.int32 or classes.shape != (npts,) \
            or votes.sum(axis=1).max() > nf or classes.max() > 133:
        fail("stream_segment broke its votes/classes contract")
    v2, c2 = stream_segment(sd, seg, uv2pt, npts=npts, nclasses=133,
                            batch_size=seg.batch_size)
    if not (np.array_equal(votes, v2) and np.array_equal(classes, c2)):
        fail("stream_segment is not bit-identical across two runs")
    # the mask route: predict_batch on the uint8 frames (already at depth
    # resolution, so the nearest resize is the identity), then voting
    masks = np.concatenate([seg.predict_batch(session.colors[i:i + seg.batch_size])
                            for i in range(0, nf, seg.batch_size)])
    _, classes_m = vote_and_classify(uv2pt, masks.reshape(nf, -1), npts, 133, 0.5,
                                     device="cuda")
    agree = float((classes_m.cpu().numpy() == classes).mean())
    log(f"stream: stream_segment {card}: {nf} frames, {npts} points in {dt:.3f} s, "
        f"K3 launches {launches}; votes per point <= {int(votes.sum(axis=1).max())}; "
        f"bit-identical twice; classes agree with predict_batch + vote_and_classify on "
        f"{agree:.4f} of points (bar {STREAM_AGREE_BAR}); labeled share "
        f"{float((classes != 133).mean()):.4f}")
    if agree <= STREAM_AGREE_BAR:
        fail(f"stream agreement {agree} not above {STREAM_AGREE_BAR}")


def _pixel_agreement(a, b):
    """Share of pixels, mapped in both results, whose point carries the same
    class: classes[uv2pt] over pixels with uv2pt >= 0 in both."""
    ua, ub = a.uv2pt.cpu().numpy(), b.uv2pt.cpu().numpy()
    both = (ua >= 0) & (ub >= 0)
    return float((a.classes[ua[both]] == b.classes[ub[both]]).mean()), float(both.mean())


def _same_run(a, b):
    import numpy as np
    import torch

    return (a.n == b.n and torch.equal(a.uv2pt, b.uv2pt) and np.array_equal(a.classes, b.classes)
            and np.array_equal(a.instance_ids, b.instance_ids))


def fusion_phase(card, seg_session=None, seg=None):
    """Phase 9: the main path `segment_session_fast` on the card. Returns
    the spatial-reduction kernel's launches inside it (segmenter branch)."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.fusion import fusion as fe
    from fusion3dseg_tpu_torch.io import synthetic
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast

    nframes, hw = 48, (256, 192)
    t0 = time.perf_counter()
    sess = synthetic.make_session(nframes=nframes, depth_hw=hw)
    sd = _session_on(sess, "cuda")
    masks = torch.as_tensor(sess.gt_mask.reshape(nframes, -1), device="cuda")
    min_cos = float(np.cos(np.deg2rad(FUSION_KW["angle"])))
    seed_cells = fe.seed_cells_for_frame(
        sd.points[0], sd.normals[0], sd.colors[0], (sd.depth[0] > 0.1) & (sd.depth[0] <= 8.0),
        *hw, FUSION_KW["radius"], min_cos, max_depth=8.0)
    window = fe.auto_window(seed_cells, FUSION_KW["capacity"])
    log(f"fusion: session {nframes} frames at {hw[0]}x{hw[1]} on the card in "
        f"{time.perf_counter() - t0:.2f} s (host build); seed frame {seed_cells} cells -> auto "
        f"window {window} at capacity {FUSION_KW['capacity']}")

    # ---- 9a. masks branch: warm-up, three timed calls, two compared
    def masks_run(**kw):
        out = segment_session_fast(sd, masks=masks, device="cuda", **dict(FUSION_KW, **kw))
        torch.cuda.synchronize()
        return out

    masks_run()
    runs, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        t0 = time.perf_counter()
        runs.append(masks_run())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    res = runs[-1]
    med = float(np.median(times))
    stages = {k: float(np.median([r.stage_seconds[k] for r in runs])) for k in res.stage_seconds}
    log(f"fusion: segment_session_fast masks branch {card}: runs "
        f"{[round(t, 4) for t in times]} s, median {med:.4f} s ({nframes / med:.1f} frames/s); "
        "stages (medians) " + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items())
        + f"; n {res.n}, instances {res.n_instances_premerge} -> {len(res.instance_info)} after "
        f"the OBB merge, overflow frames {res.overflow_frames}; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    if not _same_run(runs[-2], runs[-1]):
        fail("segment_session_fast: two runs on the card are not bit-identical")
    if res.uv2pt.device.type != "cuda" or res.state.points.device.type != "cuda":
        fail("segment_session_fast did not run on the card")
    t0 = time.perf_counter()
    on_cpu = segment_session_fast(_session_on(sess, "cpu"), masks=sess.gt_mask, device="cpu",
                                  **FUSION_KW)
    cpu_s = time.perf_counter() - t0
    agree, mapped = _pixel_agreement(res, on_cpu)
    cats, cats_cpu = ({i["category_id"] for i in r.instance_info} for r in (res, on_cpu))
    log(f"fusion: two card runs bit-identical (n, uv2pt, classes, instance ids); the port on "
        f"the CPU ({cpu_s:.1f} s): n {on_cpu.n}, {len(on_cpu.instance_info)} instances; pixel "
        f"class agreement {agree:.6f} over {mapped:.4f} of pixels (bar {FUSION_AGREE_BAR}); "
        f"instance categories {sorted(cats)} (CPU {sorted(cats_cpu)})")
    if abs(res.n - on_cpu.n) > FUSION_N_BAR * on_cpu.n or agree < FUSION_AGREE_BAR \
            or cats != cats_cpu:
        fail(f"masks branch against the CPU: n {res.n} vs {on_cpu.n}, agreement {agree}, "
             f"categories {sorted(cats)} vs {sorted(cats_cpu)}")
    del runs, on_cpu

    # ---- 9b. loop closure: two turns overflow the auto window
    lsess = synthetic.make_session(nframes=nframes, depth_hw=hw, turns=2.0)
    lsd = _session_on(lsess, "cuda")
    lmasks = torch.as_tensor(lsess.gt_mask.reshape(nframes, -1), device="cuda")
    loop = {name: segment_session_fast(lsd, masks=lmasks, device="cuda", **dict(FUSION_KW, **kw))
            for name, kw in (("repaired", {}), ("raw", dict(auto_dedup=False)),
                             ("full", dict(window=None)))}
    n = {k: v.n for k, v in loop.items()}
    log(f"fusion: loop closure (turns=2): overflow frames {loop['raw'].overflow_frames}; n raw "
        f"{n['raw']}, repaired {n['repaired']}, full merge {n['full']} (repaired / full "
        f"{n['repaired'] / n['full']:.4f}, bar {REPAIR_BAR}); repair "
        f"{loop['repaired'].stage_seconds['repair']:.4f} s")
    if loop["raw"].overflow_frames == 0 or n["repaired"] > REPAIR_BAR * n["full"] \
            or int(loop["repaired"].uv2pt.max()) >= n["repaired"]:
        fail(f"loop closure: overflow {loop['raw'].overflow_frames}, n {n}")
    del loop, lsd, lmasks

    # ---- 9c. scale: the engine alone at capacity 2^20, then VGA frames
    def engine(sdx, height, width, capacity, win, nf):
        valid = (sdx.depth > 0.1) & (sdx.depth <= 8.0)
        out = fe.fuse_session(sdx.Ks, sdx.quats_wxyz[:nf], sdx.translations[:nf],
                              sdx.points[:nf], sdx.normals[:nf], sdx.colors[:nf], valid[:nf],
                              height=height, width=width, radius=FUSION_KW["radius"],
                              min_cosine=min_cos, max_depth=8.0, capacity=capacity, window=win,
                              window_policy="split", device="cuda")
        torch.cuda.synchronize()
        return out

    def host_syncs(fn):
        """Operations in `fn()` that make the host wait for the device, as
        torch's sync debug mode reports them."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("called a synchronizing" in str(w.message) for w in caught)

    vsess = synthetic.make_session(nframes=12, depth_hw=(480, 640))
    for name, sdx, (height, width), cap, win in (
            ("capacity 2^20, auto window", sd, hw, 1 << 20, fe.auto_window(seed_cells, 1 << 20)),
            ("VGA 480x640, capacity 2^18, window 2^14", _session_on(vsess, "cuda"), (480, 640),
             1 << 18, 1 << 14)):
        nf = sdx.nframes
        args = (sdx, height, width, cap, win)
        engine(*args, nf)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a = engine(*args, nf)
        dt = time.perf_counter() - t0
        b = engine(*args, nf)
        # the frame loop never waits for the device: a call of half the
        # frames waits as often (the set-up's copies and its 3x3 inverse)
        syncs = (host_syncs(lambda: engine(*args, nf)), host_syncs(lambda: engine(*args, nf // 2)))
        na = int(a[0].n)
        same = all(torch.equal(x, y) for x, y in zip((*a[0], a[1]), (*b[0], b[1])))
        log(f"fusion: fuse_session {name} (window {win}) {card}: {nf} frames in {dt:.4f} s "
            f"({nf / dt:.1f} frames/s); n {na}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; two runs bit-identical: "
            f"{same}; host syncs in a call of {nf} / {nf // 2} frames: {syncs[0]} / {syncs[1]}")
        if not same or na > cap or int(a[1].max()) >= na or syncs[0] != syncs[1]:
            fail(f"fuse_session {name}: invariants broken (n {na}, uv2pt max "
                 f"{int(a[1].max())}, identical {same}, host syncs {syncs})")
        del a, b
    del vsess
    torch.cuda.empty_cache()

    # ---- 9d. segmenter branch: the shipped B2 on phase 7's session
    if seg is None:
        seg_session, (seg, _, _) = textured_session(16), shipped_b2(8)
    tsd = _session_on(seg_session, "cuda")
    kw = FUSION_KW
    segment_session_fast(tsd, segmenter=seg, device="cuda", **kw)  # warm-up
    torch.cuda.synchronize()
    attn.sr_attention.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    res = segment_session_fast(tsd, segmenter=seg, device="cuda", **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = attn.sr_attention.launches
    nf = tsd.nframes
    forwards = -(-nf // 8)  # stream_segment's batch of 8
    pm = np.concatenate([seg.predict_batch(seg_session.colors[i:i + seg.batch_size])
                         for i in range(0, nf, seg.batch_size)])
    via_masks = segment_session_fast(tsd, masks=pm, device="cuda", **kw)
    if via_masks.n != res.n or not torch.equal(via_masks.uv2pt, res.uv2pt):
        fail("the segmenter and masks branches fused differently")
    agree = float((via_masks.classes == res.classes).mean())
    log(f"fusion: segment_session_fast segmenter branch (shipped B2) {card}: {nf} frames at "
        f"96x72 in {dt:.4f} s ({nf / dt:.1f} frames/s); n {res.n}; spatial-reduction kernel "
        f"launches {launches} in {forwards} forwards; classes agree with the masks branch fed "
        f"predict_batch's masks on {agree:.4f} of points (bar {STREAM_AGREE_BAR})")
    if launches != 7 * forwards:
        fail(f"segmenter branch: the spatial-reduction kernel launched {launches} times")
    if agree <= STREAM_AGREE_BAR:
        fail(f"segmenter branch agreement {agree} not above {STREAM_AGREE_BAR}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    phases = ap.parse_args().phases.split(",")
    if set(phases) - set(ALL_PHASES) or ("stream" in phases and "segmenter" not in phases):
        fail(f"--phases {phases}: choose from {ALL_PHASES}; stream needs segmenter")
    sys.path.insert(0, str(HERE))
    try:
        import torch
        import fusion3dseg_tpu_torch
    except ImportError as e:
        fail(f"cannot import the port beside this script: {e}")
    if Path(fusion3dseg_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"fusion3dseg_tpu_torch came from {fusion3dseg_tpu_torch.__file__}, "
             f"not from {HERE}")
    from fusion3dseg_tpu_torch import cuda

    # ---- 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {kind} x{count}; nvidia-smi: {smi}")
    log(f"device: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build
    t0 = time.perf_counter()
    built = cuda.build(KERNEL_SOURCES)
    log(f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for b in built.values():
        log(f"build: {b.name}.cu nvcc {b.seconds:.2f} s -> {b.path.name}")
        for line in b.ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"build: ptxas: {line.strip()}")

    card = f"[{smi}]"
    kernels = []
    t_start = time.perf_counter()
    if "label" in phases:
        kernels.append(label_phases(card))
    if "attention" in phases:
        kernels += attention_phase(card)
    session = seg = None
    if "segmenter" in phases:
        session, seg, launches = segmenter_phase(card)
        for entry, n in zip(kernels[-2:] if "attention" in phases else (), launches):
            entry["launches"] = n
        if "stream" in phases:
            stream_phase(card, session, seg)
    if "fusion" in phases:
        n = fusion_phase(card, session, seg)
        for entry in kernels:
            if entry["name"] == "sr_attention":
                entry["launches"] += n
    log(f"phases {phases} took {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}
    if phases != ALL_PHASES:
        result["phases"] = phases  # a partial run says so
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
