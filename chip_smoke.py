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
10. files   the file-artifact path on the 48-frame 256x192 textured
            session: written as an rtabmap-export directory by the port's
            own codec and read back (depth and masks exact, JPEG PSNR >= 35
            dB); `SegmentImage` with the shipped B2 (launches counted, mask
            files equal to predict_batch, pixel accuracy); `process3DSeg`
            -> `segment` -> `remove_classes` at process3DSeg's defaults,
            timed by stage, the artifact tree's names and dtypes checked,
            two card runs bit-identical, held to the port on the CPU with
            phase 9's bars; the codec timed on phase 9's 12 VGA frames.
11. hf       the HF import at B2 width: a seeded random HF-named B2 checkpoint
            with the HF decode head (150 labels) and an HF-named copy of the
            shipped B2's encoder, each through torch.save -> load_hf_state_dict
            -> infer_config_from_state_dict -> params_from_hf_segformer -> npz
            -> Segmenter2D with the spatial-reduction kernel: the transplant
            exact, the masks against the plain-version forward (>= 0.999 on
            the trained weights, equal to the shipped checkpoint's own).
12. train   `train` at SegFormer-B2 width (bfloat16, 256x256, batch 8) from
            random init: 40 steps on host textured batches with augment,
            boundary weight and EMA (timed, peak memory; the loss descends);
            the step-20 checkpoint restored bit for bit and resumed to 40; 20
            steps on device_dataset; the step alone under torch.profiler
            (launches, busy share); the neighbourhood-attention variant (K2
            launches counted, loss and gradients against the plain versions);
            the EMA snapshot through Segmenter2D with K3 (evaluate_synthetic);
            sweep_conf_threshold with the shipped B2 (K3 launches counted).
13. post    post-processing and the graph ops. (a) The CLI end to end, each
            subcommand a subprocess of `python -m fusion3dseg_tpu_torch`,
            timed: `synth` of the 48-frame 256x192 textured room, `all`
            with the shipped B2 (seg2d -> fuse -> seg3d) on the card and,
            on its masks, on the CPU; on copies of the card's tree, on the
            card and on the CPU, `doorwindow` (at least one quad), `refine`
            in depth and colour from a seed on a door/window instance and
            `remove-classes`; `tum` of a `write_tum_dir` export of the
            degraded session, converted and probed. Each pair of trees
            equal file for file (.npy/.json/.pkl/.ply/.txt), n equal. (b) The
            device graph ops: `radius_graph(k=16, cap_per_cell=8)` on the
            36k fused cloud at r 0.05 and 0.10 (every row equal to the port
            on the CPU) and on the 1M-point room cloud of `make_workload` at
            r 0.05 (4 chunks of 4096 rows recomputed on the CPU by the same
            chunk function); on that graph the device instance split equal
            to the native one, `propagate_labels`, `floodfill_level` and
            `gated_floodfill` (equal to the CPU's): ms after a synchronize,
            launches, sweeps, peak memory.

Then one JSON line for the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
`--phases attention,segmenter,stream` runs a subset while iterating (device
and build always run; `stream` needs `segmenter`; `fusion`, `files`, `hf`
and `train` alone load the B2 segmenter themselves, `post` builds its own
session; the last line then names the phases that ran).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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
ALL_PHASES = ["label", "attention", "segmenter", "stream", "fusion", "files", "hf", "train",
              "post"]
JPEG_PSNR_BAR = 35.0  # the port's q95 JPEG of the textured frames against their colours
FILES_CAPACITY = 1 << 20  # process3DSeg's default
# port state-dict name -> HF SegformerForSemanticSegmentation name, in order
HF_NAMES = (
    (r"^patch_embed(\d)\.conv\.", r"segformer.encoder.patch_embeddings.\1.proj."),
    (r"^patch_embed(\d)\.norm\.", r"segformer.encoder.patch_embeddings.\1.layer_norm."),
    (r"^stage(\d)_block(\d+)\.", r"segformer.encoder.block.\1.\2."),
    (r"\.norm1\.", ".layer_norm_1."), (r"\.norm2\.", ".layer_norm_2."),
    (r"\.attn\.q\.", ".attention.self.query."), (r"\.attn\.k\.", ".attention.self.key."),
    (r"\.attn\.v\.", ".attention.self.value."), (r"\.attn\.sr\.", ".attention.self.sr."),
    (r"\.attn\.norm\.", ".attention.self.layer_norm."),
    (r"\.attn\.proj\.", ".attention.output.dense."),
    (r"\.ffn\.fc1\.", ".mlp.dense1."), (r"\.ffn\.dw\.", ".mlp.dwconv.dwconv."),
    (r"\.ffn\.fc2\.", ".mlp.dense2."),
    (r"^stage_norm(\d)\.", r"segformer.encoder.layer_norm.\1."),
    (r"^linear_c(\d)\.", r"decode_head.linear_c.\1.proj."),
    (r"^fuse\.", "decode_head.linear_fuse."), (r"^classifier\.", "decode_head.classifier."),
    (r"^bn_scale$", "decode_head.batch_norm.weight"), (r"^bn_bias$", "decode_head.batch_norm.bias"),
    (r"^bn_mean$", "decode_head.batch_norm.running_mean"),
    (r"^bn_var$", "decode_head.batch_norm.running_var"),
)
HF_LABELS = 150  # ADE20K's, the taxonomy of the HF SegFormer-B2 semantic checkpoint
TRAIN_STEPS, TRAIN_DEVICE_STEPS, TRAIN_NAT_STEPS = 40, 20, 6
TRAIN_DESCENT_BAR = 0.8  # mean loss of the last 5 steps against the first 5
TRAIN_GRAD_BAR = 2e-2  # K2's path against the plain one: relative L2 of all gradients, bf16
POST_NPTS, POST_K, POST_CAP, POST_ROWS = 1_000_000, 16, 8, 4096
TREE_SUFFIXES = {".npy", ".json", ".pkl", ".ply", ".txt", ".csv", ".yaml"}


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
    return launches, vsess


def _read_tree(out, nframes):
    """The artifacts phase 10 compares: (fusion_data dict, uv2pt [F, H*W],
    classes, ids, final_info)."""
    import pickle

    import numpy as np

    with open(out / "fusion" / "fusion_data.pkl", "rb") as fp:
        data = pickle.load(fp)
    uv = np.stack([np.load(out / "fusion" / "uv2pt" / f"{i}.npy") for i in range(nframes)])
    return (data, uv, np.load(out / "segmentation" / "classes.npy"),
            np.load(out / "panoptic_segmentation" / "ids.npy"),
            json.loads((out / "panoptic_segmentation" / "final_info.json").read_text()))


def files_phase(card, seg=None, vga=None):
    """Phase 10: the file-artifact path on the card. Returns the
    spatial-reduction kernel's launches inside `SegmentImage`."""
    import pickle
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.io import image, native, ply, synthetic
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline import get2dseg, get3dseg, process3d
    from fusion3dseg_tpu_torch.utils import timing

    nframes, (h, w) = 48, (256, 192)
    work = Path(tempfile.mkdtemp(prefix="f3s_files_"))
    try:
        # ---- 10a. write the session, read it back
        sess = synthetic.make_session(nframes=nframes, depth_hw=(h, w), appearance="textured")
        t0 = time.perf_counter()
        codec = native.build(image.SOURCE)  # g++ at first use; kept out of the timings
        log(f"files: codec library {codec.name} ready in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        src = synthetic.write_session_dir(sess, work / "session")
        t_write = time.perf_counter() - t0
        psnr = []
        for i in range(nframes):
            d = image.read(src / "depth" / f"{i}.png", unchanged=True)
            m = image.read(src / "masks" / f"{i}.png", gray=True)
            want_d = np.clip(sess.depth[i] * 1000.0, 0, 65535).astype(np.uint16)
            if d.dtype != np.uint16 or not np.array_equal(d, want_d) \
                    or not np.array_equal(m, sess.gt_mask[i]):
                fail(f"files: frame {i}: depth or mask read back differs from what was written")
            rgb = image.read(src / "rgb" / f"{i}.jpg")
            mse = np.mean((rgb.astype(np.float64) - sess.colors[i]) ** 2)
            psnr.append(10 * np.log10(255.0 ** 2 / mse))
        log(f"files: wrote {nframes} frames at {h}x{w} (jpg q95 4:2:0, 16-bit png depth, png "
            f"masks) in {t_write:.3f} s; depth and masks read back exactly; JPEG PSNR min "
            f"{min(psnr):.2f} / median {float(np.median(psnr)):.2f} / max {max(psnr):.2f} dB "
            f"(bar {JPEG_PSNR_BAR})")
        if min(psnr) < JPEG_PSNR_BAR:
            fail(f"files: JPEG PSNR {min(psnr):.2f} dB below {JPEG_PSNR_BAR}")

        # ---- 10b. SegmentImage with the shipped B2 at batch 8
        if seg is None:
            seg, _, _ = shipped_b2(8)
        seg.predict_batch(sess.colors[:8])  # warm-up: the model's first forward
        torch.cuda.synchronize()
        attn.sr_attention.launches = 0  # count the main path's launches only
        t0 = time.perf_counter()
        get2dseg.SegmentImage(src / "rgb", work / "masks2d", segmenter=seg, batch_size=8)
        t_seg = time.perf_counter() - t0
        launches = attn.sr_attention.launches
        forwards = -(-nframes // 8)
        frames = np.stack([image.read(src / "rgb" / f"{i}.jpg") for i in range(nframes)])
        want = np.concatenate([seg.predict_batch(frames[i:i + 8]) for i in range(0, nframes, 8)])
        got = np.stack([image.read(work / "masks2d" / f"{i}.png", gray=True)
                        for i in range(nframes)])
        acc = float((got == sess.gt_mask).mean())
        log(f"files: SegmentImage (shipped B2, batch 8) {card}: {nframes} frames in {t_seg:.3f} s "
            f"({nframes / t_seg:.1f} frames/s); spatial-reduction kernel launches {launches} in "
            f"{forwards} forwards; mask files equal predict_batch on the decoded frames: "
            f"{np.array_equal(got, want)}; pixel accuracy against ground truth {acc:.4f} "
            f"(bar {STREAM_AGREE_BAR})")
        if launches != 7 * forwards:
            fail(f"SegmentImage: the spatial-reduction kernel launched {launches} times")
        if not np.array_equal(got, want) or acc <= STREAM_AGREE_BAR:
            fail(f"SegmentImage: masks differ from predict_batch or accuracy {acc}")

        # ---- 10c. process3DSeg -> segment -> remove_classes, twice on the card
        def pipeline(out, device):
            stages = {}
            timing.METRICS.spans.clear()
            t0 = time.perf_counter()
            sd = process3d.load_session(src, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            stages["from_export_dir"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            ret = process3d.process3DSeg(src, out, session=sd, capacity=FILES_CAPACITY,
                                         device=device)
            t_p3d = time.perf_counter() - t1
            get3dseg.segment(out, src / "masks", verbose=False, device=device)
            t0 = time.perf_counter()
            get3dseg.remove_classes(out, src / "masks", verbose=False, device=device)
            stages["remove_classes"] = time.perf_counter() - t0
            for key, span in (("fusion", "fusion"), ("dump", "fusion.dump"),
                              ("vote", "segmentation.vote"), ("split", "segmentation.instances"),
                              ("viz+ply", "segmentation.viz"),
                              ("master_classes", "segmentation.master_classes")):
                stages[key] = timing.METRICS.total(span)
            return ret, stages, t_p3d

        torch.cuda.reset_peak_memory_stats()
        card_runs = [pipeline(work / f"card{k}", "cuda") for k in range(2)]
        peak = torch.cuda.max_memory_allocated()
        ret, stages, t_p3d = card_runs[1]
        n = len(ret[0])
        log(f"files: process3DSeg + segment + remove_classes {card} (capacity {FILES_CAPACITY}): "
            f"n {n}; process3DSeg {t_p3d:.3f} s ({nframes / t_p3d:.1f} frames/s, decode and "
            "from_arrays included); stages " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                                      stages.items())
            + f"; peak device memory {peak / 2**20:.1f} MiB")

        out = work / "card1"
        adj = ret[7]
        data, uv, classes, ids, final = _read_tree(out, nframes)
        info_sem = json.loads((out / "segmentation" / "info.json").read_text())
        info_pan = json.loads((out / "panoptic_segmentation" / "info.json").read_text())
        boxes = [i["bbox"] for i in final if i.get("bbox") is not None]
        plys = sorted(out.rglob("*.ply"))
        for f in plys:
            pts, _, _ = ply.read_point_cloud(f)
            if pts.ndim != 2 or pts.shape[1] != 3 or not np.isfinite(pts).all():
                fail(f"files: {f.name} is not a finite [N, 3] cloud")
        votes = np.load(out / "segmentation" / "votes.npy")
        checks = {
            "uv2pt int32 [H*W]": uv.dtype == np.int32 and uv.shape == (nframes, h * w)
            and int(uv.max()) < n,
            "occurences uint32": data["occurences"].dtype == np.uint32,
            "fusion arrays NumPy": all(isinstance(data[k], np.ndarray) for k in
                                       ("points", "normals", "colors", "nmerges")),
            "adj.pkl object array of n": isinstance(adj, np.ndarray) and adj.dtype == object
            and len(adj) == n,
            "votes [n, 134]": votes.shape == (n, 134),
            "classes [n], ids [n]": classes.shape == (n,) and ids.shape == (n,),
            "info.json keys": all({"category_id", "name", "area", "hexcolor", "parent_id"}
                                  <= set(i) for i in info_sem)
            and all({"id", "category_id", "area", "isthing"} <= set(i) for i in info_pan),
            "8-corner bboxes": bool(boxes) and all(np.asarray(b).shape == (8, 3) for b in boxes),
            "remaining mask": np.load(out / "segmentation" / "remaining_mask.npy").shape == (n,),
            "PLY files": len(plys) >= 7,
        }
        log("files: artifact tree: " + ", ".join(f"{k} {v}" for k, v in checks.items())
            + f"; {len(plys)} PLY files, {len(final)} final instances")
        if not all(checks.values()):
            fail(f"files: artifact contract broken: {checks}")

        # ---- 10d. the card against itself, then against the CPU
        a, b = _read_tree(work / "card0", nframes), (data, uv, classes, ids, final)
        same = all(np.array_equal(a[0][k], b[0][k]) for k in a[0] if isinstance(a[0][k], np.ndarray))
        same = same and all(np.array_equal(x, y) for x, y in zip(a[1:4], b[1:4])) and a[4] == b[4]
        t0 = time.perf_counter()
        pipeline(work / "cpu", "cpu")
        cpu_s = time.perf_counter() - t0
        c = _read_tree(work / "cpu", nframes)
        both = (c[1] >= 0) & (uv >= 0)
        agree = float((c[2][c[1][both]] == classes[uv[both]]).mean())
        cats, cats_cpu = ({i["category_id"] for i in t[4]} for t in (b, c))
        log(f"files: two card runs bit-identical (uv2pt, fusion_data arrays, classes, ids, "
            f"final_info): {same}; the port on the CPU ({cpu_s:.1f} s, capacity "
            f"{FILES_CAPACITY}): n {len(c[2])} vs {n}; pixel class agreement {agree:.6f} over "
            f"{both.mean():.4f} of pixels (bar {FUSION_AGREE_BAR}); instance categories "
            f"{sorted(cats)} (CPU {sorted(cats_cpu)})")
        if not same:
            fail("files: two card runs differ")
        if abs(len(c[2]) - n) > FUSION_N_BAR * len(c[2]) or agree < FUSION_AGREE_BAR \
                or cats != cats_cpu:
            fail(f"files: card against CPU: n {n} vs {len(c[2])}, agreement {agree}, "
                 f"categories {sorted(cats)} vs {sorted(cats_cpu)}")

        # ---- 10e. the codec at capture size: phase 9's 12 VGA frames
        if vga is None:
            vga = synthetic.make_session(nframes=12, depth_hw=(480, 640))
        jpgs = [image.encode_jpeg(f) for f in vga.colors]
        dmm = np.clip(vga.depth * 1000.0, 0, 65535).astype(np.uint16)
        pngs = [image.encode_png(d) for d in dmm]

        def per_frame_ms(fn, items):
            fn(items[0])  # warm-up: the codec library's first load
            t0 = time.perf_counter()
            for x in items:
                fn(x)
            return (time.perf_counter() - t0) / len(items) * 1e3

        times = {"jpeg encode": per_frame_ms(image.encode_jpeg, vga.colors),
                 "jpeg decode": per_frame_ms(image.decode, jpgs),
                 "png16 encode": per_frame_ms(image.encode_png, dmm),
                 "png16 decode": per_frame_ms(lambda d: image.decode(d, unchanged=True), pngs)}
        log(f"files: codec at 480x640 on the host, ms a frame over {len(vga.colors)} frames: "
            + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches



def to_hf_names(state):
    """A port state dict as the HF checkpoint's tensors: renamed, the 1x1
    fuse and classifier as [out, in, 1, 1] convs, float32 on the host."""
    import re

    import torch

    out = {}
    for name, t in state.items():
        hf = name
        for pattern, repl in HF_NAMES:
            hf = re.sub(pattern, repl, hf)
        t = t.detach().float().cpu()
        if name in ("fuse.weight", "classifier.weight"):
            t = t[:, :, None, None]
        out[hf] = t.clone()
    if "decode_head.batch_norm.running_mean" in out:
        out["decode_head.batch_norm.num_batches_tracked"] = torch.tensor(0)
    return out


def hf_phase(card, seg=None, device="cuda", nframes=16):
    """Phase 11: the HF import at B2 width. A seeded random HF-named B2
    checkpoint with the HF decode head (150 labels) and an HF-named copy of
    the shipped B2's encoder and decoder projections go through
    `torch.save` -> `load_hf_state_dict` -> `infer_config_from_state_dict`
    -> `params_from_hf_segformer` -> npz -> `Segmenter2D` on the card.
    Returns the spatial-reduction kernel's launches."""
    import tempfile
    import shutil

    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert, import_hf
    from fusion3dseg_tpu_torch.models.segformer import SegFormer
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    work = Path(tempfile.mkdtemp(prefix="f3s_hf_"))
    frames = textured_session(nframes).colors
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    launches = 0
    try:
        def imported(source, want, name, with_head, template=None):
            """torch.save `source` under HF names, then the import chain, held
            exactly to `want`; returns (config, npz path)."""
            path = work / f"{name}.pth"
            torch.save(to_hf_names(source), path)
            t0 = time.perf_counter()
            sd = import_hf.load_hf_state_dict(path)
            cfg = import_hf.infer_config_from_state_dict(sd, with_head=with_head)
            got = import_hf.params_from_hf_segformer(sd, cfg, params_template=template,
                                                     include_head=with_head)
            npz = work / f"{name}.npz"
            import_hf.save_snapshot(npz, got, cfg, input_hw=(256, 256))
            dt = time.perf_counter() - t0
            exact = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k])
                                                        for k in want)
            log(f"hf: {name}: {len(sd)} HF tensors -> config {cfg.embed_dims} depths "
                f"{cfg.depths} heads {cfg.num_heads} sr {cfg.sr_ratios} head {cfg.head!r} "
                f"{cfg.num_classes} classes; transplant exact: {exact}; import + npz in "
                f"{dt:.2f} s (host)")
            if not exact:
                fail(f"hf: {name}: the transplant is not the source state")
            return cfg, npz

        def segmenters(npz, cfg):
            cfg = dataclasses.replace(cfg, use_pallas_attention=True)
            return [Segmenter2D(cfg, npz, batch_size=8, device=device, use_cuda_attention=use)
                    for use in (True, False)]

        def masks_of(s):
            return np.concatenate([s.predict_batch(frames[i:i + 8])
                                   for i in range(0, nframes, 8)])

        def masks_and_logits(s):
            masks = masks_of(s)
            x = s._model_input(frames[:8])
            return masks, s._logits_sem_conf(x, 0.017, frames.shape[1:3])[0]

        # (a) seeded random, with the HF decode head and non-trivial statistics
        cfg = dataclasses.replace(SegFormerConfig.b2(), head="hf", num_classes=HF_LABELS,
                                  dtype=torch.float32)
        gen = torch.Generator().manual_seed(0)
        state = SegFormer(cfg, gen).state_dict()
        state["bn_mean"] = torch.rand(cfg.decoder_dim, generator=gen) - 0.5
        state["bn_var"] = torch.rand(cfg.decoder_dim, generator=gen) * 1.5 + 0.5
        got_cfg, npz = imported(state, state, "random_b2_hf_head", True)
        want_cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        if got_cfg != want_cfg or convert.checkpoint_config(npz) != want_cfg:
            fail(f"hf: inferred config {got_cfg} is not {want_cfg}")
        seg_k, seg_p = segmenters(npz, got_cfg)
        attn.sr_attention.launches = 0
        mk, lk = masks_and_logits(seg_k)
        sync()
        launches += attn.sr_attention.launches
        mp, lp = masks_and_logits(seg_p)
        diff = float((lk - lp).abs().max())
        log(f"hf: random B2 + HF head through Segmenter2D {card}: masks {mk.shape} {mk.dtype}, "
            f"{len(np.unique(mk))} classes; K3 path against the plain-version forward: masks "
            f"agree on {float((mk == mp).mean()):.6f} of pixels (random weights: near-flat "
            f"logits), max logit difference {diff:.4f} (bar {LOGIT_DIFF_BAR})")
        if not np.isfinite(lk.float().cpu().numpy()).all() or not diff <= LOGIT_DIFF_BAR:
            fail(f"hf: random B2 logits not finite or {diff} from the plain-version forward")
        del seg_k, seg_p

        # (b) the shipped B2's encoder and decoder projections under HF names;
        # the template gives the native head
        ckpt = convert.shipped_checkpoint("b2")
        b2 = SegFormerConfig.b2()
        shipped = convert.from_flax_params(convert.load_params_npz(ckpt),
                                           dataclasses.replace(b2, dtype=torch.float32))
        encoder = {k: v for k, v in shipped.items()
                   if not k.startswith(("fuse.", "decoder_norm.", "classifier."))}
        got_cfg, npz = imported(encoder, shipped, "shipped_b2_encoder", False, template=shipped)
        if got_cfg != b2:
            fail(f"hf: inferred config {got_cfg} is not SegFormer-B2's")
        seg_k, seg_p = segmenters(npz, got_cfg)
        attn.sr_attention.launches = 0
        mk, _ = masks_and_logits(seg_k)
        sync()
        launches += attn.sr_attention.launches
        mp, _ = masks_and_logits(seg_p)
        agree = float((mk == mp).mean())
        ref = seg if seg is not None else Segmenter2D(
            dataclasses.replace(b2, use_pallas_attention=True), ckpt, device=device)
        same = np.array_equal(mk, masks_of(ref))
        log(f"hf: shipped B2 through the importer {card}: masks agree with the plain-version "
            f"forward on {agree:.6f} of pixels (bar {MASK_AGREE_BAR}); equal to the shipped "
            f"checkpoint's own masks: {same}; K3 launches {launches} in this phase")
        if agree < MASK_AGREE_BAR or not same:
            fail(f"hf: imported shipped B2 masks agree {agree}, equal to shipped: {same}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def _clone_state(model, optimizer, ema):
    """Host copies of what a checkpoint must restore: parameters, the moving
    average, and the optimizer's per-parameter state."""
    import torch

    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt = {i: {k: (v.detach().cpu().clone() if torch.is_tensor(v) else v) for k, v in st.items()}
           for i, st in optimizer.state_dict()["state"].items()}
    return params, opt, None if ema is None else ema.flat.detach().cpu().clone()


def train_phase(card, seg=None, device="cuda", model=None, hw=(256, 256), batch=8,
                steps=TRAIN_STEPS):
    """Phase 12: `train` at SegFormer-B2 width (bfloat16, 256x256, batch 8, the
    TrainConfig defaults) from random init on host textured batches with
    augmentation, boundary weight and EMA: the loss descends; the step-20
    checkpoint restores bit for bit and resumes to 40; 20 steps on
    `device_dataset`; the step alone profiled (launches, busy share); the NAT
    variant through K2 with its launches counted and its loss and gradients
    held to the plain version's; the EMA snapshot evaluated through
    `Segmenter2D` with K3; `sweep_conf_threshold` with the shipped B2 and K3.
    Returns (K2 launches, K3 launches) of these runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.models import SegFormerConfig, calibrate, convert
    from fusion3dseg_tpu_torch.models import train as tr
    from fusion3dseg_tpu_torch.models.segformer import SegFormer
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.parallel import sharding
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    model = model if model is not None else SegFormerConfig.b2()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    work = Path(tempfile.mkdtemp(prefix="f3s_train_"))
    k2 = k3 = 0
    try:
        cfg = tr.TrainConfig(model=model, input_hw=hw, batch_size=batch, steps=steps,
                             appearance="textured", augment=True, boundary_weight=2.0,
                             ema_decay=0.9, checkpoint_dir=str(work / "run"),
                             checkpoint_every=steps // 2, log_every=10 ** 9)
        nparams = sum(p.numel() for p in SegFormer(model, param_dtype=torch.float32,
                                                   generator=torch.Generator()).parameters())

        class Watch:
            """on_step: loss tensors, wall time between two steps, state at one."""

            def __init__(self, t_from, t_to, keep_at=None):
                self.losses, self.t, self.keep_at, self.kept = [], {}, keep_at, None
                self.t_from, self.t_to, self.first = t_from, t_to, None

            def __call__(self, it, loss, m, opt, ema):
                self.first = it if self.first is None else self.first
                self.losses.append(loss)
                if it in (self.t_from, self.t_to):
                    sync()
                    self.t[it] = time.perf_counter()
                if it == self.keep_at:
                    shutil.copytree(work / "run", work / f"run{it}", symlinks=True)
                    self.kept = _clone_state(m, opt, ema)

            def ms_per_step(self):
                return 1e3 * (self.t[self.t_to] - self.t[self.t_from]) / (self.t_to - self.t_from)

            def loss_values(self):
                return [float(x) for x in self.losses]

        # ---- 12a. host textured batches, with a commit at 20 and 40
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        w = Watch(5, steps // 2 - 1, keep_at=steps // 2)
        t0 = time.perf_counter()
        tr.train(cfg, device=dev, verbose=False, on_step=w)
        sync()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else float("nan")
        losses = w.loss_values()
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"train: SegFormer-B2 {nparams / 1e6:.2f}M float32 parameters, {model.dtype} "
            f"compute, {hw[0]}x{hw[1]}, batch {batch}, host textured batches (augment, "
            f"boundary weight 2, EMA 0.9, prefetch 2) {card}: {steps} steps in {wall:.2f} s "
            f"with init and two commits; steady {w.ms_per_step():.2f} ms a step "
            f"({1e3 / w.ms_per_step():.2f} it/s) over steps {w.t_from}-{w.t_to}; peak device "
            f"memory {peak:.1f} MiB; loss first {losses[0]:.4f} last {losses[-1]:.4f}; mean "
            f"of the first 5 {first:.4f}, of the last 5 {last:.4f} (bar: below "
            f"{TRAIN_DESCENT_BAR} x the first)")
        if not np.isfinite(losses).all() or not last < TRAIN_DESCENT_BAR * first:
            fail(f"train: the loss did not descend: {losses}")
        if tr.committed_step(work / "run") != steps:
            fail("train: the final state was not committed")

        # ---- 12b. the step-20 checkpoint: restored bit for bit, resumed to 40
        mid = steps // 2
        params, opt_state, it = tr.load_train_state(work / f"run{mid}")
        want_p, want_o, want_e = w.kept
        restored = convert.from_flax_params(params, model, torch.float32)
        ema = convert.from_flax_params(tr.load_ema(work / f"run{mid}"), model, torch.float32)
        names = list(want_p)
        ok = (it == mid and all(torch.equal(restored[k], want_p[k]) for k in names)
              and torch.equal(torch.cat([ema[k].reshape(-1) for k in names]), want_e)
              and all(torch.equal(opt_state["optimizer"]["state"][i][k].cpu(), v)
                      for i, st in want_o.items() for k, v in st.items() if torch.is_tensor(v)))
        r = Watch(mid + 1, steps)
        tr.train(dataclasses.replace(cfg, resume=True, checkpoint_dir=str(work / f"run{mid}")),
                 device=dev, verbose=False, on_step=r)
        resumed = r.loss_values()
        log(f"train: step-{mid} checkpoint: params, EMA and AdamW state restored bit for bit: "
            f"{ok}; resumed at step {r.first} and ran to {tr.committed_step(work / f'run{mid}')}"
            f", losses {resumed[0]:.4f} .. {resumed[-1]:.4f}")
        if not ok or r.first != mid + 1 or not np.isfinite(resumed).all():
            fail("train: the checkpoint did not restore and resume")

        # ---- 12c. device_dataset batches
        dsteps = TRAIN_DEVICE_STEPS if steps == TRAIN_STEPS else 4
        d = Watch(5 if dsteps > 6 else 1, dsteps)
        tr.train(dataclasses.replace(cfg, device_datagen=True, steps=dsteps, checkpoint_dir=None),
                 device=dev, verbose=False, on_step=d)
        dl = d.loss_values()
        log(f"train: device_dataset batches {card}: {dsteps} steps, steady "
            f"{d.ms_per_step():.2f} ms a step ({1e3 / d.ms_per_step():.2f} it/s) over steps "
            f"{d.t_from}-{d.t_to}; loss {dl[0]:.4f} .. {dl[-1]:.4f}")
        if not np.isfinite(dl).all():
            fail("train: device_dataset run gave a non-finite loss")

        # ---- 12d. the step alone, profiled on one device batch
        net = SegFormer(model, torch.Generator().manual_seed(1),
                        param_dtype=torch.float32).to(dev).train()
        opt, sched = tr.make_optimizer(cfg, net.parameters())
        step = sharding.make_train_step(net, opt, sched, boundary_weight=2.0,
                                        ema=sharding.FlatEMA(list(net.parameters()), 0.9))
        images, masks = next(tr.synthetic_dataset(hw, batch, seed=3, appearance="textured"))
        images, masks = torch.as_tensor(images, device=dev), torch.as_tensor(masks, device=dev)
        for _ in range(3):
            step(images, masks)
        sync()
        if on_card:
            from fusion3dseg_tpu_torch.tools.profiling import profile_run

            nprof = 5
            t0 = time.perf_counter()
            for _ in range(nprof):
                step(images, masks)
            sync()
            bare = (time.perf_counter() - t0) / nprof
            prof = profile_run(lambda: [step(images, masks) for _ in range(nprof)],
                               f"train step, SegFormer-B2, {nprof} steps on one device batch",
                               top=12)
            log(f"train: the step alone {card}: {1e3 * bare:.2f} ms ({1 / bare:.2f} it/s) "
                f"unprofiled; {prof['launches'] / nprof:.0f} launches a step; device time "
                f"{1e3 * prof['device_s'] / nprof:.2f} ms a step; busy share against the "
                f"unprofiled wall {prof['device_s'] / nprof / bare:.3f}")
        del net, opt, sched, step

        # ---- 12e. the NAT variant: K2 inside the train step
        cfg_nat = dataclasses.replace(model, nat_windows=(7, 0, 0, 0))
        nat_steps = TRAIN_NAT_STEPS if steps == TRAIN_STEPS else 2
        attn.neighborhood_attention.launches = 0
        tr.train(dataclasses.replace(cfg, model=cfg_nat, steps=nat_steps, checkpoint_dir=None,
                                     ema_decay=0.0), device=dev, verbose=False)
        sync()
        k2 = attn.neighborhood_attention.launches
        per_step = cfg_nat.depths[0]
        log(f"train: nat_windows=(7,0,0,0): {nat_steps} steps launched the neighbourhood "
            f"kernel {k2} times (want {per_step} a step: stage 0's blocks, forward; the "
            f"backward takes the plain version's autograd)")
        if on_card and k2 != per_step * nat_steps:
            fail(f"train: K2 launched {k2} times in {nat_steps} NAT steps")
        grads = []
        for use in (True, False):
            net = SegFormer(cfg_nat, torch.Generator().manual_seed(2), use_cuda_attention=use,
                            param_dtype=torch.float32).to(dev)
            loss = sharding.segmenter_loss(net, images, masks, boundary_weight=2.0)
            loss.backward()
            grads.append((float(loss.detach()), torch.cat([p.grad.reshape(-1).float()
                                                  for p in net.parameters()])))
        (lk, gk), (lp, gp) = grads
        rel = float((gk - gp).norm() / gp.norm())
        log(f"train: NAT step, K2 path against the plain versions on one batch: loss "
            f"{lk:.6f} / {lp:.6f}, gradients' relative L2 difference {rel:.3e} (bar "
            f"{TRAIN_GRAD_BAR}, bfloat16 compute)")
        if abs(lk - lp) > TRAIN_GRAD_BAR * abs(lp) or not rel <= TRAIN_GRAD_BAR:
            fail(f"train: NAT step differs from the plain version: loss {lk} / {lp}, "
                 f"gradients {rel}")
        del net, grads

        # ---- 12f. the EMA snapshot through Segmenter2D with K3
        ecfg = dataclasses.replace(convert.checkpoint_config(work / "run" / "ema"),
                                   use_pallas_attention=True)
        eseg = Segmenter2D(ecfg, work / "run" / "ema", batch_size=batch, device=dev)
        if eseg.input_hw != tuple(hw):
            fail(f"train: the EMA snapshot's input size read {eseg.input_hw}")
        attn.sr_attention.launches = 0
        ev = tr.evaluate_synthetic(eseg, nsessions=2, nframes=16)
        sync()
        k3 += attn.sr_attention.launches
        log(f"train: EMA snapshot ({steps} steps from random init) through Segmenter2D with "
            f"K3: held-out mIoU {ev['miou']:.4f}, pixel accuracy {ev['pixel_acc']:.4f}; K3 "
            f"launches {attn.sr_attention.launches}")
        if not (0.0 <= ev["miou"] <= 1.0 and 0.0 <= ev["pixel_acc"] <= 1.0):
            fail(f"train: evaluate_synthetic gave {ev}")

        # ---- 12g. the calibration sweep with the shipped B2 and K3
        if on_card:
            sseg = seg if seg is not None else shipped_b2(8)[0]
            attn.sr_attention.launches = 0
            t0 = time.perf_counter()
            rows = calibrate.sweep_conf_threshold(sseg)
            sync()
            dt = time.perf_counter() - t0
            k3 += attn.sr_attention.launches
            pick = calibrate.pick_threshold(rows)
            want = 7 * 3 * 3  # 3 sessions x 3 batches of 8 frames x 7 a forward
            log(f"train: sweep_conf_threshold (shipped B2, 3 sessions x 24 frames at 128x96) "
                f"{card}: {dt:.2f} s; K3 launches {attn.sr_attention.launches} (want {want}); "
                + "; ".join(f"t={r['conf_threshold']}: agreement {r['agreement_mean']:.4f}, "
                            f"unclassified points {r['unclassified_points_mean']:.4f}"
                            for r in rows)
                + f"; picked {pick and pick['conf_threshold']}")
            shares = [r["unclassified_pixels_mean"] for r in rows]
            if attn.sr_attention.launches != want or len(rows) != 9 \
                    or shares != sorted(shares) or not all(0 <= r["agreement_mean"] <= 1
                                                           for r in rows):
                fail("train: sweep_conf_threshold broke its contract")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return k2, k3


def _cli(args, device=None):
    """`python -m fusion3dseg_tpu_torch <args> [--device device]` as a
    subprocess of the port beside this script. Returns (wall seconds,
    stdout); a non-zero exit fails the phase."""
    cmd = [sys.executable, "-m", "fusion3dseg_tpu_torch", *map(str, args)]
    if device is not None:
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=HERE, timeout=900)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"post: {' '.join(cmd[3:])} exited {r.returncode}:\n{r.stdout[-2000:]}\n"
             f"{r.stderr[-4000:]}")
    return dt, r.stdout


def _tree_diff(a, b, skip=()):
    """Relative paths where two artifact trees differ: a file in one only,
    or a data file (TREE_SUFFIXES) whose bytes differ. Top-level entries
    named in `skip` are left out."""
    import filecmp

    def files(d):
        return {p.relative_to(d) for p in d.rglob("*") if p.is_file() and p.relative_to(d).parts[0]
                not in skip}

    fa, fb = files(a), files(b)
    diff = sorted(str(f) for f in fa ^ fb)
    diff += sorted(str(f) for f in fa & fb if f.suffix in TREE_SUFFIXES
                   and not filecmp.cmp(a / f, b / f, shallow=False))
    return diff


def _profile(fn, top=0):
    """(CUDA kernels one `fn()` launches, their summed device ms), from
    torch.profiler; logs the `top` kernels by device time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    def us(e):  # renamed from self_cuda_time_total in newer torch releases
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    device_us = sum(us(e) for e in kernels)
    for e in sorted(kernels, key=us, reverse=True)[:top]:
        log(f"post:     {us(e) / 1e3:8.3f} ms {e.count:5d}x {100 * us(e) / device_us:5.1f}% "
            f"{e.key[:80]}")
    return sum(e.count for e in kernels), device_us / 1e3


def _on_card(fn, top=0):
    """(result, ms, launches, peak MiB, busy share) of `fn()` on the card: a
    warm-up call, one timed call between synchronizes (peak memory over
    it), one profiled call for the launches and the kernel time, whose
    share of the timed call's wall is the busy share."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches, device_ms = _profile(fn, top)
    return out, ms, launches, peak, device_ms / ms


def _room_classes(points, size):
    """Per-point classes of the workload's room surfaces: floor 87,
    ceiling 118, walls 131, a door (86) on the x=0 wall, a window (115) on
    the z=0 wall."""
    import numpy as np

    x, y, z = points.T
    cls = np.full(len(points), 131, np.int32)
    cls[y == 0] = 87
    cls[y == np.float32(size[1])] = 118
    cls[(x == 0) & (z > 1) & (z < 2) & (y < 2.1)] = 86
    cls[(z == 0) & (x > 2) & (x < 3.5) & (y > 1) & (y < 2)] = 115
    return cls


def post_phase(card):
    """Phase 13: the CLI end to end, card against CPU, then the device
    graph ops at 36k and 1M points."""
    import pickle
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.io import synthetic, workload
    from fusion3dseg_tpu_torch.ops import components, neighbors
    from fusion3dseg_tpu_torch.pipeline import refinement
    from fusion3dseg_tpu_torch.pipeline.door_window import DOOR_WINDOW_CATEGORIES, fit_plane

    work = Path(tempfile.mkdtemp(prefix="f3s_post_"))
    walls = {}
    try:
        # ---- 13a. the CLI: synth, then all on the card and on the CPU
        nframes, (h, w) = 48, (256, 192)
        sess_dir = work / "session"
        walls["synth"], _ = _cli(["synth", sess_dir, "--frames", nframes, "--height", h,
                                  "--width", w, "--appearance", "textured"])
        walls["all cuda"], out = _cli(["all", sess_dir, work / "card"], "cuda")
        masks = work / "card" / "masks"
        walls["all cpu (card masks)"], _ = _cli(["all", sess_dir, work / "cpu", "--mask-dir",
                                                 masks], "cpu")

        def npoints(d):
            with open(d / "fusion" / "fusion_data.pkl", "rb") as fp:
                return pickle.load(fp)["points"]

        pts36 = npoints(work / "card")
        n, n_cpu = len(pts36), len(npoints(work / "cpu"))
        diff = _tree_diff(work / "card", work / "cpu", skip=("masks",))
        log(f"post: CLI {card}: synth 48x256x192 textured {walls['synth']:.2f} s; all (shipped "
            f"B2: seg2d -> fuse -> seg3d) on the card {walls['all cuda']:.2f} s, on the CPU "
            f"with the card's masks {walls['all cpu (card masks)']:.2f} s; n {n} (CPU {n_cpu}); "
            f"files that differ: {diff[:8]} ({len(diff)})")
        if n != n_cpu or diff:
            fail(f"post: all on the card and on the CPU differ: n {n} vs {n_cpu}, {diff[:20]}")

        # ---- post-processing on copies of the card's tree, card and CPU
        pan = work / "card" / "panoptic_segmentation"
        ids = np.load(pan / "ids.npy")
        doors = [i for i in json.loads((pan / "info.json").read_text())
                 if i["category_id"] in DOOR_WINDOW_CATEGORIES]
        if not doors:
            fail("post: the card's tree has no door/window instance")
        door = max(doors, key=lambda i: i["area"])["id"]
        c, nrm = fit_plane(pts36[ids == door].astype(np.float64))
        seed = int(np.nonzero(ids == door)[0][0])
        quads, grew = {}, {}
        for dev in ("cuda", "cpu"):
            d = work / f"post_{dev}"
            shutil.copytree(work / "card", d)
            walls[f"doorwindow {dev}"], o = _cli(["doorwindow", d])
            quads[dev] = int(re.search(r"(\d+) door/window quads", o).group(1))
            walls[f"refine depth {dev}"], o1 = _cli(
                ["refine", d, seed, "--mode", "depth", "--from-point", "--wall-point", *c,
                 "--wall-normal", *nrm], dev)
            walls[f"refine color {dev}"], o2 = _cli(
                ["refine", d, seed, "--mode", "color", "--from-point"], dev)
            grew[dev] = [int(re.search(r"grew (\d+) points", o).group(1)) for o in (o1, o2)]
            walls[f"remove-classes {dev}"], _ = _cli(["remove-classes", d, masks], dev)
        diff = _tree_diff(work / "post_cuda", work / "post_cpu")

        # ---- tum: a write_tum_dir export of the degraded session
        sess = synthetic.make_session(nframes=nframes, depth_hw=(h, w), appearance="textured")
        synthetic.write_tum_dir(synthetic.degrade_session(sess, seed=0), work / "tum")
        probe = {}
        for dev in ("cuda", "cpu"):
            walls[f"tum convert {dev}"], _ = _cli(["tum", work / "tum", work / f"tum_{dev}",
                                                   "--intrinsics", "fr1"], dev)
            walls[f"tum probe {dev}"], probe[dev] = _cli(["tum", work / "tum", "--intrinsics",
                                                          "fr1"], dev)
        tum_diff = _tree_diff(work / "tum_cuda", work / "tum_cpu")
        log(f"post: CLI walls (s, each a subprocess with its start-up): "
            + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
        log(f"post: on the card's tree, card against CPU: doorwindow quads {quads}, refine "
            f"grew (depth, colour) {grew}, files that differ {diff[:8]} ({len(diff)}); tum: "
            f"{probe['cuda'].strip().splitlines()[-1]!r}, exports differ in {tum_diff[:8]}")
        if quads["cuda"] < 1 or quads["cuda"] != quads["cpu"] or grew["cuda"] != grew["cpu"] \
                or diff or tum_diff or probe["cuda"] != probe["cpu"]:
            fail(f"post: post-processing card against CPU: quads {quads}, grew {grew}, "
                 f"{diff[:20]}, tum {tum_diff[:20]}")

        # ---- 13b. the device radius graph on the 36k fused cloud
        p36 = torch.from_numpy(pts36).cuda()
        for r in (0.05, 0.10):
            adj, ms, launches, peak, busy = _on_card(
                lambda: neighbors.radius_graph(p36, r, k=POST_K, cap_per_cell=POST_CAP))
            want = neighbors.radius_graph(pts36, r, k=POST_K, cap_per_cell=POST_CAP,
                                          device="cpu")
            same = torch.equal(adj.cpu(), want)
            log(f"post: radius_graph {card} on the fused cloud (n {n}) at r {r}: {ms:.3f} ms, "
                f"{launches} launches, busy share {busy:.3f}, peak {peak:.1f} MiB; mean degree "
                f"{float((want >= 0).sum()) / n:.2f}; every row equal to the CPU port: {same}")
            if not same:
                fail(f"post: radius_graph at r {r} on the card differs from the CPU")

        # ---- the 1M-point room cloud
        wl = workload.make_workload(POST_NPTS, 2, (48, 36), seed=0)[0]
        room = synthetic.RoomSpec(num_objects=8, seed=0).size
        classes = _room_classes(wl, room)
        p1m = torch.from_numpy(wl).cuda()
        adj, ms, launches, peak, busy = _on_card(
            lambda: neighbors.radius_graph(p1m, 0.05, k=POST_K, cap_per_cell=POST_CAP), top=5)
        ncap = neighbors.lookup_cap(wl, 0.05)
        grid = neighbors.build_grid(torch.from_numpy(wl), 0.05, ncap=ncap)
        starts = np.linspace(0, POST_NPTS - POST_ROWS, 4).astype(np.int64)
        same = all(torch.equal(neighbors.query_rows(grid, torch.arange(s, s + POST_ROWS),
                                                    POST_K, POST_CAP),
                               adj[s:s + POST_ROWS].cpu()) for s in starts)
        chunks = -(-POST_NPTS // neighbors.CUDA_CHUNK)
        log(f"post: radius_graph {card} at 1M points, r 0.05 (dense table of {ncap} cells): "
            f"{ms:.3f} ms, {launches} launches ({launches / chunks:.1f} a chunk of "
            f"{neighbors.CUDA_CHUNK} rows), busy share {busy:.3f}, peak {peak:.1f} MiB; mean "
            f"degree "
            f"{float((adj >= 0).sum()) / POST_NPTS:.2f}; rows {starts.tolist()} + {POST_ROWS} "
            f"equal to the CPU chunk function: {same}")
        if not same:
            fail("post: the 1M graph on the card differs from the CPU chunk function")

        adj_np = adj.cpu().numpy()
        t0 = time.perf_counter()
        dev_split = components.split_into_instances(classes, adj, 133, backend="device")
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat_split = components.split_into_instances(classes, adj_np, 133, backend="native")
        t_nat = time.perf_counter() - t0
        same = all(np.array_equal(a, b) for a, b in zip(
            (dev_split[0], dev_split[1], dev_split[3]),
            (nat_split[0], nat_split[1], nat_split[3]))) and dev_split[2] == nat_split[2]
        sym, ms_sym, _, _, _ = _on_card(lambda: components.symmetrize_adjacency(adj))
        cls_d = torch.from_numpy(classes).cuda()
        (labels, sweeps), ms_p, launches_p, peak_p, busy_p = _on_card(
            lambda: components.propagate_labels(sym, cls_d, return_sweeps=True), top=3)
        log(f"post: instance split at 1M {card}: backend device {t_dev:.3f} s (symmetrize on "
            f"the card {ms_sym:.3f} ms, degree {sym.shape[1]}), native {t_nat:.3f} s, "
            f"{len(nat_split[2])} "
            f"instances; ids, info and classes equal: {same}; propagate_labels alone "
            f"{ms_p:.3f} ms, {sweeps} sweeps, {launches_p} launches, busy share {busy_p:.3f}, "
            f"peak {peak_p:.1f} MiB")
        if not same:
            fail("post: the device split differs from the native split at 1M")

        floor = np.nonzero(classes == 87)[0]
        centre = floor[np.argsort(np.linalg.norm(wl[floor] - [room[0] / 2, 0, room[2] / 2],
                                                 axis=1))[:16]]
        ff_seeds = np.zeros(POST_NPTS, bool)
        ff_seeds[centre] = True
        ff, ms_f, launches_f, peak_f, busy_f = _on_card(
            lambda: components.floodfill_level(adj, ff_seeds, 50, classes))
        ff_cpu = components.floodfill_level(adj_np, ff_seeds, 50, classes, device="cpu")
        seeds = classes == 86
        dist = np.abs(wl[:, 0]).astype(np.float32)  # distance to the x=0 wall
        (gf, rounds), ms_g, launches_g, peak_g, busy_g = _on_card(
            lambda: refinement.gated_floodfill(adj, seeds, dist, 0.02, return_rounds=True))
        gf_cpu = refinement.gated_floodfill(adj_np, seeds, dist, 0.02, device="cpu")
        ok = np.array_equal(ff, ff_cpu) and torch.equal(gf.cpu(), gf_cpu)
        log(f"post: fills at 1M {card}: floodfill_level from 16 floor points (50 rounds, "
            f"classes) {ms_f:.3f} ms, {launches_f} launches, busy share {busy_f:.3f}, peak "
            f"{peak_f:.1f} MiB, "
            f"{int(ff.sum())} members; gated_floodfill from the {int(seeds.sum())} door points "
            f"(distance to their wall within 0.02) {ms_g:.3f} ms, {rounds} rounds, "
            f"{launches_g} launches, busy share {busy_g:.3f}, peak {peak_g:.1f} MiB, "
            f"{int(gf.sum())} members; both "
            f"equal to the CPU: {ok}")
        if not ok:
            fail("post: a fill on the card differs from the CPU at 1M")
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    vga = None
    if "fusion" in phases:
        n, vga = fusion_phase(card, session, seg)
        for entry in kernels:
            if entry["name"] == "sr_attention":
                entry["launches"] += n
    if "files" in phases:
        n = files_phase(card, seg, vga)
        for entry in kernels:
            if entry["name"] == "sr_attention":
                entry["launches"] += n
    if "hf" in phases:
        n = hf_phase(card, seg)
        for entry in kernels:
            if entry["name"] == "sr_attention":
                entry["launches"] += n
    if "train" in phases:
        n2, n3 = train_phase(card, seg)
        for entry in kernels:
            entry["launches"] += {"neighborhood_attention": n2, "sr_attention": n3}.get(
                entry["name"], 0)
    if "post" in phases:
        post_phase(card)  # launches no kernel of the kernels line (no K3 in the CLI's B2)
    log(f"phases {phases} took {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}
    if phases != ALL_PHASES:
        result["phases"] = phases  # a partial run says so
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
