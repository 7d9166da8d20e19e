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
            with 254 classes; timed in a CUDA graph beside its bound and
            its plain version (`tools/bench.k1_row`, as the bench times it).
4. headline the session label lifter `label_fuse_session` on the 1M-point,
            300-frame, 256x192, 133-class workload: timed, its kernel
            launches counted, held exactly to the same run classified by
            the plain version, and to the NumPy oracle over all frames.
5. sharded  the same session with id_bits=18 (the gid-range-sharded
            z-buffer, 4 sub-ranges): exactly equal to phase 4.
6. attention  the two attention kernels (spatial-reduction and
            neighbourhood) against their plain versions at the segmenter's
            shapes, a ragged float32 case each and the neighbourhood
            kernel's backward; the spatial-reduction kernel (K3) at every
            SegFormer-B2 call of 256x256, 512x512 and 1024x1024 inputs
            (batch 8; 64, 256 and 1024 keys) and at its edges (1 to 4096
            keys, D = 32 to 512 in both dtypes, float32 with 1024 keys, a
            layout TMA cannot describe at 1024 keys and at D = 160, B x H =
            65,537 on each kernel), its bfloat16 cases through wgmma and,
            where its shared memory holds the keys, mma.sync; timed (in CUDA
            graphs, between CUDA events) beside the plain version, a bound
            (bytes and products; the exponentials' floor printed beside it)
            and `scaled_dot_product_attention` (timed here, used nowhere
            else). Every counted K3 launch of phases 7-12 must take the
            wgmma kernel; their counts by kernel print before the kernels
            line. The wgmma launcher's instance for every D to 512 against
            `_sr_shape`, and each instance's registers and spilled bytes
            (none allowed in the wide instances). Timed past D = 128 (each
            line says "faster" or "slower" than the call): [8,4096,1,256]x64
            keys, [8,1024,2,160]x256 and [8,1024,2,192]x256 (DP = 192),
            [8,1024,1,320]x256 and [8,4096,1,320]x64 (DP = 320), and
            [8,1024,1,320]x256 in float32. K3 in float32 (the tile kernel,
            one pass, every D): its launcher's instance for every D to 700
            against `_sr_f32_shape`, each instance's registers (no spill),
            timed at B2's two 256x256 calls and [8,1024,1,128]x256 beside
            SDPA, N and M off every tile, 1 and 5000 keys, D = 129 to 512, B
            x H = 65,537 at D = 160. The neighbourhood kernel (K2): its
            launcher's chunk plan against `_nat_plan` (every odd window to
            255, widths to 256, D to 512), the registers and spilled bytes of
            its kernels (none in the bfloat16 wide kernel), windows 1 to 63
            in both dtypes at D = 7 to 512 (windows 15-63 streaming the halo,
            column pieces, a halo clamped inside the window; D > 128 in
            chunks), B x H = 65,537, timed at window 7 ([8, 64*64] and
            [2, 128*128], and [8, 16*16] at D = 320 in both dtypes and at
            D = 256; [8, 64*64] in float32) and 23 beside its bound and the
            masked `scaled_dot_product_attention`; the float32 wide kernel
            (no spill) at ragged grids, windows 9 to 63, D = 129 to 512, B x
            H = 65,537 at D = 129. float16 (the float16 instances of every
            tensor-core kernel, no spill in any): K3 on each route (wgmma on
            the tensors, mma.sync, wgmma on copies, D = 160, 320, 384 and
            512) and K2 on each kernel (window 7 staged once, 23 streamed,
            column pieces, the wide kernel at D = 320 and 384), B x H = 65,537
            on each, held to the plain version and to the exact float64
            attention within F16_BAR or two float16 steps; timed at B2's two
            256x256 K3 calls, [8,1024,1,320]x256, K2 at [8, 64*64] and
            [8, 16*16] D = 320, window 7, beside float16 SDPA and the bound;
            the launchers' float16 instances and plans against `_sr_shape` and
            `_nat_plan`.
7. segmenter  `Segmenter2D` at SegFormer-B2 width, bfloat16, 256x256, batch 8,
            on a textured synthetic session: the shipped checkpoint through
            the fused spatial-reduction kernel (launches counted, pixel
            accuracy against ground truth, masks against the same forward
            through the plain versions, frames/s); the same weights at
            512x512 and 1024x1024 (13 and 16 K3 launches a forward, masks and
            logits against the plain versions, frames/s, peak memory); then
            B2 width with a neighbourhood-attention first stage (the shipped
            weights less that stage's reduction conv) at windows 7 and 23
            (K2 launches counted, masks against the plain versions); B2 with
            num_heads=(1, 1, 1, 2) (head dims 64, 128, 320, 256; the shipped
            weights) at 256x256, 512x512 and 1024x1024 (K3 at D = 320 and
            256; frames/s at 512x512), and at 256x256 with stage 2 a
            window-7 neighbourhood stage
            (K2 at D = 320, 16 x 16 tokens), masks >= 0.995 equal to the
            plain-version forward, launches counted; the same two in float32
            (512x512: K3's tile kernel at D = 320, 13 launches a forward, all
            on the "f32" route; the neighbourhood stage at 256x256: K2's
            float32 wide kernel); in float16, the shipped B2 as a snapshot
            whose metadata says "float16" (Segmenter2D reads the config from
            it; K3, 7 launches a forward, frames/s) and the re-headed B2 with a
            window-7 neighbourhood stage 2 (K2's wide kernel), masks >= 0.999
            equal to the plain-version float16 forward; and `predict`'s
            contract.
8. stream   `stream_segment` on that session: votes' contract, run twice
            bit-identical, classes against predict_batch + vote_and_classify.
8a. soak    `tools/soak.py`, the long-session soak: 2048 frames at 128x96,
            four turns, `fuse_session_checkpointed` at capacity 2^20 with the
            auto window, interrupted after half its chunks and resumed, then
            run uninterrupted: the resumed state and uv2pt equal the
            uninterrupted run's and a plain `fuse_session`'s bit for bit,
            int32 counters, n <= capacity.
8b. loop    `tools/model_in_the_loop.py`: the shipped B2 through
            `stream_segment` over the unseen 24-frame textured session
            (bench.py's config 4): 3D agreement against the ground-truth-mask
            pipeline >= 0.98, classes >= 0.999 equal to the same run with
            use_pallas_attention=False, K3 launches counted.
9. fusion   the main path `segment_session_fast`. Masks branch on the
            48-frame 256x192 session (capacity 2^17, auto window, split
            policy): timed by stage, two runs bit-identical, held to the
            port on the CPU (n within 1%, pixel classes >= 0.999, the same
            instance categories); the match kernel's launches in a
            profiled run equal to the run's `fuse_match.kernel_frames` and
            to the frames stepped. Loop closure (two turns): the window
            overflows and the repair lands within 1.02x of the full merge.
            Scale: fusion alone at capacity 2^20, and 12 VGA frames.
            Segmenter branch with phase 7's shipped B2 on its 16 frames:
            the spatial-reduction kernel's launches counted, classes held
            to the masks branch fed predict_batch's masks. The match kernel
            (9e) on the last frame's inputs of an eager VGA engine run at
            the scan cells' settings: `match` and `matched` equal to the
            plain version's on the same card tensors and on the CPU, timed
            in a CUDA graph beside its byte bound and the plain version.
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
14. parallel  the multi-device decompositions (`parallel/`), each rank a
            process of `parallel/launch.spawn`: one rank over NCCL on cuda:0,
            then two ranks (on two cards over NCCL where there are two, else
            sharing cuda:0 over gloo; gloo's CUDA collectives probed first),
            then two CPU ranks over gloo. On the card: voting at 1M points x
            300 frames (frame- and point-sharded, exact); the three sharded
            label lifters on `make_workload(1M, 300)` against the one-device
            `tpu_label_fuse` (frames exact; points exactly their own tie rule,
            computed on one device without collectives; cells >= 0.9995
            against the one-rank cell-sharded run; the agreement of both with
            the one-device lifter printed: their ties of equal quantised
            depth go by rank-local id or gather slot, as in the JAX package;
            K1 launched on every rank, on aligned rows); both fusion engines on
            phase 9's 48-frame session (one rank spatially sharded bit for bit
            the one-device engine; two ranks against it with the JAX package's
            bars: n, p99 nearest distance, label agreement; the two-rank card
            run equal to the two-rank CPU run); `train` at B2 width (bfloat16,
            256x256, global batch 8) for 10 steps at dp 2 and at the default
            mesh (dp 1 x tp 2): step 1's loss within 1e-2 of the one-device
            loss, the loss descends. Every call timed beside its one-device
            call, with its collectives and the bytes gloo moved through the
            host.
15. bench   the port's bench (`tools/bench.py`, `bench.py`'s counterpart) in
            this process at cut sizes: the headline at 200k points x 60
            frames, config 5 at 2.5M x 20 (the gid-range-sharded z-buffer,
            nsub 3), the fusion blocks with the reference resolution
            (960x720) on 2 frames, config 4 with the shipped B2; every bar of
            the full run (label agreement >= 0.9995 at both sizes, classes
            equal to the plain-version run, n equal in two runs, the model in
            the loop >= 0.98, K1 on both winner matrices equal to its plain
            version), K1's launches in its timed runs counted and K1 timed on
            both winner matrices; the classes at both sizes and the 960x720
            state and uv2pt equal to the port's on the CPU bit for bit.

Then one JSON line for the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
`--phases attention,segmenter,stream` runs a subset while iterating (device
and build always run; `stream` needs `segmenter`; `fusion`, `files`, `hf`
and `train` alone load the B2 segmenter themselves, `post` and `parallel`
build their own inputs; the last line then names the phases that ran).
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
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bfloat16 (and float16) on the tensor cores
EXP_PER_S = 16 * 132 * 1.98e9  # H100 SXM exponentials: 16 a clock on each SM, boost clock
AGREEMENT_BAR = 0.9995
BF16_BAR, F32_BAR = 2e-2, 1e-4  # attention kernels vs plain versions, unit-normal inputs
# float16: BF16_BAR is about 1.3 bfloat16 steps at outputs below 4 (2^-6
# each); float16 has three more bits, so 1.3 of its steps there (2^-9 each),
# or two steps of the output's magnitude where that is more (`f16_apart`)
F16_BAR = 2.5e-3
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
KERNEL_SOURCES = ["histogram", "sr_attention", "neighborhood_attention", "match_pixels"]
ALL_PHASES = ["label", "attention", "segmenter", "stream", "soak", "loop", "fusion", "files",
              "hf", "train", "post", "parallel", "bench"]
K1_ENTRY = {"name": "histogram_classify", "route": "cuda",
            "source": "fusion3dseg_tpu_torch/csrc/histogram.cu",
            "replaces": "fusion3dseg_tpu/ops/histogram.py:33"}
MATCH_ENTRY = {"name": "match_pixels", "route": "cuda",
               "source": "fusion3dseg_tpu_torch/csrc/match_pixels.cu",
               "replaces": "fusion3dseg_tpu/fusion/fusion.py:233 (XLA array code, no TPU kernel)",
               "kernels": ["match_pixels_kernel"]}
# phase 9e: the scan cells' engine on a VGA room lap, 3.6 degrees a frame
MATCH_ENGINE = dict(radius=0.05, angle=10.0, max_depth=8.0, capacity=1 << 20, window=1 << 15,
                    window_policy="split", candidate_px=1)
MATCH_FRAMES = 8
# phase 15: the bench's sizes cut to about 90 s (nsub 3 at 2.5M ids)
BENCH_ARGV = ["--npts", "200000", "--frames", "60", "--tenm-npts", "2500000",
              "--tenm-frames", "20"]
BENCH_REF_FRAMES = 2
SOAK_FRAMES = 2048  # examples/soak_long_session.py's session
LOOP_AGREE_BAR, LOOP_SAME_BAR = 0.98, 0.999  # loop: vs the gt masks, vs use_pallas_attention=False
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
# phase 14: fusion capacity in all (2^16 a rank on two ranks, 2^17 a chunk
# frame-sharded), each rank's split window, the train cell, the bars (the
# JAX package's own: tests/test_model_parallel.py, tests/test_label_fuse.py)
PAR_CAPACITY, PAR_WINDOW = 1 << 17, 1 << 14
PAR_SESSION = (48, (256, 192))  # phase 9's session: frames, depth size
PAR_TRAIN_HW, PAR_BATCH, PAR_TRAIN_STEPS = (256, 256), 8, 10
PAR_TIMEOUT = 300.0  # seconds a world may take, start-up included
PAR_LOSS_BAR, PAR_AGREE_BAR = 1e-2, 0.9
PAR_N_SPATIAL, PAR_N_FRAMES = (0.95, 1.05), (0.6, 1.7)
PAR_COVER_BAR = 2 * 3 ** 0.5 * FUSION_KW["radius"]
TREE_SUFFIXES = {".npy", ".json", ".pkl", ".ply", ".txt", ".csv", ".yaml"}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


K3_ROUTES = {"wgmma": 0, "mma": 0, "f32": 0}  # K3's main-path launches by kernel
MATCH_COUNTER = "fuse_match.kernel_frames"  # the engine's frames matched by the kernel


def k3_counted(where, route="wgmma"):
    """K3's launches since `reset_sr_counts()`, which must all have taken
    `route` (bfloat16: the wgmma kernel; float32: the tile kernel, the "f32"
    route's only kernel); added to K3_ROUTES."""
    from fusion3dseg_tpu_torch.ops import attention as attn

    routes = attn.sr_attention.routes
    if routes[route] != attn.sr_attention.launches:
        fail(f"{where}: K3 launched {attn.sr_attention.launches} times, by kernel {routes}: "
             f"not all on {route}")
    for route, n in routes.items():
        K3_ROUTES[route] += n
    return attn.sr_attention.launches


def f16_apart(got, want):
    """The largest |got - want| in units of the float16 bar: F16_BAR or two
    float16 steps of the two's magnitude, whichever is larger (<= 1 holds)."""
    import torch

    got, want = got.double(), want.double()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -14)
    bar = (2 * torch.exp2(torch.floor(torch.log2(big)) - 10)).clamp_min(F16_BAR)
    return float(((got - want).abs() / bar).max())


def label_phases(card):
    """Phases 3-5: K1 and the session label lifter. Returns K1's entry."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.io.workload import cpu_label_fuse, make_workload
    from fusion3dseg_tpu_torch.ops import histogram as hist
    from fusion3dseg_tpu_torch.ops import label_fuse as lf
    from fusion3dseg_tpu_torch.tools.bench import k1_err, k1_row
    from fusion3dseg_tpu_torch.tools.profiling import event_ms

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
        # k1_row holds K1 to its plain version and times both
        row = k1_row(C, nc, thr) if time_it else {"max_abs_err": k1_err(C, nc, thr)}
        if row["max_abs_err"] != 0:
            fail(f"K1 disagrees with its plain version at {tuple(C.shape)}, stride "
                 f"{C.stride(0)}, nclasses={nc}: max abs err {row['max_abs_err']}")
        max_err = max(max_err, row["max_abs_err"])
        log(f"kernels: histogram_classify {tuple(C.shape)} stride {C.stride(0)} ({name}; "
            f"{'tiled' if tiled else 'byte'} kernel) nclasses={nc} threshold={thr}: "
            "exact vs plain version")
        if time_it:
            row = dict(row, shape=f"{row['shape']} {name}", library_ms=None)
            extra = ""
            if not rows:  # there also the time between CUDA events around
                # single calls, as earlier runs read it
                e_ms = event_ms(lambda: hist.histogram_classify(C, NCLASSES, 0.5), iters=50,
                                warmup=2)
                extra = f"; between events around single calls {e_ms:.4f} ms"
            log(f"kernels: histogram_classify {row['shape']} {card}: kernel {row['ms']:.4f} ms "
                f"(in a CUDA graph), bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
                f"{row['bytes'] / 1e6:.1f} MB at 3.35 TB/s), "
                f"{100 * row['share_of_bound']:.1f}% of bound, "
                f"{row['bytes'] / (row['ms'] * 1e-3) / 1e12:.3f} TB/s; plain version "
                f"{row['plain_ms']:.3f} ms{extra}")
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
        **K1_ENTRY,
        "launches": launches,
        "max_abs_err": max_err,
        **rows[0],
        "other_shapes": rows[1:],
    }


def _window_pairs(n, r):
    """Number of (query, key) index pairs along one axis of length n with
    |query - key| <= r, both inside [0, n)."""
    return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))


def attention_phase(card):
    """Phase 6: K3 and K2 against their plain versions. Returns their
    entries for the kernels line (`launches` still 0: phase 7 counts them)."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from fusion3dseg_tpu_torch import cuda
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.tools.profiling import F32_OPS_PER_S, bound_ms, graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}

    def qkv(shape_q, shape_kv, dtype):
        return [torch.randn(s, device=dev, generator=gen).to(dtypes[dtype])
                for s in (shape_q, shape_kv, shape_kv)]

    def held(name, got, want, dtype, what):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == "f16":
            ok, bar = f16_apart(got, want) <= 1.0, f"{F16_BAR} or two float16 steps"
        else:
            bar = BF16_BAR if dtype == "bf16" else F32_BAR
            ok = err <= bar
        if got.shape != want.shape or got.dtype != want.dtype or not ok:
            fail(f"{name} {what}: max abs err {err} against its plain version (bar {bar})")
        return err

    def exact_of(q, k, v, window=None, hw=None):
        """The exact attention of the inputs in float64 (q * scale rounded as
        the kernels round it, p unrounded); with `window`, masked to it."""
        scores = torch.einsum("bnhd,bmhd->bhnm", attn._scaled(q).double(), k.double())
        if window is not None:
            r = window // 2
            iy, ix = torch.arange(hw[0], device=dev), torch.arange(hw[1], device=dev)
            near = ((iy[:, None] - iy[None, :]).abs() <= r)[:, None, :, None] & \
                ((ix[:, None] - ix[None, :]).abs() <= r)[None, :, None, :]
            scores = scores.masked_fill(~near.reshape(hw[0] * hw[1], -1), float("-inf"))
        return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, -1), v.double())

    def held_exact(name, got, plain, exact, what):
        """A float16 kernel and its plain version against the exact attention
        (each within F16_BAR or two float16 steps); returns their errors."""
        torch.cuda.synchronize()
        err, plain_err = (float((t.double() - exact).abs().max()) for t in (got, plain))
        if not (f16_apart(got, exact) <= 1.0 and f16_apart(plain, exact) <= 1.0):
            fail(f"{name} {what} float16: {err} (plain version {plain_err}) from the exact "
                 f"attention, past {F16_BAR} or two float16 steps")
        return err, plain_err

    def timed(entry, name, shape, dtype, kernel, plain, library, nbytes, ops, others=None):
        # these kernels are shorter than a launch from Python: time them in
        # CUDA graphs (with events around single calls the host's launch
        # rate, about 0.05 ms a call, is what shows). `others`: further
        # kernels for the same function, {label: fn}, timed beside it
        k_ms = graph_ms(kernel, iters=50)
        o_ms = {label: graph_ms(fn, iters=50) for label, fn in (others or {}).items()}
        p_ms = graph_ms(plain, iters=5)
        l_ms = graph_ms(library, iters=50)
        b_ms, by = bound_ms(nbytes, ops, F32_OPS_PER_S if dtype == "f32" else BF16_OPS_PER_S)
        log(f"attention: {name} {shape} {dtype} {card}: kernel {k_ms:.4f} ms, "
            + "".join(f"{label} {ms:.4f} ms, " for label, ms in o_ms.items())
            + f"bound {b_ms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} Gop), "
            f"{100 * b_ms / k_ms:.1f}% of bound; plain version {p_ms:.4f} ms; "
            f"scaled_dot_product_attention {l_ms:.4f} ms: the kernel "
            + (f"{l_ms / k_ms:.2f}x faster" if k_ms < l_ms else f"{k_ms / l_ms:.2f}x slower"))
        row = {"shape": shape, "dtype": dtype, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
               "bound_by": by, "library_ms": l_ms,
               **{f"{label.split()[0]}_ms": ms for label, ms in o_ms.items()}}
        if "ms" not in entry:  # the first timed shape is the entry's own
            entry.update(row)
        else:
            entry.setdefault("other_shapes", []).append(row)

    def resources(fn, lib, names, new):
        """Each instance's registers and spilled bytes (cudaFuncGetAttributes);
        fails where one of the `new` (wide) kernels spills, or where a float16
        instance ("<name>_f16") spills more than its bfloat16 twin."""
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        local = {}
        for name in names:
            out = (ctypes.c_int * 4)()
            err = fn(name.encode(), out)
            if err != 0:
                fail(f"{lib}: no attributes for {name} (error {err})")
            log(f"attention: {lib} {name}: {out[0]} registers a thread, {out[1]} bytes local "
                f"(spilled) a thread, {out[2]} bytes static shared, up to {out[3]} threads")
            local[name] = out[1]
            if name in new and out[1] != 0:
                fail(f"{lib} {name}: {out[1]} bytes of local memory a thread (a spill)")
        for name, n in local.items():
            twin = name.removesuffix("_f16")
            if name != twin and n > local.get(twin, 0):
                fail(f"{lib} {name}: {n} bytes of local memory a thread, its bfloat16 twin "
                     f"{local.get(twin, 0)}")

    # ---- K3, spatial-reduction attention: each bfloat16 case through
    # `sr_attention` (the wgmma kernel on every layout here) and, where its
    # shared memory holds the keys, through the mma.sync kernel named
    # explicitly, both against the plain version. Timed: SegFormer-B2's
    # calls at batch 8 (256x256: M = 64; 512x512: 256; 1024x1024: 1024) and
    # stage 0 at 512x512 at batch 2
    sra = {"name": "sr_attention", "route": "cuda",
           "source": "fusion3dseg_tpu_torch/csrc/sr_attention.cu",
           "replaces": "fusion3dseg_tpu/ops/attention.py:30", "launches": 0,
           "max_abs_err": 0.0,
           "kernels": ["sr_attention_wgmma_kernel", "sr_attention_wide_kernel",
                       "sr_attention_mma_kernel", "sr_attention_f32_tile_kernel"]}
    # the wgmma launcher's instance choice against its mirror in
    # ops/attention.py, and the resources of each instance (no spills)
    shape_fn = cuda.load("sr_attention").f3s_sr_shape
    shape_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int64)]
    got_shape = (ctypes.c_int64 * 5)()
    for code in (1, 2):  # bfloat16, float16: the same instances
        for D in range(1, 513):
            for M in (1, 64, 65, 1024):
                if shape_fn(code, D, M, got_shape) != 0 or \
                        tuple(got_shape) != tuple(attn._sr_shape(D, M)):
                    fail(f"sr_attention: the launcher takes {tuple(got_shape)} at D {D}, M "
                         f"{M}, dtype {code}; _sr_shape {attn._sr_shape(D, M)}")
    log("attention: sr_attention: the launcher's instance equals _sr_shape for D 1-512 "
        "(DP 64, 128, 192, 256, 320; column blocks past 320), bfloat16 and float16")
    # the float32 tile kernel's instance (DP, keys a unit, units, shared
    # bytes) against `_sr_f32_shape`
    f32_shape = cuda.load("sr_attention").f3s_sr_f32_shape
    f32_shape.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    got_f32 = (ctypes.c_int64 * 4)()
    for D in range(1, 701):
        if f32_shape(D, got_f32) != 0 or tuple(got_f32) != tuple(attn._sr_f32_shape(D)):
            fail(f"sr_attention: the float32 launcher takes {tuple(got_f32)} at D {D}; "
                 f"_sr_f32_shape {attn._sr_f32_shape(D)}")
    log("attention: sr_attention: the float32 launcher's instance equals _sr_f32_shape for "
        "D 1-700 (DP 64 to 320; column chunks and blocks past 320)")
    f32_tiles = tuple(f"f32_tile_{dp}" for dp in (64, 128, 192, 256, 320))
    sr_two_byte = ("wgmma_64_64", "wgmma_64_128", "wgmma_128_64", "wgmma_192_64",
                   "wgmma_256_64", "wgmma_320_32", "wide", "mma_16", "mma_32", "mma_64",
                   "mma_128")
    sr_f16 = tuple(f"{name}_f16" for name in sr_two_byte)
    resources(cuda.load("sr_attention").f3s_sr_resources, "sr_attention",
              (*sr_two_byte, *f32_tiles, *sr_f16),
              new=("wgmma_192_64", "wgmma_320_32", *f32_tiles, *sr_f16))  # none spills
    b2_calls = [(8, N, H, 64, M, "bf16", True) for N, H, M in (
        (4096, 1, 64), (1024, 2, 64), (16384, 1, 256), (4096, 2, 256), (1024, 5, 256),
        (65536, 1, 1024), (16384, 2, 1024), (4096, 5, 1024), (1024, 8, 1024))]
    for B, N, H, D, M, dtype, time_it in (
            *b2_calls, (2, 16384, 1, 64, 256, "bf16", True), (1, 1000, 3, 32, 37, "f32", False),
            # the wgmma kernel's edges: one key; keys masked in the last key tile;
            # ragged rows; runs that cross (batch, head); q rounded in shared
            # memory (D = 32); two column blocks (D = 128); one key past a tile
            # of 64 and of 128, past what mma.sync holds (849), the key tiles
            # streamed (2048, 4096); float32 with 1024 keys
            (2, 700, 2, 64, 1, "bf16", False), (1, 1000, 3, 64, 37, "bf16", False),
            (3, 1000, 5, 32, 100, "bf16", False), (2, 640, 1, 64, 200, "bf16", False),
            (1, 2048, 2, 128, 256, "bf16", False), (2, 700, 2, 64, 257, "bf16", False),
            (1, 1000, 3, 64, 849, "bf16", False), (1, 777, 2, 64, 2048, "bf16", False),
            (1, 512, 1, 64, 4096, "bf16", False), (2, 1000, 1, 128, 1024, "bf16", False),
            (1, 1000, 2, 64, 1024, "f32", False),
            # head dims past 128 (timed: a head of 256 against B2's stage-0
            # keys, of 160 and 192 against 256 keys (DP = 192), and B2 with
            # num_heads=(1,1,1,2) at stage 2 of 512x512 and 256x256, D = 320
            # (DP = 320, key tiles of 32), in bfloat16; D = 320 in float32); in
            # both dtypes a D that is not a multiple of 8 (129: copied for
            # wgmma, DP = 192), ragged N and M, DP = 256, 320, and D > 320 (D
            # in chunks, column blocks)
            (8, 4096, 1, 256, 64, "bf16", True), (8, 1024, 2, 160, 256, "bf16", True),
            (8, 1024, 2, 192, 256, "bf16", True), (8, 1024, 1, 320, 256, "bf16", True),
            (8, 4096, 1, 320, 64, "bf16", True), (8, 1024, 1, 320, 256, "f32", True),
            (1, 999, 3, 288, 1000, "bf16", False), (3, 300, 2, 176, 129, "bf16", False),
            *((B, N, H, D, M, dtype, False) for dtype in ("f32", "bf16") for B, N, H, D, M in (
                (1, 1000, 2, 129, 37), (1, 777, 2, 160, 64), (2, 500, 1, 200, 257),
                (1, 1000, 1, 256, 300), (2, 700, 1, 320, 256), (1, 600, 1, 512, 100))),
            # float32 at B2's two 256x256 calls and at [8,1024,1,128]x256 (the
            # narrow yardsticks: timed beside SDPA); past D = 128: N and M off
            # every tile, one key, 5000 keys, D = 321 and 512 (column chunks
            # and blocks of 320)
            (8, 4096, 1, 64, 64, "f32", True), (8, 1024, 2, 64, 64, "f32", True),
            (8, 1024, 1, 128, 256, "f32", True), (2, 333, 1, 321, 1, "f32", False),
            (1, 200, 1, 320, 5000, "f32", False), (1, 300, 2, 512, 77, "f32", False),
            (3, 65, 1, 160, 1, "f32", False), (2, 100, 1, 129, 5000, "f32", False),
            # float16 (the float16 instances; mma.sync named where its shared
            # memory holds the keys): B2's two 256x256 calls and
            # [8,1024,1,320]x256 (DP = 320) timed beside float16 SDPA; ragged N
            # and M, keys in tiles and streamed, DP = 192, past D = 320 (column
            # blocks); each also held to the exact attention
            (8, 4096, 1, 64, 64, "f16", True), (8, 1024, 2, 64, 64, "f16", True),
            (8, 1024, 1, 320, 256, "f16", True), (1, 1000, 3, 32, 37, "f16", False),
            (2, 700, 2, 64, 257, "f16", False), (1, 777, 2, 64, 2048, "f16", False),
            (8, 1024, 2, 160, 256, "f16", False), (1, 999, 3, 384, 300, "f16", False),
            (1, 600, 1, 512, 100, "f16", False)):
        q, k, v = qkv((B, N, H, D), (B, M, H, D), dtype)
        shape = f"[{B},{N},{H},{D}]x[{B},{M},{H},{D}]"
        route = attn._sr_route(q, k, v)
        if route != ("f32" if dtype == "f32" else "wgmma"):
            fail(f"sr_attention {shape} {dtype}: routed to {route}")
        want = attn.sr_attention_reference(q, k, v)
        got = attn.sr_attention(q, k, v)
        err = held("sr_attention", got, want, dtype, shape)
        line = f"attention: sr_attention {shape} {dtype}: {route} max abs err {err:.3e}"
        if route == "wgmma" and D > 128:
            line += f" ({attn._sr_shape(D, M)})"
        if dtype == "f16":
            e, pe = held_exact("sr_attention", got, want, exact_of(q, k, v), shape)
            line += f" (exact: {e:.3e}, plain version {pe:.3e})"
        del got
        mma = dtype != "f32" and attn._mma_fits(M, D)
        if mma:
            err_mma = held("sr_attention (mma)", attn.launch_sr_attention(q, k, v, "mma"),
                           want, dtype, shape)
            err = max(err, err_mma)
            line += f", mma max abs err {err_mma:.3e}"
        sra["max_abs_err"] = max(sra["max_abs_err"], err)
        log(line + " vs plain version")
        if time_it:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            timed(sra, "sr_attention", shape, dtype,
                  lambda: attn.sr_attention(q, k, v),
                  lambda: attn.sr_attention_reference(q, k, v),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt),
                  nbytes=(2 * q.numel() + 2 * k.numel()) * q.element_size(),
                  ops=4 * B * H * N * M * D,
                  others={"mma kernel": lambda: attn.launch_sr_attention(q, k, v, "mma")}
                  if mma else None)
            log(f"attention: sr_attention {shape}: {B * H * N * M / 1e6:.1f} M exponentials, "
                f"{B * H * N * M / EXP_PER_S * 1e3:.4f} ms at 16 a clock on each of 132 SMs "
                "(1.98 GHz)")
        del q, k, v, want
    # a layout TMA cannot describe (a base 8 bytes off 16) with more keys
    # than the mma.sync kernel holds: copied into a TMA layout for wgmma
    flat = torch.randn(4 + 2 * 1024 * 64, device=dev, generator=gen).bfloat16()
    k = flat[4:].view(2, 1024, 1, 64)
    q = torch.randn((2, 700, 1, 64), device=dev, generator=gen).bfloat16()
    if attn._tma_layout(k) or attn._mma_fits(1024, 64) or attn._sr_route(q, k, k) != "wgmma":
        fail("sr_attention: the offset layout at M = 1024 is not routed through the copy")
    err = held("sr_attention", attn.sr_attention(q, k, k),
               attn.sr_attention_reference(q, k.contiguous(), k.contiguous()), "bf16",
               "a base 8 bytes off 16 at M = 1024")
    sra["max_abs_err"] = max(sra["max_abs_err"], err)
    log(f"attention: sr_attention [2,700,1,64]x[2,1024,1,64] bf16, k and v 8 bytes off 16 "
        f"(copied for wgmma): max abs err {err:.3e} vs plain version")
    # a layout the mma.sync kernel would take at D <= 128 (a base 8 bytes off
    # 16, 40 keys), at D = 160: copied for wgmma; the mma route refuses it
    flat = torch.randn(4 + 2 * 300 * 160, device=dev, generator=gen).bfloat16()
    q = flat[4:].view(2, 300, 1, 160)
    k, v = (torch.randn((2, 40, 1, 160), device=dev, generator=gen).bfloat16() for _ in "kv")
    if attn._tma_layout(q) or attn._sr_route(q, k, v) != "wgmma":
        fail("sr_attention: the offset layout at D = 160 is not routed through the copy")
    err = held("sr_attention", attn.sr_attention(q, k, v),
               attn.sr_attention_reference(q.contiguous(), k, v), "bf16",
               "a base 8 bytes off 16 at D = 160")
    sra["max_abs_err"] = max(sra["max_abs_err"], err)
    try:
        attn.launch_sr_attention(k, k, k, "mma")
        fail("sr_attention: the mma route took D = 160")
    except ValueError as e:
        refusal = str(e)
    log(f"attention: sr_attention [2,300,1,160]x[2,40,1,160] bf16, q 8 bytes off 16 (copied "
        f"for wgmma): max abs err {err:.3e} vs plain version; the mma route: {refusal!r}")
    # float16 on a layout TMA cannot describe (q's base 8 bytes off 16): the
    # mma.sync kernel at 40 keys, wgmma on copies at 1024 (past what mma.sync
    # holds)
    for M, want_route in ((40, "mma"), (1024, "wgmma")):
        flat = torch.randn(4 + 2 * 300 * 64, device=dev, generator=gen).half()
        q = flat[4:].view(2, 300, 1, 64)
        k, v = (torch.randn((2, M, 1, 64), device=dev, generator=gen).half() for _ in "kv")
        route = attn._sr_route(q, k, v)
        if route != want_route:
            fail(f"sr_attention float16, q 8 bytes off 16, M = {M}: routed to {route}")
        before = attn.sr_attention.routes[route]
        got, plain = attn.sr_attention(q, k, v), attn.sr_attention_reference(q.contiguous(), k, v)
        if attn.sr_attention.routes[route] != before + 1:
            fail(f"sr_attention float16 at M = {M} did not launch {route}")
        err = held("sr_attention", got, plain, "f16", f"q 8 bytes off 16, M = {M}")
        e, pe = held_exact("sr_attention", got, plain, exact_of(q, k, v), f"M = {M}")
        sra["max_abs_err"] = max(sra["max_abs_err"], err)
        log(f"attention: sr_attention [2,300,1,64]x[2,{M},1,64] f16, q 8 bytes off 16: {route} "
            f"max abs err {err:.3e} vs plain version (exact: {e:.3e}, plain version {pe:.3e})")
    # batch x heads past the 65,535 a grid axis holds: every kernel. A
    # pair's output must not depend on how many pairs share the call (the
    # grid kernels take them in runs of 65,535, wgmma walks a flat list), so
    # each 65,537-pair result is held bit for bit against the same pairs
    # launched as 65,535 and as 2, beside its plain version
    def by_pairs(fn, q, k, v, what):
        whole = fn(q, k, v)
        parts = torch.cat([fn(q[s], k[s], v[s]) for s in (slice(0, 65535), slice(65535, None))])
        torch.cuda.synchronize()
        if not torch.equal(whole, parts):
            fail(f"{what}: the 65,537-pair result differs from the same pairs as 65,535 + 2")
        return whole

    for dtype, route in (("f32", "f32"), ("bf16", "wgmma"), ("bf16", "mma"), ("f16", "wgmma"),
                         ("f16", "mma")):
        q, k, v = qkv((65537, 16, 1, 16), (65537, 64, 1, 16), dtype)
        got = by_pairs(lambda *t: attn.launch_sr_attention(*t, route), q, k, v,
                       f"sr_attention on {route}")
        plain = attn.sr_attention_reference(q, k, v)
        err = held("sr_attention", got, plain, dtype, f"B x H = 65537 on {route}")
        sra["max_abs_err"] = max(sra["max_abs_err"], err)
        line = ""
        if dtype == "f16":
            e, pe = held_exact("sr_attention", got, plain, exact_of(q, k, v), route)
            line = f" (exact: {e:.3e}, plain version {pe:.3e})"
        log(f"attention: sr_attention [65537,16,1,16]x[65537,64,1,16] {dtype} on {route}: "
            f"max abs err {err:.3e} vs plain version{line}; equal bit for bit to 65,535 + 2 "
            "pairs")
        del got, plain
    # float32 past D = 128: the tile kernel at D = 160 (DP = 192)
    q, k, v = qkv((65537, 16, 1, 160), (65537, 8, 1, 160), "f32")
    got = by_pairs(attn.sr_attention, q, k, v, "sr_attention f32 at D = 160")
    err = held("sr_attention", got, attn.sr_attention_reference(q, k, v), "f32",
               "B x H = 65537 at D = 160")
    sra["max_abs_err"] = max(sra["max_abs_err"], err)
    log(f"attention: sr_attention [65537,16,1,160]x[65537,8,1,160] f32: max abs err "
        f"{err:.3e} vs plain version; equal bit for bit to 65,535 + 2 pairs")
    del q, k, v, got
    # bfloat16 at 65,537 pairs and other (N, M, D). The plain version (and
    # mma.sync) rounds normalised p, the one-pass wgmma kernel rounds p
    # before dividing by the row sum, and each rounds its output once: the
    # two may land on neighbouring bfloat16 values, a step apart, and a step
    # is 2^-5, past BF16_BAR, at |o| >= 4. So each is held within BF16_BAR
    # of the exact attention of the same inputs (float64, p unrounded), and
    # the two agree on each output within BF16_BAR or two steps of its
    # magnitude. The first six draw as tests/test_torch_cuda.py's `_qkv`
    # (host, seed 0); the last (cuda, seed 13) has an output where the two
    # land a step apart at |o| >= 4
    def bf16_steps(x):
        return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)

    for N, M, D, where, seed in ((16, 16, 8, "cpu", 0), (16, 64, 16, "cpu", 0),
                                 (16, 16, 16, "cpu", 0), (16, 8, 8, "cpu", 0),
                                 (16, 16, 32, "cpu", 0), (64, 64, 64, "cpu", 0),
                                 (16, 8, 8, "cuda", 13)):
        g = torch.Generator(device=where).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g, device=where).bfloat16().to(dev)
                   for s in ((65537, N, 1, D), (65537, M, 1, D), (65537, M, 1, D)))
        exact = exact_of(q, k, v)
        plain = attn.sr_attention_reference(q, k, v).double()
        plain_err = float((plain - exact).abs().max())
        for route in ("wgmma", "mma"):
            got = by_pairs(lambda *t: attn.launch_sr_attention(*t, route), q, k, v,
                           f"sr_attention on {route}").double()
            err = float((got - exact).abs().max())
            apart, big = (got - plain).abs(), torch.maximum(got.abs(), plain.abs())
            i, over = int(apart.argmax()), apart > BF16_BAR
            steps = float((apart[over] / bf16_steps(big[over])).max()) if over.any() else 0.0
            log(f"attention: sr_attention [65537,{N},1,{D}]x[65537,{M},1,{D}] bf16 ({where} "
                f"seed {seed}) on {route}: max abs err {err:.3e} vs exact (plain version "
                f"{plain_err:.3e}); {float(apart.max()):.3e} from the plain version, at o = "
                f"{float(got.flatten()[i]):.6f} (plain {float(plain.flatten()[i]):.6f}, exact "
                f"{float(exact.flatten()[i]):.6f}); {int(over.sum())} outputs past BF16_BAR, "
                f"those at most {steps:g} bf16 steps apart; equal bit for bit to 65,535 + 2 pairs")
            if not (err <= BF16_BAR and plain_err <= BF16_BAR and steps <= 2):
                fail(f"sr_attention [65537,{N},1,{D}]x{M} on {route}: {err} vs exact, plain "
                     f"{plain_err} vs exact (bar {BF16_BAR}), {steps} steps from the plain version")
        del q, k, v, exact, plain, got, apart, big, over

    # ---- K2, neighbourhood attention
    nat = {"name": "neighborhood_attention", "route": "cuda",
           "source": "fusion3dseg_tpu_torch/csrc/neighborhood_attention.cu",
           "replaces": "fusion3dseg_tpu/ops/attention.py:151", "launches": 0,
           "max_abs_err": 0.0,
           "kernels": ["nat_mma_kernel", "nat_mma_wide_kernel", "nat_f32_kernel",
                       "nat_f32_wide_kernel"]}
    # the launcher's chunk plan against its mirror in ops/attention.py, over
    # the domain tests/test_torch_nat_windows.py checks on the CPU
    plan_fn = cuda.load("neighborhood_attention").f3s_nat_plan
    plan_fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)]
    got_plan, cases = (ctypes.c_int64 * 4)(), 0
    for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
        for D in (8, 24, 32, 64, 128, 129, 512):
            for window in range(1, 256, 2):
                for w in range(1, 257):
                    want_plan = tuple(attn._nat_plan(window, D, dtype, w))
                    if plan_fn(code, window, D, w, got_plan) != 0 or tuple(got_plan) != want_plan:
                        fail(f"neighborhood_attention: the launcher plans {tuple(got_plan)} for "
                             f"window {window}, D {D}, {dtype}, width {w}; _nat_plan "
                             f"{want_plan}")
                    cases += 1
    log(f"attention: neighborhood_attention: the launcher's chunk plan equals _nat_plan in "
        f"{cases} cases (odd windows 1-255, D 8-512, widths 1-256, both dtypes)")
    cases = 0  # float16 stages as bfloat16 does: the same plans
    for D in (8, 64, 128, 129, 320, 512):
        for window in range(1, 64, 2):
            for w in (1, 5, 9, 16, 17, 64, 70, 256):
                want_plan = tuple(attn._nat_plan(window, D, torch.float16, w))
                if plan_fn(2, window, D, w, got_plan) != 0 or tuple(got_plan) != want_plan:
                    fail(f"neighborhood_attention: the launcher plans {tuple(got_plan)} for "
                         f"window {window}, D {D}, float16, width {w}; _nat_plan {want_plan}")
                cases += 1
    log(f"attention: neighborhood_attention: float16's chunk plan equals _nat_plan in {cases} "
        "cases (odd windows 1-63, D 8-512, widths 1-256)")
    # the narrow kernel at D <= 64 (NK2 = 1, 2) holds four blocks an SM, 128
    # registers a thread: its bfloat16 instances spill 8 and 24 bytes, its
    # float16 twin at NK2 = 2 16 bytes, held to its twin's
    nat_two_byte = ("mma_wide", "mma_wide_online", "mma_1", "mma_2", "mma_3", "mma_4")
    nat_f16 = tuple(f"{name}_f16" for name in nat_two_byte)
    resources(cuda.load("neighborhood_attention").f3s_nat_resources, "neighborhood_attention",
              (*nat_two_byte, "f32_wide", "f32_16", *nat_f16),
              new=("mma_wide", "mma_wide_online", "f32_wide", "mma_wide_f16",
                   "mma_wide_online_f16", "mma_3_f16", "mma_4_f16"))
    for B, h, w, H, D, window, dtype, time_it in (
            (8, 64, 64, 1, 64, 7, "bf16", True), (2, 128, 128, 1, 64, 7, "bf16", True),
            (1, 9, 11, 2, 8, 5, "f32", False),
            # windows 3, 9, 13 on grids no tile divides; head dims 24 and 128;
            # head dims that rule out 16-byte (20) and 4-byte (7) accesses
            (1, 20, 23, 2, 32, 3, "bf16", False), (2, 17, 19, 1, 64, 9, "bf16", False),
            (1, 12, 30, 1, 64, 13, "bf16", False), (1, 13, 9, 1, 16, 13, "f32", False),
            (1, 20, 7, 2, 24, 3, "bf16", False), (2, 10, 12, 2, 128, 5, "bf16", False),
            (1, 11, 10, 1, 20, 5, "bf16", False), (1, 9, 9, 3, 7, 3, "bf16", False),
            (1, 9, 9, 3, 7, 3, "f32", False),
            # windows whose halo is streamed in chunks: 23 at B2's stage 0
            # (timed), 15 and 23 at D = 64 and 128 in both dtypes on ragged
            # grids, 41 and 63 with rows cut into column pieces (63 at 12 x
            # 100, D = 128), and a halo clamped far inside the window (63 on
            # a 9 x 10 image)
            (8, 64, 64, 1, 64, 23, "bf16", True), (1, 16, 16, 1, 64, 15, "f32", False),
            (2, 17, 19, 1, 64, 15, "bf16", False), (1, 21, 18, 2, 128, 15, "bf16", False),
            (1, 21, 18, 2, 128, 15, "f32", False), (2, 40, 37, 1, 64, 23, "f32", False),
            (1, 30, 27, 1, 128, 23, "bf16", False), (1, 30, 27, 1, 128, 23, "f32", False),
            (1, 24, 30, 2, 128, 41, "bf16", False), (1, 24, 30, 2, 64, 41, "f32", False),
            (1, 12, 100, 1, 128, 63, "bf16", False), (1, 20, 24, 1, 128, 63, "f32", False),
            (1, 33, 100, 1, 64, 63, "bf16", False), (1, 9, 10, 1, 128, 63, "bf16", False),
            (1, 9, 10, 1, 64, 63, "f32", False),
            # head dims past 128 (the wide kernels, both dtypes): timed at B2
            # num_heads=(1,1,1,2)'s stage 2 (16 x 16, D = 320, window 7) in both
            # dtypes and at D = 256 in bfloat16; ragged grids, a D that is not a
            # multiple of 8, windows 7 to 41, window 23 (the chunk's scores,
            # online over the chunks), two column blocks (D = 384)
            (8, 16, 16, 1, 320, 7, "bf16", True), (8, 16, 16, 1, 256, 7, "bf16", True),
            (8, 16, 16, 1, 320, 7, "f32", True), (2, 13, 21, 1, 320, 9, "bf16", False),
            (1, 30, 27, 1, 320, 23, "bf16", False), (1, 33, 40, 2, 384, 11, "bf16", False),
            *((B, h, w, H, D, window, dtype, False) for dtype in ("f32", "bf16")
              for B, h, w, H, D, window in (
                  (1, 16, 16, 1, 129, 7), (1, 13, 19, 2, 160, 7), (1, 16, 16, 1, 200, 9),
                  (2, 16, 16, 1, 256, 7), (1, 17, 16, 1, 320, 7), (1, 12, 30, 1, 512, 15),
                  (1, 9, 70, 1, 160, 41))),
            # float32: the narrow kernel's yardstick (B2's stage 0 at 256x256,
            # timed beside the masked SDPA); past D = 128 a halo in bands
            # (window 23), two column blocks (384, 321), an image smaller than
            # the window
            (8, 64, 64, 1, 64, 7, "f32", True), (1, 30, 27, 1, 320, 23, "f32", False),
            (1, 33, 40, 2, 384, 11, "f32", False), (2, 13, 21, 1, 321, 9, "f32", False),
            (1, 5, 3, 1, 200, 63, "f32", False),
            # float16 (the float16 instances), each also held to the exact
            # attention (p float32-grade: a high part and a float16 remainder,
            # subnormal below p of about 0.12): window 7 at B2's stage 0 and D =
            # 320 on 16 x 16 tokens timed beside float16 SDPA; window 23
            # streamed in bands, rows in column pieces, element copies, the wide
            # kernel's chunk scores online, two column blocks
            (8, 64, 64, 1, 64, 7, "f16", True), (8, 16, 16, 1, 320, 7, "f16", True),
            (2, 64, 64, 1, 64, 23, "f16", False), (1, 12, 100, 1, 128, 63, "f16", False),
            (1, 9, 9, 3, 7, 3, "f16", False), (1, 30, 27, 1, 320, 23, "f16", False),
            (1, 33, 40, 2, 384, 11, "f16", False)):
        N = h * w
        q, k, v = qkv((B, N, H, D), (B, N, H, D), dtype)
        shape = f"[{B},{h}*{w},{H},{D}] window {window}"
        got = attn.neighborhood_attention(q, k, v, h, w, window)
        plain = attn.neighborhood_attention_reference(q, k, v, h, w, window)
        err = held("neighborhood_attention", got, plain, dtype, shape)
        nat["max_abs_err"] = max(nat["max_abs_err"], err)
        line = f"attention: neighborhood_attention {shape} {dtype}: max abs err {err:.3e} " \
            f"vs plain version; {attn._nat_plan(window, D, dtypes[dtype], w)}"
        if dtype == "f16":
            e, pe = held_exact("neighborhood_attention", got, plain,
                               exact_of(q, k, v, window, (h, w)), shape)
            line += f"; exact: {e:.3e}, plain version {pe:.3e}"
        log(line)
        del got, plain
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

    # batch x heads past the 65,535 a grid axis holds; float32 also past D =
    # 128 (the wide kernel, D = 129: element copies)
    for dtype, D in (("f32", 8), ("bf16", 8), ("f32", 129), ("f16", 8)):
        q, k, v = qkv((65537, 16, 1, D), (65537, 16, 1, D), dtype)
        got = by_pairs(lambda *t: attn.neighborhood_attention(*t, 4, 4, 3), q, k, v,
                       "neighborhood_attention")
        err = held("neighborhood_attention", got,
                   attn.neighborhood_attention_reference(q, k, v, 4, 4, 3), dtype,
                   "B x H = 65537")
        nat["max_abs_err"] = max(nat["max_abs_err"], err)
        log(f"attention: neighborhood_attention [65537,4*4,1,{D}] window 3 {dtype}: max abs "
            f"err {err:.3e} vs plain version; equal bit for bit to 65,535 + 2 pairs")
    del q, k, v

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

    def throughput(seg):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            masks_of(seg)  # ends in a copy to the host
            times.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        masks_of(seg)
        log(f"segmenter: predict_batch at {seg.input_hw[0]}x{seg.input_hw[1]} {card}: "
            f"{nframes} frames in {[round(t, 4) for t in times]} s, best "
            f"{nframes / min(times):.1f} frames/s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    def compare(name, seg, plain, per_forward, bar, route="wgmma"):
        """Masks and logits of the kernel path against the plain versions.
        per_forward: launches a forward of each kernel, {"sr": K3, "nat": K2};
        route: the K3 kernel every launch must take; returns the masks and
        the launches of each in the masks' run."""
        attn.reset_sr_counts()
        attn.neighborhood_attention.launches = 0
        got = masks_of(seg)
        torch.cuda.synchronize()
        launches = {"sr": k3_counted(name, route), "nat": attn.neighborhood_attention.launches}
        forwards = nframes // batch
        for kernel, n in launches.items():
            if n != per_forward.get(kernel, 0) * forwards:
                fail(f"{name}: {kernel} launched {n} times in {forwards} forwards (want "
                     f"{per_forward.get(kernel, 0)} each)")
        want = masks_of(plain)
        if (attn.sr_attention.launches, attn.neighborhood_attention.launches) != \
                (launches["sr"], launches["nat"]):
            fail(f"{name}: use_cuda_attention=False launched a kernel")
        agree = float((got == want).mean())
        diff = float((logits_of(seg) - logits_of(plain)).abs().max())
        log(f"segmenter: {name}: launches {launches} in {forwards} forwards; masks agree "
            f"with the plain-version forward on {agree:.6f} of pixels (bar {bar}); max "
            f"logit difference {diff:.4f} (bar {LOGIT_DIFF_BAR})")
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
    got, n = compare("shipped B2, use_pallas_attention", seg, plain, {"sr": 7}, MASK_AGREE_BAR)
    sra_launches = n["sr"]
    acc = float((got == gts).mean())
    log(f"segmenter: pixel accuracy against ground truth {acc:.4f} (bar {PIXEL_ACC_BAR})")
    if acc < PIXEL_ACC_BAR:
        fail(f"pixel accuracy {acc} below {PIXEL_ACC_BAR}")
    throughput(seg)
    del plain

    # the same weights at 512x512 (ADE20K's size: 13 K3 calls a forward, M =
    # 256) and 1024x1024 (Cityscapes': 16 calls, M = 1024), against the plain
    # versions; no ground-truth bar (the weights were trained at 256x256)
    for hw, per_forward in (((512, 512), 13), ((1024, 1024), 16)):
        big, big_plain = (Segmenter2D(cfg, ckpt, input_hw=hw, batch_size=batch, device="cuda",
                                      use_cuda_attention=use) for use in (True, False))
        masks_of(big)  # warm-up: cuDNN/cuBLAS plans at this size
        _, n = compare(f"shipped B2 at {hw[0]}x{hw[1]}, use_pallas_attention", big, big_plain,
                       {"sr": per_forward}, MASK_AGREE_BAR)
        sra_launches += n["sr"]
        del big_plain
        throughput(big)
        del big

    # B2 width with a neighbourhood-attention first stage. The weights are the
    # shipped checkpoint's without the first stage's reduction conv and its
    # norm, which a neighbourhood stage does not have: not trained for this
    # attention, but decisive logits, so that masks can be compared (seeded
    # random weights give near-flat logits whose argmax flips on rounding)
    shipped = convert.flatten_params(convert.load_params_npz(ckpt))

    def less_reduction(stage):
        """The shipped weights without stage `stage`'s reduction conv and norm."""
        return {k: v for k, v in shipped.items()
                if not (k.startswith(f"stage{stage}_") and (
                    "/sr/" in k or "EfficientAttention_0/LayerNorm_0" in k))}

    flat = less_reduction(0)
    nat_launches = 0
    # window 7, whose halo the kernel stages once, and window 23 (stage 0's
    # 64 x 64 tokens, D = 64), whose halo it streams in bands of rows
    for window in (7, 23):
        cfg_nat = dataclasses.replace(SegFormerConfig.b2(), nat_windows=(window, 0, 0, 0))
        state = convert.from_flax_params(flat, cfg_nat)
        seg_nat, plain_nat = (Segmenter2D(cfg_nat, input_hw=(256, 256), batch_size=batch,
                                          device="cuda", use_cuda_attention=use)
                              for use in (True, False))
        for s in (seg_nat, plain_nat):
            s.model.load_state_dict(state)
        _, n = compare(f"B2 width, nat_windows=({window},0,0,0), shipped weights less the "
                       "first stage's reduction", seg_nat, plain_nat, {"nat": 3},
                       NAT_MASK_AGREE_BAR)
        nat_launches += n["nat"]
        del seg_nat, plain_nat

    # B2 with one head in stages 0-2 and two in stage 3 (head dims 64, 128,
    # 320, 256): the attention weights do not depend on the heads, so the
    # shipped checkpoint loads. K3 runs where N % 512 == 0: D = 64 and 128 at
    # 256x256 (M = 64), also 320 at 512x512 (M = 256), also 256 at
    # 1024x1024 (stage 3, M = 1024). Then stage 2 as a window-7
    # neighbourhood stage (the shipped weights less its reduction): K2 at
    # D = 320 on the 16 x 16 grid, beside K3 in stages 0 and 1
    cfg_wide = dataclasses.replace(cfg, num_heads=(1, 1, 1, 2))
    for hw, per_forward in (((256, 256), 7), ((512, 512), 13), ((1024, 1024), 16)):
        wide, wide_plain = (Segmenter2D(cfg_wide, ckpt, input_hw=hw, batch_size=batch,
                                        device="cuda", use_cuda_attention=use)
                            for use in (True, False))
        masks_of(wide)  # warm-up
        _, n = compare(f"B2 num_heads=(1,1,1,2) at {hw[0]}x{hw[1]}, use_pallas_attention",
                       wide, wide_plain, {"sr": per_forward}, NAT_MASK_AGREE_BAR)
        sra_launches += n["sr"]
        del wide_plain
        if hw == (512, 512):  # K3 at D = 320 (stage 2) on the main path's kernel
            log("segmenter: B2 num_heads=(1,1,1,2) at 512x512, before the wide kernels' "
                "redesign: no frames/s was taken (PERF.md has none); now:")
            throughput(wide)
        del wide
    cfg_wide_nat = dataclasses.replace(cfg_wide, nat_windows=(0, 0, 7, 0))
    state = convert.from_flax_params(less_reduction(2), cfg_wide_nat)
    seg_nat, plain_nat = (Segmenter2D(cfg_wide_nat, input_hw=(256, 256), batch_size=batch,
                                      device="cuda", use_cuda_attention=use)
                          for use in (True, False))
    for s in (seg_nat, plain_nat):
        s.model.load_state_dict(state)
    masks_of(seg_nat)  # warm-up
    _, n = compare("B2 num_heads=(1,1,1,2), nat_windows=(0,0,7,0), shipped weights less "
                   "stage 2's reduction", seg_nat, plain_nat, {"sr": 7, "nat": 6},
                   NAT_MASK_AGREE_BAR)
    sra_launches += n["sr"]
    nat_launches += n["nat"]
    del seg_nat, plain_nat

    # the float32 path of the two float32 kernels: the same re-headed B2 in
    # float32 at 512x512 (K3's tile kernel at D = 64, 128 and 320, 13
    # launches a forward), and with stage 2 a window-7 neighbourhood stage
    # at 256x256 (K2's float32 wide kernel at D = 320 on 16 x 16 tokens,
    # beside K3 in stages 0 and 1); every K3 launch on the "f32" route
    cfg_f32 = dataclasses.replace(cfg_wide, dtype=torch.float32)
    wide, wide_plain = (Segmenter2D(cfg_f32, ckpt, input_hw=(512, 512), batch_size=batch,
                                    device="cuda", use_cuda_attention=use)
                        for use in (True, False))
    masks_of(wide)  # warm-up
    _, n = compare("B2 num_heads=(1,1,1,2) float32 at 512x512, use_pallas_attention", wide,
                   wide_plain, {"sr": 13}, MASK_AGREE_BAR, route="f32")
    sra_launches += n["sr"]
    del wide, wide_plain
    cfg_f32_nat = dataclasses.replace(cfg_wide_nat, dtype=torch.float32)
    state = convert.from_flax_params(less_reduction(2), cfg_f32_nat)
    seg_nat, plain_nat = (Segmenter2D(cfg_f32_nat, input_hw=(256, 256), batch_size=batch,
                                      device="cuda", use_cuda_attention=use)
                          for use in (True, False))
    for s in (seg_nat, plain_nat):
        s.model.load_state_dict(state)
    masks_of(seg_nat)  # warm-up
    _, n = compare("B2 num_heads=(1,1,1,2), nat_windows=(0,0,7,0), float32", seg_nat, plain_nat,
                   {"sr": 7, "nat": 6}, NAT_MASK_AGREE_BAR, route="f32")
    sra_launches += n["sr"]
    nat_launches += n["nat"]
    del seg_nat, plain_nat

    # float16: the shipped B2 as a snapshot whose metadata says "float16"
    # (and use_pallas_attention), Segmenter2D reading its config from the
    # file, at 256x256, batch 8: K3's float16 wgmma instance, 7 launches a
    # forward; then the re-headed B2 with stage 2 a window-7 neighbourhood
    # stage in float16 (K2's float16 wide kernel at D = 320 beside K3 in
    # stages 0 and 1). Masks against the plain-version float16 forward
    import shutil
    import tempfile

    cfg16 = dataclasses.replace(cfg, dtype=torch.float16)
    work = Path(tempfile.mkdtemp(prefix="f3s_f16_"))
    try:
        snap = work / "b2_float16.npz"
        convert.save_params_npz(snap, convert.load_params_npz(ckpt), input_hw=(256, 256),
                                config=cfg16)
        seg16, plain16 = (Segmenter2D(checkpoint_dir=snap, batch_size=batch, device="cuda",
                                      use_cuda_attention=use) for use in (True, False))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if seg16.config != cfg16 or seg16.input_hw != (256, 256):
        fail(f"the float16 snapshot resolved to {seg16.config}, {seg16.input_hw}")
    masks_of(seg16)  # warm-up
    _, n = compare("shipped B2 float16 from the snapshot's metadata, use_pallas_attention",
                   seg16, plain16, {"sr": 7}, MASK_AGREE_BAR)
    sra_launches += n["sr"]
    del plain16
    throughput(seg16)
    del seg16
    cfg16_nat = dataclasses.replace(cfg_wide_nat, dtype=torch.float16)
    state = convert.from_flax_params(less_reduction(2), cfg16_nat)
    seg_nat, plain_nat = (Segmenter2D(cfg16_nat, input_hw=(256, 256), batch_size=batch,
                                      device="cuda", use_cuda_attention=use)
                          for use in (True, False))
    for s in (seg_nat, plain_nat):
        s.model.load_state_dict(state)
    masks_of(seg_nat)  # warm-up
    _, n = compare("B2 num_heads=(1,1,1,2), nat_windows=(0,0,7,0), float16", seg_nat,
                   plain_nat, {"sr": 7, "nat": 6}, MASK_AGREE_BAR)
    sra_launches += n["sr"]
    nat_launches += n["nat"]
    del seg_nat, plain_nat

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

    attn.reset_sr_counts()
    t0 = time.perf_counter()
    votes, classes = stream_segment(sd, seg, uv2pt, npts=npts, nclasses=133,
                                    batch_size=seg.batch_size)
    dt = time.perf_counter() - t0
    launches = k3_counted("stream")
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


def soak_phase(card):
    """The long-session soak (`tools/soak.py`) on the card: resumed equals
    uninterrupted equals a plain `fuse_session` over the same frames."""
    import torch

    from fusion3dseg_tpu_torch.fusion import fusion as fusion_engine
    from fusion3dseg_tpu_torch.tools import soak

    t0 = time.perf_counter()
    run = soak.soak(SOAK_FRAMES, device="cuda")
    wall = time.perf_counter() - t0
    res = run.result
    log(f"soak: {json.dumps(res)}")
    t0 = time.perf_counter()
    state, uv2pt = fusion_engine.fuse_session(*run.args, **run.kw)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(run.state, state)) and \
        bool((uv2pt.cpu().numpy() == run.uv2pt).all())
    log(f"soak {card}: {SOAK_FRAMES} frames at 128x96, window {res['window']}: three "
        f"checkpointed runs and the session in {wall:.1f} s; resumed == uninterrupted "
        f"(state {res['resume_equals_oneshot_state']}, uv2pt "
        f"{res['resume_equals_oneshot_uv2pt']}); resumed == fuse_session ({t_plain:.1f} s) "
        f"bit for bit: {same}; n {res['points']} of {res['capacity']}, max nmerges "
        f"{res['max_nmerges']}")
    if not (res["resume_equals_oneshot_state"] and res["resume_equals_oneshot_uv2pt"] and same):
        fail("soak: the resumed run differs from the uninterrupted one or from fuse_session")
    if run.state.nmerges.dtype != torch.int32 or run.state.occurences.dtype != torch.int32 \
            or not res["points"] <= res["capacity"]:
        fail(f"soak: counters {run.state.nmerges.dtype}, {run.state.occurences.dtype}, "
             f"n {res['points']} of {res['capacity']}")


def loop_phase(card):
    """The model in the loop (`tools/model_in_the_loop.py`) with the shipped
    B2 and K3; its classes against the same run through the model's own
    attention (`use_pallas_attention=False`). Returns K3's launches in the
    kernel run."""
    import numpy as np

    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.tools import model_in_the_loop as mitl

    attn.reset_sr_counts()
    res, classes, _ = mitl.in_the_loop(mitl.shipped_segmenter("cuda"))
    launches = k3_counted("loop")
    if launches != 7 * -(-res["frames"] // 8):
        fail(f"loop: K3 launched {launches} times for {res['frames']} frames")
    _, plain_classes, _ = mitl.in_the_loop(
        mitl.shipped_segmenter("cuda", use_pallas_attention=False))
    same = float(np.mean(classes == plain_classes))
    log(f"loop {card}: {json.dumps(res)}")
    log(f"loop: 3D agreement {res['model_in_loop_3d_agreement']:.4f} (bar {LOOP_AGREE_BAR}; "
        f"the JAX package recorded 0.9889 on a TPU v5e, BENCH_r05.json); unclassified "
        f"{res['model_in_loop_unclassified']:.4f}; stream {res['model_in_loop_stream_seconds']:.3f}"
        f" s; K3 launches {launches}; classes equal to the run with use_pallas_attention=False "
        f"on {same:.6f} of {res['points']} points (bar {LOOP_SAME_BAR})")
    if res["model_in_loop_3d_agreement"] < LOOP_AGREE_BAR or same < LOOP_SAME_BAR:
        fail(f"loop: 3D agreement {res['model_in_loop_3d_agreement']}, agreement with "
             f"use_pallas_attention=False {same}")
    return launches


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
    the spatial-reduction kernel's launches inside it (segmenter branch),
    the VGA session of 9c and the match kernel's entry for the kernels
    line."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.fusion import fusion as fe
    from fusion3dseg_tpu_torch.io import synthetic
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast
    from fusion3dseg_tpu_torch.utils import timing

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

    timing.METRICS.counts.pop(MATCH_COUNTER, None)  # count the main path's frames only
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
    # the match kernel: one launch a frame stepped (the seed frame aside),
    # replayed from the frame graph, so the host never sees it. The run's
    # record against the kernels a profiled run launched
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        counted = masks_run()
    traced = sum(e.count for e in prof.key_averages() if "match_pixels_kernel" in e.key)
    recorded = counted.stage_seconds[MATCH_COUNTER]
    match_launches = timing.METRICS.counts.get(MATCH_COUNTER, 0)
    log(f"fusion: match kernel launches in a profiled masks-branch run {traced}, its record's "
        f"{MATCH_COUNTER} {recorded:g} (fuse_graph.frames "
        f"{counted.stage_seconds['fuse_graph.frames']:g}), {nframes - 1} frames stepped; "
        f"{match_launches} counted in the phase's {len(runs) + 2} runs")
    if not traced == recorded == nframes - 1 or match_launches != (len(runs) + 2) * traced:
        fail(f"match kernel: {traced} launches traced, {recorded} recorded, "
             f"{match_launches} counted, for {nframes - 1} frames a run")
    del counted
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
    attn.reset_sr_counts()  # count the main path's launches only
    t0 = time.perf_counter()
    res = segment_session_fast(tsd, segmenter=seg, device="cuda", **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = k3_counted("fusion: segmenter branch")
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
    return launches, vsess, dict(match_row(card), launches=match_launches)


def _match_frame_inputs():
    """The (tensors, keywords) of the last frame's `_match_pixels` call in
    an eager engine run on the card over `MATCH_FRAMES` frames of a VGA
    room lap: the main path's own match inputs."""
    from unittest import mock

    import numpy as np

    from fusion3dseg_tpu_torch.fusion import fusion as fe
    from fusion3dseg_tpu_torch.io import synthetic

    sess = synthetic.make_session(nframes=MATCH_FRAMES, depth_hw=(480, 640),
                                  appearance="textured", turns=MATCH_FRAMES / 100,
                                  room=synthetic.RoomSpec(seed=3))
    sd = _session_on(sess, "cuda")
    valid = (sd.depth > 0.1) & (sd.depth <= 4.0)
    seen = {}
    match = fe._match_pixels

    def keep(*args, **kw):
        seen["args"], seen["kw"] = tuple(a.clone() for a in args), kw
        return match(*args, **kw)

    kw = dict(MATCH_ENGINE)
    min_cos = float(np.cos(np.deg2rad(kw.pop("angle"))))
    with mock.patch.object(fe, "_match_pixels", keep), \
            mock.patch.object(fe, "_replay_frames", lambda key, *a: fe._step_frames(*a)):
        fe.fuse_session(sd.Ks, sd.quats_wxyz, sd.translations, sd.points, sd.normals, sd.colors,
                        valid, height=480, width=640, min_cosine=min_cos, device="cuda", **kw)
    return seen["args"], seen["kw"]


def match_row(card):
    """Phase 9e: the match kernel on a real frame's inputs, equal to its
    plain version on the same card tensors and on the CPU, timed in a CUDA
    graph beside its byte bound and the plain version. Returns its entry
    for the kernels line (`launches` set by the caller)."""
    import torch

    from fusion3dseg_tpu_torch.fusion import fusion as fe
    from fusion3dseg_tpu_torch.tools.profiling import bound_ms, graph_ms

    args, kw = _match_frame_inputs()
    got = fe._match_kernel(*args, **kw)
    want = fe._match_pixels_plain(*args, **kw)
    on_cpu = fe._match_pixels_plain(*(a.cpu() for a in args), **kw)
    equal = [all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, ref)) for ref in (want, on_cpu)]
    if not all(equal):
        fail(f"match kernel against its plain version on the card / on the CPU: equal {equal}")
    P = kw["height"] * kw["width"]
    # read once: the grid, its ids, the pixels' points, normals and valid
    # flags; written once: match and matched
    nbytes = sum(a.numel() * a.element_size() for a in args) + P * (4 + 1)
    k_ms = graph_ms(lambda: fe._match_kernel(*args, **kw), iters=50)
    p_ms = graph_ms(lambda: fe._match_pixels_plain(*args, **kw), iters=5)
    b_ms, by = bound_ms(nbytes, 0.0)
    matched = got[1].float().mean().item()
    shape = f"[{kw['height']}, {kw['width']}] half {kw['half']}, frame {MATCH_FRAMES - 1} of a lap"
    log(f"kernels: match_pixels {shape} {card}: {matched:.4f} of pixels matched; equal to the "
        f"plain version on the card and on the CPU; kernel {k_ms:.4f} ms (in a CUDA graph), "
        f"bound {b_ms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s), "
        f"{100 * b_ms / k_ms:.1f}% of bound; plain version {p_ms:.4f} ms ({p_ms / k_ms:.0f}x)")
    return {**MATCH_ENTRY, "launches": 0, "max_abs_err": 0, "shape": shape, "dtype": "f32",
            "ms": k_ms, "bytes": nbytes, "bound_ms": b_ms, "bound_by": by,
            "share_of_bound": b_ms / k_ms, "plain_ms": p_ms, "library_ms": None,
            "matched_share": matched}


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
        attn.reset_sr_counts()  # count the main path's launches only
        t0 = time.perf_counter()
        get2dseg.SegmentImage(src / "rgb", work / "masks2d", segmenter=seg, batch_size=8)
        t_seg = time.perf_counter() - t0
        launches = k3_counted("files: SegmentImage")
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
            timing.METRICS.clear()
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
        attn.reset_sr_counts()
        mk, lk = masks_and_logits(seg_k)
        sync()
        launches += k3_counted("hf")
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
        attn.reset_sr_counts()
        mk, _ = masks_and_logits(seg_k)
        sync()
        launches += k3_counted("hf")
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
        attn.reset_sr_counts()
        ev = tr.evaluate_synthetic(eseg, nsessions=2, nframes=16)
        sync()
        k3 += k3_counted("train: evaluate_synthetic")
        log(f"train: EMA snapshot ({steps} steps from random init) through Segmenter2D with "
            f"K3: held-out mIoU {ev['miou']:.4f}, pixel accuracy {ev['pixel_acc']:.4f}; K3 "
            f"launches {attn.sr_attention.launches}")
        if not (0.0 <= ev["miou"] <= 1.0 and 0.0 <= ev["pixel_acc"] <= 1.0):
            fail(f"train: evaluate_synthetic gave {ev}")

        # ---- 12g. the calibration sweep with the shipped B2 and K3
        if on_card:
            sseg = seg if seg is not None else shipped_b2(8)[0]
            attn.reset_sr_counts()
            t0 = time.perf_counter()
            rows = calibrate.sweep_conf_threshold(sseg)
            sync()
            dt = time.perf_counter() - t0
            k3 += k3_counted("train: sweep_conf_threshold")
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



# ------------------------------------------------------------ 14. parallel
# ranks run these functions in their own processes (`parallel/launch.spawn`
# imports this script by name); inputs come through .npy files in a
# temporary directory


def _load_inputs(path):
    import numpy as np

    return {p.stem: np.load(p) for p in Path(path).glob("*.npy")}


def _probe_gloo_cuda(dev, world):
    """Which collectives a gloo group takes for CUDA tensors: {name: True
    or the error}."""
    import torch
    import torch.distributed as dist

    def gather():
        parts = [torch.empty(4, dtype=torch.uint8, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.ones(4, dtype=torch.uint8, device=dev))

    def gather_into():
        dist.all_gather_into_tensor(torch.empty(4 * world, dtype=torch.uint8, device=dev),
                                    torch.ones(4, dtype=torch.uint8, device=dev))

    out = {}
    for name, fn in (
            ("all_reduce SUM int32", lambda: dist.all_reduce(
                torch.ones(4, dtype=torch.int32, device=dev))),
            ("all_reduce MIN int32", lambda: dist.all_reduce(
                torch.ones(4, dtype=torch.int32, device=dev), op=dist.ReduceOp.MIN)),
            ("all_reduce MAX int32", lambda: dist.all_reduce(
                torch.ones(4, dtype=torch.int32, device=dev), op=dist.ReduceOp.MAX)),
            ("all_reduce SUM float32", lambda: dist.all_reduce(
                torch.ones(4, dtype=torch.float32, device=dev))),
            ("all_gather uint8", gather), ("all_gather_into_tensor uint8", gather_into)):
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = True
        except Exception as e:  # noqa: BLE001 (the probe reports every refusal)
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def _point_shard_rule(n, ndev, args, dev):
    """The classes `label_fuse_sharded_points` gives on ndev ranks, computed
    on one device without collectives: per pixel the least (quantised
    depth, rank-local id, rank) wins, the order its two pmins produce,
    where the one-device lifter takes the least (depth, global id).
    Classified by K1's plain version."""
    import torch

    from fusion3dseg_tpu_torch.geometry import camera
    from fusion3dseg_tpu_torch.ops import histogram as hist
    from fusion3dseg_tpu_torch.ops import label_fuse as lf
    from fusion3dseg_tpu_torch.ops import zbuffer

    (h, w), local_n = HW, n // ndev
    pts = torch.as_tensor(args[0], device=dev)
    sess = lf._Session(*args[1:], dev)
    gid = torch.arange(n, device=dev)
    key_of_point = ((gid % local_n) << 8) | (gid // local_n)  # (local id, rank)
    none = torch.iinfo(torch.int64).max
    C = lf._winner_matrix(n, sess.nframes, dev)
    for f in range(sess.nframes):
        u, v, z = camera.project_with_matrices(pts, sess.M[f], sess.R[f], sess.trans[f])
        ok = zbuffer._in_image(u, v, z, torch.ones_like(z, dtype=torch.bool), h, w)
        key = (zbuffer._zq(z, 11, 10.0).long() << 28) | key_of_point
        kmin = zbuffer._segment_min(torch.where(ok, key, none), torch.where(ok, v * w + u, h * w),
                                    h * w + 1, none)[:h * w]
        win = ((kmin & 0xFF) * local_n + ((kmin >> 8) & ((1 << 20) - 1)))
        lf._set_row(C, f, win, kmin != none, sess.masks[f], n)
    return hist.histogram_classify_reference(C[:, :n], NCLASSES, 0.5)[1]


def parallel_rank(rank, path, parts):
    """One rank of phase 14: the decompositions in `parts` on this rank's
    device, each timed beside its one-device call on the same device and
    held to it; returns numbers, verdicts and (rank 0) the fusion states."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.fusion import fusion as fe
    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.models import train as tr
    from fusion3dseg_tpu_torch.models.segformer import SegFormer
    from fusion3dseg_tpu_torch.ops import histogram as hist
    from fusion3dseg_tpu_torch.ops import label_fuse as lf
    from fusion3dseg_tpu_torch.ops import voting
    from fusion3dseg_tpu_torch.parallel import comm, sharding
    from fusion3dseg_tpu_torch.parallel import fusion as pf
    from fusion3dseg_tpu_torch.parallel import label_fuse as pl
    from fusion3dseg_tpu_torch.parallel import voting as pv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank.device
    on_card = dev.type == "cuda"
    inp = _load_inputs(path)
    res = {"rank": rank.rank, "backend": rank.backend, "device": str(dev), "ms": {},
           "calls": {}, "host_mb": {}, "ok": {}}
    if on_card and rank.backend == "gloo":
        res["gloo_cuda"] = _probe_gloo_cuda(dev, rank.world_size)
        if not all(v is True for v in res["gloo_cuda"].values()):
            return res
    mesh = sharding.make_mesh(rank.world_size, tp=1, device_type=dev.type)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def timed(name, fn):
        """fn's call timed after a synchronize; on the card its second (the
        first warms up)."""
        if on_card:
            fn()
        sync()
        c0, t0 = dict(comm.STATS), time.perf_counter()
        out = fn()
        sync()
        res["ms"][name] = 1e3 * (time.perf_counter() - t0)
        res["calls"][name] = comm.STATS["calls"] - c0["calls"]
        res["host_mb"][name] = (comm.STATS["host_bytes"] - c0["host_bytes"]) / 1e6
        return out

    real_k1, layouts = pl.histogram_classify, set()

    def k1(C, nclasses, threshold=0.5):  # K1's wrapper, noting the rows' layout
        layouts.add(hist.rows_aligned(C.data_ptr(), C.stride(0), C.shape[0]))
        return real_k1(C, nclasses, threshold)

    pl.histogram_classify = k1
    hist.histogram_classify.launches = 0  # the parallel path's launches only
    n, ndev, r = int(inp["npts"]), rank.world_size, rank.rank
    if "vote" in parts:
        uv, masks = inp["uv2pt"], inp["masks"]
        votes = timed("vote one device", lambda: voting.vote_all_frames(
            uv, masks, n, NCLASSES, device=dev))
        vf = timed("vote_sharded_frames", lambda: pv.vote_sharded_frames(
            mesh, uv, masks, n, NCLASSES))
        vp, cp = timed("vote_sharded_points", lambda: pv.vote_sharded_points(
            mesh, uv, masks, n, NCLASSES))
        lo, hi = r * n // ndev, (r + 1) * n // ndev
        res["ok"]["vote_sharded_frames"] = torch.equal(vf, votes)
        res["ok"]["vote_sharded_points"] = torch.equal(vp, votes[lo:hi]) and torch.equal(
            cp, voting.classify(votes[lo:hi], 0.5, NCLASSES))
        del votes, vf, vp, cp
    if "label" in parts:
        args = [inp[k] for k in ("points", "K", "quats", "trans", "masks")]
        one = timed("label one device (tpu_label_fuse)", lambda: lf.tpu_label_fuse(
            n, NCLASSES, HW, device=dev)(*args)[1])
        launches0 = hist.histogram_classify.launches
        lo, hi = r * n // ndev, (r + 1) * n // ndev
        got = timed("label_fuse_sharded", lambda: pl.label_fuse_sharded(
            mesh, *args, HW, nclasses=NCLASSES))
        res["ok"]["label_fuse_sharded"] = torch.equal(got, one[lo:hi])
        got = timed("label_fuse_sharded_points", lambda: pl.label_fuse_sharded_points(
            mesh, *args, HW, nclasses=NCLASSES))
        res["label_points_differ"] = int((got != one[lo:hi]).sum())
        res["ok"]["label_fuse_sharded_points: its tie rule"] = torch.equal(
            got, _point_shard_rule(n, ndev, args, dev)[lo:hi])
        dl, vs = inp[f"dev_lists_{ndev}"], inp[f"valid_{ndev}"]
        got = timed("label_fuse_sharded_cells", lambda: pl.label_fuse_sharded_cells(
            mesh, inp["cells_table"], dl, vs, *args[1:], HW, npts=n, nclasses=NCLASSES))
        res["label_cells_agree"] = float((got == one).float().mean())
        if r == 0:
            res["label_cells"] = got.cpu()
        res["k1_launches"] = hist.histogram_classify.launches - launches0
        res["k1_tiled"] = sorted(layouts)
        del one, got
    pl.histogram_classify = real_k1
    if "fusion" in parts:
        sess = [inp[k] for k in ("Ks", "quats_wxyz", "translations", "points_s", "normals_s",
                                 "colors_s", "valid_s")]
        kw = dict(height=int(inp["fusion_h"]), width=int(inp["fusion_w"]),
                  radius=FUSION_KW["radius"], max_depth=8.0,
                  min_cosine=float(np.cos(np.deg2rad(FUSION_KW["angle"]))))
        out = {}
        if r == 0 and "fusion_one" in parts:  # the one-device references
            out["one"] = timed("fuse_session one device", lambda: fe.fuse_session(
                *sess, **kw, capacity=PAR_CAPACITY, device=dev))
            out["one_split"] = timed("fuse_session one device, split window", lambda: (
                fe.fuse_session(*sess, **kw, capacity=PAR_CAPACITY,
                                window=ndev * PAR_WINDOW, window_policy="split", device=dev)))
        out["spatial"] = timed("fuse_session_spatial_sharded", lambda: (
            pf.fuse_session_spatial_sharded(mesh, *sess, **kw,
                                            capacity=PAR_CAPACITY // ndev)))
        if "split" in parts:
            out["split"] = timed("fuse_session_spatial_sharded, split window", lambda: (
                pf.fuse_session_spatial_sharded(mesh, *sess, **kw,
                                                capacity=PAR_CAPACITY // ndev,
                                                window=PAR_WINDOW, window_policy="split")))
        out["frames"] = timed("fuse_session_sharded", lambda: pf.fuse_session_sharded(
            mesh, *sess, **kw, capacity=PAR_CAPACITY, halo_frames=2))
        if r == 0:
            res["fusion"] = {k: {**fe.state_to_arrays(s), "uv2pt": u.cpu().numpy()}
                             for k, (s, u) in out.items()}
        del out
    if "train" in parts:
        images, labels = np.asarray(inp["images"]), np.asarray(inp["labels"])
        steps = len(images) // PAR_BATCH
        batches = [(images[i * PAR_BATCH:(i + 1) * PAR_BATCH],
                    labels[i * PAR_BATCH:(i + 1) * PAR_BATCH]) for i in range(steps)]
        b2 = SegFormerConfig.b2()
        model = SegFormer(b2, torch.Generator().manual_seed(0), param_dtype=torch.float32)
        with torch.no_grad():
            res["train_one_loss"] = float(sharding.segmenter_loss(
                model.to(dev), torch.from_numpy(batches[0][0]).to(dev),
                torch.from_numpy(batches[0][1]).to(dev), boundary_weight=2.0))
        del model
        meshes = {"dp": (ndev, 1)} if ndev == 1 else {"dp": (ndev, 1),
                                                         "default": sharding.mesh_shape(ndev)}
        res["train"] = {}
        for name, (dp, tp) in meshes.items():
            m = sharding.make_mesh(ndev, tp=tp, device_type=dev.type)
            rec = {"loss": [], "ms": [], "calls": [], "host_mb": []}
            mark = {}

            def on_step(it, loss, model, opt, ema):
                rec["loss"].append(float(loss))  # waits for the step
                sync()
                t = time.perf_counter()
                if mark:
                    rec["ms"].append(1e3 * (t - mark["t"]))
                    rec["calls"].append(comm.STATS["calls"] - mark["calls"])
                    rec["host_mb"].append((comm.STATS["host_bytes"] - mark["host"]) / 1e6)
                mark.update(t=t, calls=comm.STATS["calls"], host=comm.STATS["host_bytes"])

            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            cfg = tr.TrainConfig(model=b2, input_hw=PAR_TRAIN_HW, batch_size=PAR_BATCH,
                                 steps=steps, lr_schedule="constant", learning_rate=2e-4,
                                 boundary_weight=2.0, ema_decay=0.9, prefetch=0, seed=0)
            tr.train(cfg, dataset=iter(batches), verbose=False, on_step=on_step, mesh=m)
            rec["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if on_card else 0
            rec["shape"] = (dp, tp)
            res["train"][name] = rec
    return res


def _rebinned_n(one):
    """Occupied cells of the one-device cloud put through the frame-sharded
    engine's reconciling voxel merge: what that merge alone makes of it."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.ops import sparsify

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in one.items()
         if k != "uv2pt"}
    live = torch.arange(len(t["points"]), device=t["n"].device) < t["n"]
    m = sparsify.voxel_merge(t["points"], t["normals"], t["colors"], t["nmerges"],
                             t["occurences"], live, FUSION_KW["radius"],
                             float(np.cos(np.deg2rad(FUSION_KW["angle"]))))
    return int((m.counts > 0).sum())


def _fusion_bars(one, sh, gt):
    """(n ratio, p99 nearest distance one -> sharded, p99 sharded -> one,
    per-pixel label agreement through vote_and_classify on the masks gt)
    of a sharded engine's result against the one-device engine's."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.ops.voting import vote_and_classify

    n1, ns = int(one["n"]), int(sh["n"])
    p1 = torch.from_numpy(one["points"][:n1]).cuda()
    ps = torch.from_numpy(sh["points"][:ns]).cuda()

    def p99(x, y):
        d = torch.cat([torch.cdist(x[i:i + 2048], y).amin(1) for i in range(0, len(x), 2048)])
        return float(torch.quantile(d, 0.99))

    imgs = []
    for res, n in ((one, n1), (sh, ns)):
        uv = res["uv2pt"]
        _, c = vote_and_classify(uv, gt, npts=n, nclasses=NCLASSES, threshold=0.5,
                                 device="cuda")
        c = c.cpu().numpy()
        imgs.append(np.where(uv >= 0, c[np.clip(uv, 0, n - 1)], -1))
    both = (imgs[0] >= 0) & (imgs[1] >= 0)
    return ns / n1, p99(p1, ps), p99(ps, p1), float((imgs[0][both] == imgs[1][both]).mean())


def _state_diff(a, b):
    """(n and uv2pt equal, largest float difference over the live rows) of
    two fusion results."""
    import numpy as np

    n = int(a["n"])
    same = n == int(b["n"]) and np.array_equal(a["uv2pt"], b["uv2pt"]) and all(
        np.array_equal(a[k][:n], b[k][:n]) for k in ("nmerges", "occurences"))
    diff = max(float(np.abs(a[k][:n] - b[k][:n]).max()) if n else 0.0
               for k in ("points", "normals", "colors"))
    return same, diff


def parallel_phase(card):
    """Phase 14: the multi-device decompositions over `parallel/launch.py`
    ranks on the card. Returns K1's launches on the parallel path."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.io import synthetic
    from fusion3dseg_tpu_torch.io.rtab import SessionData
    from fusion3dseg_tpu_torch.io.workload import make_workload
    from fusion3dseg_tpu_torch.models.train import synthetic_dataset
    from fusion3dseg_tpu_torch.ops import label_fuse as lf
    from fusion3dseg_tpu_torch.parallel import launch
    from fusion3dseg_tpu_torch.parallel import label_fuse as pl

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="f3s_parallel_"))
    try:
        # ---- the inputs, made once on the host and read by every rank
        t0 = time.perf_counter()
        points, K, quats, trans, masks = make_workload(NPTS, NFRAMES, HW, seed=0)
        uv2pt = np.random.default_rng(0).integers(-1, NPTS, (NFRAMES, HW[0] * HW[1]),
                                                  dtype=np.int32)
        cells_table, cell_lists, counts = lf.build_cell_index(points, K, quats, trans, HW,
                                                              cell_size=128)
        arrays = dict(points=points, K=np.asarray(K), quats=quats, trans=trans, masks=masks,
                      uv2pt=uv2pt, npts=np.int64(NPTS), cells_table=cells_table)
        for nd in (1, 2):
            arrays[f"dev_lists_{nd}"], arrays[f"valid_{nd}"] = pl.plan_cell_shards(
                cells_table, cell_lists, counts, nd)
        nf, (sh, sw) = PAR_SESSION
        sess = synthetic.make_session(nframes=nf, depth_hw=(sh, sw))
        sd = SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                     sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                     device="cpu")
        valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
        for k, v in (("Ks", sd.Ks), ("quats_wxyz", sd.quats_wxyz),
                     ("translations", sd.translations), ("points_s", sd.points),
                     ("normals_s", sd.normals), ("colors_s", sd.colors), ("valid_s", valid)):
            arrays[k] = np.asarray(v)
        arrays.update(fusion_h=np.int64(sh), fusion_w=np.int64(sw))
        gt = sess.gt_mask.reshape(nf, -1)
        data = synthetic_dataset(PAR_TRAIN_HW, PAR_BATCH, seed=0, appearance="textured")
        batches = [next(data) for _ in range(PAR_TRAIN_STEPS)]
        data.close()
        arrays["images"] = np.concatenate([b[0] for b in batches])
        arrays["labels"] = np.concatenate([b[1] for b in batches])
        for k, v in arrays.items():
            np.save(work / f"{k}.npy", v)
        log(f"parallel: inputs ({NPTS} x {NFRAMES} workload, its cell index and shard plans, "
            f"the {nf}-frame {sh}x{sw} session, {PAR_TRAIN_STEPS} textured batches of {PAR_BATCH}) "
            f"made in {time.perf_counter() - t0:.2f} s (host), "
            f"{sum(v.nbytes for v in arrays.values()) / 1e6:.0f} MB")

        ncard = torch.cuda.device_count()
        every = ("vote", "label", "fusion", "fusion_one", "split", "train")
        worlds = [("one rank, NCCL", 1, "cuda", every),
                  ("two ranks on two cards, NCCL" if ncard >= 2 else
                   "two ranks sharing cuda:0, gloo", 2, "cuda", every),
                  ("two ranks on the CPU, gloo", 2, "cpu", ("fusion",))]
        runs, k1 = {}, 0
        for name, nranks, dtype, parts in worlds:
            t0 = time.perf_counter()
            try:
                res = launch.spawn(parallel_rank, nranks, (str(work), parts),
                                   device_type=dtype, timeout=PAR_TIMEOUT, verbose=True)
            except (RuntimeError, TimeoutError) as e:
                fail(f"parallel: {name}: {e}")
            runs[name] = res
            shared = dtype == "cuda" and res[0]["backend"] == "gloo"
            tag = " (ranks share one card: host-staged collectives, not scaling)" if shared \
                else ""
            where = card if dtype == "cuda" else "[the host's CPU, one thread a rank]"
            log(f"parallel: {name}: {nranks} rank(s) on "
                f"{[x['device'] for x in res]}, backend {res[0]['backend']}, "
                f"{time.perf_counter() - t0:.1f} s with start-up{tag}")
            if "gloo_cuda" in res[0]:
                log(f"parallel: {name}: gloo with CUDA tensors: {res[0]['gloo_cuda']}")
                refused = [k for k, v in res[0]["gloo_cuda"].items() if v is not True]
                if refused:
                    fail(f"parallel: gloo refuses {refused} for CUDA tensors: stage them "
                         "(parallel/comm.GLOO_CUDA_STAGED)")
            for x in res:
                bad = [k for k, v in x["ok"].items() if not v]
                if bad:
                    fail(f"parallel: {name}, rank {x['rank']}: {bad} differ from the one-device "
                         "call")
                for k in sorted(x["ms"]):
                    log(f"parallel: {name}, rank {x['rank']} {where}: {k} {x['ms'][k]:.2f} ms, "
                        f"{x['calls'][k]} collectives, {x['host_mb'][k]:.1f} MB through the "
                        f"host{tag}")
            if "label" in parts:
                for x in res:
                    if x["k1_launches"] != 6 or x["k1_tiled"] != [True]:
                        fail(f"parallel: rank {x['rank']} launched K1 {x['k1_launches']} times "
                             f"(want 6: three lifters, twice), rows aligned {x['k1_tiled']}")
                    k1 += x["k1_launches"]
                differ = sum(x["label_points_differ"] for x in res)
                agree_p = 1.0 - differ / NPTS
                agree_c = res[0]["label_cells_agree"]
                if nranks == 1:
                    cells_one = res[0]["label_cells"]
                    agree_r = 1.0
                else:
                    agree_r = float((res[0]["label_cells"] == cells_one).float().mean())
                log(f"parallel: {name}: label_fuse_sharded exact; label_fuse_sharded_points "
                    f"exactly its tie rule (least depth, rank-local id, rank), agreeing "
                    f"{agree_p:.6f} with the one-device lifter ({differ} points differ: ties "
                    f"of equal depth across ranks); label_fuse_sharded_cells agrees "
                    f"{agree_r:.6f} with one "
                    f"rank's (bar {AGREEMENT_BAR}) and {agree_c:.6f} with the one-device "
                    f"lifter (its ties go by gather slot: no bar); K1 launched "
                    f"{sum(x['k1_launches'] for x in res)} times, all on aligned rows (the "
                    "tiled kernel)")
                if agree_r < AGREEMENT_BAR:
                    fail("parallel: the cell-sharded lifter fell below its bar")
                if nranks == 1 and differ:
                    fail("parallel: one rank's point-sharded lifter is not exact")
            if "train" in parts:
                one = res[0]["train_one_loss"]
                for mname, rec in res[0]["train"].items():
                    rel = abs(rec["loss"][0] - one) / abs(one)
                    first, last = np.mean(rec["loss"][:3]), np.mean(rec["loss"][-3:])
                    peaks = [round(x["train"][mname]["peak_mib"], 1) for x in res]
                    log(f"parallel: {name}: train B2 bf16 {PAR_TRAIN_HW[0]}x{PAR_TRAIN_HW[1]}, "
                        f"global batch {PAR_BATCH}, mesh dp {rec['shape'][0]} x tp "
                        f"{rec['shape'][1]} {card}: {len(rec['loss'])} steps, "
                        f"{np.median(rec['ms']):.2f} ms a step (median after a synchronize, "
                        f"{min(rec['ms']):.2f}-{max(rec['ms']):.2f}), "
                        f"{int(np.median(rec['calls']))} collectives and "
                        f"{np.median(rec['host_mb']):.1f} MB through the host a step; peak "
                        f"memory per rank {peaks} MiB; loss {rec['loss'][0]:.4f} -> "
                        f"{rec['loss'][-1]:.4f}; step 1 vs one device {one:.4f}: relative "
                        f"{rel:.2e} (bar {PAR_LOSS_BAR}){tag}")
                    if not np.isfinite(rec["loss"]).all() or rel > PAR_LOSS_BAR \
                            or not last < first:
                        fail(f"parallel: {name}, mesh {mname}: the loss is off or did not "
                             f"descend: {rec['loss']}")
            if "fusion" in parts and dtype == "cuda":
                f = res[0]["fusion"]
                if nranks == 1:
                    for a, b in (("spatial", "one"), ("split", "one_split")):
                        same, diff = _state_diff(f[a], f[b])
                        if not same or diff:
                            fail(f"parallel: one rank's {a} engine is not fuse_session bit for "
                                 f"bit (max float difference {diff})")
                    log(f"parallel: {name}: one-rank spatially sharded fusion is fuse_session "
                        f"bit for bit (full merge n {int(f['one']['n'])}, split window n "
                        f"{int(f['one_split']['n'])})")
                else:
                    rebinned = _rebinned_n(f["one"])
                    for a, b, (lo, hi), ref in (("spatial", "one", PAR_N_SPATIAL, 1.000),
                                                ("frames", "one", PAR_N_FRAMES, 0.994),
                                                ("split", "one_split", (1.0, 10.0), None)):
                        ratio, p1s, ps1, agree = _fusion_bars(f[b], f[a], gt)
                        cov = max(p1s, ps1) if a != "frames" else p1s
                        n_bar, note = ratio, ", bar"
                        if a == "frames":  # its merge re-bins: held to the re-binned count
                            n_bar = int(f[a]["n"]) / rebinned
                            note = (f"; {n_bar:.4f} of the one-device cloud's {rebinned} "
                                    "cells after the same voxel merge, bar")
                        elif a == "split":  # merges missed past the window re-append
                            n_bar = int(f[a]["n"]) / int(f["spatial"]["n"])
                            note = (f"; {n_bar:.4f} of the sharded full merge's n, at least "
                                    "as many, bar")
                        log(f"parallel: {name}: {a}: n {int(f[a]['n'])} vs {int(f[b]['n'])} "
                            f"one-device ({ratio:.4f}{note} {lo}-{hi}); p99 nearest distance "
                            f"{p1s:.4f} / {ps1:.4f} m (bar {PAR_COVER_BAR:.4f}); label "
                            f"agreement {agree:.4f} (bar {PAR_AGREE_BAR}"
                            + (f"; the JAX dryrun read {ref:.3f}" if ref else "") + ")")
                        if not (lo <= n_bar <= hi) or cov >= PAR_COVER_BAR \
                                or agree <= PAR_AGREE_BAR:
                            fail(f"parallel: {a} fusion misses its bars")

        # the two-rank card run against the two-rank CPU run
        card2 = runs[worlds[1][0]][0]["fusion"]
        cpu2 = runs[worlds[2][0]][0]["fusion"]
        for k in ("spatial", "frames"):
            same, diff = _state_diff(card2[k], cpu2[k])
            log(f"parallel: {k}: two ranks on the card vs two on the CPU: n, counters and "
                f"uv2pt equal: {same}; largest float difference {diff:.3e}")
            if not same or diff:
                fail(f"parallel: the card's two-rank {k} engine differs from the CPU's")
        log(f"parallel: phase took {time.perf_counter() - t_phase:.1f} s; K1 launches on the "
            f"parallel path {k1}")
        return k1
    finally:
        shutil.rmtree(work, ignore_errors=True)


def bench_phase(card):
    """Phase 15: the port's bench (`tools/bench.py`) in-process at cut sizes,
    with every bar of the full run. Returns (K1's launches in the bench's
    timed runs, K1's rows on their winner matrices)."""
    import numpy as np
    import torch

    from fusion3dseg_tpu_torch.fusion import fusion as fe
    from fusion3dseg_tpu_torch.ops import histogram as hist
    from fusion3dseg_tpu_torch.tools import bench

    args = bench.parse_args(BENCH_ARGV)
    sizes = bench.FusionSizes(ref_frames=BENCH_REF_FRAMES)
    hist.histogram_classify.launches = 0  # count the bench's launches only
    t0 = time.perf_counter()
    result, outputs = bench.run(args, sizes=sizes)
    wall = time.perf_counter() - t0
    log(f"bench {card}: {json.dumps(result)}")
    log(f"bench: cut from the full run (python -m fusion3dseg_tpu_torch.tools.bench): headline "
        f"{args.npts} x {args.frames}, config 5 {args.tenm_npts} x {args.tenm_frames} (nsub "
        f"{result['tenm_nsub']}), the reference resolution on {sizes.ref_frames} frames; "
        f"{wall:.1f} s")
    for text in result.get("failed_bars", []):
        fail(f"bench: {text}")
    launches = result["k1_launches"]
    want = (1 + args.repeat) + (1 + 2)  # warm-up and timed runs of the headline and config 5
    if launches != want or hist.histogram_classify.launches < launches:
        fail(f"bench: K1 launched {launches} times in its timed runs (want {want})")
    for key, n in (("headline", args.npts), ("10m", args.tenm_npts)):
        c = outputs[key]["classes"]
        if c.shape != (n,) or int(c.min()) < 0 or int(c.max()) > args.nclasses:
            fail(f"bench {key}: classes of shape {c.shape} in [{c.min()}, {c.max()}]")
    for row in result["k1_rows"]:
        log(f"bench: K1 {row['shape']} {card}: {row['kernel']} kernel {row['ms']:.4f} ms (in a "
            f"CUDA graph), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{100 * row['share_of_bound']:.1f}% of bound; plain version {row['plain_ms']:.3f} ms; "
            f"max abs err {row['max_abs_err']}")

    # the card's classes against the port's lifter on the CPU: the same
    # workload and cell index (both cached by the run above), bit for bit
    hw = (args.height, args.width)
    tenm_cs = max(args.cell_size, 256)  # config5_10m's
    for key, npts, frames, cs, cache in (
            ("headline", args.npts, args.frames, args.cell_size, None),
            ("10m", args.tenm_npts, args.tenm_frames, tenm_cs,
             bench.cells_cache(args.tenm_npts, args.tenm_frames, hw, tenm_cs))):
        t0 = time.perf_counter()
        build, cpu_args, _, _ = bench.cells_run(npts, args.nclasses, hw,
                                                *bench.cached_workload(npts, frames, hw), cs,
                                                torch.device("cpu"), cache)
        cpu_classes = build()(*cpu_args)[1].numpy()
        same = np.array_equal(outputs[key]["classes"], cpu_classes)
        log(f"bench {key}: {npts} x {frames} classes on the card equal to the port's lifter on "
            f"the CPU ({time.perf_counter() - t0:.1f} s) bit for bit: {same}")
        if not same:
            fail(f"bench {key}: the card's classes differ from the CPU's at "
                 f"{int(np.count_nonzero(outputs[key]['classes'] != cpu_classes))} points")

    # the reference-resolution state on the card against the port on the CPU
    state, uv2pt = outputs["fusion/e2e"]["ref_res"]
    hw = sizes.ref_hw
    _, _, rargs = bench.fusion_session(sizes.ref_frames, hw, "cpu")
    t0 = time.perf_counter()
    st_cpu, uv_cpu = fe.fuse_session(*rargs, **bench.engine_kw(hw, 1 << 18, 1 << 14, "cpu"))
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(a.cpu(), b) for a, b in zip(state, st_cpu)) and \
        torch.equal(uv2pt.cpu(), uv_cpu)
    n = int(state.n)
    log(f"bench: {hw[0]}x{hw[1]} engine, {sizes.ref_frames} frames, capacity 2^18: n {n} "
        f"({int(np.count_nonzero(uv2pt.cpu().numpy() >= 0))} pixels mapped); state and uv2pt "
        f"equal to the port on the CPU ({cpu_s:.1f} s) bit for bit: {same}")
    if not same or not 0 < n <= 1 << 18 or not bool(torch.isfinite(state.points[:n]).all()):
        fail(f"bench: the {hw[0]}x{hw[1]} engine state differs from the CPU's or is broken "
             f"(n {n}, equal {same})")
    return launches, result["k1_rows"]


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
            if any(w in line for w in ("registers", "Compiling entry", "spill",
                                       "Performance Loss")):
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
    if "soak" in phases:
        soak_phase(card)
    if "loop" in phases:
        n = loop_phase(card)
        for entry in kernels:
            if entry["name"] == "sr_attention":
                entry["launches"] += n
    vga = None
    if "fusion" in phases:
        n, vga, match = fusion_phase(card, session, seg)
        kernels.append(match)
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
    if "parallel" in phases:
        n = parallel_phase(card)  # K1 in every rank's sharded label lifters
        for entry in kernels:
            if entry["name"] == "histogram_classify":
                entry["launches"] += n
    if "bench" in phases:
        n, rows = bench_phase(card)
        rows = [dict(row, shape=f"{row['shape']} {row['kernel']} kernel, bench", library_ms=None)
                for row in rows]
        entry = next((e for e in kernels if e["name"] == "histogram_classify"), None)
        if entry is None:  # without phase 3: the bench's last row is the entry's own
            entry = dict(K1_ENTRY, launches=0, **rows[-1], other_shapes=[])
            kernels.append(entry)
        entry["launches"] += n
        entry["max_abs_err"] = max(entry["max_abs_err"], *(row["max_abs_err"] for row in rows))
        entry["other_shapes"] += rows
    log(f"phases {phases} took {time.perf_counter() - t_start:.1f} s")
    log(f"K3 launches by kernel in the counted main-path runs: {json.dumps(K3_ROUTES)}")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    result = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}
    if phases != ALL_PHASES:
        result["phases"] = phases  # a partial run says so
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
