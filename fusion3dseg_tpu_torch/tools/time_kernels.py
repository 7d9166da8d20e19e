"""Times of kernels K1, K2 and K3 at the kernel table's shapes, for any
checkout of the port, so that two commits can be timed in one process run
after the other on one card.

    python fusion3dseg_tpu_torch/tools/time_kernels.py [--root DIR]

`--root` names the checkout whose `fusion3dseg_tpu_torch` is imported
(default: the one this file lies in); it uses only what every version of
the port has (`histogram_classify`, `neighborhood_attention`,
`sr_attention`). K1: [300, 1M]
uint8, rows 1,000,064 bytes apart (16-byte aligned) and 1,000,001 bytes
apart; 133 classes with 85% and 10% of entries invalid, then 254 and 20
classes (the counters decide how many blocks an SM holds). K2:
[8, 64*64, 1, 64] window 7 in bfloat16 and float32. K3 in bfloat16 at
`K3_SHAPES`: SegFormer-B2's calls at 256x256, 512x512 and 1024x1024
(batch 8) and [2,16384,1,64]x[2,256,1,64]; a checkout whose K3 raises at a
shape says so. `--kernels k3` times K3 alone. `wide` times both kernels
past D = 128 at `WIDE_K3` and `WIDE_K2` (the shapes of B2 re-headed to
num_heads=(1,1,1,2)) and the float32 kernels at the narrow yardsticks (B2's
two 256x256 calls, [8,1024,1,128]x256; K2 at [8,64*64,1,64]), each beside
`scaled_dot_product_attention` (masked to the window for K2) on the same
inputs, saying which is faster, and K2's rows beside its plain version
(`neighborhood_attention_reference`, between CUDA events around single
calls after a warm-up), and `b2wide` that model's
predict_batch frames/s at 512x512 (the shipped checkpoint, K3 on, batch 8).
Each kernel runs 20 times inside one CUDA graph, replayed 5 times between
two CUDA events. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as nnf


def _own_profiling():
    """This checkout's `tools/profiling.py`, loaded by its path: importing
    the package here would shadow the `--root` checkout's."""
    spec = importlib.util.spec_from_file_location(
        "_time_kernels_profiling", Path(__file__).resolve().with_name("profiling.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_profiling = _own_profiling()
card_line, event_ms = _profiling.card_line, _profiling.event_ms
graph_ms = functools.partial(_profiling.graph_ms, iters=20)

# K3's timed shapes (B, N, H, M) at D = 64: SegFormer-B2's calls at batch 8,
# stages 0 and 1 at 256x256, stages 0-2 at 512x512, stages 0-3 at
# 1024x1024; and stage 0 at 512x512 at batch 2
K3_SHAPES = ((8, 4096, 1, 64), (8, 1024, 2, 64), (2, 16384, 1, 256),
             (8, 16384, 1, 256), (8, 4096, 2, 256), (8, 1024, 5, 256),
             (8, 65536, 1, 1024), (8, 16384, 2, 1024), (8, 4096, 5, 1024), (8, 1024, 8, 1024))


# past D = 128, and float32 at the narrow yardsticks: K3 (B, N, H, D, M,
# dtype) and K2 (B, h, w, D, window, dtype)
WIDE_K3 = ((8, 4096, 1, 256, 64, "bf16"), (8, 1024, 2, 160, 256, "bf16"),
           (8, 1024, 2, 192, 256, "bf16"), (8, 1024, 1, 320, 256, "bf16"),
           (8, 4096, 1, 320, 64, "bf16"), (8, 1024, 1, 320, 256, "f32"),
           (8, 4096, 1, 64, 64, "f32"), (8, 1024, 2, 64, 64, "f32"),
           (8, 1024, 1, 128, 256, "f32"))
WIDE_K2 = ((8, 16, 16, 320, 7, "bf16"), (8, 16, 16, 256, 7, "bf16"), (8, 32, 32, 320, 7, "bf16"),
           (8, 16, 16, 320, 7, "f32"), (8, 64, 64, 64, 7, "f32"))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _versus(ms, lib_ms):
    """The kernel against the library call, as a factor."""
    return (f"the kernel {lib_ms / ms:.2f}x faster" if ms < lib_ms
            else f"the kernel {ms / lib_ms:.2f}x slower")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose fusion3dseg_tpu_torch is timed")
    ap.add_argument("--kernels", default="k1,k2,k3",
                    help="comma-separated subset of k1,k2,k3,wide,b2wide")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, root)
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.ops import histogram as hist

    print(f"card: {card_line()}; package: {Path(hist.__file__).resolve().parents[2]}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    F, N = 300, 1_000_000
    for pitch in (1_000_064, 1_000_001) if "k1" in kernels else ():
        for nclasses, share in ((133, 0.85), (133, 0.10), (254, 0.85), (20, 0.85)):
            C = torch.randint(0, nclasses + 1, (F, pitch), device=dev, dtype=torch.int32,
                              generator=gen)
            C = torch.where(torch.rand((F, pitch), device=dev, generator=gen) < share, 255, C)
            C = C.to(torch.uint8)[:, :N]
            ms = graph_ms(lambda: hist.histogram_classify(C, nclasses, 0.5))
            print(f"K1 histogram_classify [{F}, {N}] pitch {pitch}, {nclasses} classes, "
                  f"{round(100 * share)}% invalid: {ms:.4f} ms")
            del C
    for dtype in (torch.bfloat16, torch.float32) if "k2" in kernels else ():
        q, k, v = (torch.randn((8, 64 * 64, 1, 64), device=dev, generator=gen).to(dtype)
                   for _ in range(3))
        ms = graph_ms(lambda: attn.neighborhood_attention(q, k, v, 64, 64, 7))
        print(f"K2 neighborhood_attention [8,64*64,1,64] window 7 {dtype}: {ms:.4f} ms")
    for B, N, H, M in K3_SHAPES if "k3" in kernels else ():
        q, k, v = (torch.randn(s, device=dev, generator=gen).bfloat16()
                   for s in ((B, N, H, 64), (B, M, H, 64), (B, M, H, 64)))
        try:  # a checkout whose K3 does not take this M raises
            ms = f"{graph_ms(lambda: attn.sr_attention(q, k, v)):.4f} ms"
        except RuntimeError as e:
            ms = f"raises ({e})"
        print(f"K3 sr_attention [{B},{N},{H},64]x[{B},{M},{H},64] bf16: {ms}")
    for B, N, H, D, M, dt in WIDE_K3 if "wide" in kernels else ():
        q, k, v = (torch.randn(s, device=dev, generator=gen).to(DTYPES[dt])
                   for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = graph_ms(lambda: attn.sr_attention(q, k, v))
        lib = graph_ms(lambda: nnf.scaled_dot_product_attention(qt, kt, vt))
        print(f"K3 sr_attention [{B},{N},{H},{D}]x[{B},{M},{H},{D}] {dt}: {ms:.4f} ms; "
              f"scaled_dot_product_attention {lib:.4f} ms: {_versus(ms, lib)}")
    for B, h, w, D, window, dt in WIDE_K2 if "wide" in kernels else ():
        q, k, v = (torch.randn((B, h * w, 1, D), device=dev, generator=gen).to(DTYPES[dt])
                   for _ in range(3))
        r = window // 2
        iy, ix = torch.arange(h, device=dev), torch.arange(w, device=dev)
        mask = (((iy[:, None] - iy[None, :]).abs() <= r)[:, None, :, None]
                & ((ix[:, None] - ix[None, :]).abs() <= r)[None, :, None, :]).reshape(h * w, h * w)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = graph_ms(lambda: attn.neighborhood_attention(q, k, v, h, w, window))
        lib = graph_ms(lambda: nnf.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        plain = event_ms(lambda: attn.neighborhood_attention_reference(q, k, v, h, w, window))
        print(f"K2 neighborhood_attention [{B},{h}*{w},1,{D}] window {window} {dt}: {ms:.4f} ms; "
              f"masked scaled_dot_product_attention {lib:.4f} ms: {_versus(ms, lib)}; "
              f"plain version {plain:.4f} ms")
    if "b2wide" in kernels:
        from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
        from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

        cfg = dataclasses.replace(SegFormerConfig.b2(), use_pallas_attention=True,
                                  num_heads=(1, 1, 1, 2))
        seg = Segmenter2D(cfg, convert.shipped_checkpoint("b2"), input_hw=(512, 512),
                          batch_size=8, device="cuda")
        frames = torch.randint(0, 256, (16, 96, 72, 3), generator=torch.Generator().manual_seed(0),
                               dtype=torch.uint8).numpy()
        best = float("inf")
        for _ in range(4):  # the first is the warm-up
            t0 = time.perf_counter()
            for i in range(0, 16, 8):
                seg.predict_batch(frames[i:i + 8], 0.017)  # ends in a copy to the host
            best = min(best, time.perf_counter() - t0)
        print(f"B2 num_heads=(1,1,1,2) predict_batch at 512x512, batch 8: "
              f"{16 / best:.1f} frames/s (best of 3 runs of 16 frames)")


if __name__ == "__main__":
    main()
