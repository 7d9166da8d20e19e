"""What bounds kernels K1, K2 and K3 on the card: each timed whole, with
its loads left out and with its arithmetic left out.

    python -m fusion3dseg_tpu_torch.tools.kernel_parts

Builds `csrc/histogram.cu`, `csrc/neighborhood_attention.cu` and
`csrc/sr_attention.cu` three times (`F3S_PARTS` unset, 1 and 2) and times
every variant at the shapes of the kernel table: K1 at [300, 1M] uint8, 133
classes, the label lifter's row pitch, 85% and 10% of entries invalid; K2
at [8, 64*64, 1, 64] and [2, 128*128, 1, 64], and past D = 128 (the strip
kernels) at [8, 16*16, 1, 320] and [8, 32*32, 1, 320], window 7, bfloat16,
and at [8, 16*16, 1, 320] in float32 (its loads: K, V and q's staging; its
arithmetic: both products); K3's two bfloat16 kernels (wgmma and, where its
shared memory holds the keys, mma.sync, each named through
`launch_sr_attention`) at `K3_SHAPES` (B2's calls at 256x256, 512x512 and
1024x1024), and its float32 tile kernel at `F32_K3` (B2's two 256x256 calls,
[8,1024,1,128]x256 and [8,1024,1,320]x256). Each variant runs 20 times inside
one CUDA graph, replayed 5 times between two CUDA events. The variants with
a part left out compute wrong results by design; only their times count.
`--kernels k3` times one kernel alone. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.ops import attention as attn
from fusion3dseg_tpu_torch.ops import histogram as hist
from fusion3dseg_tpu_torch.tools.profiling import card_line
from fusion3dseg_tpu_torch.tools.time_kernels import K3_SHAPES, graph_ms

# float32 K3 (B, N, H, D, M)
F32_K3 = ((8, 4096, 1, 64, 64), (8, 1024, 2, 64, 64), (8, 1024, 1, 128, 256),
          (8, 1024, 1, 320, 256))
VARIANTS = (("whole", ()), ("loads left out", ("F3S_PARTS=1",)),
            ("arithmetic left out", ("F3S_PARTS=2",)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="k1,k2,k3", help="comma-separated subset of k1,k2,k3")
    kernels = set(ap.parse_args(argv).kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"card: {card_line()}")

    F, N, nclasses = 300, 1_000_000, 133
    pitch = hist.row_pitch(N + 1)
    cases = []
    for share in (0.85, 0.10) if "k1" in kernels else ():
        C = torch.randint(0, nclasses + 1, (F, pitch), device=dev, dtype=torch.int32,
                          generator=gen)
        C = torch.where(torch.rand((F, pitch), device=dev, generator=gen) < share, 255, C)
        C = C.to(torch.uint8)[:, :N]
        cases.append((f"K1 histogram_classify [{F}, {N}] pitch {pitch}, "
                      f"{round(100 * share)}% invalid", "histogram",
                      lambda C=C: hist.histogram_classify(C, nclasses, 0.5)))
    for B, h, w, D, dt in ((8, 64, 64, 64, "bf16"), (2, 128, 128, 64, "bf16"),
                           (8, 16, 16, 320, "bf16"), (8, 32, 32, 320, "bf16"),
                           (8, 16, 16, 320, "f32")) if "k2" in kernels else ():
        q, k, v = (torch.randn((B, h * w, 1, D), device=dev, generator=gen).to(
            torch.bfloat16 if dt == "bf16" else torch.float32) for _ in range(3))
        cases.append((f"K2 neighborhood_attention [{B},{h}*{w},1,{D}] window 7 {dt}",
                      "neighborhood_attention",
                      lambda q=q, k=k, v=v, h=h, w=w: attn.neighborhood_attention(q, k, v, h, w, 7)))
    for B, N, H, M in K3_SHAPES if "k3" in kernels else ():
        q, k, v = (torch.randn(s, device=dev, generator=gen).bfloat16()
                   for s in ((B, N, H, 64), (B, M, H, 64), (B, M, H, 64)))
        for route in ("wgmma", "mma") if attn._mma_fits(M, 64) else ("wgmma",):
            cases.append((f"K3 sr_attention ({route}) [{B},{N},{H},64]x[{B},{M},{H},64] bf16",
                          "sr_attention",
                          lambda q=q, k=k, v=v, r=route: attn.launch_sr_attention(q, k, v, r)))
    for B, N, H, D, M in F32_K3 if "k3" in kernels else ():
        q, k, v = (torch.randn(s, device=dev, generator=gen)
                   for s in ((B, N, H, D), (B, M, H, D), (B, M, H, D)))
        cases.append((f"K3 sr_attention (f32 tile) [{B},{N},{H},{D}]x[{B},{M},{H},{D}] f32",
                      "sr_attention", lambda q=q, k=k, v=v: attn.sr_attention(q, k, v)))
    for title, lib, fn in cases:
        times = []
        for _, defines in VARIANTS:
            with cuda.use_variant(lib, defines):
                times.append(graph_ms(fn))
        print(f"{title}: " + ", ".join(f"{name} {ms:.4f} ms"
                                       for (name, _), ms in zip(VARIANTS, times)))


if __name__ == "__main__":
    main()
