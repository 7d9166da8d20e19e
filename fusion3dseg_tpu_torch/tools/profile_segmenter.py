"""Where the time of the 2D segmenter goes on the card.

    python -m fusion3dseg_tpu_torch.tools.profile_segmenter [--plain] [--nat]

Loads the shipped SegFormer-B2 checkpoint (bfloat16, 256x256 input) with the
fused spatial-reduction attention kernel on, makes a textured synthetic
session of 16 frames at 96x72, warms up, and runs `predict_batch` over the
session (two batches of 8) under `torch.profiler`. `--plain` runs the
attention kernels' plain PyTorch versions instead; `--nat` gives the first
stage a 7x7 neighbourhood attention (weights from a seed). Prints the wall
time, the summed device time of the kernels, the device's busy share and
the kernels by device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from fusion3dseg_tpu_torch.io import synthetic
from fusion3dseg_tpu_torch.models import SegFormerConfig
from fusion3dseg_tpu_torch.models.convert import shipped_checkpoint
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from fusion3dseg_tpu_torch.tools.profiling import profile_run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="run the attention kernels' plain PyTorch versions")
    ap.add_argument("--nat", action="store_true",
                    help="neighbourhood attention (window 7) in the first stage, seeded weights")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nframes, batch = 16, 8
    frames = synthetic.make_session(
        nframes=nframes, depth_hw=(96, 72), appearance="textured",
        room=synthetic.RoomSpec(seed=(1 << 30) + 990_000)).colors
    if args.nat:
        cfg = dataclasses.replace(SegFormerConfig.b2(), nat_windows=(7, 0, 0, 0))
        seg = Segmenter2D(cfg, input_hw=(256, 256), batch_size=batch, device="cuda",
                          use_cuda_attention=not args.plain)
    else:
        cfg = dataclasses.replace(SegFormerConfig.b2(), use_pallas_attention=True)
        seg = Segmenter2D(cfg, shipped_checkpoint("b2"), batch_size=batch, device="cuda",
                          use_cuda_attention=not args.plain)

    def run():
        for i in range(0, nframes, batch):
            seg.predict_batch(frames[i:i + batch])

    run()
    torch.cuda.synchronize()
    profile_run(run, f"SegFormer-B2 {'nat ' if args.nat else ''}"
                     f"{'plain attention' if args.plain else 'attention kernels'}, "
                     f"{nframes} frames in batches of {batch}")


if __name__ == "__main__":
    main()
