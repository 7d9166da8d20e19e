"""Model: the Mask2Former's share of the card's bfloat16 peak: its forward
FLOPs, counted from its shapes (2 per multiply-add, `f3sbench/m2f_counts`),
for every frame of the window, over the seconds of the segmenter's own
stage ("stream" of `FastSegmentation.stage_seconds`: the model over every
frame, the confidence rule, the resize and the vote) and 989 TFLOP/s, in %.
The fusion engine's time is left out. Read only where the program's count
of images forwarded ("m2f.images") equals the window's frames; None
without a Mask2Former or that count."""

import sys

from f3sbench import counts, m2f_counts


def read(rec):
    seg = rec["config"].get("segmenter")
    reqs = [r for r in rec["requests"] if "stream" in r["stages"]]
    if not seg or not seg["model"].startswith("mask2former") or not reqs:
        return None
    frames = sum(r["frames"] for r in reqs)
    images = sum(r["stages"].get("m2f.images", 0.0) for r in reqs)
    if images != frames:
        print(f"scan.m2f_mfu: {images} images forwarded against {frames} frames: not read",
              file=sys.stderr)
        return None
    seconds = sum(r["stages"]["stream"] for r in reqs)
    flops = m2f_counts.mask2former_flops(seg, seg["input_hw"]) * frames
    return 100.0 * flops / (seconds * counts.BF16_FLOPS)
