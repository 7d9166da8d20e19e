"""The whole request's share of the card's bfloat16 peak in a Mask2Former
cell: the model's forward FLOPs, counted from its shapes (2 per
multiply-add, `f3sbench/m2f_counts`), for every frame of the window, over
the window's seconds and 989 TFLOP/s, in %. It bounds what a kernel's
roofline can claim in the cell: the fusion engine's arithmetic is left out
of the FLOPs and kept in the time. Read only where the program's count of
images forwarded ("m2f.images") equals the window's frames."""

import sys

from f3sbench import counts, m2f_counts


def read(rec):
    seg = rec["config"].get("segmenter")
    if not seg or not seg["model"].startswith("mask2former") or not rec["requests"]:
        return None
    frames = sum(r["frames"] for r in rec["requests"])
    images = sum(r.get("stages", {}).get("m2f.images", 0.0) for r in rec["requests"])
    if images != frames:
        print(f"scan.m2f_step_mfu: {images} images forwarded against {frames} frames: not read",
              file=sys.stderr)
        return None
    flops = m2f_counts.mask2former_flops(seg, seg["input_hw"]) * frames
    return 100.0 * flops / (rec["window_s"] * counts.BF16_FLOPS)
