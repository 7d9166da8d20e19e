"""The whole request's share of the card's bfloat16 peak: the segmenter's
forward FLOPs, counted from its shapes (2 per multiply-add), for every frame
of the window, over the window's seconds and 989 TFLOP/s, in %. It bounds
what a kernel's roofline can claim: the fusion engine's arithmetic is left
out of the FLOPs and kept in the time."""

from f3sbench import counts


def read(rec):
    seg = rec["config"].get("segmenter")
    if not seg or not rec["requests"]:
        return None
    frames = sum(r["frames"] for r in rec["requests"])
    flops = counts.segformer_flops(seg, seg["input_hw"]) * frames
    return 100.0 * flops / (rec["window_s"] * counts.BF16_FLOPS)
