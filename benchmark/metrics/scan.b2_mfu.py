"""Model: the segmenter's share of the card's bfloat16 peak: SegFormer's
forward FLOPs, counted from its shapes (2 per multiply-add), for every frame
of the window, over the seconds of the segmenter's own stage ("stream" of
`FastSegmentation.stage_seconds`: the model over every frame, the confidence
rule, the resize and the vote) and 989 TFLOP/s, in %. The fusion engine's
time is left out."""

from f3sbench import counts


def read(rec):
    seg = rec["config"].get("segmenter")
    reqs = [r for r in rec["requests"] if "stream" in r["stages"]]
    if not seg or not reqs:
        return None
    frames = sum(r["frames"] for r in reqs)
    seconds = sum(r["stages"]["stream"] for r in reqs)
    flops = counts.segformer_flops(seg, seg["input_hw"]) * frames
    return 100.0 * flops / (seconds * counts.BF16_FLOPS)
