"""Segmenter: the "stream" stage of `FastSegmentation.stage_seconds`
(`stream_segment`: the model over every frame in batches, the confidence
rule, the resize to depth resolution and the vote), per frame, mean over
the window's sessions."""


def read(rec):
    ms = [1e3 * r["stages"]["stream"] / r["frames"] for r in rec["requests"]
          if "stream" in r["stages"]]
    return sum(ms) / len(ms) if ms else None
