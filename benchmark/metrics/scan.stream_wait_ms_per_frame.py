"""Segmenter: the host's waits on the card inside the "stream" stage
("stream.wait" of `FastSegmentation.stage_seconds`: uv2pt to the host and
back, the votes and classes read, the cloud's read), per frame, mean over
the window's sessions. None where the program records no such key."""


def read(rec):
    ms = [1e3 * r["stages"]["stream.wait"] / r["frames"] for r in rec["requests"]
          if "stream.wait" in r["stages"]]
    return sum(ms) / len(ms) if ms else None
