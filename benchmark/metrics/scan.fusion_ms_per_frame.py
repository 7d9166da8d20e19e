"""Fusion engine: device fusion and voting ("fuse_vote", or "fuse" with a
segmenter) per frame, from `FastSegmentation.stage_seconds`, mean over the
window's sessions. The stage ends where the host first reads the device,
so it also holds the wait for `SessionData.from_arrays`' device work."""


def read(rec):
    ms = [1e3 * r["stages"].get("fuse_vote", r["stages"].get("fuse", 0.0)) / r["frames"]
          for r in rec["requests"]]
    return sum(ms) / len(ms) if ms else None
