"""Fusion engine: the host's waits on the card inside the fusion stage
("fuse_vote.wait", or "fuse.wait" with a segmenter, of
`FastSegmentation.stage_seconds`: the seed frame's count, the uploads, the
span telemetry's read), per frame, mean over the window's sessions. None
where the program records no such key."""

KEYS = ("fuse_vote.wait", "fuse.wait")


def read(rec):
    ms = [1e3 * r["stages"][k] / r["frames"] for r in rec["requests"]
          for k in KEYS if k in r["stages"]]
    return sum(ms) / len(ms) if ms else None
