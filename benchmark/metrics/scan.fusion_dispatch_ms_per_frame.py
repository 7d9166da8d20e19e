"""Host dispatch: the fusion stage less the host's waits on the card
("fuse_vote.dispatch", or "fuse.dispatch" with a segmenter, of
`FastSegmentation.stage_seconds`): the host issuing the engine's and the
vote's work and computing, per frame, mean over the window's sessions.
None where the program records no such key."""

KEYS = ("fuse_vote.dispatch", "fuse.dispatch")


def read(rec):
    ms = [1e3 * r["stages"][k] / r["frames"] for r in rec["requests"]
          for k in KEYS if k in r["stages"]]
    return sum(ms) / len(ms) if ms else None
