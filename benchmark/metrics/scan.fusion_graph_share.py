"""Host dispatch: the share of a session's frames that the fusion engine
replayed from a CUDA graph, in percent: the count "fuse_graph.frames" of
`FastSegmentation.stage_seconds` over the session's frames, mean over the
window's sessions. The seed frame runs eagerly, so a session of F frames
reads at most 100 (F - 1) / F. None where the program records no such key."""

KEY = "fuse_graph.frames"


def read(rec):
    shares = [100.0 * r["stages"][KEY] / r["frames"] for r in rec["requests"]
              if KEY in r.get("stages", {})]
    return sum(shares) / len(shares) if shares else None
