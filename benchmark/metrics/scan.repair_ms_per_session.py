"""Overflow repair (`dedup_and_revote` / `dedup_state`) and the copy of the
cloud and classes to the host: the "repair" stage of
`FastSegmentation.stage_seconds`, mean over the window's sessions."""


def read(rec):
    ms = [1e3 * r["stages"]["repair"] for r in rec["requests"] if "repair" in r["stages"]]
    return sum(ms) / len(ms) if ms else None
