"""Label lifter: the 90th percentile of the seconds of every relabel call in
the window (mask upload, lift, classes on the host), by the host's clock."""

import statistics


def read(rec):
    s = [r["end"] - r["start"] for r in rec["requests"]]
    if len(s) < 10:
        return None
    return statistics.quantiles(s, n=10)[-1]
