"""Device: the share of the traced relabel call in which nothing ran on the card
(1 - union of kernel, copy and fill intervals / window), in %. The profiler
slows the host and not the card, so this reads above an untraced run;
`relabel.busy_ms_per_frame` is its reading that the profiler leaves alone."""


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
