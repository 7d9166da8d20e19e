"""Device: the milliseconds in which something ran on the card (the union
of kernel, copy and fill intervals) in the traced relabel call, per frame. The
profiler slows the host, not the card, so this reads as it would untraced,
where the idle share does not."""


def read(rec):
    t = rec["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["work"]["frames"]
