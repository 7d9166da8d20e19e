"""Label lifter's dispatch: kernels launched in the traced relabel call,
per frame of the trajectory."""


def read(rec):
    t = rec["trace"]
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["work"]["frames"]
