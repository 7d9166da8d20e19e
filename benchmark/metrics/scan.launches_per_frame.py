"""Host dispatch: kernels launched in the traced session, per frame."""


def read(rec):
    t = rec["trace"]
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["work"]["frames"]
