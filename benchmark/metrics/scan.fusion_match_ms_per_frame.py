"""Fusion engine: the device time of the engine's pixel-match kernel
(`match_pixels_kernel`, one launch a frame step) in the traced session, per
frame, in ms. Read only where its launches number the program's count of
frames matched by the kernel in that session ("fuse_match.kernel_frames");
where they do not (the kernel serves other calls, or fewer ran), or where
the program counts no such frame, None."""

import sys

from f3sbench import trace

KERNELS = ("match_pixels_kernel",)
KEY = "fuse_match.kernel_frames"


def read(rec):
    t = rec["trace"]
    frames = (t or {}).get("work", {}).get("stages", {}).get(KEY)
    if not frames:
        return None
    seconds, names = trace.kernel_seconds(t, KERNELS)
    launches = sum(t["kernels"][n][0] for n in names)
    print(f"scan.fusion_match_ms_per_frame: kernels matched {names}, {launches} launches",
          file=sys.stderr)
    if launches != frames:
        print(f"scan.fusion_match_ms_per_frame: {launches} launches against {frames:g} frames: "
              f"not read", file=sys.stderr)
        return None
    return 1e3 * seconds / t["work"]["frames"]
