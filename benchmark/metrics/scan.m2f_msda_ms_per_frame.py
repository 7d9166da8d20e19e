"""Pixel decoder: the device time of the deformable attention's sampling
kernels (`grid_sample`'s, one launch a level of each call of
`models/mask2former.msda_core`) in the traced session, per frame, in ms.
Read only where their launches number the program's count of deformable
calls in that session ("m2f.msda_calls") times the levels; where they do
not (the kernels serve other calls, or fewer ran), or where the program
counts no such call, None."""

import sys

from f3sbench import m2f_counts, trace

KERNELS = ("grid_sampler_2d",)


def read(rec):
    t = rec["trace"]
    calls = (t or {}).get("work", {}).get("stages", {}).get("m2f.msda_calls")
    if not calls:
        return None
    seconds, names = trace.kernel_seconds(t, KERNELS)
    launches = sum(t["kernels"][n][0] for n in names)
    want = m2f_counts.MSDA_LEVELS * calls
    print(f"scan.m2f_msda_ms_per_frame: kernels matched {names}, {launches} launches",
          file=sys.stderr)
    if launches != want:
        print(f"scan.m2f_msda_ms_per_frame: {launches} launches against {want:g} samplings: "
              f"not read", file=sys.stderr)
        return None
    return 1e3 * seconds / t["work"]["frames"]
