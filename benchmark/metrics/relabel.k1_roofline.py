"""Kernel K1 (`ops/histogram.histogram_classify` -> `csrc/histogram.cu`):
the least time of the traced call's classification, its bytes (F * N read,
12 * N written) at the card's HBM rate, over the device time of the kernels
named below, in %. None when none of them ran."""

import sys

from f3sbench import counts, trace

KERNELS = ("hist_tiled_kernel", "hist_bytes_kernel")


def read(rec):
    t = rec["trace"]
    if not t:
        return None
    seconds, names = trace.kernel_seconds(t, KERNELS)
    print(f"relabel.k1_roofline: kernels matched {names}", file=sys.stderr)
    if not names or seconds <= 0:
        return None
    w = t["work"]
    return 100.0 * counts.k1_bound_s(w["frames"], w["npts"]) / seconds
