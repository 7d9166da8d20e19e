"""Kernel K3 (`ops/attention.sr_attention` -> `csrc/sr_attention.cu`): the
least time of the traced session's fused attention calls (each call's
bound from its shapes: Q, K, V and O once at the HBM rate, or 4 N M D
products at the bfloat16 peak) over the device time of the kernels named
below, in %.

The calls counted are those that the configuration's
`use_pallas_attention` sends to the fused kernel (the stages whose token
count is a multiple of 512). The bound and the time cover the same calls
only while the traced launches of those kernels number exactly these
calls; where they do not (the kernel serves other calls, or fewer), the
share is not read. None also when none of the kernels ran."""

import sys

from f3sbench import counts, trace

KERNELS = ("sr_attention_",)


def read(rec):
    t, seg = rec["trace"], rec["config"].get("segmenter")
    if not t or not seg or not seg["use_pallas_attention"]:
        return None
    seconds, names = trace.kernel_seconds(t, KERNELS)
    launches = sum(t["kernels"][n][0] for n in names)
    print(f"scan.k3_roofline: kernels matched {names}, {launches} launches", file=sys.stderr)
    if not names or seconds <= 0:
        return None
    frames, b = t["work"]["frames"], seg["batch"]
    batches = [b] * (frames // b) + ([frames % b] if frames % b else [])
    calls = [c[1:] for n in batches for c in counts.attention_calls(seg, seg["input_hw"], n)
             if c[2] % 512 == 0]
    if launches != len(calls):
        print(f"scan.k3_roofline: {launches} launches against {len(calls)} fused calls: "
              f"not read", file=sys.stderr)
        return None
    return 100.0 * sum(counts.k3_bound_s(*c) for c in calls) / seconds
