"""Reading a `torch.profiler` trace of a slice of a run.

The arithmetic of the port's profile tools (`tools/profiling.py`,
`tools/profile_*.py`), frozen here: device busy time is the union of the
intervals in which a kernel, copy or fill ran on the card; launches are
the kernels counted; idle gaps are the stretches of the traced window in
which nothing ran, each labelled by the innermost host event (operator,
runtime call or the benchmark's own span) under way at its midpoint.
Only aggregates leave this module; the events stay in memory.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch

TOP = 10


@contextlib.contextmanager
def profiled(cuda: bool = True):
    """Profile the block (the host and, with `cuda`, the card). Yields a
    dict that is filled on exit with `summarize`'s aggregates."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.time_ns()
        yield out
        sync()
        t1 = time.time_ns()
    out.update(summarize(prof.profiler.kineto_results.events(), t0, t1))


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged, sorted intervals of [starts, ends)."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.nonzero(new)[0]
    last = np.r_[idx[1:] - 1, len(s) - 1]
    return s[idx], run_end[last]


def summarize(events, t0: int, t1: int) -> dict:
    """Aggregates of the kineto events of a window [t0, t1] (ns, the
    profiler's clock): window_s, busy_s, launches, kernels {name: [count,
    seconds]}, device_ops and idle_gaps (the `breakdown` lists)."""
    dev_name, dev_s, dev_e, is_kernel = [], [], [], []
    host_name, host_s, host_e = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    events = list(events)
    # the benchmark's spans (record_function) are also copied onto the
    # card's timeline under their host names; those copies are no device work
    spans = {ev.name() for ev in events if ev.device_type() != cuda}
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            name = ev.name()
            if name in spans:
                continue
            dev_name.append(name)
            dev_s.append(s)
            dev_e.append(e)
            low = name.lower()
            is_kernel.append(not (low.startswith("memcpy") or low.startswith("memset")))
        elif e > s:
            host_name.append(ev.name())
            host_s.append(s)
            host_e.append(e)
    ds = np.asarray(dev_s, np.int64).clip(t0, t1)
    de = np.asarray(dev_e, np.int64).clip(t0, t1)
    us, ue = _union(ds, de)
    busy_ns = int((ue - us).sum())
    kernels = defaultdict(lambda: [0, 0.0])
    for name, s, e, k in zip(dev_name, ds, de, is_kernel):
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-9
    # idle gaps: the window less the busy union, labelled by host activity
    gs = np.r_[t0, ue]
    ge = np.r_[us, t1]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    order = np.argsort(host_s, kind="stable")
    hs = np.asarray(host_s, np.int64)[order]
    he = np.asarray(host_e, np.int64)[order]
    hn = [host_name[i] for i in order]
    idle = defaultdict(float)
    mids = (gs + ge) // 2
    for s, e, mid, j in zip(gs, ge, mids, np.searchsorted(hs, mids, side="right") - 1):
        label = "(no host event)"
        for _ in range(4096):
            if j < 0:
                break
            if he[j] > mid:
                label = hn[j]
                break
            j -= 1
        idle[label] += (e - s) * 1e-9
    ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda x: -x[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return {
        "window_s": (t1 - t0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "launches": int(sum(is_kernel)),
        "kernels": {n: list(v) for n, v in kernels.items()},
        "device_ops": [[n[:200], s] for n, s in ops],
        "idle_gaps": [[n[:200], s] for n, s in gaps],
    }


def kernel_seconds(trace: dict, patterns) -> tuple:
    """(device seconds, names) of the traced kernels whose name contains one
    of `patterns`."""
    names = [n for n in trace["kernels"] if any(p in n for p in patterns)]
    return sum(trace["kernels"][n][1] for n in names), names
