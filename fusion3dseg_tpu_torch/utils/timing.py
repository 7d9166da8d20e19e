"""Named wall-time spans of the pipeline's stages.

Counterpart of `fusion3dseg_tpu/utils/timing.py`: a process-wide registry
of spans (name, seconds, attributes), printable as a summary or JSON. A
span measures the host's wall clock and does not wait for the card: work
still queued on the device when a span closes belongs to a later span.
Pass `sync=True` (or call `block_until_ready` on the span's outputs) where
a span must cover the device time too. `trace(logdir)` records a
`torch.profiler` trace of a block (CPU, and CUDA where there is a card),
written as a Chrome trace under `logdir`.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


def block_until_ready(tree):
    """Wait for the card's queued work when any tensor of `tree` (a tensor,
    or a list, tuple or dict of them) lives on a CUDA device; returns
    `tree`."""
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
        else:
            yield t

    devices = {t.device for t in leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class Metrics:
    """Process-wide span registry."""

    def __init__(self):
        self.spans: List[Dict] = []

    @contextlib.contextmanager
    def span(self, name: str, verbose: bool = False, sync: bool = False, **attrs):
        """Time the block; `sync` waits for the current CUDA device before
        the clock starts and before it stops."""
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.spans.append({"name": name, "seconds": dt, **attrs})
            if verbose:
                print(f"[{name}] {dt:.3f}s")

    def total(self, name: str) -> float:
        return sum(s["seconds"] for s in self.spans if s["name"] == name)

    def summary(self) -> str:
        agg: Dict[str, float] = {}
        for s in self.spans:
            agg[s["name"]] = agg.get(s["name"], 0.0) + s["seconds"]
        return "\n".join(f"{k:32s} {v:9.3f}s" for k, v in agg.items())

    def dump_json(self, path) -> None:
        with open(path, "w") as fp:
            json.dump(self.spans, fp, indent=2)


METRICS = Metrics()


@contextlib.contextmanager
def span(name: str, verbose: bool = False, sync: bool = False, **attrs):
    with METRICS.span(name, verbose=verbose, sync=sync, **attrs):
        yield


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Record a `torch.profiler` trace around the block when `logdir` is set
    (`<logdir>/trace.json`, Chrome trace format); nothing otherwise. Yields
    the profiler, or None."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
