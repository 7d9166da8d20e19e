"""The port's one tracing module: spans, waits and profiler ranges.

Counterpart of `fusion3dseg_tpu/utils/timing.py`.

- `span(name)` times a block with `time.time_ns()`, the clock that the
  profiler's events carry, and adds its seconds under its name to the
  process-wide aggregates (`METRICS`). Inside `record()` the outermost open
  span is the call's stage: it also adds to the record `<name>` (its
  seconds), `<name>.wait` (the seconds of the waits it holds) and
  `<name>.dispatch` (the rest: the host issuing work or computing), so
  `dispatch + wait == <name>`. A span inside a stage adds to `METRICS`
  only.
- `wait(name)` is a span around a block in which the host blocks on the
  card: a read of a device tensor, an operation whose output size the host
  reads (`unique`, boolean-mask indexing), a synchronous copy from the
  host. It counts as `wait.<name>` in `METRICS` and adds its seconds to the
  `.wait` of the record's open stage.
- `range(name)` only names a block in a profile: no stamps, no record.
  A read outside any record is `range("wait.<name>")`.
- `count(name, k)` adds `k` to a counter: in `METRICS.counts`, and inside
  `record()` to the record's `<name>` (a float, as every value there).

While a `torch.profiler` records, every span, wait and range is also the
profiler range `f3s.<name>` (waits: `f3s.wait.<name>`), so the trace tells
the program's stages and steps apart; with no profiler a range costs one
flag check. `trace(logdir)` writes such a profile as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PREFIX = "f3s."

_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


class Metrics:
    """Process-wide aggregates: seconds per span name, counts per counter."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def total(self, name: str) -> float:
        return self.seconds.get(name, 0.0)

    def clear(self) -> None:
        self.seconds.clear()
        self.counts.clear()


METRICS = Metrics()


class _Record:
    """The record of one call: its seconds by key, and its open stage."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.stage: Optional["Span"] = None

    def close(self, name: str, ns: int, waited_ns: int) -> None:
        s = self.seconds
        s[name] = s.get(name, 0.0) + ns * 1e-9
        s[name + ".wait"] = s.get(name + ".wait", 0.0) + waited_ns * 1e-9
        s[name + ".dispatch"] = s[name] - s[name + ".wait"]


_RECORD: contextvars.ContextVar[Optional[_Record]] = contextvars.ContextVar(
    "f3s_timing_record", default=None)


@contextlib.contextmanager
def record():
    """Open the record of one call; yields its dict of seconds, which the
    spans inside the block fill, and of counts (see the module's
    docstring)."""
    rec = _Record()
    token = _RECORD.set(rec)
    try:
        yield rec.seconds
    finally:
        _RECORD.reset(token)


class Span:
    """A timed block; `start_ns` and `end_ns` are its `time.time_ns()`
    stamps, taken outside its profiler range."""

    __slots__ = ("name", "is_wait", "verbose", "start_ns", "end_ns", "waited_ns", "_range",
                 "_record")

    def __init__(self, name: str, is_wait: bool = False, verbose: bool = False):
        self.name, self.is_wait, self.verbose = name, is_wait, verbose
        self.start_ns = self.end_ns = self.waited_ns = 0

    def __enter__(self) -> "Span":
        self._record = rec = _RECORD.get()
        if rec is not None and not self.is_wait:
            if rec.stage is None:
                rec.stage = self
            else:  # inside the stage: METRICS only
                self._record = None
        self.start_ns = time.time_ns()
        self._range = None
        if _profiling():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        ns = self.end_ns - self.start_ns
        METRICS.add(self.name, ns * 1e-9)
        rec = self._record
        if rec is not None and rec.stage is not None:
            if self.is_wait:
                rec.stage.waited_ns += ns
            else:
                rec.stage = None
                rec.close(self.name, ns, self.waited_ns)
        if self.verbose:
            print(f"[{self.name}] {ns * 1e-9:.3f}s")
        return False


def span(name: str, verbose: bool = False) -> Span:
    """Time the block as `name` (printed with `verbose`)."""
    return Span(name, verbose=verbose)


def wait(name: str) -> Span:
    """Time the block as the host waiting on the card (`wait.<name>`)."""
    return Span("wait." + name, is_wait=True)


def count(name: str, k: int = 1) -> None:
    """Add `k` to the counter `name` (see the module's docstring)."""
    METRICS.counts[name] = METRICS.counts.get(name, 0) + k
    rec = _RECORD.get()
    if rec is not None:
        rec.seconds[name] = rec.seconds.get(name, 0.0) + float(k)


def range(name: str):  # noqa: A001 (the module's name for a profiler range)
    """The profiler range `f3s.<name>` around the block while a profiler
    records; otherwise nothing."""
    return torch.profiler.record_function(PREFIX + name) if _profiling() else _NULL


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Record a `torch.profiler` trace around the block when `logdir` is set
    (`<logdir>/trace.json`, Chrome trace format), with the program's
    spans, waits and ranges in it; nothing otherwise. Yields the profiler,
    or None."""
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
