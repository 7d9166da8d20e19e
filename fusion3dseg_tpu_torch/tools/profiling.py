"""Shared by the profile tools: the card's identity line, one profiled
run reported by kernel, a kernel's device time in a CUDA graph or between
CUDA events, and the least time the card could take for a piece of work."""

from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_line(dev) -> str:
    """`card_line()` for a CUDA device, else the device's name ("cpu")."""
    return card_line() if torch.device(dev).type == "cuda" else str(dev)


def _device_us(e):
    # renamed from self_cuda_time_total in newer torch releases
    t = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if t is None else t


# the port's hand-written kernels, by the names their sources give them
OWN_KERNELS = ("hist_tiled_kernel", "hist_bytes_kernel", "sr_attention_", "nat_",
               "match_pixels_kernel")


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time of one `fn()` in ms: `iters` calls captured in one CUDA
    graph, so that no host launch cost lies between them, replayed
    `replays` times between two CUDA events."""
    fn()  # warm-up outside the capture: builds, plans, allocations
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def event_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """ms of one `fn()` between two CUDA events around `iters` calls, after
    `warmup` calls: for plain versions, which allocate as they go, and for
    single calls as a user makes them."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """(ms, "bytes" or "operations"): the least time of work that moves
    `nbytes` through HBM and does `ops` operations at `ops_per_s`, the
    larger of the two."""
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def profile_run(run, title: str, top: int = 25, trace_path=None) -> dict:
    """Run `run()` once under `torch.profiler` (the caller has warmed it up)
    and print the wall time, the summed device time of its kernels, their
    share of the wall time (the device's busy share) and the kernels by
    device time: the `top` longest, then any hand-written kernel of the
    port that is not among them. With `trace_path`, also writes the
    timeline there as a Chrome trace. Returns {"wall_s", "device_s",
    "launches"} of the profiled run."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"card: {card_line()}")
    print(f"profiled run: {title}, wall {wall * 1e3:.2f} ms (profiler on); device kernel "
          f"time {dev_us / 1e3:.2f} ms in {launches} launches; device busy share "
          f"{dev_us / 1e6 / wall:.3f}")
    kernels.sort(key=lambda e: -_device_us(e))
    own = [e for e in kernels[top:] if any(name in e.key for name in OWN_KERNELS)]
    for e in kernels[:top] + own:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{100 * _device_us(e) / max(dev_us, 1):5.2f}%  {e.key[:90]}")
    return {"wall_s": wall, "device_s": dev_us / 1e6, "launches": launches}
