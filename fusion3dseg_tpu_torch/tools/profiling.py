"""Shared by the profile tools: the card's identity line and one profiled
run reported by kernel."""

from __future__ import annotations

import subprocess
import time

import torch


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
OWN_KERNELS = ("hist_tiled_kernel", "hist_bytes_kernel", "sr_attention_", "nat_")


def profile_run(run, title: str, top: int = 25) -> dict:
    """Run `run()` once under `torch.profiler` (the caller has warmed it up)
    and print the wall time, the summed device time of its kernels, their
    share of the wall time (the device's busy share) and the kernels by
    device time: the `top` longest, then any hand-written kernel of the
    port that is not among them. Returns {"wall_s", "device_s",
    "launches"} of the profiled run."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
