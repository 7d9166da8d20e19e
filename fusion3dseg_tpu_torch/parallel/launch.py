"""Starting the ranks of a multi-device run.

`spawn(fn, world_size, ...)` starts `world_size` processes with
`torch.multiprocessing`'s `spawn` start method (never `fork`: a caller may
have initialised CUDA), joins them into one process group and runs
`fn(rank, *args)` in each, where `rank` is a `Rank`. Each rank's return
value comes back to the caller in rank order (through a file, so it should
hold host tensors or arrays). The group meets through a `FileStore` in a
fresh temporary directory, never a fixed TCP port, so that several groups
can start at once on one host. `timeout` (seconds) is both the group's
collective timeout and the deadline of the whole run: a rank that raises
fails the call with its traceback and the others are stopped, and a group
that has not finished by the deadline is killed and raises TimeoutError.

Devices: rank r runs on `cuda:{r % device_count}` unless the caller asks
for the CPU (`device_type="cpu"`). `backend_for` chooses the backend, in
this one place: NCCL when every rank has a card of its own; gloo when ranks
share a card (NCCL refuses two ranks on one device) and on the CPU. The
tensors and the compute stay on the rank's device either way; only gloo's
collectives pass through host memory (`comm.STATS["host_bytes"]`).

Ranks load the kernels that the caller built: a spawned rank never runs
`nvcc` (`F3S_TORCH_NO_BUILD`), since ranks building at once would race on
the build directory. CPU ranks use one thread each.

Under `torchrun`, `init_from_env` joins the group that torchrun's
environment describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NO_BUILD_ENV = "F3S_TORCH_NO_BUILD"


@dataclasses.dataclass(frozen=True)
class Rank:
    """What a rank's function learns about itself."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def backend_for(device_type: str, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cpu":
        torch.set_num_threads(1)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' requested but torch.cuda.is_available() is "
                           "False; pass device_type='cpu' to run the ranks on the CPU")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _child(index, fn, world_size, args, device_type, backend, workdir, timeout):
    os.environ[NO_BUILD_ENV] = "1"
    out = Path(workdir)
    try:
        dev = _rank_device(index, device_type)
        store = dist.FileStore(str(out / "store"), world_size)
        dist.init_process_group(backend, store=store, rank=index, world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            result = fn(Rank(index, world_size, dev, backend), *args)
            torch.save(result, out / f"result_{index}.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (out / f"error_{index}.txt").write_text(traceback.format_exc())
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def spawn(fn: Callable, world_size: int, args: tuple = (), *, device_type: str = "cuda",
          timeout: float = 120.0, verbose: bool = False) -> list:
    """Run `fn(rank, *args)` on `world_size` new processes in one group;
    returns their results in rank order. `fn` must be importable by name
    (a module-level function). Raises RuntimeError with the failing rank's
    traceback, or TimeoutError after `timeout` seconds."""
    backend = backend_for(device_type, world_size)
    if verbose:
        ndev = torch.cuda.device_count() if device_type == "cuda" else 0
        devs = ["cpu"] * world_size if device_type == "cpu" else [
            f"cuda:{r % max(ndev, 1)}" for r in range(world_size)]
        print(f"launch: {world_size} rank(s), backend {backend}, devices {devs}", flush=True)
    workdir = tempfile.mkdtemp(prefix="f3s_ranks_")
    deadline = time.monotonic() + timeout
    ctx = mp.start_processes(_child, args=(fn, world_size, args, device_type, backend, workdir,
                                           timeout),
                             nprocs=world_size, join=False, start_method="spawn")
    try:
        while True:
            try:
                if ctx.join(timeout=max(0.0, min(1.0, deadline - time.monotonic()))):
                    break
            except Exception as e:  # a rank raised or died: the others are stopped
                errors = sorted(Path(workdir).glob("error_*.txt"))
                detail = "\n".join(f"{p.stem}:\n{p.read_text()}" for p in errors)
                raise RuntimeError(f"a rank failed ({e.__class__.__name__}: {e})\n{detail}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} rank(s) did not finish within {timeout} s")
        return [torch.load(Path(workdir) / f"result_{r}.pt", weights_only=False)
                for r in range(world_size)]
    finally:
        _stop(ctx.processes)
        shutil.rmtree(workdir, ignore_errors=True)


def init_from_env(device_type: str = "cuda", timeout: float = 1800.0) -> Rank:
    """Join the process group that `torchrun`'s environment describes (once;
    a second call returns the same rank). The rank's device is
    `cuda:{LOCAL_RANK % device_count}`, or the CPU."""
    world_size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(local, device_type)
    backend = backend_for(device_type, world_size)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout))
    return Rank(rank, world_size, dev, dist.get_backend())

