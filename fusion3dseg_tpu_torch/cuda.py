"""Device selection and the build of the hand-written CUDA kernels.

Every kernel source lives in `fusion3dseg_tpu_torch/csrc/<name>.cu` and
exposes a plain C interface. At first use it is compiled with `nvcc` for
Hopper (`sm_90a`) into a shared library under the build directory and
loaded with `ctypes`. Nothing is compiled when a module is imported.

The build directory is `build/` beside the package, or the directory named
by `F3S_TORCH_BUILD_DIR`. Each library's file name carries a hash of its
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited source
builds anew.

`build(names, defines=...)` compiles a variant with preprocessor macros
set; `tools/kernel_parts.py` uses it to time a kernel with its loads or its
arithmetic switched off (`F3S_PARTS`), and `use_variant` to launch it
through the ordinary wrapper. A process with `F3S_TORCH_NO_BUILD` set (a
rank of a multi-device run, `parallel/launch.py`) loads built libraries
only and raises where it would compile.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (an entry point never carries on on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def build_dir() -> Path:
    env = os.environ.get("F3S_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent.parent / "build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


@dataclass
class Built:
    """One compiled kernel library."""

    name: str
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas: str  # nvcc's -Xptxas -v report ("" when reused)


_LIBS: dict[str, ctypes.CDLL] = {}
BUILDS: dict[str, Built] = {}


def _target(name: str, flags) -> Path:
    # the shared headers are part of every source's identity
    src = b"".join(p.read_bytes() for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))))
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def build(names, defines=()) -> dict[str, Built]:
    """Compile the named sources, one nvcc process each, all started
    together. Sources whose library is already built are not compiled.
    `defines` ("NAME=value", ...) builds a variant with those macros set,
    kept apart from the plain build. Raises with nvcc's output when a
    compile fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    keys = {name: "|".join((name, *defines)) for name in names}
    procs = {}
    for name, key in keys.items():
        if key in BUILDS:
            continue
        target = _target(name, flags)
        if target.exists():
            BUILDS[key] = Built(name, target, 0.0, "")
            continue
        if os.environ.get("F3S_TORCH_NO_BUILD"):
            raise RuntimeError(f"{target.name} is not built, and this process may not run "
                               "nvcc (F3S_TORCH_NO_BUILD: a rank of a multi-device run); "
                               "build the kernels before starting the ranks")
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
        BUILDS[keys[name]] = Built(name, target, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: BUILDS[keys[n]] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name].path))
    return lib


@contextlib.contextmanager
def use_variant(name: str, defines):
    """Within the block, `load(name)` (and so the kernel's wrapper) gives
    the variant of `name` built with `defines`. For measurement tools."""
    plain = load(name)
    _LIBS[name] = ctypes.CDLL(str(build([name], defines)[name].path))
    try:
        yield
    finally:
        _LIBS[name] = plain
