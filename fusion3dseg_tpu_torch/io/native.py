"""ctypes binding to the native neighbour-graph library.

Counterpart of `fusion3dseg_tpu/io/native.py`: fixed-radius neighbour
graphs and connected components of a host point cloud, from the C++ source
`native/neighbor_graph.cpp` that both packages share. The port compiles its
own copy with `g++` into its build directory (`cuda.build_dir()`), at first
use; the file name carries a hash of the source, the flags and the CPU
model. A failed build raises: there is no slower fall-back.

`build(source)` and `load_library(source)` build and load any host C++
source the same way; the port's image codec (`native/image_codec.cpp`,
read by `io/image.py`) is the other one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

from fusion3dseg_tpu_torch import cuda

SOURCE = Path(__file__).resolve().parents[2] / "native" / "neighbor_graph.cpp"
# the flags of native/Makefile, so that both packages compute the same graph
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "radius_graph": [_F32P, ctypes.c_int64, ctypes.c_float, ctypes.c_int32, _I32P],
    "radius_graph_csr": [_F32P, ctypes.c_int64, ctypes.c_float, _I64P, _I32P],
    "connected_components": [_F32P, ctypes.c_int64, ctypes.c_float, _I32P, _I32P],
    "components_from_adjacency": [_I32P, ctypes.c_int64, ctypes.c_int32, _I32P, _I32P],
    "components_from_csr": [_I32P, _I32P, ctypes.c_int64, _I32P, _I32P],
}
_LIB: dict = {}


def _host_cpu() -> bytes:
    """The CPU model: `-march=native` builds for it, so a build directory
    carried to another host must not reuse the library."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"model name")), b"")
    except OSError:
        return platform.processor().encode()


def library_path(source: Path = SOURCE) -> Path:
    """Where the library of this source, these flags and this CPU is (or
    will be) built."""
    key = source.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_cpu()
    return cuda.build_dir() / f"lib{source.stem}-{hashlib.sha256(key).hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source` (by default the neighbour-graph library) unless it
    is already built. Raises with the compiler's output when `g++` is
    missing or fails."""
    target = library_path(source)
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: cannot build {source.name}")
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds leave one whole file
    return target


def load_library(source: Path, signatures: dict, restypes: dict | None = None) -> ctypes.CDLL:
    """The ctypes handle of `source`'s library, built at first use, with
    each function in `signatures` (name -> argument types) declared; it
    returns `restypes[name]`, by default a C int."""
    lib = _LIB.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.restype = (restypes or {}).get(name, ctypes.c_int)
            fn.argtypes = argtypes
        _LIB[source] = lib
    return lib


def load() -> ctypes.CDLL:
    """The neighbour-graph library's ctypes handle, built at first use."""
    return load_library(SOURCE, _SIGNATURES)


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def _points(points) -> np.ndarray:
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pts.shape}")
    return pts


def _labels(labels, n):
    if labels is None:
        return None, None
    lab = np.ascontiguousarray(np.asarray(labels, np.int32))
    if lab.shape != (n,):
        raise ValueError(f"labels must be [{n}], got {lab.shape}")
    return lab, _ptr(lab, _I32P)


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed rc={rc}")


def radius_graph(points, radius: float, k: int = 16) -> np.ndarray:
    """[N, k] int32 fixed-degree adjacency (-1 padded, nearest first)."""
    pts = _points(points)
    adj = np.empty((len(pts), k), np.int32)
    if len(pts):
        _check(load().radius_graph(_ptr(pts, _F32P), len(pts), radius, k, _ptr(adj, _I32P)),
               "radius_graph")
    return adj


def radius_graph_lists(points, radius: float) -> np.ndarray:
    """Object array of int64 neighbour lists, from the two-pass CSR call."""
    pts = _points(points)
    n = len(pts)
    if n == 0:
        return np.empty(0, object)
    lib = load()
    offsets = np.empty(n + 1, np.int64)
    _check(lib.radius_graph_csr(_ptr(pts, _F32P), n, radius, _ptr(offsets, _I64P), None),
           "radius_graph_csr count")
    indices = np.empty(int(offsets[n]), np.int32)
    _check(lib.radius_graph_csr(_ptr(pts, _F32P), n, radius, _ptr(offsets, _I64P),
                                _ptr(indices, _I32P)), "radius_graph_csr fill")
    out = np.empty(n, object)
    for i in range(n):
        out[i] = indices[offsets[i]:offsets[i + 1]].astype(np.int64)
    return out


def connected_components(points, radius: float, labels=None) -> np.ndarray:
    """[N] int32 component roots (the minimum point index) over every pair
    within `radius`, joined only within equal `labels` when given."""
    pts = _points(points)
    n = len(pts)
    out = np.empty(n, np.int32)
    if n:
        lab, lab_ptr = _labels(labels, n)
        _check(load().connected_components(_ptr(pts, _F32P), n, radius, lab_ptr,
                                           _ptr(out, _I32P)), "connected_components")
    return out


def components_from_adjacency(adj, labels=None) -> np.ndarray:
    """[N] int32 component roots over an [N, K] adjacency (-1 padded)."""
    a = np.ascontiguousarray(np.asarray(adj, np.int32))
    if a.ndim != 2:
        raise ValueError(f"adjacency must be [N, K], got {a.shape}")
    n, k = a.shape
    out = np.empty(n, np.int32)
    if n:
        lab, lab_ptr = _labels(labels, n)
        _check(load().components_from_adjacency(_ptr(a, _I32P), n, k, lab_ptr,
                                                _ptr(out, _I32P)), "components_from_adjacency")
    return out


def components_from_csr(offsets, flat, labels=None) -> np.ndarray:
    """[N] int32 component roots over a ragged CSR adjacency (neighbours of
    i: flat[offsets[i]:offsets[i+1]])."""
    offsets = np.asarray(offsets)
    if int(offsets[-1]) >= np.iinfo(np.int32).max:
        raise ValueError("edge count exceeds int32 CSR offsets; split the graph")
    off = np.ascontiguousarray(offsets.astype(np.int32))
    fl = np.ascontiguousarray(np.asarray(flat, np.int32))
    n = len(off) - 1
    out = np.empty(max(n, 0), np.int32)
    if n > 0:
        lab, lab_ptr = _labels(labels, n)
        _check(load().components_from_csr(_ptr(off, _I32P), _ptr(fl, _I32P), n, lab_ptr,
                                          _ptr(out, _I32P)), "components_from_csr")
    return out
