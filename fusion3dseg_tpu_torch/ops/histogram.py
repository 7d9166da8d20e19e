"""Per-point class histogram + thresholded argmax (kernel K1).

Counterpart of `fusion3dseg_tpu/ops/histogram.py`. The label lifter emits
a [F, N] uint8 winner-class matrix C (255 = no win); each point's class is
the thresholded argmax of its column's histogram.

`histogram_classify` launches the hand-written CUDA kernel
`csrc/histogram.cu` on a CUDA tensor and runs the plain PyTorch version
`histogram_classify_reference` on a CPU tensor. Nothing else selects
between them: a CUDA tensor either launches the kernel or raises.

The source holds two kernels. Rows that start on 16-byte boundaries
(`rows_aligned`) stream through a ring of 16-byte asynchronous copies in
shared memory at about half of the card's memory rate; any other view goes
through a byte-per-thread loop at under a third of it. `row_pitch` is the
pitch a producer of C allocates to get the first.
"""

from __future__ import annotations

import ctypes

import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.utils import timing

INVALID = 255
MAX_ROWS = 65535  # the kernel's per-column counters are 16-bit
ROW_ALIGN = 128  # bytes; a multiple of the 16 bytes the fast kernel's copies need


def row_pitch(ncols: int) -> int:
    """Bytes between the rows of a [F, ncols] uint8 matrix allocated for
    `histogram_classify`: `ncols` rounded up to a multiple of ROW_ALIGN, so
    that every row starts on a 16-byte boundary when the first does."""
    if ncols < 0:
        raise ValueError(f"ncols must not be negative, got {ncols}")
    return -(-ncols // ROW_ALIGN) * ROW_ALIGN


def rows_aligned(data_ptr: int, row_stride: int, nrows: int) -> bool:
    """Whether every row of a uint8 matrix starts on a 16-byte boundary: the
    one condition that selects the fast kernel (the launcher in
    `csrc/histogram.cu` applies the same test)."""
    return data_ptr % 16 == 0 and (nrows <= 1 or row_stride % 16 == 0)


def _check(C, nclasses):
    if C.dtype != torch.uint8:
        raise TypeError(f"C must be uint8, got {C.dtype}")
    if C.dim() != 2:
        raise ValueError(f"C must be [F, N], got shape {tuple(C.shape)}")
    if not 0 <= nclasses <= 254:
        raise ValueError(f"nclasses must lie in [0, 254], got {nclasses}")


def histogram_classify_reference(C: torch.Tensor, nclasses: int, threshold: float = 0.5):
    """Plain PyTorch version of the kernel: a count per class 0..nclasses,
    strict `>` so ties keep the lowest id, and the float32 division test.

    Returns ((total [N], vmax [N]) int32, classes [N] int32).
    """
    _check(C, nclasses)
    total = (C != INVALID).sum(0, dtype=torch.int32)
    vmax = torch.zeros_like(total)
    cls = torch.zeros_like(total)
    for c in range(nclasses + 1):
        cnt = (C == c).sum(0, dtype=torch.int32)
        better = cnt > vmax
        vmax = torch.where(better, cnt, vmax)
        cls = torch.where(better, c, cls)
    thr = torch.tensor(threshold, dtype=torch.float32, device=C.device)
    confident = (total > 0) & (vmax > 0) & (
        vmax.float() / torch.clamp(total, min=1).float() >= thr
    )
    return (total, vmax), torch.where(confident, cls, nclasses).to(torch.int32)


def _launch(C, nclasses, threshold):
    F, N = C.shape
    if F > MAX_ROWS:
        raise ValueError(f"F={F} rows exceed the kernel's 16-bit counters ({MAX_ROWS})")
    if N > 1 and C.stride(1) != 1:
        raise ValueError("C's rows must be contiguous (stride(1) == 1)")
    lib = cuda.load("histogram")
    fn = lib.f3s_histogram_classify
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ]
    fn.restype = ctypes.c_int
    total = torch.empty(N, dtype=torch.int32, device=C.device)
    vmax = torch.empty_like(total)
    classes = torch.empty_like(total)
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream(C.device).cuda_stream
        err = fn(C.data_ptr(), F, N, C.stride(0), nclasses, threshold,
                 total.data_ptr(), vmax.data_ptr(), classes.data_ptr(), stream,
                 int(rows_aligned(C.data_ptr(), C.stride(0), F)))
    if err != 0:
        raise RuntimeError("histogram kernel launch failed: " +
                           ("rows not 16-byte aligned" if err == -1 else f"cudaError {err}"))
    histogram_classify.launches += 1
    return (total, vmax), classes


def histogram_classify(C: torch.Tensor, nclasses: int, threshold: float = 0.5):
    """Classify a [F, N] uint8 winner-class matrix (rows may be strided).

    Returns ((total [N], vmax [N]) int32, classes [N] int32) — the contract
    of the JAX package's `histogram_classify_tpu`. A CUDA tensor launches
    the kernel (and adds one to `histogram_classify.launches`): the tiled
    one where `rows_aligned` holds, the byte-per-thread one for any other
    base or pitch. A CPU tensor runs `histogram_classify_reference`.
    """
    _check(C, nclasses)
    with timing.range("k1.histogram_classify"):
        if C.device.type == "cuda":
            return _launch(C, nclasses, float(threshold))
        if C.device.type == "cpu":
            return histogram_classify_reference(C, nclasses, threshold)
    raise ValueError(f"unsupported device {C.device}")


histogram_classify.launches = 0
