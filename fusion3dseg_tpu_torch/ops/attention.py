"""The segmenter's two fused attention kernels (K3 and K2).

Counterpart of `fusion3dseg_tpu/ops/attention.py`.

* `sr_attention` (K3): dense attention of a long query axis against the
  short, spatially reduced key/value axis of SegFormer's encoder.
* `neighborhood_attention` (K2): sliding-window attention on the token
  grid, masked (not shifted) at the image borders.

Each wrapper launches its hand-written CUDA kernel (`csrc/sr_attention.cu`,
`csrc/neighborhood_attention.cu`) on CUDA tensors and runs its plain PyTorch
version (`*_reference`) on CPU tensors. Nothing else selects between them: a
CUDA tensor either launches a kernel or raises. Both take q pre-scaling on
themselves (callers must not scale) and read `[B, tokens, H, D]` tensors
through their strides. Their domain is the JAX kernels': any D, any number
of queries and keys, any odd window, any B * H, and the float dtypes the
segmenter runs (float32, bfloat16, float16). In float32 both run on the
CUDA cores; bfloat16 and float16 take the same tensor-core kernels, each
built for both element types (two bytes an element, the same shared-memory
plans). K3 has two such kernels, and `_sr_route` alone decides which one a
call takes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.utils import timing

# element-type codes of the C entry points; the two-byte types share the
# tensor-core kernels and their plans
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_HALF = (torch.bfloat16, torch.float16)
_MMA_MAX_HEAD_DIM = 128  # the mma.sync kernel keeps a query's q in registers
_ERRORS = {
    -1: f"the mma route takes D <= {_MMA_MAX_HEAD_DIM}",
    -2: "the keys and values one block needs exceed an SM's shared memory",  # K3 only
    -3: "unsupported dtype",
    -4: "TMA cannot describe the tensors",
    -5: "libcuda has no cuTensorMapEncodeTiled",
    -6: "the kernel's register allocation is smaller than its warpgroups ask for",
    -7: "too many query tiles for one launch",
}
_MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90


def _check(q, k, v, name):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B,N,H,D] and k, v [B,M,H,D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch, heads or head dim")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q, k, v must share float32, bfloat16 or float16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v lie on {q.device}, {k.device}, {v.device}")
    if k.shape[1] < 1:
        raise ValueError(f"{name}: no keys")


def _scale(q) -> float:
    """1/sqrt(D) rounded to q's dtype, as a Python float (no device copy)."""
    return float(torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype))


def _scaled(q):
    """q / sqrt(D) in q's own dtype, the scale itself rounded to that dtype
    first (what `(q * scale).astype(q.dtype)` gives in the JAX package for
    a bfloat16 or float16 q)."""
    return q * _scale(q)


def _launch(fn_name, lib_name, tensors, out, ints):
    """One launch of a `csrc` attention kernel on the current stream: the
    C function takes q, k, v, out, then `ints` (codes and sizes), the 12
    strides, the scale and the stream."""
    q = tensors[0]
    strides = []
    for t in (*tensors, out):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{fn_name}: the head-dim axis must be contiguous")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    fn = getattr(cuda.load(lib_name), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * len(ints)
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), *ints,
                 (ctypes.c_int64 * 12)(*strides), _scale(q), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: " + _ERRORS.get(err, f"launch failed, cudaError {err}"))
    return out


# ---------------------------------------------------------------- K3

def sr_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `sr_attention`, with the kernel's roundings:
    q scaled in its own dtype, scores accumulated in float32, softmax in
    float32, probabilities cast to v's dtype, the second product accumulated
    in float32, output in q's dtype (the JAX kernel's, in each dtype)."""
    _check(q, k, v, "sr_attention")
    scores = torch.einsum("bnhd,bmhd->bhnm", _scaled(q).float(), k.float())
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(q.dtype)


# K3's kernels, by the code `f3s_sr_attention` takes beside the dtype's
SR_ROUTES = {"f32": 0, "mma": 1, "wgmma": 2}


def _tma_layout(t) -> bool:
    """TMA can describe t [B, tokens, H, D] of a two-byte type: a 16-byte aligned
    base and positive strides of whole 16-byte pieces on every axis longer
    than 1 (the last axis is contiguous)."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) > 0 and t.stride(i) % 8 == 0 for i in range(3) if t.shape[i] > 1)


def _wgmma_direct(q, k, v) -> bool:
    """The wgmma kernel reads q, k, v (and writes a fresh output) as they
    are: D a multiple of 8 and every tensor a TMA layout."""
    return q.shape[-1] % 8 == 0 and all(_tma_layout(t) for t in (q, k, v))


def _mma_fits(M: int, D: int) -> bool:
    """The mma.sync kernel takes D <= 128 and stages K and V of one (batch,
    head), [Mp, 16 NK + 8] and V transposed [16 NK, Mp + 8] of two-byte
    elements (bfloat16 or float16), in an SM's shared memory: 848 keys at D
    = 64, 432 at D = 128."""
    if D > _MMA_MAX_HEAD_DIM:
        return False
    nk = -(-D // 16)
    nk = 1 << (nk - 1).bit_length()  # the kernel's head-dim padding: 1, 2, 4 or 8
    mp = -(-M // 16) * 16
    return (mp * (16 * nk + 8) + 16 * nk * (mp + 8)) * 2 <= _MAX_SMEM


def _sr_route(q, k, v) -> str:
    """The kernel a CUDA call of `sr_attention` launches: "f32" for float32
    (the one-pass tile kernel at every D, `_sr_f32_shape`);
    for bfloat16 and float16 "wgmma" (TMA-fed, keys streamed in tiles, any
    M, any D) when TMA can describe q, k and v, else "mma" (`mma.sync`, any
    strides) while D <= 128 and K and V of one (batch, head) fit its shared
    memory, else "wgmma" again on copies of q, k and v in a TMA layout
    (`_tma_copy`). Each of these kernels has a bfloat16 and a float16
    instance; the dtype picks it."""
    if q.dtype == torch.float32:
        return "f32"
    if _wgmma_direct(q, k, v) or not _mma_fits(k.shape[1], q.shape[-1]):
        return "wgmma"
    return "mma"


class SrShape(NamedTuple):
    """The wgmma route's kernel instance at a head dim: D padded to `dp`
    columns (past D = 320, the column-block kernel: `dp` output columns a
    block), key tiles of `kt`, `consumers` warpgroups, `stages` K, V stages
    (the column-block kernel: units of its ring), `smem` dynamic shared
    bytes."""
    dp: int
    kt: int
    consumers: int
    stages: int
    smem: int


# csrc/sr_attention.cu `WgShape<DP>`: consumer warpgroups, the producer's and
# each consumer's registers under setmaxnreg, q stages, O out through q
WG_SHAPES = {64: (3, 24, 160, 2, False), 128: (2, 40, 232, 2, False),
             192: (2, 24, 240, 1, True), 256: (2, 24, 240, 1, True),
             320: (2, 24, 240, 1, True)}
_SR_WIDE_OUT, _SR_WIDE_STAGES = 256, 4  # past D = 320: columns a block, units of 16 KB


def _sr_shape(D: int, M: int) -> SrShape:
    """The instance `csrc/sr_attention.cu` (`wgmma_shape`) takes for head dim
    D and M keys in bfloat16 or float16: DP the smallest of 64, 128, 192, 256, 320
    that holds D, key tiles of 128 at DP = 64 past 64 keys, of 32 at DP =
    320, else 64; as many K, V stages (at most 16) as fit an SM's shared
    memory beside the q stages, the output tiles and the barriers. Past D =
    320 the column-block kernel."""
    if D > max(WG_SHAPES):
        return SrShape(_SR_WIDE_OUT, 64, 1, _SR_WIDE_STAGES, 1024 + _SR_WIDE_STAGES * 2 * 64 * 128)
    dp = next(w for w in WG_SHAPES if D <= w)
    kt = 128 if dp == 64 and M > 64 else 32 if dp == 320 else 64
    consumers, _, _, q_stages, o_in_q = WG_SHAPES[dp]
    fixed = 1024 + (q_stages + (0 if o_in_q else 2)) * consumers * 64 * dp * 2
    bars = 8 * (2 * q_stages + 2 * 16)  # the kernel's static mbarriers
    kv = 2 * kt * dp * 2
    stages = min((_MAX_SMEM - bars - fixed) // kv, 16)
    return SrShape(dp, kt, consumers, stages, fixed + stages * kv)


class SrF32Shape(NamedTuple):
    """The float32 tile kernel's instance at a head dim: q, K and V in rows
    of `dp` columns (D padded up to it; past D = 320 column chunks of 320
    and the output in column blocks of 320), units of `kt` keys, `stages`
    units in the ring, `smem` dynamic shared bytes."""
    dp: int
    kt: int
    stages: int
    smem: int


_SR_F32_Q, _SR_F32_KT, _SR_F32_MAX_DJ, _SR_F32_MAX_STAGES = 64, 32, 5, 4


def _sr_f32_shape(D: int) -> SrF32Shape:
    """The instance `csrc/sr_attention.cu` (`F32Tile<DJ>`) takes for head dim
    D in float32: DJ = D / 64 rounded up, at most 5; DP = 64 DJ columns in
    staged rows of DP + 8 floats; q (64 rows), p^T (32 rows of 68) and two
    rows of 64 statistics fixed; then as many units of 32 keys (at most 4)
    as fit an SM's shared memory: 4 up to DP = 256, 3 at 320."""
    dj = min(-(-D // 64), _SR_F32_MAX_DJ)
    dp = 64 * dj
    ld = dp + 8
    fixed = (_SR_F32_Q * ld + _SR_F32_KT * (_SR_F32_Q + 4) + 2 * _SR_F32_Q) * 4
    unit = _SR_F32_KT * ld * 4
    stages = min((_MAX_SMEM - fixed) // unit, _SR_F32_MAX_STAGES)
    return SrF32Shape(dp, _SR_F32_KT, stages, fixed + stages * unit)


def _tma_copy(t, width: int):
    """t [B, T, H, D] copied into fresh storage whose rows are `width`
    (>= D, a multiple of 8) elements, as a [B, T, H, D] view of it."""
    out = torch.empty((*t.shape[:3], width), dtype=t.dtype, device=t.device)[..., :t.shape[3]]
    return out.copy_(t)


def launch_sr_attention(q, k, v, route: str) -> torch.Tensor:
    """One launch of K3's kernel `route` on CUDA tensors, counted in
    `sr_attention.launches` and `sr_attention.routes`. `sr_attention` calls
    it with `_sr_route`'s choice; measurement tools name a route to time a
    kernel on a layout the other one would take. "wgmma" on tensors TMA
    cannot describe copies them into a TMA layout first; the result is then
    a view of storage whose rows are D rounded up to 8. "mma" takes D <= 128
    and raises above it."""
    if (route == "f32") != (q.dtype == torch.float32):
        raise ValueError(f"sr_attention: route {route!r} does not take {q.dtype}")
    B, N, H, D = q.shape
    if route == "mma" and D > _MMA_MAX_HEAD_DIM:
        raise ValueError(f"sr_attention: {_ERRORS[-1]}, got D={D}")
    width = D
    if route == "wgmma" and not _wgmma_direct(q, k, v):
        width = -(-D // 8) * 8
        q, k, v = (_tma_copy(t, width) for t in (q, k, v))
    out = torch.empty((B, N, H, width), dtype=q.dtype, device=q.device)[..., :D]
    _launch("f3s_sr_attention", "sr_attention", (q, k, v), out,
            (SR_ROUTES[route], _DTYPES[q.dtype], B, N, k.shape[1], H, D))
    sr_attention.launches += 1
    sr_attention.routes[route] += 1
    return out


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused spatial-reduction attention: q [B, N, H, D] against k, v
    [B, M, H, D]; returns [B, N, H, D] in q's dtype. Scaling by 1/sqrt(D)
    happens here. Any N, any M, any D, any B * H (the JAX kernel's domain:
    M and D up to what VMEM holds). bfloat16 and float16 run on the tensor
    cores (`_sr_route` picks the kernel; `_sr_shape` the wgmma instance: D
    padded to 64, 128, 192, 256 or 320), float32 on the CUDA cores (one
    pass, `_sr_f32_shape`: D padded to 64 to 320); both stream the keys
    through shared memory in tiles, and above D = 320 take D in chunks,
    the output in column blocks.

    Forward only, like the JAX package's kernel: raises when an input
    requires grad while grad is enabled. A CUDA tensor launches a kernel
    (and adds one to `sr_attention.launches` and to its route's count in
    `sr_attention.routes`); a CPU tensor runs `sr_attention_reference`.
    """
    _check(q, k, v, "sr_attention")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("sr_attention is forward only; run it under torch.no_grad() "
                           "or train with use_pallas_attention=False")
    with timing.range("k3.sr_attention"):
        if q.device.type == "cuda":
            return launch_sr_attention(q, k, v, _sr_route(q, k, v))
        if q.device.type == "cpu":
            return sr_attention_reference(q, k, v)
    raise ValueError(f"unsupported device {q.device}")


def reset_sr_counts():
    """Set K3's launch counts (all routes) to 0."""
    sr_attention.launches = 0
    sr_attention.routes = dict.fromkeys(SR_ROUTES, 0)


reset_sr_counts()


# ---------------------------------------------------------------- K2

def _check_window(q, height, width, window):
    if q.shape[1] != height * width:
        raise ValueError(f"neighborhood_attention: N={q.shape[1]} is not "
                         f"height*width = {height}*{width}")
    if window < 1 or window % 2 == 0:
        raise ValueError(f"neighborhood_attention: window must be odd, got {window}")


class NatPlan(NamedTuple):
    """How a K2 block walks its tile's halo: chunks of `rows` x `cols`
    key positions through `stages` shared-memory buffers, `smem` bytes."""
    rows: int
    cols: int
    stages: int
    smem: int


_NAT_TILE = 8  # queries per tile side
_NAT_BUDGET = 57344  # bytes of K and V a block stages: four blocks an SM
_NAT_MAX_NARROW_D = 128  # past it, the wide kernels
# float32 past D = 128: columns a unit (rows of 68 staged), the most
# positions a chunk, the ring's most buffers, the budget (half an SM)
_NAT_F32_WIDE_COLS, _NAT_F32_WIDE_POS, _NAT_F32_WIDE_STAGES = 64, 128, 4
_NAT_F32_WIDE_BUDGET = _MAX_SMEM // 2 - 1024
# bfloat16 and float16 past D = 128: a block's query rows (a strip of 2 x
# 8), a unit's columns (rows of 72 staged), slots of 8 keys a chunk, a row of
# p (16 slots of 8 and 8), the ring's most buffers
_NAT_STRIP_ROWS, _NAT_MMA_WIDE_COLS, _NAT_MMA_WIDE_SLOTS = 2, 64, 16
_NAT_P_LD, _NAT_MMA_WIDE_STAGES = 136, 4
_NAT_STRIP = _NAT_STRIP_ROWS * _NAT_TILE  # queries a block


def _score_ld(n: int) -> int:
    """Floats a score row of the two-byte wide kernel takes for n entries:
    n rounded up to 4 mod 8."""
    return n + (12 - n % 8) % 8


def _window_scores(window: int) -> bool:
    """Whether the two-byte wide kernel keeps each query's whole window of
    scores (its 16 rows of window^2 floats within a sixth of the budget:
    windows up to 11), else a chunk's, with the softmax online over the
    chunks."""
    return _NAT_STRIP * (_score_ld(window * window) + 1) * 4 <= _NAT_BUDGET // 6


def _mma_wide_smem(window: int, D: int, npos: int, stages: int) -> int:
    """The two-byte wide kernel's shared bytes for chunks of npos positions:
    16 score rows (of the window, or of the chunk's positions) and the
    corrections in float32, the strip's q (all of D in units of 64, and 8),
    p's high parts and remainders, `stages` ring buffers of 72 two-byte
    elements a position."""
    entries = window * window if _window_scores(window) else npos
    q_ld = -(-D // _NAT_MMA_WIDE_COLS) * _NAT_MMA_WIDE_COLS + 8
    fixed = _NAT_STRIP * ((_score_ld(entries) + 1) * 4 + q_ld * 2 + 2 * _NAT_P_LD * 2)
    return fixed + stages * npos * (_NAT_MMA_WIDE_COLS + 8) * 2


def _f32_wide_smem(npos: int, stages: int) -> int:
    """The float32 wide kernel's shared bytes for chunks of npos positions:
    16 rows of p (npos floats, rounded up to 4 mod 8) and `stages` units of
    the strip's 16 q rows and npos positions, 64 columns in rows of 68
    floats."""
    return _NAT_STRIP * _score_ld(npos) * 4 + \
        stages * (_NAT_STRIP + npos) * (_NAT_F32_WIDE_COLS + 4) * 4


def _nat_f32_rows(plan: NatPlan, halo_rows: int, halo_cols: int) -> int:
    """The rows of a strip's chunks in the float32 wide kernel
    (`f32_wide_rows` in csrc/neighborhood_attention.cu): as many as fit the
    plan's positions in pieces as wide as the strip's halo, clamped to the
    image, allows, within its rows."""
    piece = min(plan.cols, halo_cols)
    return max(1, min(plan.rows * plan.cols // piece, halo_rows))


def _nat_tile_rows(plan: NatPlan, halo_rows: int, halo_cols: int) -> int:
    """The rows of a strip's chunks in the two-byte wide kernel
    (`tile_rows` in csrc/neighborhood_attention.cu): the plan's, or more
    where the strip's halo clamped to the image is narrower than the plan's
    pieces, as many as the ring's buffers hold within 16 slots."""
    piece = min(plan.cols, halo_cols)
    nsx = -(-piece // 8)
    t = min(plan.rows * plan.cols // piece, halo_rows)
    while t > plan.rows and t * nsx > _NAT_MMA_WIDE_SLOTS:
        t -= 1
    return max(t, 1)


def _nat_plan(window: int, D: int, dtype, width: int) -> NatPlan:
    """The chunking `csrc/neighborhood_attention.cu` (`nat_plan`,
    `mma_wide_plan`, `f32_wide_plan`) picks for an odd `window`, head dim D,
    q's dtype and the image's width. The tile's halo, 8 + window - 1
    positions a side, is clamped to the width. Up to D = 128: where all of
    it fits `_NAT_BUDGET` it is one chunk staged once; else the block
    streams it through two buffers of half the budget each, in bands of
    whole rows, or of pieces of a row (a multiple of 8 positions) where one
    row does not fit. The two-byte kernel (bfloat16 and float16 alike) also
    stores its 64 output rows through shared memory. Above D = 128 the wide
    kernels cut rows into pieces of at most 64 columns. Two-byte types (a
    block owns a strip of 2 x 8
    queries, whose halo is 2 + window - 1 rows): as many rows a chunk as
    keep it at 16 slots of 8 columns and two ring buffers of 64 columns of
    K or V within the budget beside the score rows (of the window up to
    window 11, `_window_scores`, else of the chunk's positions), the
    strip's q and p; then as many buffers (2 to 4) as fit (window 7 at D =
    320: the 8 x 14 halo in one chunk, two buffers). float32 (the same
    strips): as many rows a chunk as keep it at 128 positions, then as many
    buffers (2 to 4) of the strip's q and the chunk's positions, 64 columns
    each, as fit half an SM beside the strip's rows of p (window 7 at D =
    320: the 8 x 14 halo in one chunk, three buffers)."""
    halo = _NAT_TILE + 2 * (window // 2)
    wide = min(halo, width)
    if D > _NAT_MAX_NARROW_D:
        cols = min(wide, 64)
        nsx = -(-cols // 8)
        if dtype in _HALF:
            rows = min(_NAT_STRIP_ROWS + 2 * (window // 2), _NAT_MMA_WIDE_SLOTS // nsx)
            while rows > 1 and _mma_wide_smem(window, D, rows * cols, 2) > _NAT_BUDGET:
                rows -= 1
            stages = _NAT_MMA_WIDE_STAGES
            while stages > 2 and _mma_wide_smem(window, D, rows * cols, stages) > _NAT_BUDGET:
                stages -= 1
            return NatPlan(rows, cols, stages, _mma_wide_smem(window, D, rows * cols, stages))
        rows = min(_NAT_STRIP_ROWS + 2 * (window // 2), _NAT_F32_WIDE_POS // cols)
        stages = _NAT_F32_WIDE_STAGES
        while stages > 2 and _f32_wide_smem(rows * cols, stages) > _NAT_F32_WIDE_BUDGET:
            stages -= 1
        return NatPlan(rows, cols, stages, _f32_wide_smem(rows * cols, stages))
    if dtype in _HALF:
        # D padded to 32 n, and 8 more against bank conflicts
        ld = 32 * next(n for n in (1, 2, 3, 4) if D <= 32 * n) + 8
        elem, out = 2, _NAT_TILE * _NAT_TILE * ld * 2
    else:
        ld = 4 * next(n for n in (2, 4, 8, 16, 32) if D <= 4 * n)  # four lanes, a share each
        elem, out = 4, 0
    pos = 2 * ld * elem  # one position of K and one of V
    if halo * wide * pos <= _NAT_BUDGET:
        return NatPlan(halo, wide, 1, max(halo * wide * pos, out))
    per = _NAT_BUDGET // 2
    cols = wide if wide * pos <= per else per // pos // 8 * 8
    rows = min(halo, per // (cols * pos))
    return NatPlan(rows, cols, 2, max(2 * rows * cols * pos, out))


def neighborhood_attention_reference(q, k, v, height: int, width: int, window: int):
    """Plain PyTorch version of `neighborhood_attention` (gathers every
    query's window; differentiable, and the route of the kernel's backward).
    q, k, v: [B, N = height*width, H, D]. Roundings as in the kernel: q scaled
    in its own dtype, everything else in float32 (the two-byte kernels feed
    the tensor cores each probability as a high part and a remainder in q's
    dtype, which keeps it float32-grade), output in q's dtype. The window
    is masked at the borders: a corner query sees only its in-image
    neighbours."""
    _check(q, k, v, "neighborhood_attention")
    _check_window(q, height, width, window)
    r = window // 2
    dev = q.device
    off = torch.arange(-r, r + 1, device=dev)
    ny = torch.arange(height, device=dev)[:, None, None, None] + off[None, None, :, None]
    nx = torch.arange(width, device=dev)[None, :, None, None] + off[None, None, None, :]
    valid = ((ny >= 0) & (ny < height) & (nx >= 0) & (nx < width)).reshape(-1, window * window)
    idx = (ny.clamp(0, height - 1) * width + nx.clamp(0, width - 1)).reshape(-1, window * window)
    kg = k[:, idx].float()  # [B, N, W2, H, D]
    vg = v[:, idx].float()
    s = torch.einsum("bnhd,bnwhd->bnhw", _scaled(q).float(), kg)
    s = s.masked_fill(~valid[None, :, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnhw,bnwhd->bnhd", p, vg).to(q.dtype)


class _NeighborhoodAttention(torch.autograd.Function):
    """Forward through the kernel, backward through the plain version's
    autograd, gradients cast back to the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, height, width, window):
        ctx.save_for_backward(q, k, v)
        ctx.geometry = (height, width, window)
        B, N, H, D = q.shape
        out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
        _launch("f3s_neighborhood_attention", "neighborhood_attention", (q, k, v), out,
                (_DTYPES[q.dtype], B, height, width, window, H, D))
        neighborhood_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = neighborhood_attention_reference(q, k, v, *ctx.geometry)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g.to(out.dtype))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def neighborhood_attention(q, k, v, height: int, width: int, window: int = 7):
    """Fused sliding-window attention: q, k, v [B, N = height*width, H, D];
    returns [B, N, H, D] in q's dtype. Scaling by 1/sqrt(D) happens here.
    Any height and width, any odd `window`, any D, any B * H (the JAX
    kernel's domain: its window and D are bounded by VMEM alone). The kernel
    streams the keys and values around an 8 x 8 tile of queries through
    shared memory in chunks (`_nat_plan`), so no window is too wide for it;
    above D = 128 a block owns a strip of 2 x 8 queries and all of D up to
    320 (each score once; past 320 the output in column blocks of 320).
    Head dims and strides that are multiples of 16 bytes are staged 16
    bytes a copy, others an element at a time. float32 runs on the CUDA
    cores, bfloat16 and float16 on the tensor cores.

    A CUDA tensor launches the kernel (and adds one to
    `neighborhood_attention.launches`), with its gradient taken through
    `neighborhood_attention_reference`; a CPU tensor runs that plain version.
    """
    _check(q, k, v, "neighborhood_attention")
    _check_window(q, height, width, window)
    if k.shape[1] != q.shape[1]:
        raise ValueError("neighborhood_attention: k, v must have q's token count")
    if q.device.type == "cuda":
        return _NeighborhoodAttention.apply(q, k, v, height, width, window)
    if q.device.type == "cpu":
        return neighborhood_attention_reference(q, k, v, height, width, window)
    raise ValueError(f"unsupported device {q.device}")


neighborhood_attention.launches = 0
