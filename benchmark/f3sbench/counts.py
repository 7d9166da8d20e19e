"""The yardstick's table of peaks and the work a call's shapes define.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
A kernel's bound counts each input byte read once and each output byte
written once, whatever the kernel itself reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def k1_bytes(frames: int, npts: int) -> int:
    """K1 (`histogram_classify` on a [F, N] uint8 winner matrix): F * N
    bytes read, and total, top count and class (three int32) written per
    point: F * N + 12 * N."""
    return frames * npts + 12 * npts


def k1_bound_s(frames: int, npts: int) -> float:
    return k1_bytes(frames, npts) / HBM_BYTES_PER_S


def _stage_grids(seg: dict, hw):
    """(h, w) token grid of each SegFormer stage for an input hw."""
    h, w = hw
    out = []
    for k, s in zip(seg["patch_sizes"], seg["patch_strides"]):
        h = (h + 2 * (k // 2) - k) // s + 1
        w = (w + 2 * (k // 2) - k) // s + 1
        out.append((h, w))
    return out


def segformer_flops(seg: dict, hw) -> int:
    """FLOPs (2 per multiply-add) of one SegFormer forward at input hw,
    counted from the shapes: patch embeddings, per block the q, k, v and
    output projections, the spatial-reduction conv, the two attention
    products, Mix-FFN (two dense layers and the 3x3 depthwise conv), and the
    decoder's four projections, fusion and classifier. Normalisations,
    activations, softmax and resizes are left out."""
    macs = 0
    cin = 3
    grids = _stage_grids(seg, hw)
    D = seg["decoder_dim"]
    for s, (h, w) in enumerate(grids):
        C, k, r = seg["embed_dims"][s], seg["patch_sizes"][s], seg["sr_ratios"][s]
        N = h * w
        macs += N * C * k * k * cin
        M = (-(-h // r)) * (-(-w // r)) if r > 1 else N
        per_block = (2 * N * C * C  # q, out projection
                     + (M * C * r * r * C if r > 1 else 0)  # spatial reduction
                     + 2 * M * C * C  # k, v
                     + 2 * N * M * C  # scores, weights x values
                     + 2 * N * C * seg["mlp_ratio"] * C  # fc1, fc2
                     + N * seg["mlp_ratio"] * C * 9)  # depthwise 3x3
        macs += seg["depths"][s] * per_block
        macs += N * C * D  # linear_c
        cin = C
    N0 = grids[0][0] * grids[0][1]
    macs += N0 * 4 * D * D + N0 * D * seg["num_classes"]
    return 2 * macs


def attention_calls(seg: dict, hw, batch: int):
    """Every spatial-reduction attention call of one forward of `batch`
    images, in order: [(stage, B, N, M, heads, head_dim)], one per block,
    whatever kernel runs it."""
    calls = []
    for s, (h, w) in enumerate(_stage_grids(seg, hw)):
        N, r, C = h * w, seg["sr_ratios"][s], seg["embed_dims"][s]
        M = (-(-h // r)) * (-(-w // r)) if r > 1 else N
        heads = seg["num_heads"][s]
        calls += [(s, batch, N, M, heads, C // heads)] * seg["depths"][s]
    return calls


def k3_bound_s(B: int, N: int, M: int, H: int, D: int, itemsize: int = 2) -> float:
    """Least time of one K3 call: Q, K, V read and O written once at the HBM
    rate, or its 4 N M D FLOPs per (image, head) at the bfloat16 tensor-core
    peak, whichever is longer."""
    nbytes = itemsize * B * H * D * (2 * N + 2 * M)
    return max(nbytes / HBM_BYTES_PER_S, 4.0 * B * H * N * M * D / BF16_FLOPS)
