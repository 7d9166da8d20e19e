"""The work of one Mask2Former forward (Swin backbone, deformable pixel
decoder, masked-attention decoder, semantic inference), counted from the
shapes that a configuration's `segmenter` entry and an input size define.

FLOPs are 2 per multiply-add of the products: dense layers and
convolutions, the attention's scores and weights times values, the mask
and semantic einsums. Normalisations, activations, softmax, sigmoid,
resizes, the deformable sampling's bilinear taps and its weighted sum
(elementwise, not products of two operands' rows) are left out, as
`counts.segformer_flops` leaves out its own. Swin's windowed layers run on
the padded grid (its qkv, attention and output projection take the padded
tokens), its MLP on the unpadded one.
"""

from __future__ import annotations

# levels of the deformable encoder (1/32, 1/16, 1/8): one sampling
# (`grid_sample`) a level in each deformable attention call
MSDA_LEVELS = 3


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def grids(seg: dict, hw):
    """(padded input (H, W), the token grid (h, w) of each Swin stage)."""
    d, p = seg["size_divisibility"], seg["patch_size"]
    H, W = _up(hw[0], d), _up(hw[1], d)
    h, w = H // p, W // p
    out = []
    for s in range(len(seg["depths"])):
        if s:
            h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return (H, W), out


def mask2former_flops(seg: dict, hw) -> int:
    """FLOPs of one image's forward at input size hw (see the module)."""
    (H, W), stages = grids(seg, hw)
    C0, ws, r = seg["embed_dim"], seg["window_size"], seg["mlp_ratio"]
    N = ws * ws
    macs = (H // seg["patch_size"]) * (W // seg["patch_size"]) * C0 * 3 * seg["patch_size"] ** 2
    for s, (h, w) in enumerate(stages):
        C = C0 * 2 ** s
        T, Tp = h * w, _up(h, ws) * _up(w, ws)
        per_block = (Tp * C * 3 * C  # qkv
                     + 2 * Tp * N * C  # scores, weights x values
                     + Tp * C * C  # output projection
                     + 2 * T * C * r * C)  # MLP
        macs += seg["depths"][s] * per_block
        if s < len(stages) - 1:  # patch merging: LayerNorm(4C) -> Linear(4C, 2C)
            macs += (-(-h // 2)) * (-(-w // 2)) * 4 * C * 2 * C
    # pixel decoder
    D = seg["conv_dim"]
    enc = stages[1:]
    S = sum(h * w for h, w in enc)
    macs += sum(h * w * C0 * 2 ** (s + 1) * D for s, (h, w) in enumerate(enc))  # input proj
    M, L, P = seg["enc_heads"], MSDA_LEVELS, seg["enc_points"]
    per_layer = (S * D * D  # value projection
                 + S * D * M * L * P * 2  # sampling offsets
                 + S * D * M * L * P  # attention weights
                 + S * D * D  # output projection
                 + 2 * S * D * seg["enc_ffn_dim"])  # FFN
    macs += seg["enc_layers"] * per_layer
    T4 = stages[0][0] * stages[0][1]
    macs += T4 * C0 * D + T4 * D * D * 9 + T4 * D * seg["mask_dim"]  # lateral, 3x3, mask features
    # transformer decoder
    Q, E = seg["num_queries"], seg["hidden_dim"]
    heads = Q * E * (seg["num_classes"] + 1) + Q * E * E * 2 + Q * E * seg["mask_dim"] \
        + Q * seg["mask_dim"] * T4  # class, mask MLP, mask einsum
    macs += (seg["dec_layers"] + 1) * heads
    for i in range(seg["dec_layers"]):
        h, w = enc[::-1][i % MSDA_LEVELS]
        Tl = h * w
        macs += (2 * Q * E * E + 2 * Tl * E * E + 2 * Q * Tl * E  # cross-attention
                 + 4 * Q * E * E + 2 * Q * Q * E  # self-attention
                 + 2 * Q * E * seg["dec_ffn_dim"])  # FFN
    macs += seg["num_classes"] * Q * hw[0] * hw[1]  # semantic einsum
    return 2 * macs
