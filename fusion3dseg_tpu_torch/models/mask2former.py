"""Mask2Former with a Swin backbone, for semantic inference, as
`torch.nn.Module`s.

Cheng et al. 2022, "Masked-attention Mask Transformer for Universal Image
Segmentation" (arXiv:2112.01527), in the layout of the authors' code
(github.com/facebookresearch/Mask2Former): the Swin backbone
(`D2SwinTransformer`), the multi-scale deformable pixel decoder
(`MSDeformAttnPixelDecoder`), the masked-attention transformer decoder
(`MultiScaleMaskedTransformerDecoder`) and `semantic_inference`. The
preset `Mask2FormerConfig.swin_large_coco()` is the COCO-panoptic Swin-L
(`configs/coco/panoptic-segmentation/swin/
maskformer2_swin_large_IN21k_384_bs16_100ep.yaml`), the network under the
reference flow's OneFormer at inference, less OneFormer's task token.

The contract is the port's segmenter's (`models/segformer.py`): images
`[B, H, W, 3]` float in [0, 1] go in, float32 semantic scores
`[B, H, W, num_classes]` at the input size come out. Inside the forward
the images are normalised with ImageNet's mean and std on the 0-255 scale,
padded with zeros to a multiple of `size_divisibility` and the scores
cropped back, as detectron2's `ImageList` and `sem_seg_postprocess` do.

Precision follows the SegFormer file: Dense and Conv layers compute in
`config.dtype` (their parameters held in it); LayerNorm, GroupNorm, every
softmax and the sigmoids compute in float32; the class head and the
semantic einsum stay float32. Deformable sampling takes its locations and
values in float32 (a bfloat16 location moves a point by up to half a
pixel at the 1/8 level).

Attention: Swin's windows go through `F.scaled_dot_product_attention`
with the relative-position bias and the shift mask as one additive mask
(the shift mask built once per stage and padded grid, and cached); the
deformable attention is `ms_deform_attn_core_pytorch`'s (per level
`grid_sample`, then the weighted sum); the decoder's masked cross-attention
is SDPA with a boolean mask, a fully masked query row attending
everywhere.

Weights are random, drawn from a `torch.Generator` (`create_model`):
Xavier-uniform Dense and Conv weights, zero biases, relative-position
tables from a normal of std 0.02 (timm's `trunc_normal_`, cut at +-2),
embeddings from a unit normal, and, unlike
Mask2Former's zero init, random sampling-offset weights (so that the
sampling locations depend on the input, as in a trained model) over its
direction-grid bias. Loading the published checkpoint is not supported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fusion3dseg_tpu_torch.models.segformer import Dense
from fusion3dseg_tpu_torch.utils import timing

# detectron2's ImageNet statistics on the 0-255 scale (RGB input)
PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
# the shift mask's value where two tokens of a window come from different
# regions of the rolled map (Swin's own)
SHIFT_MASK = -100.0
LN_EPS = 1e-5
GN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class Mask2FormerConfig:
    num_classes: int = 133  # semantic channels; the class head has one more, "no object"
    # backbone: Swin
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: int = 4
    patch_size: int = 4
    # pixel decoder: 1/32, 1/16 and 1/8 through the deformable encoder,
    # 1/4 through the lateral
    conv_dim: int = 256
    mask_dim: int = 256
    norm_groups: int = 32
    enc_layers: int = 6
    enc_heads: int = 8
    enc_points: int = 4
    enc_ffn_dim: int = 1024
    # transformer decoder
    num_queries: int = 200
    hidden_dim: int = 256
    dec_heads: int = 8
    dec_ffn_dim: int = 2048
    dec_layers: int = 9  # DEC_LAYERS 10 less the prediction from the queries alone
    size_divisibility: int = 32
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def swin_large_coco() -> "Mask2FormerConfig":
        """Swin-L (384 pretraining, window 12) on COCO panoptic's 133 classes."""
        return Mask2FormerConfig()


# levels of the deformable encoder: res5, res4, res3 (strides 32, 16, 8)
ENC_LEVELS = 3


def test_resize_hw(h: int, w: int, short: int = 800, longest: int = 1333) -> Tuple[int, int]:
    """detectron2's `ResizeShortestEdge` at test time (the config's
    MIN_SIZE_TEST 800, MAX_SIZE_TEST 1333): the input size of an h x w
    frame. 480 x 640 -> (800, 1067)."""
    scale = short / min(h, w)
    if max(h, w) * scale > longest:
        scale = longest / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


class Conv(nn.Conv2d):
    """`nn.Conv2d` on channels-last maps [B, H, W, C], computing in `dtype`."""

    def __init__(self, din: int, dout: int, kernel: int, dtype: torch.dtype, **kw):
        super().__init__(din, dout, kernel, **kw)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = self._conv_forward(x.to(self.dtype).permute(0, 3, 1, 2), self.weight.to(self.dtype), b)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 (parameters and arithmetic), the output rounded
    to `out_dtype`."""

    def __init__(self, dim: int, out_dtype: torch.dtype):
        super().__init__(dim, eps=LN_EPS)
        self.out_dtype = out_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.out_dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm in float32 on channels-last maps [B, H, W, C]."""

    def __init__(self, groups: int, dim: int, out_dtype: torch.dtype):
        super().__init__(groups, dim, eps=GN_EPS)
        self.out_dtype = out_dtype

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.permute(0, 2, 3, 1).to(self.out_dtype)


# ------------------------------------------------------------------ Swin


def relative_position_index(window: int) -> torch.Tensor:
    """[N, N] index into a (2 window - 1)^2 bias table (Swin's)."""
    c = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                   indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def shift_mask(hp: int, wp: int, window: int, shift: int, device) -> torch.Tensor:
    """[nW, 1, N, N] float32: 0 where two tokens of a window of the rolled
    (hp, wp) map come from one region, SHIFT_MASK where not. Built with
    device operations only (no copy from the host)."""

    def region(n):  # Swin's slices (0, -window), (-window, -shift), (-shift, None)
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    img = region(hp)[:, None] * 3 + region(wp)[None, :]
    win = img.view(hp // window, window, wp // window, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    other = win[:, None, :] != win[:, :, None]
    return torch.where(other, SHIFT_MASK, 0.0).float()[:, None]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, Hp, Wp, C] -> [B, nW, window^2, C], windows in row-major order."""
    B, Hp, Wp, C = x.shape
    x = x.view(B, Hp // window, window, Wp // window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, -1, window * window, C)


def window_reverse(w: torch.Tensor, window: int, hp: int, wp: int) -> torch.Tensor:
    """Inverse of `window_partition`."""
    B, C = w.shape[0], w.shape[-1]
    x = w.view(B, hp // window, wp // window, window, window, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hp, wp, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, dtype):
        super().__init__()
        self.heads, self.window, self.dtype = heads, window, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """x [B, nW, N, C] windows; mask [nW, 1, N, N] (shifted) or None."""
        B, nW, N, C = x.shape
        h = self.heads
        qkv = self.qkv(x).view(B, nW, N, 3, h, C // h).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv.unbind(0)  # [B, nW, h, N, d]
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        # [h, N, N], contiguous: the fused kernels take a mask whose last
        # axis has stride 1
        bias = bias.view(N, N, h).permute(2, 0, 1).contiguous()
        if mask is None:
            am = bias[None].to(q.dtype)  # [1, h, N, N] over every window
            q, k, v = (t.reshape(B * nW, h, N, -1) for t in (q, k, v))
        else:
            am = (bias[None] + mask).to(q.dtype).reshape(1, nW * h, N, N)
            q, k, v = (t.reshape(B, nW * h, N, -1) for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=am)
        out = out.view(B, nW, h, N, -1).transpose(2, 3).reshape(B, nW, N, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio, dtype):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, mlp_ratio * dim, dtype)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """x [B, H, W, C]; `mask` the stage's shift mask at its padded grid."""
        B, H, W, C = x.shape
        ws, s = self.window, self.shift
        y = self.norm1(x)
        ph, pw = (-H) % ws, (-W) % ws
        if ph or pw:
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = H + ph, W + pw
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        y = self.attn(window_partition(y, ws), mask if s else None)
        y = window_reverse(y, ws, hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = Dense(4 * dim, 2 * dim, dtype, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, heads, window, mlp_ratio, dtype, downsample: bool):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2, mlp_ratio, dtype)
            for i in range(depth))
        self.downsample = PatchMerging(dim, dtype) if downsample else None


class SwinBackbone(nn.Module):
    """Swin as Mask2Former's `D2SwinTransformer`: outputs res2-res5
    [B, h, w, C] channels-last, each through its own LayerNorm."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        dt, C, p = cfg.dtype, cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = Conv(3, C, p, dt, stride=p)
        self.patch_embed.norm = LayerNorm(C, dt)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            SwinStage(C * 2 ** i, cfg.depths[i], cfg.num_heads[i], cfg.window_size,
                      cfg.mlp_ratio, dt, i < n - 1) for i in range(n))
        for i in range(n):
            setattr(self, f"norm{i}", LayerNorm(C * 2 ** i, dt))
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, hp, wp, window, device):
        key = (hp, wp, window, str(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(hp, wp, window, window // 2, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_embed.norm(self.patch_embed.proj(x))
        outs = []
        for i, stage in enumerate(self.layers):
            _, H, W, _ = x.shape
            ws = stage.window
            mask = self._mask(H + (-H) % ws, W + (-W) % ws, ws, x.device)
            for blk in stage.blocks:
                x = blk(x, mask)
            outs.append(getattr(self, f"norm{i}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


# ------------------------------------------------------------ pixel decoder


def sine_position(h: int, w: int, dim: int, device) -> torch.Tensor:
    """[h, w, 2 * dim] float32: DETR's normalised sine embedding (temperature
    10000, scale 2 pi) of an unmasked map, y's half first."""
    scale, eps = 2 * math.pi, 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    y = y / (y[-1:] + eps) * scale
    x = x / (x[-1:] + eps) * scale
    t = torch.arange(dim, dtype=torch.float32, device=device)
    t = 10000 ** (2 * torch.div(t, 2, rounding_mode="floor") / dim)

    def embed(p):  # [n] -> [n, dim], sin and cos interleaved
        p = p[:, None] / t
        return torch.stack((p[:, 0::2].sin(), p[:, 1::2].cos()), dim=2).flatten(1)

    py, px = embed(y), embed(x)
    return torch.cat([py[:, None].expand(h, w, dim), px[None].expand(h, w, dim)], dim=-1)


def msda_core(value: torch.Tensor, shapes, loc: torch.Tensor, weights: torch.Tensor):
    """`ms_deform_attn_core_pytorch`: value [B, S, heads, d] (levels
    concatenated), loc [B, Lq, heads, L, P, 2] in [0, 1] (x, y), weights
    [B, Lq, heads, L, P] -> [B, Lq, heads * d] float32. Each level's values
    are sampled by bilinear `grid_sample` (zero padding, half-pixel
    centres) at 2 loc - 1 and weighted; the levels' sums add up. The
    points lie on the sampled grid's rows and the queries along them, so
    that the weighted sum runs over a middle axis of 4, not over 4
    contiguous values."""
    B, S, M, D = value.shape
    Lq, P = loc.shape[1], loc.shape[4]
    out = None
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].float().permute(0, 2, 3, 1).reshape(B * M, D, h, w)
        start += h * w
        g = (2 * loc[:, :, :, lvl] - 1).permute(0, 2, 3, 1, 4).reshape(B * M, P, Lq, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        wl = weights[:, :, :, lvl].permute(0, 2, 3, 1).reshape(B * M, 1, P, Lq)
        part = (s * wl).sum(2)  # [B*M, D, Lq]
        out = part if out is None else out + part
    return out.view(B, M * D, Lq).transpose(1, 2)


class MSDeformAttn(nn.Module):
    def __init__(self, dim: int, levels: int, heads: int, points: int, dtype):
        super().__init__()
        self.levels, self.heads, self.points = levels, heads, points
        self.sampling_offsets = Dense(dim, heads * levels * points * 2, dtype)
        self.attention_weights = Dense(dim, heads * levels * points, dtype)
        self.value_proj = Dense(dim, dim, dtype)
        self.output_proj = Dense(dim, dim, dtype)
        self._norms: Dict[tuple, torch.Tensor] = {}

    def forward(self, query, ref, value_in, shapes):
        """query, value_in [B, S, C]; ref [S, 2] (x, y) in (0, 1), one point
        a query on every level."""
        B, S, C = query.shape
        M, L, P = self.heads, self.levels, self.points
        value = self.value_proj(value_in).view(B, S, M, C // M)
        off = self.sampling_offsets(query).float().view(B, S, M, L, P, 2)
        aw = self.attention_weights(query).float().view(B, S, M, L * P).softmax(-1)
        # offsets are in pixels of each level: x over its width, y over its height
        loc = ref[None, :, None, None, None, :] + off / self._normalizer(shapes, query.device)
        out = msda_core(value, shapes, loc, aw.view(B, S, M, L, P))
        return self.output_proj(out.to(value.dtype))

    def _normalizer(self, shapes, device) -> torch.Tensor:
        """[L, 1, 2] float32 (w, h) of each level, filled on the device."""
        key = (tuple(shapes), str(device))
        if key not in self._norms:
            n = torch.empty((len(shapes), 1, 2), device=device)
            for lvl, (h, w) in enumerate(shapes):
                n[lvl, 0, 0], n[lvl, 0, 1] = float(w), float(h)
            self._norms[key] = n
        return self._norms[key]


class EncoderLayer(nn.Module):
    """`MSDeformAttnTransformerEncoderLayer`: deformable self-attention and
    a ReLU FFN, each followed by its LayerNorm (post-norm)."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        d, dt = cfg.conv_dim, cfg.dtype
        self.self_attn = MSDeformAttn(d, ENC_LEVELS, cfg.enc_heads, cfg.enc_points, dt)
        self.norm1 = LayerNorm(d, dt)
        self.linear1 = Dense(d, cfg.enc_ffn_dim, dt)
        self.linear2 = Dense(cfg.enc_ffn_dim, d, dt)
        self.norm2 = LayerNorm(d, dt)

    def forward(self, src, pos, ref, shapes):
        with timing.range("m2f.msda"):
            timing.count("m2f.msda_calls")
            src = self.norm1(src + self.self_attn(src + pos, ref, src, shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class PixelDecoder(nn.Module):
    """`MSDeformAttnPixelDecoder`: res3-res5 projected (1x1 conv + GroupNorm),
    with sine positions and a level embedding, through the deformable
    encoder; res2's lateral (1x1 conv + GroupNorm) plus the encoded 1/8
    map upsampled, through a 3x3 conv + GroupNorm + ReLU; `mask_features`
    a 1x1 conv of that. Returns (mask_features [B, h4, w4, mask_dim], the
    encoded maps at 1/32, 1/16, 1/8 [B, h, w, conv_dim])."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        d, dt, g = cfg.conv_dim, cfg.dtype, cfg.norm_groups
        chans = [cfg.embed_dim * 2 ** i for i in range(len(cfg.depths))]
        # res5, res4, res3
        self.input_proj = nn.ModuleList(
            nn.Sequential(Conv(c, d, 1, dt), GroupNorm(g, d, dt)) for c in chans[:0:-1])
        self.level_embed = nn.Parameter(torch.zeros(ENC_LEVELS, d))
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.enc_layers))
        self.adapter_1 = nn.Sequential(Conv(chans[0], d, 1, dt, bias=False), GroupNorm(g, d, dt))
        self.layer_1 = nn.Sequential(Conv(d, d, 3, dt, padding=1, bias=False), GroupNorm(g, d, dt))
        self.mask_features = Conv(d, cfg.mask_dim, 1, dt)
        self.dtype = dt

    def forward(self, feats: List[torch.Tensor], pos_of):
        """feats res2-res5 [B, h, w, C]; `pos_of(h, w)` the [h, w, C] sine
        positions."""
        dt = self.dtype
        srcs, pos, shapes = [], [], []
        for lvl, f in enumerate(feats[:0:-1]):
            B, h, w, _ = f.shape
            srcs.append(self.input_proj[lvl](f).reshape(B, h * w, -1))
            pos.append((pos_of(h, w).reshape(h * w, -1) + self.level_embed[lvl]).to(dt))
            shapes.append((h, w))
        src, pos = torch.cat(srcs, dim=1), torch.cat(pos, dim=0)
        ref = _reference_points(shapes, src.device)
        for layer in self.layers:
            src = layer(src, pos, ref, shapes)
        outs, start = [], 0
        for h, w in shapes:
            outs.append(src[:, start:start + h * w].reshape(B, h, w, -1))
            start += h * w
        lat = self.adapter_1(feats[0])
        up = F.interpolate(outs[-1].permute(0, 3, 1, 2).float(), size=lat.shape[1:3],
                           mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        y = F.relu(self.layer_1((lat.float() + up).to(dt)))
        return self.mask_features(y), outs


def _reference_points(shapes, device) -> torch.Tensor:
    """[S, 2] (x, y): each level's pixel centres over its size, levels
    concatenated (`get_reference_points` with every valid ratio 1)."""
    refs = []
    for h, w in shapes:
        y = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
        refs.append(torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], -1)
                    .reshape(-1, 2))
    return torch.cat(refs)


# ------------------------------------------------------- transformer decoder


class Attention(nn.Module):
    """`nn.MultiheadAttention`'s projections (one [3C, C] input projection
    with bias, an output projection) around SDPA."""

    def __init__(self, dim: int, heads: int, dtype):
        super().__init__()
        self.heads = heads
        self.in_proj = Dense(dim, 3 * dim, dtype)
        self.out_proj = Dense(dim, dim, dtype)

    def forward(self, q, k, v, keep=None):
        """q [B, Lq, C], k and v [B, Lk, C]; keep [B, 1, Lq, Lk] bool, True
        where a query attends."""
        B, Lq, C = q.shape
        h, dt = self.heads, self.in_proj.dtype
        w, b = self.in_proj.weight.to(dt), self.in_proj.bias.to(dt)
        q = F.linear(q, w[:C], b[:C]).view(B, Lq, h, -1).transpose(1, 2)
        k = F.linear(k, w[C:2 * C], b[C:2 * C])
        v = F.linear(v, w[2 * C:], b[2 * C:])
        k, v = (t.view(B, -1, h, C // h).transpose(1, 2) for t in (k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        return self.out_proj(out.transpose(1, 2).reshape(B, Lq, C))


class DecoderLayer(nn.Module):
    """Masked cross-attention, self-attention, FFN; each residual followed
    by its LayerNorm (post-norm)."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        d, dt = cfg.hidden_dim, cfg.dtype
        self.cross_attn = Attention(d, cfg.dec_heads, dt)
        self.cross_norm = LayerNorm(d, dt)
        self.self_attn = Attention(d, cfg.dec_heads, dt)
        self.self_norm = LayerNorm(d, dt)
        self.linear1 = Dense(d, cfg.dec_ffn_dim, dt)
        self.linear2 = Dense(cfg.dec_ffn_dim, d, dt)
        self.ffn_norm = LayerNorm(d, dt)

    def forward(self, x, qpos, mem, mpos, keep):
        x = self.cross_norm(x + self.cross_attn(x + qpos, mem + mpos, mem, keep))
        q = x + qpos
        x = self.self_norm(x + self.self_attn(q, q, x))
        return self.ffn_norm(x + self.linear2(F.relu(self.linear1(x))))


def attention_keep(masks: torch.Tensor, size) -> torch.Tensor:
    """The masked cross-attention's mask from mask logits [B, Q, h, w]:
    [B, 1, Q, size[0] * size[1]] bool, True where a query attends: where
    the logits' sigmoid, resized (bilinear) to `size`, is at least 0.5, and
    everywhere in a row that would attend nowhere."""
    a = F.interpolate(masks, size=size, mode="bilinear", align_corners=False)
    keep = ~(a.sigmoid().flatten(2) < 0.5)
    return (keep | ~keep.any(-1, keepdim=True))[:, None]


class Predictor(nn.Module):
    """`MultiScaleMaskedTransformerDecoder` (mask classification, no input
    projection at hidden_dim == conv_dim). Returns the last layer's class
    logits [B, Q, classes + 1] float32 and mask logits [B, Q, h4, w4]."""

    def __init__(self, cfg: Mask2FormerConfig):
        super().__init__()
        d, dt = cfg.hidden_dim, cfg.dtype
        if d != cfg.conv_dim:
            raise ValueError("hidden_dim != conv_dim needs the decoder's input projection")
        self.query_feat = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.query_embed = nn.Parameter(torch.zeros(cfg.num_queries, d))
        self.level_embed = nn.Parameter(torch.zeros(ENC_LEVELS, d))
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.dec_layers))
        self.decoder_norm = LayerNorm(d, torch.float32)
        self.class_embed = Dense(d, cfg.num_classes + 1, torch.float32)
        self.mask_embed = nn.ModuleList(
            Dense(d, d if i < 2 else cfg.mask_dim, dt) for i in range(3))
        self.dtype = dt

    def heads(self, x, mask_features, size):
        """(class logits, mask logits [B, Q, h4, w4] float32, keep): the
        prediction of the queries x, and the attention mask of the next
        layer at `size` (`attention_keep`)."""
        y = self.decoder_norm(x)
        cls = self.class_embed(y)
        e = y.to(self.dtype)
        for i, lin in enumerate(self.mask_embed):
            e = lin(e)
            if i < 2:
                e = F.relu(e)
        B, h4, w4, C = mask_features.shape
        masks = torch.bmm(e, mask_features.view(B, h4 * w4, C).transpose(1, 2))
        masks = masks.float().view(B, -1, h4, w4)
        return cls, masks, attention_keep(masks, size)

    def forward(self, levels: List[torch.Tensor], mask_features, pos_of):
        dt = self.dtype
        B = mask_features.shape[0]
        mem, mpos, sizes = [], [], []
        for lvl, f in enumerate(levels):
            _, h, w, C = f.shape
            mem.append((f.reshape(B, h * w, C).float() + self.level_embed[lvl]).to(dt))
            mpos.append(pos_of(h, w).reshape(h * w, C).to(dt))
            sizes.append((h, w))
        qpos = self.query_embed.to(dt)
        x = self.query_feat.to(dt).expand(B, -1, -1)
        cls, masks, keep = self.heads(x, mask_features, sizes[0])
        for i, layer in enumerate(self.layers):
            lvl = i % ENC_LEVELS
            x = layer(x, qpos, mem[lvl], mpos[lvl], keep)
            cls, masks, keep = self.heads(x, mask_features, sizes[(i + 1) % ENC_LEVELS])
        return cls, masks


# -------------------------------------------------------------------- model


class Mask2Former(nn.Module):
    """Dense and Conv parameters held in `config.dtype` (the class head
    float32), the rest float32. See the module's docstring."""

    def __init__(self, config: Mask2FormerConfig = Mask2FormerConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = cfg = config
        self.backbone = SwinBackbone(cfg)
        self.pixel_decoder = PixelDecoder(cfg)
        self.predictor = Predictor(cfg)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(PIXEL_STD), persistent=False)
        self._init_weights(generator)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)) and m is not self.predictor.class_embed:
                m.to(cfg.dtype)
        self._pos: Dict[tuple, torch.Tensor] = {}

    @torch.no_grad()
    def _init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                rf = m.weight[0, 0].numel() if m.weight.dim() > 2 else 1
                bound = math.sqrt(6.0 / ((m.weight.shape[0] + m.weight.shape[1]) * rf))
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, generator=gen)
        # after the loop above, which zeroes every Dense bias, the offsets' too
        for m in self.modules():
            if isinstance(m, MSDeformAttn):
                # Mask2Former's direction grid: head k looks along angle
                # 2 pi k / heads, point p at (p + 1) times the unit step
                M, L, P = m.heads, m.levels, m.points
                theta = torch.arange(M, dtype=torch.float32) * (2.0 * math.pi / M)
                grid = torch.stack([theta.cos(), theta.sin()], -1)
                grid = grid / grid.abs().max(-1, keepdim=True)[0]
                grid = grid.view(M, 1, 1, 2).repeat(1, L, P, 1)
                grid *= torch.arange(1, P + 1, dtype=torch.float32).view(1, 1, P, 1)
                m.sampling_offsets.bias.copy_(grid.view(-1))
        for p in (self.pixel_decoder.level_embed, self.predictor.query_feat,
                  self.predictor.query_embed, self.predictor.level_embed):
            p.normal_(0.0, 1.0, generator=gen)

    def _pos_of(self, device):
        """`pos_of(h, w)`: the [h, w, hidden] sine positions, cached by size."""
        half = self.config.hidden_dim // 2

        def pos_of(h, w):
            key = (h, w, str(device))
            if key not in self._pos:
                self._pos[key] = sine_position(h, w, half, device)
            return self._pos[key]

        return pos_of

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] float in [0, 1]. Returns [B, H, W,
        num_classes] float32 semantic scores at the input size."""
        cfg = self.config
        B, H, W, _ = images.shape
        d = cfg.size_divisibility
        hp, wp = H + (-H) % d, W + (-W) % d
        timing.count("m2f.images", B)
        timing.count("m2f.padded_pixels", B * hp * wp)
        pos_of = self._pos_of(images.device)
        with timing.range("m2f.backbone"):
            x = (images.float() * 255.0 - self.pixel_mean) / self.pixel_std
            x = F.pad(x, (0, 0, 0, wp - W, 0, hp - H))
            feats = self.backbone(x)
        with timing.range("m2f.pixel_decoder"):
            mask_features, levels = self.pixel_decoder(feats, pos_of)
        with timing.range("m2f.decoder"):
            cls, masks = self.predictor(levels, mask_features, pos_of)
        with timing.range("m2f.semseg"):
            return semantic_inference(cls, masks, (hp, wp), (H, W))


def semantic_inference(cls: torch.Tensor, masks: torch.Tensor, padded_hw, hw) -> torch.Tensor:
    """Mask2Former's semantic inference: the mask logits [B, Q, h4, w4]
    upsampled (bilinear) to the padded input, cropped to the image,
    through a sigmoid; scores = sum over queries of softmax(cls) without
    "no object" times the masks. Returns [B, H, W, classes] float32."""
    B, Q = masks.shape[:2]
    H, W = hw
    m = F.interpolate(masks.float(), size=tuple(padded_hw), mode="bilinear",
                      align_corners=False)[:, :, :H, :W].sigmoid()
    p = torch.softmax(cls.float(), dim=-1)[..., :-1]
    return torch.bmm(m.reshape(B, Q, H * W).transpose(1, 2), p).view(B, H, W, -1)


def create_model(config: Mask2FormerConfig = Mask2FormerConfig(), seed: int = 0,
                 device="cuda") -> Mask2Former:
    """A Mask2Former in eval mode on `device` with random weights drawn
    from `seed` (on the host, so that every device draws the same)."""
    from fusion3dseg_tpu_torch import cuda

    dev = cuda.resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return Mask2Former(config, gen).to(dev).eval()
