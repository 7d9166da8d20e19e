"""SegFormer-style 2D semantic segmentation model (Mix-Transformer encoder,
all-MLP decoder) as `torch.nn.Module`s.

Counterpart of `fusion3dseg_tpu/models/segformer.py` (Flax). The public
contract is the same: images `[B, H, W, 3]` float in [0, 1] go in, float32
logits `[B, H, W, num_classes]` at input resolution come out. Inside, tokens
are `[B, N, C]` and convolutions run on `[B, C, h, w]` views.

What the Flax modules do that PyTorch's defaults do not, kept here so that
`models/convert.from_flax_params` carries a checkpoint across unchanged:

* GELU is the tanh approximation.
* LayerNorm has eps 1e-6, keeps float32 parameters and computes in float32
  whatever the activation dtype, and rounds only its output.
* Dense and Conv layers compute in `config.dtype`: their parameters are
  cast to it at use. The module holds them in `param_dtype`, which is
  `config.dtype` for inference (the cast is then no copy) and float32 for
  training, as Flax keeps `param_dtype=float32`. The classifier and the
  "hf" head's batch-norm stay float32.
* The spatial-reduction conv pads like Flax's `SAME`.
* The einsum attention branch divides the scores (in `config.dtype`) by
  sqrt(head_dim) before the float32 softmax; the fused kernels scale q.

`use_pallas_attention` keeps its name from the JAX config: it sends the
stages whose token count is a multiple of 512 through the fused
spatial-reduction kernel (`ops.attention.sr_attention`), so that both
packages take the same branch on the same input. `nat_windows` sends a stage
through `ops.attention.neighborhood_attention`. The model's
`use_cuda_attention=False` runs the same forward through the kernels' plain
PyTorch versions instead (a switch for comparisons, not a fallback).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fusion3dseg_tpu_torch.ops import attention as attn_ops
from fusion3dseg_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class SegFormerConfig:
    num_classes: int = 134  # 133 + unclassified
    # MiT-B0-like by default; scale up via width/depth
    embed_dims: Tuple[int, ...] = (32, 64, 160, 256)
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    decoder_dim: int = 256
    patch_strides: Tuple[int, ...] = (4, 2, 2, 2)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    # decode-head variant: "native" = bias + LayerNorm + GELU (what every
    # shipped checkpoint trains with); "hf" = the HF SegformerDecodeHead
    # recipe: bias-free fuse + frozen BatchNorm (running stats held as
    # ordinary parameters) + ReLU
    head: str = "native"
    dtype: torch.dtype = torch.bfloat16
    # fused spatial-reduction attention (ops/attention.sr_attention) for the
    # stages with N % 512 == 0
    use_pallas_attention: bool = False
    # per-stage neighbourhood (sliding-window) attention window; 0 = the
    # stage's spatial-reduction attention. E.g. (7, 0, 0, 0)
    nat_windows: Tuple[int, ...] = (0, 0, 0, 0)

    @staticmethod
    def _mit(depths, decoder_dim) -> "SegFormerConfig":
        return SegFormerConfig(embed_dims=(64, 128, 320, 512), depths=depths,
                               num_heads=(1, 2, 5, 8), decoder_dim=decoder_dim)

    @staticmethod
    def b1() -> "SegFormerConfig":
        return SegFormerConfig._mit((2, 2, 2, 2), 256)

    @staticmethod
    def b2() -> "SegFormerConfig":
        """MiT-B2 scale, the size of the shipped flagship checkpoint."""
        return SegFormerConfig._mit((3, 4, 6, 3), 768)

    @staticmethod
    def b3() -> "SegFormerConfig":
        return SegFormerConfig._mit((3, 4, 18, 3), 768)

    @staticmethod
    def b4() -> "SegFormerConfig":
        return SegFormerConfig._mit((3, 8, 27, 3), 768)

    @staticmethod
    def b5() -> "SegFormerConfig":
        return SegFormerConfig._mit((3, 6, 40, 3), 768)

    @staticmethod
    def named(name: str) -> "SegFormerConfig":
        """'b0'..'b5' preset lookup."""
        if name == "b0":
            return SegFormerConfig()
        return getattr(SegFormerConfig, name)()


class LayerNorm(nn.LayerNorm):
    """Flax's LayerNorm: eps 1e-6, float32 parameters and arithmetic, the
    output rounded to `out_dtype`."""

    def __init__(self, dim: int, out_dtype: torch.dtype):
        super().__init__(dim, eps=1e-6)
        self.out_dtype = out_dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.out_dtype)


class Dense(nn.Linear):
    """`nn.Linear` computing in `dtype`: weight and bias are cast at use."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype, bias: bool = True):
        super().__init__(din, dout, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x, self.weight.to(self.dtype), b)


class Conv(nn.Conv2d):
    """`nn.Conv2d` computing in `dtype`: weight and bias are cast at use."""

    def __init__(self, din: int, dout: int, kernel: int, dtype: torch.dtype, **kw):
        super().__init__(din, dout, kernel, **kw)
        self.dtype = dtype

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(self.dtype), self.bias.to(self.dtype))


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of Flax/XLA `SAME` along one axis."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def _conv_tokens(conv: nn.Conv2d, x: torch.Tensor, hw, pad=None) -> torch.Tensor:
    """Run `conv` on tokens [B, h*w, C] laid out on the (h, w) grid; returns
    ([B, C', h', w'])."""
    B, _, C = x.shape
    x = x.reshape(B, hw[0], hw[1], C).permute(0, 3, 1, 2)
    if pad is not None:
        x = F.pad(x, pad)
    return conv(x)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_dim: int, dim: int, patch: int, stride: int, dtype):
        super().__init__()
        self.conv = Conv(in_dim, dim, patch, dtype, stride=stride, padding=patch // 2)
        self.norm = LayerNorm(dim, dtype)

    def forward(self, x):
        """x: [B, C, H, W] -> tokens [B, h*w, dim], (h, w)."""
        x = self.conv(x)
        hw = x.shape[2:]
        return self.norm(x.flatten(2).transpose(1, 2)), (hw[0], hw[1])


class EfficientAttention(nn.Module):
    """Self-attention with spatial reduction of K/V (SegFormer's SRA), or,
    when nat_window > 0, sliding-window neighbourhood attention over the
    full-resolution K/V."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, dtype,
                 use_pallas: bool = False, nat_window: int = 0,
                 use_cuda_attention: bool = True):
        super().__init__()
        self.dim, self.heads, self.sr_ratio, self.dtype = dim, heads, sr_ratio, dtype
        self.use_pallas, self.nat_window = use_pallas, nat_window
        self.use_cuda_attention = use_cuda_attention
        # sqrt(head_dim) rounded to the activation dtype, as the scores'
        # divisor is in the JAX package
        self.sqrt_head_dim = float(torch.sqrt(
            torch.tensor(float(dim // heads), dtype=dtype, device="cpu")))
        self.q = Dense(dim, dim, dtype)
        self.k = Dense(dim, dim, dtype)
        self.v = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        if nat_window == 0 and sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, dtype, stride=sr_ratio)
            self.norm = LayerNorm(dim, dtype)

    def forward(self, x, hw):
        B, N, C = x.shape
        h, w = hw
        head_dim = self.dim // self.heads
        q = self.q(x).reshape(B, N, self.heads, head_dim)

        if self.nat_window > 0:
            k = self.k(x).reshape(B, N, self.heads, head_dim)
            v = self.v(x).reshape(B, N, self.heads, head_dim)
            nat = (attn_ops.neighborhood_attention if self.use_cuda_attention
                   else attn_ops.neighborhood_attention_reference)
            return self.proj(nat(q, k, v, h, w, self.nat_window).reshape(B, N, self.dim))

        kv_in = x
        if self.sr_ratio > 1:
            ph, pw = (_same_padding(s, self.sr_ratio, self.sr_ratio) for s in (h, w))
            pad = (*pw, *ph) if any(ph + pw) else None
            kv_in = _conv_tokens(self.sr, x, hw, pad).flatten(2).transpose(1, 2)
            kv_in = self.norm(kv_in)
        M = kv_in.shape[1]
        k = self.k(kv_in).reshape(B, M, self.heads, head_dim)
        v = self.v(kv_in).reshape(B, M, self.heads, head_dim)

        if self.use_pallas and N % 512 == 0:
            sra = (attn_ops.sr_attention if self.use_cuda_attention
                   else attn_ops.sr_attention_reference)
            out = sra(q, k, v)
        else:
            attn = torch.einsum("bnhd,bmhd->bhnm", q, k) / self.sqrt_head_dim
            attn = torch.softmax(attn.float(), dim=-1).to(self.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.proj(out.reshape(B, N, self.dim))


class MixFFN(nn.Module):
    def __init__(self, dim: int, ratio: int, dtype):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = Dense(dim, hidden, dtype)
        # 3x3 depthwise conv mixes local position info (SegFormer's
        # positional-encoding-free trick)
        self.dw = Conv(hidden, hidden, 3, dtype, padding=1, groups=hidden)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x, hw):
        x = _conv_tokens(self.dw, self.fc1(x), hw).flatten(2).transpose(1, 2)
        return self.fc2(F.gelu(x, approximate="tanh"))


class Block(nn.Module):
    def __init__(self, dim, heads, sr_ratio, mlp_ratio, dtype, use_pallas=False,
                 nat_window=0, use_cuda_attention=True):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = EfficientAttention(dim, heads, sr_ratio, dtype, use_pallas, nat_window,
                                       use_cuda_attention)
        self.norm2 = LayerNorm(dim, dtype)
        self.ffn = MixFFN(dim, mlp_ratio, dtype)

    def forward(self, x, hw):
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ffn(self.norm2(x), hw)


# the profiler ranges of the encoder's stages
_STAGE_RANGES = tuple(f"segformer.stage{s}" for s in range(4))


class SegFormer(nn.Module):
    """Dense/Conv parameters held in `param_dtype` (default `config.dtype`)
    and cast to `config.dtype` at use; LayerNorm, the classifier and the
    "hf" batch-norm float32. Weights are Xavier-uniform (LeCun normal for
    the depthwise conv), biases zero, drawn from `generator`.

    The "hf" head's batch-norm statistics (`bn_mean`, `bn_var`) are ordinary
    parameters, as in the JAX package: training moves them by gradient like
    any weight, where HF's BatchNorm would track running averages."""

    def __init__(self, config: SegFormerConfig = SegFormerConfig(),
                 generator: torch.Generator | None = None,
                 use_cuda_attention: bool = True, param_dtype: torch.dtype | None = None):
        super().__init__()
        cfg = self.config = config
        if cfg.head not in ("native", "hf"):
            raise ValueError(f"unknown head {cfg.head!r}")
        in_dim = 3
        for s in range(4):
            dim = cfg.embed_dims[s]
            setattr(self, f"patch_embed{s}", OverlapPatchEmbed(
                in_dim, dim, cfg.patch_sizes[s], cfg.patch_strides[s], cfg.dtype))
            nat = cfg.nat_windows[s] if s < len(cfg.nat_windows) else 0
            for d in range(cfg.depths[s]):
                setattr(self, f"stage{s}_block{d}", Block(
                    dim, cfg.num_heads[s], cfg.sr_ratios[s], cfg.mlp_ratio, cfg.dtype,
                    cfg.use_pallas_attention, nat, use_cuda_attention))
            setattr(self, f"stage_norm{s}", LayerNorm(dim, cfg.dtype))
            setattr(self, f"linear_c{s}", Dense(dim, cfg.decoder_dim, cfg.dtype))
            in_dim = dim
        self.fuse = Dense(4 * cfg.decoder_dim, cfg.decoder_dim, cfg.dtype, bias=cfg.head != "hf")
        if cfg.head == "hf":
            for name, fill in (("bn_scale", 1.0), ("bn_bias", 0.0), ("bn_mean", 0.0),
                               ("bn_var", 1.0)):
                setattr(self, name, nn.Parameter(torch.full((cfg.decoder_dim,), fill)))
        else:
            self.decoder_norm = LayerNorm(cfg.decoder_dim, cfg.dtype)
        self.classifier = Dense(cfg.decoder_dim, cfg.num_classes, torch.float32)
        self._init_weights(generator)
        param_dtype = cfg.dtype if param_dtype is None else param_dtype
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)) and m is not self.classifier:
                m.to(param_dtype)
        self.use_cuda_attention = use_cuda_attention

    @torch.no_grad()
    def _init_weights(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m.groups > 1:
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                rf = m.weight[0, 0].numel() if m.weight.dim() > 2 else 1
                bound = math.sqrt(6.0 / ((m.weight.shape[0] + m.weight.shape[1]) * rf))
                m.weight.uniform_(-bound, bound, generator=generator)
            if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
                m.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] float in [0, 1]. Returns [B, H, W, num_classes]
        float32 logits at input resolution.

        A float32 model's forward on the card runs its convolutions in
        float32: cuDNN's TF32 (PyTorch's default) is turned off for the call
        and turned back on after it."""
        if self.config.dtype == torch.float32 and images.is_cuda \
                and torch.backends.cudnn.allow_tf32:
            torch.backends.cudnn.allow_tf32 = False
            try:
                return self._forward(images)
            finally:
                torch.backends.cudnn.allow_tf32 = True
        return self._forward(images)

    def _forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        B, H, W, _ = images.shape
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)

        feats = []
        for s in range(4):
            with timing.range(_STAGE_RANGES[s]):
                x, hw = getattr(self, f"patch_embed{s}")(x)
                for d in range(cfg.depths[s]):
                    x = getattr(self, f"stage{s}_block{d}")(x, hw)
                x = getattr(self, f"stage_norm{s}")(x)
                feats.append((x, hw))
                x = x.transpose(1, 2).reshape(B, -1, *hw)

        with timing.range("segformer.decoder"):
            # all-MLP decoder: project every stage to decoder_dim, upsample to
            # the stride-4 grid, concatenate (deepest first), fuse, classify
            hw4 = feats[0][1]
            ups = []
            for s, (f, hw) in enumerate(feats):
                f = getattr(self, f"linear_c{s}")(f)
                if hw[0] != hw4[0]:
                    f = f.transpose(1, 2).reshape(B, -1, *hw)
                    f = F.interpolate(f, size=hw4, mode="bilinear", align_corners=False)
                    f = f.flatten(2).transpose(1, 2)
                ups.append(f)
            x = self.fuse(torch.cat(ups[::-1], dim=-1))
            if cfg.head == "hf":
                x = (x.float() - self.bn_mean) * (
                    self.bn_scale * torch.rsqrt(self.bn_var + 1e-5)) + self.bn_bias
                x = F.relu(x).to(cfg.dtype)
            else:
                x = F.gelu(self.decoder_norm(x), approximate="tanh")
            logits = self.classifier(x.float())  # [B, h4*w4, classes] float32
            logits = logits.transpose(1, 2).reshape(B, -1, *hw4)
            logits = F.interpolate(logits, size=(H, W), mode="bilinear", align_corners=False)
            return logits.permute(0, 2, 3, 1)


def create_model(config: SegFormerConfig = SegFormerConfig(), seed: int = 0,
                 input_hw: Tuple[int, int] = (512, 512), device="cuda",
                 use_cuda_attention: bool = True) -> SegFormer:
    """A SegFormer in eval mode on `device` with random weights drawn from
    `seed`. `input_hw` is accepted for the JAX signature's sake: no
    parameter's shape depends on it."""
    from fusion3dseg_tpu_torch import cuda

    dev = cuda.resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return SegFormer(config, gen, use_cuda_attention).to(dev).eval()
