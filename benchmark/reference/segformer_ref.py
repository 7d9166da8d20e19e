"""Plain reference of SegFormer (Xie et al. 2021, arXiv:2105.15203): the
Mix-Transformer encoder (overlapping patch embeddings, efficient
self-attention with a spatial-reduction convolution, Mix-FFN with a 3x3
depthwise convolution, tanh GELU) and the all-MLP decoder, in functional
PyTorch. Weights are read from a Flax-layout npz snapshot (convolution
kernels HWIO, dense kernels [in, out]), as the program's checkpoints are
written. Imports nothing of the program.

`mode` "float32" computes in float32 with TF32 off. "fp8" is the control:
every operand of every product (dense, convolution, attention scores and
weights) is first rounded to float8 e4m3 with a per-tensor scale (its
largest magnitude onto e4m3's 448), one step below the configuration's
bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def load_npz(path, device) -> dict:
    """The snapshot's parameters as float32 tensors on `device`, keyed by
    their Flax paths."""
    z = np.load(path)
    return {k: torch.as_tensor(z[k].astype(np.float32), device=device)
            for k in z.files if not k.startswith("__meta__")}


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class SegFormerRef:
    def __init__(self, params: dict, cfg: dict, mode: str = "float32"):
        if mode not in ("float32", "fp8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p, self.cfg, self.mode = params, cfg, mode

    def _q(self, x):
        return fp8(x) if self.mode == "fp8" else x

    def dense(self, x, name):
        return F.linear(self._q(x), self._q(self.p[name + "/kernel"].t()), self.p[name + "/bias"])

    def conv(self, x, name, stride=1, padding=0, groups=1):
        w = self.p[name + "/kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(self._q(x), self._q(w), self.p[name + "/bias"], stride=stride,
                        padding=padding, groups=groups)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + "/scale"], self.p[name + "/bias"],
                            LN_EPS)

    def attention(self, x, hw, pre, heads, sr):
        B, N, C = x.shape
        d = C // heads
        q = self.dense(x, pre + "q").reshape(B, N, heads, d).transpose(1, 2)
        kv = x
        if sr > 1:
            g = x.transpose(1, 2).reshape(B, C, *hw)
            ph, pw = ((-s) % sr for s in hw)  # SAME padding at stride = kernel
            g = F.pad(g, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            kv = self.conv(g, pre + "sr", stride=sr).flatten(2).transpose(1, 2)
            kv = self.ln(kv, pre + "LayerNorm_0")
        M = kv.shape[1]
        k = self.dense(kv, pre + "k").reshape(B, M, heads, d).transpose(1, 2)
        v = self.dense(kv, pre + "v").reshape(B, M, heads, d).transpose(1, 2)
        s = self._q(q) @ self._q(k).transpose(-1, -2) / math.sqrt(d)
        out = self._q(torch.softmax(s, dim=-1)) @ self._q(v)
        return self.dense(out.transpose(1, 2).reshape(B, N, C), pre + "proj")

    def ffn(self, x, hw, pre):
        B, N, _ = x.shape
        h = self.dense(x, pre + "fc1")
        g = h.transpose(1, 2).reshape(B, -1, *hw)
        g = self.conv(g, pre + "dw", padding=1, groups=g.shape[1])
        return self.dense(F.gelu(g.flatten(2).transpose(1, 2), approximate="tanh"), pre + "fc2")

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] in [0, 1] -> logits [B, H, W, classes]."""
        cfg = self.cfg
        B, H, W, _ = images.shape
        x = images.permute(0, 3, 1, 2)
        feats = []
        for s in range(4):
            k = cfg["patch_sizes"][s]
            x = self.conv(x, f"patch_embed{s}/Conv_0", stride=cfg["patch_strides"][s],
                          padding=k // 2)
            hw = tuple(x.shape[2:])
            t = self.ln(x.flatten(2).transpose(1, 2), f"patch_embed{s}/LayerNorm_0")
            for b in range(cfg["depths"][s]):
                pre = f"stage{s}_block{b}/"
                t = t + self.attention(self.ln(t, pre + "LayerNorm_0"), hw,
                                       pre + "EfficientAttention_0/", cfg["num_heads"][s],
                                       cfg["sr_ratios"][s])
                t = t + self.ffn(self.ln(t, pre + "LayerNorm_1"), hw, pre + "MixFFN_0/")
            t = self.ln(t, f"LayerNorm_{s}")
            feats.append((t, hw))
            x = t.transpose(1, 2).reshape(B, -1, *hw)
        hw4 = feats[0][1]
        ups = []
        for s, (t, hw) in enumerate(feats):
            f = self.dense(t, f"linear_c{s}")
            if hw != hw4:
                f = f.transpose(1, 2).reshape(B, -1, *hw)
                f = F.interpolate(f, size=hw4, mode="bilinear", align_corners=False)
                f = f.flatten(2).transpose(1, 2)
            ups.append(f)
        x = self.dense(torch.cat(ups[::-1], dim=-1), "fuse")
        x = F.gelu(self.ln(x, f"LayerNorm_{4}"), approximate="tanh")
        logits = self.dense(x, "classifier").transpose(1, 2).reshape(B, -1, *hw4)
        logits = F.interpolate(logits, size=(H, W), mode="bilinear", align_corners=False)
        return logits.permute(0, 2, 3, 1)


def masks_from_colors(model: SegFormerRef, colors: torch.Tensor, input_hw, conf_threshold,
                      batch: int = 8) -> torch.Tensor:
    """Per-frame class masks at the colours' resolution: frames [F, H, W, 3]
    in [0, 1] resized (bilinear, half-pixel centres) to the model's input,
    the argmax class, "unclassified" (the last class) where the softmax
    confidence is below `conf_threshold`, resized back by nearest-exact
    sampling. Returns [F, H*W] uint8."""
    Fn, H, W, _ = colors.shape
    out = torch.empty((Fn, H * W), dtype=torch.uint8, device=colors.device)
    thr = float(np.float32(conf_threshold))
    for a in range(0, Fn, batch):
        x = colors[a:a + batch].permute(0, 3, 1, 2)
        x = F.interpolate(x, size=tuple(input_hw), mode="bilinear", align_corners=False)
        logits = model(x.permute(0, 2, 3, 1).contiguous())
        sem = logits.argmax(-1)
        conf = torch.softmax(logits, dim=-1).amax(-1)
        sem = torch.where(conf < thr, logits.shape[-1] - 1, sem)
        sem = F.interpolate(sem[:, None].float(), size=(H, W), mode="nearest-exact")
        out[a:a + batch] = sem[:, 0].reshape(len(sem), -1).to(torch.uint8)
    return out
