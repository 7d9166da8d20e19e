"""Plain reference of Mask2Former with a Swin backbone (Cheng et al. 2022,
arXiv:2112.01527; github.com/facebookresearch/Mask2Former) for semantic
inference, in functional PyTorch: Swin (patch embedding, windowed
self-attention with a relative-position bias, shifted windows under
Swin's region mask, patch merging), the multi-scale deformable pixel
decoder, the masked-attention transformer decoder and
`semantic_inference`. Parameters are a dict of float32 tensors keyed as the
program's `state_dict()` names them. Imports nothing of the program. The
repository's one plain Mask2Former: the benchmark holds the card to it,
and the port's CPU tests (`tests/test_torch_mask2former.py`) load it too.

Written from the authors' code, literally where it is plain: windows by
explicit reshapes, attention as softmax(q k^T / sqrt(d) + bias + mask) v,
the shift mask from Swin's slices, `ms_deform_attn_core_pytorch` (one
`grid_sample` a level, the levels stacked, then the weighted sum), the
decoder's boolean mask with its fully-masked-row rule, and the semantic
einsum. Departures from the paper: none in the network; the images are
normalised, padded to `size_divisibility` and the scores cropped as
detectron2 does, and the task token of OneFormer is absent.

`mode` "float32" computes in float32, TF32 off. "fp8" is
the control: every operand of every product (dense, convolution, the
attention's scores and weights, the deformable sampling's values and
weights, the mask and semantic einsums) is first rounded to float8 e4m3
with a per-tensor scale (its largest magnitude onto e4m3's 448), one step
below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
EPS = 1e-5
LEVELS = 3


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Mask2FormerRef:
    def __init__(self, params: dict, cfg: dict, mode: str = "float32"):
        if mode not in ("float32", "fp8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p, self.cfg, self.mode = params, cfg, mode

    def _q(self, x):
        return fp8(x) if self.mode == "fp8" else x

    # -------------------------------------------------------------- layers

    def linear(self, x, name, bias=True):
        b = self.p[name + ".bias"] if bias else None
        return F.linear(self._q(x), self._q(self.p[name + ".weight"]), b)

    def conv(self, x, name, padding=0, stride=1, bias=True):
        """x [B, C, H, W]."""
        b = self.p[name + ".bias"] if bias else None
        return F.conv2d(self._q(x), self._q(self.p[name + ".weight"]), b, stride=stride,
                        padding=padding)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"],
                            EPS)

    def gn(self, x, name):
        """x [B, C, H, W]."""
        return F.group_norm(x, self.cfg["norm_groups"], self.p[name + ".weight"],
                            self.p[name + ".bias"], EPS)

    def attend(self, q, k, v, bias=None):
        """softmax(q k^T / sqrt(d) + bias) v over the last two axes."""
        s = self._q(q) @ self._q(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
        if bias is not None:
            s = s + bias
        return self._q(torch.softmax(s, dim=-1)) @ self._q(v)

    # ---------------------------------------------------------------- Swin

    def swin_mask(self, hp, wp, ws, shift, device):
        """[nW, N, N]: Swin's attention mask of the rolled (hp, wp) map."""
        img = torch.zeros((hp, wp), device=device)
        cnt = 0
        for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
                img[hs, wsl] = cnt
                cnt += 1
        win = img.view(hp // ws, ws, wp // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)
        diff = win[:, None, :] - win[:, :, None]
        return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)

    def swin_block(self, x, pre, heads, ws, shift):
        """x [B, H, W, C]."""
        B, H, W, C = x.shape
        N, d = ws * ws, C // heads
        y = self.ln(x, pre + "norm1")
        pb, pr = (-H) % ws, (-W) % ws
        y = F.pad(y, (0, 0, 0, pr, 0, pb))
        hp, wp = H + pb, W + pr
        if shift:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        # windows: [B * nW, N, C]
        win = y.view(B, hp // ws, ws, wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        win = win.reshape(-1, N, C)
        nW = win.shape[0] // B
        qkv = self.linear(win, pre + "attn.qkv").reshape(-1, N, 3, heads, d).permute(2, 0, 3, 1, 4)
        table = self.p[pre + "attn.relative_position_bias_table"]
        coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
        coords = coords.flatten(1)
        rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
        index = (rel[:, :, 0] + ws - 1) * (2 * ws - 1) + (rel[:, :, 1] + ws - 1)
        bias = table[index.reshape(-1).to(table.device)].view(N, N, heads).permute(2, 0, 1)
        bias = bias[None]  # [1, heads, N, N]
        if shift:
            mask = self.swin_mask(hp, wp, ws, shift, x.device)
            bias = (bias.view(1, 1, heads, N, N) + mask.view(1, nW, 1, N, N)).view(-1, heads, N, N)
            bias = bias.repeat(B, 1, 1, 1)
        out = self.attend(qkv[0], qkv[1], qkv[2], bias)  # [B * nW, heads, N, d]
        out = self.linear(out.transpose(1, 2).reshape(-1, N, C), pre + "attn.proj")
        out = out.view(B, hp // ws, wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(B, hp, wp, C)
        if shift:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        x = x + out[:, :H, :W]
        h = self.ln(x, pre + "norm2")
        h = self.linear(F.gelu(self.linear(h, pre + "mlp.fc1")), pre + "mlp.fc2")
        return x + h

    def backbone(self, x):
        """x [B, 3, H, W] -> res2-res5 [B, h, w, C]."""
        cfg = self.cfg
        ws = cfg["window_size"]
        x = self.conv(x, "backbone.patch_embed.proj", stride=cfg["patch_size"])
        x = self.ln(x.permute(0, 2, 3, 1), "backbone.patch_embed.norm")
        outs = []
        for i, depth in enumerate(cfg["depths"]):
            for j in range(depth):
                x = self.swin_block(x, f"backbone.layers.{i}.blocks.{j}.", cfg["num_heads"][i], ws,
                                    0 if j % 2 == 0 else ws // 2)
            outs.append(self.ln(x, f"backbone.norm{i}"))
            if i < len(cfg["depths"]) - 1:
                B, H, W, C = x.shape
                x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                               x[:, 1::2, 1::2]], -1)
                pre = f"backbone.layers.{i}.downsample."
                x = self.linear(self.ln(x, pre + "norm"), pre + "reduction", bias=False)
        return outs

    # ------------------------------------------------------- pixel decoder

    @staticmethod
    def sine(h, w, num_feats, device):
        """DETR's `PositionEmbeddingSine(normalize=True)` of an unmasked
        [h, w] map: [2 num_feats, h, w]."""
        not_mask = torch.ones((1, h, w), device=device)
        y = not_mask.cumsum(1, dtype=torch.float32)
        x = not_mask.cumsum(2, dtype=torch.float32)
        y = y / (y[:, -1:, :] + 1e-6) * (2 * math.pi)
        x = x / (x[:, :, -1:] + 1e-6) * (2 * math.pi)
        t = torch.arange(num_feats, dtype=torch.float32, device=device)
        t = 10000 ** (2 * (t // 2) / num_feats)
        px, py = x[:, :, :, None] / t, y[:, :, :, None] / t
        px = torch.stack((px[:, :, :, 0::2].sin(), px[:, :, :, 1::2].cos()), dim=4).flatten(3)
        py = torch.stack((py[:, :, :, 0::2].sin(), py[:, :, :, 1::2].cos()), dim=4).flatten(3)
        return torch.cat((py, px), dim=3).permute(0, 3, 1, 2)[0]

    def msda(self, query, ref, value_in, shapes, pre):
        """`MSDeformAttn` with `ms_deform_attn_core_pytorch`."""
        cfg = self.cfg
        M, L, P = cfg["enc_heads"], LEVELS, cfg["enc_points"]
        N, Lq, C = query.shape
        D = C // M
        value = self.linear(value_in, pre + "value_proj").view(N, -1, M, D)
        off = self.linear(query, pre + "sampling_offsets").view(N, Lq, M, L, P, 2)
        aw = self.linear(query, pre + "attention_weights").view(N, Lq, M, L * P)
        aw = torch.softmax(aw, -1).view(N, Lq, M, L, P)
        normalizer = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                                  device=query.device)
        loc = ref[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]
        # ms_deform_attn_core_pytorch
        value_list = value.split([h * w for h, w in shapes], dim=1)
        grids = 2 * loc - 1
        sampled = []
        for lid, (h, w) in enumerate(shapes):
            v = self._q(value_list[lid]).flatten(2).transpose(1, 2).reshape(N * M, D, h, w)
            g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
            sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                         align_corners=False))
        aw = self._q(aw).transpose(1, 2).reshape(N * M, 1, Lq, L * P)
        out = (torch.stack(sampled, dim=-2).flatten(-2) * aw).sum(-1).view(N, M * D, Lq)
        return self.linear(out.transpose(1, 2), pre + "output_proj")

    def pixel_decoder(self, feats):
        """res2-res5 [B, h, w, C] -> (mask_features [B, C, h4, w4], the
        encoded maps at 1/32, 1/16, 1/8 [B, C, h, w])."""
        cfg = self.cfg
        dev = feats[0].device
        srcs, pos, shapes = [], [], []
        for lvl, f in enumerate(feats[:0:-1]):
            x = f.permute(0, 3, 1, 2)
            pre = f"pixel_decoder.input_proj.{lvl}."
            srcs.append(self.gn(self.conv(x, pre + "0"), pre + "1"))
            pos.append(self.sine(x.shape[2], x.shape[3], cfg["conv_dim"] // 2, dev))
            shapes.append(tuple(x.shape[2:]))
        B = srcs[0].shape[0]
        level_embed = self.p["pixel_decoder.level_embed"]
        src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        lvl_pos = torch.cat([(p.flatten(1).transpose(0, 1) + level_embed[lvl])[None]
                             for lvl, p in enumerate(pos)], 1)
        refs = []
        for h, w in shapes:
            ry, rx = torch.meshgrid(torch.linspace(0.5, h - 0.5, h, device=dev),
                                    torch.linspace(0.5, w - 0.5, w, device=dev), indexing="ij")
            refs.append(torch.stack((rx.reshape(-1)[None] / w, ry.reshape(-1)[None] / h), -1))
        ref = torch.cat(refs, 1)[:, :, None].expand(B, -1, LEVELS, 2)
        for i in range(cfg["enc_layers"]):
            pre = f"pixel_decoder.layers.{i}."
            src = self.ln(src + self.msda(src + lvl_pos, ref, src, shapes, pre + "self_attn."),
                          pre + "norm1")
            ffn = self.linear(F.relu(self.linear(src, pre + "linear1")), pre + "linear2")
            src = self.ln(src + ffn, pre + "norm2")
        outs = [o.transpose(1, 2).reshape(B, -1, h, w) for o, (h, w) in
                zip(src.split([h * w for h, w in shapes], dim=1), shapes)]
        x = feats[0].permute(0, 3, 1, 2)
        lat = self.gn(self.conv(x, "pixel_decoder.adapter_1.0", bias=False),
                      "pixel_decoder.adapter_1.1")
        y = lat + F.interpolate(outs[-1], size=lat.shape[-2:], mode="bilinear",
                                align_corners=False)
        y = F.relu(self.gn(self.conv(y, "pixel_decoder.layer_1.0", padding=1, bias=False),
                           "pixel_decoder.layer_1.1"))
        return self.conv(y, "pixel_decoder.mask_features"), outs

    # ------------------------------------------------- transformer decoder

    def mha(self, q, k, v, pre, mask=None):
        """`nn.MultiheadAttention` (batch first): mask [B, heads, Lq, Lk]
        bool, True where a query may not attend."""
        heads = self.cfg["dec_heads"]
        C = q.shape[-1]
        w, b = self.p[pre + "in_proj.weight"], self.p[pre + "in_proj.bias"]
        q = F.linear(self._q(q), self._q(w[:C]), b[:C])
        k = F.linear(self._q(k), self._q(w[C:2 * C]), b[C:2 * C])
        v = F.linear(self._q(v), self._q(w[2 * C:]), b[2 * C:])
        B, Lq, Lk, d = q.shape[0], q.shape[1], k.shape[1], C // heads
        q, k, v = (t.view(B, -1, heads, d).transpose(1, 2) for t in (q, k, v))
        bias = None
        if mask is not None:
            bias = torch.zeros(mask.shape, device=q.device).masked_fill(mask, float("-inf"))
        out = self.attend(q, k, v, bias).transpose(1, 2).reshape(B, Lq, C)
        return self.linear(out, pre + "out_proj")

    def heads(self, x, mask_features, size):
        heads = self.cfg["dec_heads"]
        y = self.ln(x, "predictor.decoder_norm")
        cls = self.linear(y, "predictor.class_embed")
        e = y
        for i in range(3):
            e = self.linear(e, f"predictor.mask_embed.{i}")
            if i < 2:
                e = F.relu(e)
        masks = torch.einsum("bqc,bchw->bqhw", self._q(e), self._q(mask_features))
        a = F.interpolate(masks, size=size, mode="bilinear", align_corners=False)
        a = (a.sigmoid().flatten(2).unsqueeze(1).repeat(1, heads, 1, 1) < 0.5).bool()
        return cls, masks, a

    def predictor(self, levels, mask_features):
        cfg = self.cfg
        p = self.p
        src, pos, sizes = [], [], []
        for lvl, f in enumerate(levels):
            sizes.append(tuple(f.shape[-2:]))
            pos.append(self.sine(*f.shape[-2:], cfg["hidden_dim"] // 2, f.device)
                       .flatten(1).transpose(0, 1))
            src.append(f.flatten(2).transpose(1, 2) + p["predictor.level_embed"][lvl])
        B = mask_features.shape[0]
        qpos = p["predictor.query_embed"][None].repeat(B, 1, 1)
        x = p["predictor.query_feat"][None].repeat(B, 1, 1)
        cls, masks, mask = self.heads(x, mask_features, sizes[0])
        for i in range(cfg["dec_layers"]):
            lvl = i % LEVELS
            mask[mask.sum(-1) == mask.shape[-1]] = False
            pre = f"predictor.layers.{i}."
            x = self.ln(x + self.mha(x + qpos, src[lvl] + pos[lvl], src[lvl],
                                     pre + "cross_attn.", mask), pre + "cross_norm")
            x = self.ln(x + self.mha(x + qpos, x + qpos, x, pre + "self_attn."), pre + "self_norm")
            ffn = self.linear(F.relu(self.linear(x, pre + "linear1")), pre + "linear2")
            x = self.ln(x + ffn, pre + "ffn_norm")
            cls, masks, mask = self.heads(x, mask_features, sizes[(i + 1) % LEVELS])
        return cls, masks

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, with_features: bool = False):
        """images [B, H, W, 3] in [0, 1] -> semantic scores [B, H, W, classes],
        with TF32 off for the call (matrix products and convolutions); with
        `with_features`, (scores, the pixel decoder's mask features [B, h4,
        w4, mask_dim])."""
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            scores, features = self._forward(images)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return (scores, features.permute(0, 2, 3, 1)) if with_features else scores

    def _forward(self, images: torch.Tensor):
        B, H, W, _ = images.shape
        div = self.cfg["size_divisibility"]
        mean = torch.tensor(PIXEL_MEAN, device=images.device).view(1, 3, 1, 1)
        std = torch.tensor(PIXEL_STD, device=images.device).view(1, 3, 1, 1)
        x = (images.permute(0, 3, 1, 2) * 255.0 - mean) / std
        hp, wp = -(-H // div) * div, -(-W // div) * div
        x = F.pad(x, (0, wp - W, 0, hp - H))
        mask_features, levels = self.pixel_decoder(self.backbone(x))
        cls, masks = self.predictor(levels, mask_features)
        masks = F.interpolate(masks, size=(hp, wp), mode="bilinear", align_corners=False)
        out = []
        for c, m in zip(cls, masks):  # semantic_inference, image by image
            c = torch.softmax(c, dim=-1)[..., :-1]
            m = m[:, :H, :W].sigmoid()
            out.append(torch.einsum("qc,qhw->chw", self._q(c), self._q(m)))
        return torch.stack(out).permute(0, 2, 3, 1), mask_features


def masks_and_scores(model: Mask2FormerRef, colors: torch.Tensor, input_hw, conf_threshold,
                     batch: int, keep_frames) -> tuple:
    """Per-frame class masks at the colours' resolution, and the semantic
    scores and mask features of the frames `keep_frames`: frames [F, H, W,
    3] in [0, 1] resized (bilinear, half-pixel centres) to the model's
    input, in blocks of `batch` frames; the argmax class, "unclassified"
    (the class count) where the softmax of the scores tops out below
    `conf_threshold`, resized back by nearest-exact sampling. Returns
    (masks [F, H*W] uint8, scores [len(keep_frames), ih, iw, classes],
    features [len(keep_frames), ih / 4, iw / 4, mask_dim], both float32 on
    the host)."""
    Fn, H, W, _ = colors.shape
    out = torch.empty((Fn, H * W), dtype=torch.uint8, device=colors.device)
    keep = {int(f): i for i, f in enumerate(keep_frames)}
    kept, feats = [None] * len(keep), [None] * len(keep)
    thr = float(np.float32(conf_threshold))
    for a in range(0, Fn, batch):
        x = colors[a:a + batch].permute(0, 3, 1, 2)
        x = F.interpolate(x, size=tuple(input_hw), mode="bilinear", align_corners=False)
        scores, features = model(x.permute(0, 2, 3, 1).contiguous(), with_features=True)
        for j in range(len(scores)):
            if a + j in keep:
                kept[keep[a + j]] = scores[j].cpu().numpy()
                feats[keep[a + j]] = features[j].cpu().numpy()
        sem = scores.argmax(-1)
        conf = torch.softmax(scores, dim=-1).amax(-1)
        sem = torch.where(conf < thr, scores.shape[-1], sem)
        sem = F.interpolate(sem[:, None].float(), size=(H, W), mode="nearest-exact")
        out[a:a + batch] = sem[:, 0].reshape(len(sem), -1).to(torch.uint8)
        del scores, conf, features
    return out, np.stack(kept), np.stack(feats)
