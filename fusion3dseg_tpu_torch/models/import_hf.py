"""Import externally trained SegFormer weights (HF transformers layout).

Counterpart of `fusion3dseg_tpu/models/import_hf.py`. The MiT encoder is
the canonical SegFormer, so any HuggingFace `SegformerModel` /
`SegformerFor*` checkpoint maps onto the port's parameters one to one. HF's
tensors already have PyTorch's layouts (`[out, in]` linear, `[out, in, kh,
kw]` conv), so the mapping is a renaming onto `models.segformer.SegFormer`'s
state dict, with no transposes. By default the decode head's fuse and
classifier are not transplanted (HF's head is BatchNorm + ReLU, the port's
native head LayerNorm + GELU); `include_head=True` with a config built by
`with_head=True` selects the HF-compatible head (`SegFormerConfig.head ==
"hf"`) and transplants the whole `SegformerForSemanticSegmentation`.

`save_snapshot` writes the result as the npz snapshot both packages read
(`convert.save_params_npz` with the architecture and input size).

Numerical caveats, as in the JAX package: HF's LayerNorm eps is 1e-5 against
the port's 1e-6, and HF's GELU is the exact erf against the port's tanh
approximation, so encoder outputs agree to about 1e-2, not bit for bit.
Nothing here imports `transformers`; `.safetensors` files are read only when
the `safetensors` package is installed.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch

from fusion3dseg_tpu_torch.models import convert
from fusion3dseg_tpu_torch.models.segformer import SegFormerConfig

# the canonical MiT head counts; infer_config_from_state_dict cannot read
# them off the weights
_MIT_HEADS = (1, 2, 5, 8)


def _t(v) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy) as a float32 CPU tensor (a copy)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32, copy=True)
    return torch.tensor(np.asarray(v), dtype=torch.float32)


def load_hf_state_dict(path) -> dict:
    """Read a checkpoint file into a flat name -> tensor dict: torch
    `.pth` / `.bin` (`torch.load`, weights only) and `.safetensors` when
    that package is installed."""
    p = str(path)
    if p.endswith(".safetensors"):
        from safetensors.torch import load_file  # optional dependency

        return dict(load_file(p))
    sd = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def config_from_hf(hf_config, num_classes: int = 134, dtype=None,
                   with_head: bool = False) -> SegFormerConfig:
    """The port's SegFormerConfig mirroring an HF SegformerConfig's encoder
    geometry. num_classes stays the caller's (the classifier is not
    imported) unless `with_head`, which builds the full-transplant config:
    head "hf" and the checkpoint's own `num_labels`. `dtype=None` means
    bfloat16, as in the JAX package."""
    if with_head:
        num_classes = int(hf_config.num_labels)
    return SegFormerConfig(
        num_classes=num_classes,
        embed_dims=tuple(hf_config.hidden_sizes),
        depths=tuple(hf_config.depths),
        num_heads=tuple(hf_config.num_attention_heads),
        sr_ratios=tuple(hf_config.sr_ratios),
        mlp_ratio=int(hf_config.mlp_ratios[0]),
        decoder_dim=int(getattr(hf_config, "decoder_hidden_size", 256)),
        patch_strides=tuple(hf_config.strides),
        patch_sizes=tuple(hf_config.patch_sizes),
        head="hf" if with_head else "native",
        dtype=dtype if dtype is not None else torch.bfloat16,
    )


def infer_config_from_state_dict(state_dict, num_classes: int = 134, dtype=None,
                                 with_head: bool = False) -> SegFormerConfig:
    """The port's SegFormerConfig read off the checkpoint's tensors alone
    (a bare .pth has no config object): embed dims, depths, patch sizes, sr
    ratios, mlp ratio and decoder width come from weight shapes; attention
    head counts cannot, so the canonical MiT (1, 2, 5, 8) is assumed where
    it divides the stage width (every released b0-b5), else the largest
    divisor below it. `dtype=None` means bfloat16, as in the JAX package."""
    sd = {k.removeprefix("segformer.").removeprefix("model."): v
          for k, v in state_dict.items()}
    dims, sizes = [], []
    for s in range(4):
        w = sd.get(f"encoder.patch_embeddings.{s}.proj.weight")
        if w is None:
            raise KeyError(f"not a SegFormer checkpoint: no patch embedding {s}")
        dims.append(int(w.shape[0]))
        sizes.append(int(w.shape[2]))
    depths, srs = [0, 0, 0, 0], [1, 1, 1, 1]
    for k in sd:
        m = re.match(r"encoder\.block\.(\d)\.(\d+)\.layer_norm_1\.weight", k)
        if m:
            s, d = int(m.group(1)), int(m.group(2))
            depths[s] = max(depths[s], d + 1)
        m = re.match(r"encoder\.block\.(\d)\.0\.attention\.self\.sr\.weight", k)
        if m:
            srs[int(m.group(1))] = int(sd[k].shape[2])
    fc1 = sd["encoder.block.0.0.mlp.dense1.weight"]
    mlp_ratio = int(round(fc1.shape[0] / fc1.shape[1]))
    dec = sd.get("decode_head.linear_c.0.proj.weight")
    decoder_dim = int(dec.shape[0]) if dec is not None else 256
    if with_head:
        cw = sd.get("decode_head.classifier.weight")
        if cw is None:
            raise KeyError("with_head=True but the checkpoint has no decode_head.classifier: "
                           "encoder-only checkpoints cannot transplant a head")
        num_classes = int(cw.shape[0])
    heads = tuple(h if d % h == 0 else max(k for k in range(1, h + 1) if d % k == 0)
                  for h, d in zip(_MIT_HEADS, dims))
    return SegFormerConfig(
        num_classes=num_classes, embed_dims=tuple(dims), depths=tuple(depths),
        num_heads=heads, sr_ratios=tuple(srs), mlp_ratio=mlp_ratio,
        decoder_dim=decoder_dim, patch_sizes=tuple(sizes), patch_strides=(4, 2, 2, 2),
        head="hf" if with_head else "native",
        dtype=dtype if dtype is not None else torch.bfloat16,
    )


def params_from_hf_segformer(
    state_dict: Mapping[str, torch.Tensor],
    config: SegFormerConfig,
    params_template: Optional[Mapping[str, torch.Tensor]] = None,
    include_decoder_projections: bool = True,
    include_head: bool = False,
    strict: bool = True,
) -> dict:
    """Map an HF SegFormer state dict onto the port's `SegFormer` state dict.

    `state_dict`: flat HF name -> tensor (torch or numpy); the
    SegformerModel, SegformerForSemanticSegmentation and
    SegformerForImageClassification layouts all work (names resolve with
    and without the "segformer." prefix). `config`: the port's config, whose
    encoder geometry must match the checkpoint (see `config_from_hf`).
    `params_template`: a state dict providing every parameter not imported
    (typically a fresh model's); None returns only the imported ones.
    `include_decoder_projections`: also transplant the decode head's
    per-stage `linear_c` where present and shape-compatible. `include_head`:
    also the bias-free fuse, the batch-norm statistics and affine, and the
    classifier; needs `config.head == "hf"` and raises otherwise. `strict`:
    raise KeyError on any missing encoder tensor; False skips it.

    Returns float32 tensors keyed by the port's parameter names.
    """
    sd = dict(state_dict)

    def get(name):
        for k in (f"segformer.{name}", name, f"model.{name}"):
            if k in sd:
                return sd[k]
        if strict:
            raise KeyError(f"HF checkpoint is missing '{name}': wrong architecture or "
                           "truncated file")
        return None

    out: dict = {}

    def put(name, val):
        if val is not None:
            out[name] = _t(val)

    def linear(ours, theirs):
        put(f"{ours}.weight", get(f"{theirs}.weight"))
        put(f"{ours}.bias", get(f"{theirs}.bias"))

    for s in range(4):
        pw = get(f"encoder.patch_embeddings.{s}.proj.weight")
        if pw is None:
            continue
        if pw.shape[0] != config.embed_dims[s]:
            raise ValueError(
                f"encoder geometry mismatch at stage {s}: checkpoint embed dim "
                f"{pw.shape[0]} vs config {config.embed_dims[s]} (use config_from_hf / "
                "infer_config_from_state_dict)")
        linear(f"patch_embed{s}.conv", f"encoder.patch_embeddings.{s}.proj")
        linear(f"patch_embed{s}.norm", f"encoder.patch_embeddings.{s}.layer_norm")
        for d in range(config.depths[s]):
            hf, ours = f"encoder.block.{s}.{d}", f"stage{s}_block{d}"
            if get(f"{hf}.layer_norm_1.weight") is None:
                continue
            linear(f"{ours}.norm1", f"{hf}.layer_norm_1")
            linear(f"{ours}.norm2", f"{hf}.layer_norm_2")
            for theirs, mine in (("query", "q"), ("key", "k"), ("value", "v")):
                linear(f"{ours}.attn.{mine}", f"{hf}.attention.self.{theirs}")
            linear(f"{ours}.attn.proj", f"{hf}.attention.output.dense")
            if config.sr_ratios[s] > 1:
                linear(f"{ours}.attn.sr", f"{hf}.attention.self.sr")
                linear(f"{ours}.attn.norm", f"{hf}.attention.self.layer_norm")
            linear(f"{ours}.ffn.fc1", f"{hf}.mlp.dense1")
            linear(f"{ours}.ffn.dw", f"{hf}.mlp.dwconv.dwconv")
            linear(f"{ours}.ffn.fc2", f"{hf}.mlp.dense2")
        linear(f"stage_norm{s}", f"encoder.layer_norm.{s}")

    if include_decoder_projections:
        for s in range(4):
            w = sd.get(f"decode_head.linear_c.{s}.proj.weight")
            if w is None or tuple(w.shape) != (config.decoder_dim, config.embed_dims[s]):
                continue  # absent, or another decoder width: keep the template's
            put(f"linear_c{s}.weight", w)
            put(f"linear_c{s}.bias", sd[f"decode_head.linear_c.{s}.proj.bias"])

    if include_head:
        if config.head != "hf":
            raise ValueError(
                "include_head=True needs config.head == 'hf' (the BatchNorm+ReLU decode-head "
                "variant); the 'native' head's forward would mis-run the imported BN "
                "statistics: use config_from_hf(..., with_head=True)")
        fw = get("decode_head.linear_fuse.weight")  # conv1x1 [out, in, 1, 1]
        if fw is not None:
            if fw.shape[0] != config.decoder_dim:
                raise ValueError(
                    f"decode head width mismatch: checkpoint linear_fuse out {fw.shape[0]} "
                    f"vs config.decoder_dim {config.decoder_dim}")
            put("fuse.weight", _t(fw)[:, :, 0, 0])
        for ours, theirs in (("bn_scale", "weight"), ("bn_bias", "bias"),
                             ("bn_mean", "running_mean"), ("bn_var", "running_var")):
            put(ours, get(f"decode_head.batch_norm.{theirs}"))
        cw = get("decode_head.classifier.weight")  # conv1x1 [labels, in, 1, 1]
        if cw is not None:
            if cw.shape[0] != config.num_classes:
                raise ValueError(
                    f"classifier mismatch: checkpoint num_labels {cw.shape[0]} vs "
                    f"config.num_classes {config.num_classes} (with_head imports predict "
                    "the checkpoint's own taxonomy)")
            put("classifier.weight", _t(cw)[:, :, 0, 0])
            put("classifier.bias", get("decode_head.classifier.bias"))

    if params_template is None:
        return out
    merged = {k: v.detach().to("cpu", torch.float32, copy=True)
              for k, v in params_template.items()}
    for k, v in out.items():
        if k in merged and merged[k].shape != v.shape:
            raise ValueError(
                f"shape mismatch importing '{k}': checkpoint {tuple(v.shape)} vs model "
                f"{tuple(merged[k].shape)}: encoder geometry differs (use config_from_hf)")
        merged[k] = v
    return merged


def save_snapshot(path, params: Mapping[str, torch.Tensor], config: SegFormerConfig,
                  input_hw=(512, 512)) -> None:
    """Write an imported state dict as the npz snapshot both packages load,
    with its architecture and input size recorded."""
    convert.save_params_npz(path, convert.to_flax_params(params), input_hw=input_hw,
                            config=config)
