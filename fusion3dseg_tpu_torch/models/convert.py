"""Carry SegFormer weights from the JAX package's Flax layout to the port.

`from_flax_params` maps a Flax parameter tree (nested dicts, or the flat
`a/b/c` dict of an npz snapshot) onto the `state_dict` of
`models.segformer.SegFormer`, and `to_flax_params` maps it back. The
snapshot readers and writers are the counterparts of
`fusion3dseg_tpu/pipeline/get2dseg.py`'s (`save_params_npz` ...
`best_shipped_checkpoint`): the same npz files, float16 on disk (float32
with `full_precision=True`, as the trainer keeps its state), with the
`__meta__/` keys for the trained input size and the architecture.

A directory checkpoint is the trainer's (`models/train.save_train_state`):
its `params` entry links to the committed snapshot, and a `meta.json`
sidecar in the directory or its parent records the input size and the
architecture. Orbax directories are not read: the JAX package's
`load_checkpoint` + `save_params_npz` turn one into an npz snapshot.

Layouts: a Flax Conv kernel `[kh, kw, in, out]` becomes `[out, in, kh, kw]`
(the depthwise `[3, 3, 1, hidden]` becomes `[hidden, 1, 3, 3]` by the same
permutation); a Dense kernel `[in, out]` is transposed; a LayerNorm `scale`
is a `weight`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path

import numpy as np
import torch

from fusion3dseg_tpu_torch.models.segformer import SegFormer, SegFormerConfig

_META_PREFIX = "__meta__/"  # reserved npz namespace: never a param path

# Flax auto-names -> the port's module names, applied in order to the
# '/'-joined parameter path
_RENAMES = (
    (r"^(patch_embed\d)/Conv_0/", r"\1/conv/"),
    (r"^(patch_embed\d)/LayerNorm_0/", r"\1/norm/"),
    (r"^(stage\d+_block\d+)/LayerNorm_0/", r"\1/norm1/"),
    (r"^(stage\d+_block\d+)/LayerNorm_1/", r"\1/norm2/"),
    (r"/EfficientAttention_0/LayerNorm_0/", "/attn/norm/"),
    (r"/EfficientAttention_0/", "/attn/"),
    (r"/MixFFN_0/", "/ffn/"),
    (r"^LayerNorm_([0-3])/", r"stage_norm\1/"),
    (r"^LayerNorm_4/", "decoder_norm/"),
    (r"/(kernel|scale)$", "/weight"),
)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def flatten_params(tree, prefix=""):
    """Nested parameter dicts -> one dict keyed by the '/'-joined path."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(flatten_params(val, path))
        else:
            flat[path] = val
    return flat


def unflatten_params(flat):
    """The inverse of `flatten_params`."""
    tree = {}
    for path, val in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


# the port's names -> Flax's, the inverse of _RENAMES
_FLAX_NAMES = (
    (r"^(patch_embed\d)/conv/", r"\1/Conv_0/"),
    (r"^(patch_embed\d)/norm/", r"\1/LayerNorm_0/"),
    (r"^(stage\d+_block\d+)/norm1/", r"\1/LayerNorm_0/"),
    (r"^(stage\d+_block\d+)/norm2/", r"\1/LayerNorm_1/"),
    (r"/attn/norm/", "/EfficientAttention_0/LayerNorm_0/"),
    (r"/attn/", "/EfficientAttention_0/"),
    (r"/ffn/", "/MixFFN_0/"),
    (r"^stage_norm([0-3])/", r"LayerNorm_\1/"),
    (r"^decoder_norm/", "LayerNorm_4/"),
    (r"(LayerNorm_\d)/weight$", r"\1/scale"),
    (r"/weight$", "/kernel"),
)


def from_flax_params(params, config: SegFormerConfig,
                     param_dtype: torch.dtype | None = None) -> dict:
    """Flax SegFormer parameters -> a `state_dict` for `SegFormer(config,
    param_dtype=param_dtype)`.

    `params` is the nested tree or its flat `a/b/c` form, with numpy (or
    array-like) leaves. Tensors come back in the dtype the module holds them
    in. Raises KeyError when the module expects a parameter the tree lacks,
    or the tree holds one the module does not use, and ValueError on a shape
    that does not fit.
    """
    with torch.device("meta"):
        expected = SegFormer(config, param_dtype=param_dtype).state_dict()
    state, unused = {}, []
    for path, val in flatten_params(params).items():
        name = path
        for pattern, repl in _RENAMES:
            name = re.sub(pattern, repl, name)
        name = name.replace("/", ".")
        if name not in expected:
            unused.append(path)
            continue
        t = torch.tensor(np.asarray(val))  # a copy: the leaf may be read-only
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        elif t.dim() == 2:
            t = t.t()
        want = expected[name]
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} after layout change, "
                             f"the module's {name} is {tuple(want.shape)}")
        state[name] = t.to(want.dtype).contiguous()
    missing = sorted(set(expected) - set(state))
    if missing or unused:
        raise KeyError(f"Flax parameters do not fit SegFormer({config.head!r} head): "
                       f"missing {missing}, unused {sorted(unused)}")
    return state


def to_flax_params(state: dict) -> dict:
    """A `SegFormer` state dict -> the flat `a/b/c` Flax-layout tree of
    float32 numpy arrays (what `save_params_npz` and the JAX package's
    model take); the inverse of `from_flax_params`."""
    flat = {}
    for name, t in state.items():
        path = name.replace(".", "/")
        for pattern, repl in _FLAX_NAMES:
            path = re.sub(pattern, repl, path)
        t = t.detach().float().cpu()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        elif t.dim() == 2:
            t = t.t()
        flat[path] = np.ascontiguousarray(t.numpy())
    return flat


def config_json(config: SegFormerConfig) -> str:
    """The architecture as json, the `__meta__/config` record."""
    d = dataclasses.asdict(config)
    d["dtype"] = str(config.dtype).removeprefix("torch.")
    return json.dumps(d)


def config_from_json(raw: str) -> SegFormerConfig:
    d = json.loads(raw)
    for k in ("embed_dims", "depths", "num_heads", "sr_ratios", "patch_strides",
              "patch_sizes", "nat_windows"):
        if k in d:
            d[k] = tuple(d[k])
    d["dtype"] = _DTYPES[d.get("dtype", "bfloat16")]
    return SegFormerConfig(**d)


def save_params_npz(path, params, input_hw=None, config=None,
                    full_precision: bool = False) -> None:
    """Portable compressed weight snapshot of a Flax-layout parameter tree
    (nested or flat, numpy leaves): float32 leaves stored as float16,
    everything else verbatim; with `full_precision` float32 stays float32
    and the file is not compressed (the trainer's state). `input_hw`
    records the resolution the weights were trained at
    (`__meta__/input_hw`); `config` the architecture (`__meta__/config`,
    json)."""
    out = {}
    for k, v in flatten_params(params).items():
        v = np.asarray(v)
        out[k] = v.astype(np.float16) if v.dtype == np.float32 and not full_precision else v
    if input_hw is not None:
        out[_META_PREFIX + "input_hw"] = np.asarray(input_hw, np.int32)
    if config is not None:
        out[_META_PREFIX + "config"] = np.asarray(config_json(config))
    (np.savez if full_precision else np.savez_compressed)(path, **out)


def load_params_npz(path) -> dict:
    """Restore a snapshot (a file, or a trainer directory's committed
    `params`) as a nested Flax-layout tree of numpy arrays (float16 ->
    float32); metadata keys are skipped (see `load_npz_meta`)."""
    p = Path(path)
    if p.is_dir():
        if not (p / "params").is_file():
            raise NotImplementedError(
                f"{p} is a directory without a committed `params` snapshot; Orbax "
                "checkpoints are not read by the port: convert one to an npz snapshot "
                "with the JAX package's load_checkpoint + save_params_npz")
        p = p / "params"
    z = np.load(p)
    return unflatten_params({
        k: (z[k].astype(np.float32) if z[k].dtype == np.float16 else z[k])
        for k in z.files if not k.startswith(_META_PREFIX)
    })


def load_npz_meta(path) -> dict:
    """Metadata recorded by `save_params_npz`: {} for snapshots without any,
    else e.g. {'input_hw': (256, 256)}."""
    z = np.load(path)
    meta = {}
    for k in z.files:
        if k.startswith(_META_PREFIX):
            v = z[k]
            meta[k[len(_META_PREFIX):]] = tuple(int(x) for x in v) if v.ndim else v.item()
    return meta


def _sidecar(checkpoint) -> dict:
    """The `meta.json` of a directory checkpoint, read from the directory
    itself, then its parent (a run's `ema/` view keeps it at the run's
    root); {} when there is none."""
    p = Path(checkpoint)
    for d in (p, p.parent):
        mj = d / "meta.json"
        if mj.is_file():
            try:
                return json.loads(mj.read_text())
            except (ValueError, OSError):
                return {}
    return {}


def _meta(checkpoint) -> dict:
    p = Path(checkpoint)
    if p.is_file() and p.suffix == ".npz":
        return load_npz_meta(p)
    return _sidecar(p) if p.is_dir() else {}


def checkpoint_config(checkpoint):
    """The SegFormerConfig recorded with an npz snapshot or in a directory
    checkpoint's `meta.json`, or None."""
    raw = _meta(checkpoint).get("config")
    if isinstance(raw, dict):  # the sidecar holds it as a json object
        raw = json.dumps(raw)
    return config_from_json(raw) if raw else None


def checkpoint_input_hw(checkpoint):
    """The trained input size recorded with an npz snapshot or in a
    directory checkpoint's `meta.json`, or None."""
    hw = _meta(checkpoint).get("input_hw")
    return tuple(int(x) for x in hw) if hw else None


def write_checkpoint_meta(checkpoint_dir, input_hw, config=None) -> None:
    """The `meta.json` sidecar of a directory checkpoint: the trained input
    size (the JAX package's key) and the architecture, written through a
    temporary file and `os.replace`."""
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    meta = {"input_hw": [int(x) for x in input_hw]}
    if config is not None:
        meta["config"] = json.loads(config_json(config))
    tmp = d / ".meta_tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, d / "meta.json")


def shipped_checkpoint(model: str = "b1"):
    """Path to the in-repo trained snapshot for `model`, or None."""
    p = Path(__file__).resolve().parents[2] / "checkpoints" / f"shipped_{model}_textured.npz"
    return p if p.is_file() else None


def best_shipped_checkpoint():
    """(model_name, npz_path) of the best in-repo snapshot, or (None, None).
    Preference order b2 > b1 > b0: the larger model is the accuracy default."""
    for name in ("b2", "b1", "b0"):
        p = shipped_checkpoint(name)
        if p is not None:
            return name, p
    return None, None
