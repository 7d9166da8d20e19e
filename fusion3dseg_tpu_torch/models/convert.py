"""Carry SegFormer weights from the JAX package's Flax layout to the port.

`from_flax_params` maps a Flax parameter tree (nested dicts, or the flat
`a/b/c` dict of an npz snapshot) onto the `state_dict` of
`models.segformer.SegFormer`. The snapshot readers and writers are the
counterparts of `fusion3dseg_tpu/pipeline/get2dseg.py`'s
(`save_params_npz` ... `best_shipped_checkpoint`): the same npz files,
float16 on disk, with the `__meta__/` keys for the trained input size and
the architecture. Orbax directory checkpoints are not read yet.

Layouts: a Flax Conv kernel `[kh, kw, in, out]` becomes `[out, in, kh, kw]`
(the depthwise `[3, 3, 1, hidden]` becomes `[hidden, 1, 3, 3]` by the same
permutation); a Dense kernel `[in, out]` is transposed; a LayerNorm `scale`
is a `weight`.
"""

from __future__ import annotations

import dataclasses
import json
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


def from_flax_params(params, config: SegFormerConfig) -> dict:
    """Flax SegFormer parameters -> a `state_dict` for `SegFormer(config)`.

    `params` is the nested tree or its flat `a/b/c` form, with numpy (or
    array-like) leaves. Tensors come back in the dtype the module holds them
    in. Raises KeyError when the module expects a parameter the tree lacks,
    or the tree holds one the module does not use, and ValueError on a shape
    that does not fit.
    """
    with torch.device("meta"):
        expected = SegFormer(config).state_dict()
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


def save_params_npz(path, params, input_hw=None, config=None) -> None:
    """Portable compressed weight snapshot of a Flax-layout parameter tree
    (nested or flat, numpy leaves): float32 leaves stored as float16,
    everything else verbatim. `input_hw` records the resolution the weights
    were trained at (`__meta__/input_hw`); `config` the architecture
    (`__meta__/config`, json)."""
    out = {}
    for k, v in flatten_params(params).items():
        v = np.asarray(v)
        out[k] = v.astype(np.float16) if v.dtype == np.float32 else v
    if input_hw is not None:
        out[_META_PREFIX + "input_hw"] = np.asarray(input_hw, np.int32)
    if config is not None:
        d = dataclasses.asdict(config)
        d["dtype"] = str(config.dtype).removeprefix("torch.")
        out[_META_PREFIX + "config"] = np.asarray(json.dumps(d))
    np.savez_compressed(path, **out)


def load_params_npz(path) -> dict:
    """Restore a snapshot as a nested Flax-layout tree of numpy arrays
    (float16 -> float32); metadata keys are skipped (see `load_npz_meta`)."""
    if Path(path).is_dir():
        raise NotImplementedError(
            f"{path} is a directory: Orbax checkpoints are not read by the port "
            "yet; convert to an npz snapshot with the JAX package's save_params_npz")
    z = np.load(path)
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


def _is_npz(path) -> bool:
    p = Path(path)
    return p.is_file() and p.suffix == ".npz"


def checkpoint_config(checkpoint):
    """The SegFormerConfig recorded with an npz snapshot, or None."""
    if not _is_npz(checkpoint):
        return None
    raw = load_npz_meta(checkpoint).get("config")
    if not raw:
        return None
    d = json.loads(raw)
    for k in ("embed_dims", "depths", "num_heads", "sr_ratios", "patch_strides",
              "patch_sizes", "nat_windows"):
        if k in d:
            d[k] = tuple(d[k])
    d["dtype"] = _DTYPES[d.get("dtype", "bfloat16")]
    return SegFormerConfig(**d)


def checkpoint_input_hw(checkpoint):
    """The trained input size recorded with an npz snapshot, or None."""
    if not _is_npz(checkpoint):
        return None
    hw = load_npz_meta(checkpoint).get("input_hw")
    return tuple(hw) if hw is not None else None


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
