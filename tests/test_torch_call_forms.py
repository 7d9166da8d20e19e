"""The JAX package's call forms of four public functions, each called the
same way on the port and on the JAX package with the same inputs:
`io/rtab.frames_to_world` with `height, width`, `pipeline/process3d.
load_session` with a positional `point_range`, and the HF importer's
`config_from_hf` and `infer_config_from_state_dict` with `dtype=None`
(bfloat16 in both)."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.io import rtab as jrtab, synthetic as jsynthetic
from fusion3dseg_tpu.models import import_hf as jimport
from fusion3dseg_tpu.pipeline import process3d as jp3d
from fusion3dseg_tpu_torch.io import rtab as trtab
from fusion3dseg_tpu_torch.models import import_hf as timport
from fusion3dseg_tpu_torch.pipeline import process3d as tp3d


@pytest.fixture(scope="module")
def session():
    return jsynthetic.make_session(nframes=3, depth_hw=(24, 32), appearance="textured")


def _frames_to_world_inputs(sess):
    """depth [F, H, W], Ks, wxyz, translations as SessionData.from_arrays
    makes them, float32."""
    h, w = sess.depth.shape[1:]
    hr, wr = sess.colors.shape[1:3]
    Ks = jrtab.scale_intrinsics(sess.K, w / wr, h / hr)
    return [np.asarray(a, np.float32) for a in (sess.depth, Ks, sess.quats_wxyz,
                                                sess.translations)]


def test_frames_to_world_jax_call_form(session):
    args = _frames_to_world_inputs(session)
    F, H, W = args[0].shape
    want = jrtab.frames_to_world(*map(jnp.asarray, args), H, W)
    targs = [torch.from_numpy(a) for a in args]
    got = trtab.frames_to_world(*targs, H, W)
    four = trtab.frames_to_world(*targs)
    named = trtab.frames_to_world(*targs, height=H, width=W)
    for g, f, n, j in zip(got, four, named, want):
        assert torch.equal(g, f) and torch.equal(g, n)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert got[0].shape == (F, H * W, 3) and got[2].shape == (F, H * W)


@pytest.mark.parametrize("height,width", [(25, 32), (24, 31), (32, 24)])
def test_frames_to_world_refuses_another_size(session, height, width):
    targs = [torch.from_numpy(a) for a in _frames_to_world_inputs(session)]
    with pytest.raises(ValueError, match="depth images are 24 x 32"):
        trtab.frames_to_world(*targs, height, width)


def test_load_session_jax_call_form(tmp_path, session):
    src = tmp_path / "session"
    jsynthetic.write_session_dir(session, src)
    want = jp3d.load_session(src, (0.1, 4.0))
    got = tp3d.load_session(src, (0.1, 4.0), device="cpu")
    assert tp3d.load_session(src, None, device="cpu").points.shape == got.points.shape
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.normals.numpy(), np.asarray(want.normals))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.frame_numbers, want.frame_numbers)
    with pytest.raises(TypeError):  # the device is keyword-only
        tp3d.load_session(src, None, "cpu")


def _hf_config():
    """The fields of an HF SegformerConfig that the importers read."""
    return types.SimpleNamespace(
        num_labels=10, hidden_sizes=[8, 16, 24, 32], depths=[1, 2, 1, 1],
        num_attention_heads=[1, 2, 3, 4], sr_ratios=[8, 4, 2, 1], mlp_ratios=[4, 4, 4, 4],
        decoder_hidden_size=32, strides=[4, 2, 2, 2], patch_sizes=[7, 3, 3, 3])


def _hf_state_dict():
    """The tensors infer_config_from_state_dict reads, shaped as an HF
    SegformerForSemanticSegmentation's of `_hf_config()` with its head."""
    dims, sizes, depths, srs = (8, 16, 24, 32), (7, 3, 3, 3), (1, 2, 1, 1), (8, 4, 2, 1)
    sd, cin = {}, 3
    for s in range(4):
        sd[f"segformer.encoder.patch_embeddings.{s}.proj.weight"] = \
            torch.zeros(dims[s], cin, sizes[s], sizes[s])
        for d in range(depths[s]):
            sd[f"segformer.encoder.block.{s}.{d}.layer_norm_1.weight"] = torch.zeros(dims[s])
        if srs[s] > 1:
            sd[f"segformer.encoder.block.{s}.0.attention.self.sr.weight"] = \
                torch.zeros(dims[s], dims[s], srs[s], srs[s])
        cin = dims[s]
    sd["segformer.encoder.block.0.0.mlp.dense1.weight"] = torch.zeros(4 * dims[0], dims[0])
    sd["decode_head.linear_c.0.proj.weight"] = torch.zeros(32, dims[0])
    sd["decode_head.classifier.weight"] = torch.zeros(10, 32, 1, 1)
    return sd


def _fields(cfg):
    return {k: v for k, v in vars(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("with_head", [False, True])
def test_hf_configs_dtype_none_is_bfloat16(with_head):
    hf, sd = _hf_config(), _hf_state_dict()
    for jcfg, tcfg in (
            (jimport.config_from_hf(hf, 134, None, with_head),
             timport.config_from_hf(hf, 134, None, with_head)),
            (jimport.config_from_hf(hf, with_head=with_head),
             timport.config_from_hf(hf, with_head=with_head)),
            (jimport.infer_config_from_state_dict(sd, 134, None, with_head),
             timport.infer_config_from_state_dict(sd, 134, None, with_head)),
            (jimport.infer_config_from_state_dict(sd, with_head=with_head),
             timport.infer_config_from_state_dict(sd, with_head=with_head))):
        assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
        assert _fields(jcfg) == _fields(tcfg)
        assert tcfg.num_classes == (10 if with_head else 134)
    # a dtype given is kept
    assert timport.config_from_hf(hf, dtype=torch.float16).dtype == torch.float16
    assert timport.infer_config_from_state_dict(sd, dtype=torch.float32).dtype == torch.float32
