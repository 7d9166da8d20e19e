"""The port's HF SegFormer importer against the JAX package's and against the
HF model itself (the checks of tests/test_import_hf.py).

The source checkpoint is a random-init transformers
SegformerForSemanticSegmentation built from a config object (no download),
with non-trivial batch-norm statistics. The port's transplant must equal the
JAX package's (`params_from_hf_segformer` -> `from_flax_params`) exactly,
and the transplanted port model must reproduce the HF model's logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from fusion3dseg_tpu.models import SegFormer as JSegFormer  # noqa: E402
from fusion3dseg_tpu.models import import_hf as jimport  # noqa: E402
from fusion3dseg_tpu.pipeline import get2dseg as jget  # noqa: E402
from fusion3dseg_tpu_torch.models import convert, import_hf as timport  # noqa: E402
from fusion3dseg_tpu_torch.models.segformer import SegFormer  # noqa: E402
from fusion3dseg_tpu_torch.pipeline import get2dseg as tget  # noqa: E402

HW = (64, 64)
# float32 both sides. Measured at these widths: logits 2.6e-8 apart; stage
# outputs 1.4e-5 of their largest value apart (LayerNorm eps 1e-5 in HF
# against 1e-6, exact-erf against tanh GELU in every MixFFN)
LOGIT_BAR = 1e-4
STAGE_BAR = 1e-4  # relative to the stage output's largest magnitude


@pytest.fixture(scope="module")
def hf_model():
    cfg = transformers.SegformerConfig(
        num_encoder_blocks=4, depths=[1, 2, 1, 1], hidden_sizes=[8, 16, 24, 32],
        num_attention_heads=[1, 2, 3, 4], sr_ratios=[8, 4, 2, 1],
        strides=[4, 2, 2, 2], patch_sizes=[7, 3, 3, 3], decoder_hidden_size=32,
        num_labels=10, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        classifier_dropout_prob=0.0, drop_path_rate=0.0,
    )
    torch.manual_seed(0)
    model = transformers.SegformerForSemanticSegmentation(cfg).eval()
    with torch.no_grad():  # statistics a mapping bug could not hide behind
        model.decode_head.batch_norm.running_mean.uniform_(-0.5, 0.5)
        model.decode_head.batch_norm.running_var.uniform_(0.5, 2.0)
    return model


def _jax_template(jcfg):
    import flax.linen as nn

    init = jax.jit(JSegFormer(jcfg).init)
    return nn.meta.unbox(init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))["params"])


def _transplants(hf_model, with_head):
    """(with_head, port config, port state dict, JAX transplant mapped by
    from_flax_params), both over the same template."""
    jcfg = jimport.config_from_hf(hf_model.config, num_classes=10, dtype=jnp.float32,
                                  with_head=with_head)
    tcfg = timport.config_from_hf(hf_model.config, num_classes=10, dtype=torch.float32,
                                  with_head=with_head)
    template = _jax_template(jcfg)
    jparams = jimport.params_from_hf_segformer(hf_model.state_dict(), jcfg,
                                               params_template=template,
                                               include_head=with_head)
    tstate = timport.params_from_hf_segformer(
        hf_model.state_dict(), tcfg,
        params_template=convert.from_flax_params(template, tcfg), include_head=with_head)
    return with_head, tcfg, tstate, convert.from_flax_params(jparams, tcfg)


@pytest.fixture(scope="module")
def encoder_pair(hf_model):
    return _transplants(hf_model, False)


@pytest.fixture(scope="module")
def head_pair(hf_model):
    return _transplants(hf_model, True)


@pytest.fixture(params=["encoder_pair", "head_pair"])
def pair(request):
    return request.getfixturevalue(request.param)


def _port_model(cfg, state):
    with torch.device("meta"):
        m = SegFormer(cfg)
    m.load_state_dict(state, assign=True)
    return m.eval()


def test_config_matches_jax(hf_model):
    for with_head in (False, True):
        j = jimport.config_from_hf(hf_model.config, dtype=jnp.float32, with_head=with_head)
        t = timport.config_from_hf(hf_model.config, dtype=torch.float32, with_head=with_head)
        dj, dt = dataclasses.asdict(j), dataclasses.asdict(t)
        dj.pop("dtype"), dt.pop("dtype")
        assert dj == dt


def test_transplant_equals_jax_exactly(pair):
    _, _, tstate, want = pair
    assert sorted(tstate) == sorted(want)
    for k, v in want.items():
        assert tstate[k].dtype == torch.float32
        assert torch.equal(tstate[k], v), k


def test_transplant_is_a_renaming(hf_model, pair):
    with_head, _, tstate, _ = pair
    sd = hf_model.state_dict()
    assert torch.equal(tstate["stage0_block0.attn.q.weight"],
                       sd["segformer.encoder.block.0.0.attention.self.query.weight"])
    assert torch.equal(tstate["patch_embed0.conv.weight"],
                       sd["segformer.encoder.patch_embeddings.0.proj.weight"])
    assert torch.equal(tstate["stage0_block0.ffn.dw.weight"],
                       sd["segformer.encoder.block.0.0.mlp.dwconv.dwconv.weight"])
    assert torch.equal(tstate["linear_c1.weight"], sd["decode_head.linear_c.1.proj.weight"])
    if with_head:
        assert torch.equal(tstate["bn_mean"], sd["decode_head.batch_norm.running_mean"])
        assert torch.equal(tstate["classifier.weight"],
                           sd["decode_head.classifier.weight"][:, :, 0, 0])


def test_stage_outputs_match_hf(hf_model, pair):
    _, cfg, tstate, _ = pair
    model = _port_model(cfg, tstate)
    x = np.random.default_rng(3).random((2, *HW, 3)).astype(np.float32)
    feats = []
    hooks = [getattr(model, f"stage_norm{s}").register_forward_hook(
        lambda m, i, o: feats.append(o)) for s in range(4)]
    with torch.no_grad():
        model(torch.from_numpy(x))
        hf = hf_model.segformer(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                output_hidden_states=True).hidden_states
    for h in hooks:
        h.remove()
    for s, (ours, theirs) in enumerate(zip(feats, hf)):
        B, C, h, w = theirs.shape
        ours = ours.reshape(B, h, w, C).permute(0, 3, 1, 2)
        err = float((ours - theirs).abs().max())
        assert err <= STAGE_BAR * float(theirs.abs().max()), (s, err)


def test_logits_match_hf(hf_model, head_pair):
    _, cfg, tstate, _ = head_pair
    model = _port_model(cfg, tstate)
    x = np.random.default_rng(11).random((2, *HW, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).permute(0, 3, 1, 2)
        t = hf_model(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits
        t = torch.nn.functional.interpolate(t, size=HW, mode="bilinear", align_corners=False)
    assert float((ours - t).abs().max()) <= LOGIT_BAR
    assert (ours.argmax(1) == t.argmax(1)).float().mean() >= 0.999


def test_snapshot_drops_into_both_segmenters(hf_model, head_pair, tmp_path):
    _, cfg, tstate, _ = head_pair
    p = tmp_path / "imported.npz"
    timport.save_snapshot(p, tstate, cfg, input_hw=HW)
    assert convert.checkpoint_config(p) == cfg
    tseg = tget.Segmenter2D(checkpoint_dir=p, device="cpu")  # no config, no input_hw
    assert tseg.config.head == "hf" and tseg.config.num_classes == 10
    assert tseg.input_hw == HW
    jseg = jget.Segmenter2D(checkpoint_dir=p)  # the JAX package reads it too
    assert jseg.config.head == "hf" and jseg.input_hw == HW
    img = (np.random.default_rng(5).random((1, *HW, 3)) * 255).astype(np.uint8)
    sem = tseg.predict_batch(img, conf_threshold=0.0)[0]
    np.testing.assert_array_equal(sem, jseg.predict_batch(img, conf_threshold=0.0)[0])
    with torch.no_grad():
        t = hf_model(torch.from_numpy((img.astype(np.float32) / 255.0).transpose(0, 3, 1, 2)))
        t = torch.nn.functional.interpolate(t.logits, size=HW, mode="bilinear",
                                            align_corners=False)
    # the snapshot stores float16 and runs bfloat16: near-ties may flip
    assert (sem == t.argmax(1)[0].numpy()).mean() > 0.98


def test_load_hf_state_dict_reads_torch_save(hf_model, pair, tmp_path):
    with_head, cfg, tstate, _ = pair
    p = tmp_path / "model.pth"
    torch.save({"state_dict": hf_model.state_dict()}, p)
    sd = timport.load_hf_state_dict(p)
    got = timport.params_from_hf_segformer(sd, cfg, params_template=tstate,
                                           include_head=with_head)
    assert all(torch.equal(got[k], v) for k, v in tstate.items())


def test_decoder_head_kept_from_template_without_include_head(hf_model, encoder_pair):
    _, cfg, tstate, _ = encoder_pair
    template = {k: torch.full_like(v, 0.5) for k, v in tstate.items()}
    got = timport.params_from_hf_segformer(hf_model.state_dict(), cfg, params_template=template)
    for k in ("classifier.weight", "fuse.weight"):
        assert torch.equal(got[k], template[k])


class TestErrors:
    def test_missing_key_raises(self, hf_model):
        cfg = timport.config_from_hf(hf_model.config, num_classes=10, dtype=torch.float32)
        sd = dict(hf_model.state_dict())
        sd.pop("segformer.encoder.block.0.0.attention.self.query.weight")
        with pytest.raises(KeyError, match="query"):
            timport.params_from_hf_segformer(sd, cfg)
        got = timport.params_from_hf_segformer(sd, cfg, strict=False)
        assert "stage0_block0.attn.q.weight" not in got and "stage0_block0.attn.k.weight" in got

    def test_geometry_mismatch_raises(self, hf_model):
        cfg = timport.config_from_hf(hf_model.config, num_classes=10, dtype=torch.float32)
        bad = dataclasses.replace(cfg, embed_dims=(8, 16, 24, 48))
        with pytest.raises(ValueError, match="geometry"):
            timport.params_from_hf_segformer(hf_model.state_dict(), bad)

    def test_include_head_requires_hf_head(self, hf_model):
        cfg = timport.config_from_hf(hf_model.config, num_classes=10, dtype=torch.float32)
        with pytest.raises(ValueError, match="head"):
            timport.params_from_hf_segformer(hf_model.state_dict(), cfg, include_head=True)

    def test_classifier_mismatch_raises(self, hf_model):
        cfg = timport.config_from_hf(hf_model.config, dtype=torch.float32, with_head=True)
        with pytest.raises(ValueError, match="classifier"):
            timport.params_from_hf_segformer(hf_model.state_dict(),
                                             dataclasses.replace(cfg, num_classes=12),
                                             include_head=True)

    def test_with_head_on_encoder_only_checkpoint_raises(self, hf_model):
        sd = {k: v for k, v in hf_model.state_dict().items()
              if not k.startswith("decode_head.")}
        with pytest.raises(KeyError, match="classifier"):
            timport.infer_config_from_state_dict(sd, with_head=True)


class TestInferConfig:
    @pytest.mark.parametrize("with_head", [False, True])
    def test_matches_jax(self, hf_model, with_head):
        sd = hf_model.state_dict()
        j = jimport.infer_config_from_state_dict(sd, num_classes=7, dtype=jnp.float32,
                                                 with_head=with_head)
        t = timport.infer_config_from_state_dict(sd, num_classes=7, dtype=torch.float32,
                                                 with_head=with_head)
        dj, dt = dataclasses.asdict(j), dataclasses.asdict(t)
        dj.pop("dtype"), dt.pop("dtype")
        assert dj == dt
        assert t.num_classes == (10 if with_head else 7)  # --with-head reads num_labels
        assert t.head == ("hf" if with_head else "native")

    def test_geometry_read_from_weights(self, hf_model):
        cfg = timport.config_from_hf(hf_model.config, num_classes=10, dtype=torch.float32)
        got = timport.infer_config_from_state_dict(hf_model.state_dict(), num_classes=10,
                                                   dtype=torch.float32)
        for k in ("embed_dims", "depths", "sr_ratios", "patch_sizes", "mlp_ratio",
                  "decoder_dim"):
            assert getattr(got, k) == getattr(cfg, k), k
