"""The Mask2Former cell's pieces on the CPU: its FLOP count against the
products counted op by op as the tiny model runs, its three readers on
canned records (None where the program's counts disagree or are absent,
as at the parent commit), the weights the driver draws and loads into the
program, the flip diagnostic, and the whole cell at a tiny size: correct
on the program, the control refused."""

import dataclasses

import pytest
import torch
from conftest import BENCH

import control
from f3sbench import core, m2f_counts
from reference import mask2former_ref

CELL = "scan-m2f-swinl-tum640"
# the architecture at the tiny widths of tests/test_torch_mask2former.py
TINY_SEG = dict(num_classes=10, embed_dim=32, depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8],
                window_size=4, conv_dim=64, mask_dim=64, norm_groups=8, enc_layers=2,
                enc_heads=4, enc_ffn_dim=128, num_queries=16, hidden_dim=64, dec_heads=4,
                dec_ffn_dim=128, dec_layers=3, input_hw=[70, 90])
# the cell cut to a few frames of a small image (conftest's cut of the B2 cell)
TINY = {"frames": 8, "hw": [60, 80], "intrinsics": [64.66, 64.56, 39.8, 31.9],
        "capacity": 131072, "nclasses": 10}
# between the tiny cell's mask-feature gaps over 11 seeds (`m2f_flips` on
# seeds 1-6, 10-14): 0.0074-0.0100 on the program, 0.080-0.117 on the
# float8 control
TINY_LIMITS = {"mask_feature_rel_gap": 0.028}


def _tiny_model(seed=0, dtype=torch.float32):
    from fusion3dseg_tpu_torch.models import mask2former as m2f

    cfg = m2f.Mask2FormerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in TINY_SEG.items() if k != "input_hw"}, dtype=dtype)
    return m2f.create_model(cfg, seed, "cpu").requires_grad_(False), cfg


def _seg_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _tiny_cell(limits=None):
    spec, cell, config, traffic, driver = core.load_cell(CELL)
    for k, v in TINY.items():
        (config if k in config else traffic)[k] = v
    config["filter_classes"] = [3, 5, 7]  # classes of the tiny model
    config["segmenter"].update(TINY_SEG)
    traffic["limits"][config["name"]].update(limits or TINY_LIMITS)
    return spec, cell, config, traffic, driver


# ------------------------------------------------------------------ counts


@pytest.mark.parametrize("hw", [(70, 90), (64, 64), (33, 100)])
def test_flops_against_products_counted_as_the_model_runs(hw):
    from torch.utils.flop_counter import FlopCounterMode

    def sdpa(q, k, v, *a, out_shape=None, **kw):  # the CPU's attention: two products
        return 2 * q[0] * q[1] * q[2] * k[2] * (q[3] + v[3])

    model, cfg = _tiny_model()
    cpu_sdpa = {torch.ops.aten._scaled_dot_product_flash_attention_for_cpu: sdpa}
    with FlopCounterMode(display=False, custom_mapping=cpu_sdpa) as fc:
        model(torch.rand(1, *hw, 3))
    assert m2f_counts.mask2former_flops(_seg_dict(cfg), hw) == fc.get_total_flops()


def test_flops_hand_count_of_one_swin_block():
    """A one-block, one-stage slice by hand: 8 x 8 tokens in 2 x 2 windows
    of 16 (no padding), C = 8, MLP ratio 4."""
    T, N, C = 64, 16, 8
    macs = T * C * 3 * C + 2 * T * N * C + T * C * C + 2 * T * C * 4 * C
    seg = dict(_seg_dict(_tiny_model()[1]), embed_dim=C, depths=[1, 0, 0, 0])
    base = dict(seg, depths=[0, 0, 0, 0])
    hw = (32, 32)
    assert m2f_counts.mask2former_flops(seg, hw) - m2f_counts.mask2former_flops(base, hw) \
        == 2 * macs


# ----------------------------------------------------------------- readers


def _reader(name):
    return core.load_module(BENCH / "metrics" / f"{name}.py", "m2f_" + name.replace(".", "_"))


SEG = {"model": "mask2former-swin-l", **_seg_dict(_tiny_model()[1]), "input_hw": [70, 90]}


def _rec(images, seg=SEG, frames=300, stream=1.5, window=20.0):
    stages = {"stream": stream, "fuse": 1.0}
    if images is not None:
        stages["m2f.images"] = float(images)
    return {"config": {"segmenter": seg}, "window_s": window,
            "requests": [{"frames": frames, "stages": dict(stages)} for _ in range(2)]}


def test_mfu_readers():
    flops = m2f_counts.mask2former_flops(SEG, (70, 90)) * 600
    rec = _rec(300)
    assert _reader("scan.m2f_mfu").read(rec) == pytest.approx(100 * flops / (3.0 * 989e12))
    assert _reader("scan.m2f_step_mfu").read(rec) == pytest.approx(100 * flops / (20 * 989e12))


@pytest.mark.parametrize("rec", [_rec(299), _rec(None), _rec(300, seg={"model": "segformer-b2"}),
                                 _rec(300, seg=None)],
                         ids=["images_disagree", "parent_no_counter", "segformer", "masks"])
@pytest.mark.parametrize("name", ["scan.m2f_mfu", "scan.m2f_step_mfu"])
def test_mfu_readers_none(name, rec):
    assert _reader(name).read(rec) is None


def _traced(launches, calls, seconds=0.012, frames=300):
    kernels = {"void at::native::(anonymous namespace)::grid_sampler_2d_kernel<float, int>(...)":
               [launches, seconds], "ampere_bf16_s16816gemm": [400, 0.5]}
    stages = {} if calls is None else {"m2f.msda_calls": float(calls)}
    return {"trace": {"kernels": kernels, "work": {"frames": frames, "stages": stages}}}


def test_msda_reader():
    read = _reader("scan.m2f_msda_ms_per_frame").read
    assert read(_traced(18 * 38, 6 * 38)) == pytest.approx(1e3 * 0.012 / 300)
    assert read(_traced(18 * 38 - 1, 6 * 38)) is None  # a launch missing
    assert read(_traced(18, None)) is None  # the parent counts no call
    assert read({"trace": None}) is None


# --------------------------------------------------------------- reference


# ----------------------------------------------------------------- weights


def _driver():
    return core.load_cell(CELL)[4]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 33])
def test_drawn_weights_load_into_the_program_by_name(seed):
    """Every parameter of the program drawn, from the seed alone; loaded
    strictly, the program holds them (rounded to its dtype), and nothing is
    left at the program's own values."""
    driver = _driver()
    model, cfg = _tiny_model(5)
    seg = _seg_dict(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = driver.draw_params(shapes, seg, seed)
    assert set(params) == set(shapes) and all(params[k].dtype == torch.float32 for k in params)
    again = driver.draw_params(shapes, seg, seed)
    assert all(torch.equal(params[k], again[k]) for k in params)
    other = driver.draw_params(shapes, seg, seed + 1)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(params, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k].to(v.dtype)), k
        if not k.endswith("sampling_offsets.bias"):  # the grid: fixed, as the program's
            assert not torch.equal(v, own[k]) and not torch.equal(params[k], other[k]), k
        else:  # cos and sin in float64 here, float32 in the program
            assert torch.allclose(v, own[k], atol=1e-6), k


def test_drawn_weights_follow_their_rules():
    driver = _driver()
    model, cfg = _tiny_model()
    p = driver.draw_params({k: tuple(v.shape) for k, v in model.state_dict().items()},
                           _seg_dict(cfg), 3)
    w = p["backbone.layers.2.blocks.0.mlp.fc1.weight"]  # [512, 128]
    assert w.abs().max() <= (6.0 / (512 + 128)) ** 0.5 and w.std() > 0.05
    k = p["pixel_decoder.layer_1.0.weight"]  # a 3x3 kernel, fans times 9
    assert k.abs().max() <= (6.0 / (9 * (64 + 64))) ** 0.5
    assert abs(float(p["backbone.norm3.weight"].mean()) - 1.0) < 0.02
    assert 0.0 < float(p["predictor.class_embed.bias"].std()) < 0.1
    assert 0.5 < float(p["predictor.query_feat"].std()) < 1.5
    assert float(p["backbone.layers.0.blocks.1.attn.relative_position_bias_table"].std()) < 0.04


def test_flip_diagnostic_counts_and_imposes():
    """The diagnostic at the tiny size: the control's masks flip more than
    the program's, and the program's scores come out alike under the
    reference's masks."""
    import m2f_flips

    _, _, config, traffic, _ = _tiny_cell()
    over = dict(TINY, filter_classes=[3, 5, 7], segmenter={**config["segmenter"]})
    (row,) = m2f_flips.readings([7], sessions=1, device="cpu", overrides=over,
                                log=lambda s: None)
    assert len(row["program"]["flip_share_per_layer"]) == TINY_SEG["dec_layers"]
    assert sum(row["control"]["flip_share_per_layer"]) > sum(row["program"]["flip_share_per_layer"])
    assert row["control"]["rel_gap"] > 3 * row["program"]["rel_gap"]
    assert row["imposed"]["rel_gap"] < 2 * row["program"]["rel_gap"]
    # the mask features come before any attention mask
    assert row["imposed"]["feature_rel_gap"] == row["program"]["feature_rel_gap"]
    assert row["control"]["feature_rel_gap"] > 3 * row["program"]["feature_rel_gap"]


def test_masks_and_scores_keeps_the_checked_frames():
    model, cfg = _tiny_model(1)
    ref = mask2former_ref.Mask2FormerRef({k: v.float() for k, v in model.state_dict().items()},
                                         _seg_dict(cfg))
    colors = torch.rand((5, 30, 40, 3), generator=torch.Generator().manual_seed(2))
    masks, scores, feats = mask2former_ref.masks_and_scores(ref, colors, (70, 90), 0.15, 2,
                                                            [0, 3])
    assert masks.shape == (5, 1200) and masks.dtype == torch.uint8
    assert scores.shape == (2, 70, 90, 10) and feats.shape == (2, 24, 24, 64)
    x = torch.nn.functional.interpolate(colors[3:4].permute(0, 3, 1, 2), size=(70, 90),
                                        mode="bilinear", align_corners=False)
    # in a batch of one, not two
    alone, feat = ref(x.permute(0, 2, 3, 1).contiguous(), with_features=True)
    assert (torch.as_tensor(scores[1]) - alone[0]).abs().max() < 1e-5
    assert (torch.as_tensor(feats[1]) - feat[0]).abs().max() < 1e-5
    assert torch.equal(ref(x.permute(0, 2, 3, 1).contiguous()), alone)


# ---------------------------------------------------------------- the cell


def test_tiny_cell_is_correct():
    spec, cell, config, traffic, driver = _tiny_cell()
    out = core.run_cell(spec, cell, config, traffic, driver, 2 ** 31 + 33, 2.0, False, "cpu",
                        core.since_boot())
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"points_gap_m", "normals_gap", "cloud_size_gap",
                                  "mask_feature_rel_gap"}
    assert "scan_frames_per_s" in out["metrics"] and "setup_s" in out["metrics"]


def test_tiny_control_is_refused():
    """The reference with float8 products in the program's place fails the
    score limit; the program passes every limit."""
    _, _, config, traffic, _ = _tiny_cell()
    limits = traffic["limits"][config["name"]]
    over = dict(TINY, filter_classes=[3, 5, 7], segmenter={**config["segmenter"]})
    rows = control.readings(CELL, [7], device="cpu", overrides=over)
    for row in rows:
        assert row["control"]["mask_feature_rel_gap"] > limits["mask_feature_rel_gap"], row
        assert all(row["program"][n] <= lim for n, lim in limits.items()), row
