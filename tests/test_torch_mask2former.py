"""The port's Mask2Former (`models/mask2former.py`) on the CPU, at the
published architecture's tiny widths (embed 32, depths 2/2/2/2, window 4,
heads 1/2/4/8, 2 encoder and 3 decoder layers, 16 queries, 10 classes; a
70 x 90 input, so that the /32 padding, the windows' padding and the
shifts all occur): against the repository's plain reference
(`benchmark/reference/mask2former_ref.py`, which the benchmark holds the
card to as well) in float32 and in bfloat16, its parts against per-element loops, through
`Segmenter2D` and `segment_session_fast`; and SegFormer's confidence rule
unchanged by the class count that `Segmenter2D` now takes from the model."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fusion3dseg_tpu_torch.io import rtab, synthetic
from fusion3dseg_tpu_torch.models import mask2former as m2f
from fusion3dseg_tpu_torch.models.segformer import SegFormerConfig
from fusion3dseg_tpu_torch.pipeline import get2dseg
from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast
from fusion3dseg_tpu_torch.pipeline.streaming import stream_segment
from torch_sessions import session_arrays

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "mask2former_ref", ROOT / "benchmark" / "reference" / "mask2former_ref.py")
m2f_ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(m2f_ref)
TINY = m2f.Mask2FormerConfig(
    num_classes=10, embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=4,
    conv_dim=64, mask_dim=64, norm_groups=8, enc_layers=2, enc_heads=4, enc_ffn_dim=128,
    num_queries=16, hidden_dim=64, dec_heads=4, dec_ffn_dim=128, dec_layers=3,
    dtype=torch.float32)
HW = (70, 90)
# float32 port against float32 reference: the same arithmetic but for the
# order of a few sums (SDPA against the explicit softmax, per-level against
# stacked deformable sums, one product against the per-image einsum), so a
# few float32 ulps of scores up to about 3 (2.6e-6 read at seed 0)
F32_TOL = 1e-5
# bfloat16 port against float32 reference: bfloat16 products and
# activations through 8 Swin blocks, 2 deformable and 3 masked decoder
# layers (and the attention masks that flip with them) move scores of up
# to 4-7 by 0.04-0.26 over seeds 0-7; float8 e4m3 rounding of every
# product's operands moves them by 0.47-1.85 (asserted below on the seeds
# of the lowest float8 and the highest bfloat16 reading)
BF16_TOL = 0.35


def _cfg_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _images(seed, hw=HW, n=2):
    return torch.rand((n, *hw, 3), generator=torch.Generator().manual_seed(seed))


def _model(seed, dtype=torch.float32):
    return m2f.create_model(dataclasses.replace(TINY, dtype=dtype), seed, "cpu")


def _reference(model, mode="float32"):
    params = {k: v.float() for k, v in model.state_dict().items()}
    return m2f_ref.Mask2FormerRef(params, _cfg_dict(TINY), mode)


@pytest.mark.parametrize("seed,hw", [(0, HW), (1, HW), (2, (64, 64))])
def test_float32_port_matches_plain_reference(seed, hw):
    model = _model(seed)
    x = _images(seed + 10, hw)
    with torch.no_grad():
        got = model(x)
    want = _reference(model)(x)
    assert got.shape == want.shape == (2, *hw, TINY.num_classes) and got.dtype == torch.float32
    assert (got - want).abs().max() < F32_TOL


@pytest.mark.parametrize("seed", [0, 6])
def test_bfloat16_port_within_tolerance_float8_outside(seed):
    model = _model(seed, torch.bfloat16)
    assert model.backbone.layers[0].blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    x = _images(seed + 20)
    with torch.no_grad():
        got = model(x)
    ref = _reference(model)
    want = ref(x)
    gap = (got - want).abs().max()
    assert got.dtype == torch.float32 and gap < BF16_TOL
    control = m2f_ref.Mask2FormerRef(ref.p, ref.cfg, "fp8")(x)
    assert (control - want).abs().max() > BF16_TOL


@pytest.mark.parametrize("hp,wp,ws", [(8, 12, 4), (12, 12, 4), (36, 24, 12)])
def test_shift_mask_and_bias_index_against_pair_loops(hp, wp, ws):
    shift = ws // 2
    got = m2f.shift_mask(hp, wp, ws, shift, "cpu")[:, 0]

    def region(i, n):  # Swin's slices (0, -ws), (-ws, -shift), (-shift, None)
        return 0 if i < n - ws else (1 if i < n - shift else 2)

    N = ws * ws
    want = torch.zeros(((hp // ws) * (wp // ws), N, N))
    for w in range(want.shape[0]):
        wy, wx = divmod(w, wp // ws)
        for i in range(N):
            for j in range(N):
                yi, xi = wy * ws + i // ws, wx * ws + i % ws
                yj, xj = wy * ws + j // ws, wx * ws + j % ws
                same = (region(yi, hp), region(xi, wp)) == (region(yj, hp), region(xj, wp))
                want[w, i, j] = 0.0 if same else m2f.SHIFT_MASK
    assert torch.equal(got, want)
    idx = m2f.relative_position_index(ws)
    for i in range(N):
        for j in range(N):
            dy, dx = i // ws - j // ws, i % ws - j % ws
            assert idx[i, j] == (dy + ws - 1) * (2 * ws - 1) + (dx + ws - 1)


def test_deformable_sampling_against_point_loop():
    """`msda_core` against bilinear sampling written out point by point
    (pixel centres at half-integers, zero outside the map)."""
    g = torch.Generator().manual_seed(5)
    shapes = [(3, 4), (5, 7)]
    B, M, D, Lq, P = 2, 2, 3, 6, 2
    S = sum(h * w for h, w in shapes)
    value = torch.randn((B, S, M, D), generator=g)
    loc = torch.rand((B, Lq, M, len(shapes), P, 2), generator=g) * 1.4 - 0.2
    weights = torch.rand((B, Lq, M, len(shapes), P), generator=g)
    got = m2f.msda_core(value, shapes, loc, weights)
    want = torch.zeros((B, Lq, M, D), dtype=torch.float64)
    starts = [0, shapes[0][0] * shapes[0][1]]
    for b in range(B):
        for q in range(Lq):
            for m in range(M):
                for lvl, (h, w) in enumerate(shapes):
                    v = value[b, starts[lvl]:starts[lvl] + h * w, m].double().view(h, w, D)
                    for p in range(P):
                        x = loc[b, q, m, lvl, p, 0].item() * w - 0.5
                        y = loc[b, q, m, lvl, p, 1].item() * h - 0.5
                        x0, y0 = math.floor(x), math.floor(y)
                        s = torch.zeros(D, dtype=torch.float64)
                        for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
                            if 0 <= yy < h and 0 <= xx < w:
                                s += (1 - abs(x - xx)) * (1 - abs(y - yy)) * v[yy, xx]
                        want[b, q, m] += weights[b, q, m, lvl, p].item() * s
    assert torch.allclose(got, want.view(B, Lq, M * D).float(), atol=1e-5)


def test_fully_masked_row_attends_everywhere():
    masks = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(3)) * 4
    masks[0, 1] = -1.0  # a query whose mask is empty everywhere
    keep = m2f.attention_keep(masks, (4, 4))
    assert keep.shape == (1, 1, 4, 16) and keep.dtype == torch.bool
    assert keep[0, 0, 1].all()
    a = F.interpolate(masks, size=(4, 4), mode="bilinear", align_corners=False).flatten(2)
    for q in (0, 2, 3):
        assert torch.equal(keep[0, 0, q], a[0, q].sigmoid() >= 0.5) and not keep[0, 0, q].all()
    # and through the decoder: no NaN from a row with nothing to attend
    x = torch.randn((1, 4, 16)).clamp(-1, 1)
    attn = m2f.Attention(16, 2, torch.float32)
    out = attn(x, torch.randn(1, 16, 16), torch.randn(1, 16, 16), keep[:, :, :, :16])
    assert torch.isfinite(out).all()


def test_create_model_sets_the_direction_grid():
    """The sampling offsets' bias is Mask2Former's direction grid (head k
    along angle 2 pi k / heads on the square's edge, point p at p + 1
    steps, every level alike), not zeroed with the other Dense biases."""
    model = _model(0)
    # four heads: 0, 90, 180 and 270 degrees
    unit = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    steps = torch.arange(1, TINY.enc_points + 1, dtype=torch.float32).view(1, 1, -1, 1)
    want = (unit.view(4, 1, 1, 2) * steps).expand(4, 3, TINY.enc_points, 2)
    for layer in model.pixel_decoder.layers:
        got = layer.self_attn.sampling_offsets.bias.view(4, 3, TINY.enc_points, 2)
        assert torch.allclose(got, want, atol=1e-6)


def test_padding_to_32_and_crop():
    """The scores of a 70 x 90 image are those of the same image padded by
    hand to 96 x 96 with the value that normalises to zero, cropped."""
    model = _model(4)
    x = _images(7, n=1)
    pad = (torch.tensor(m2f.PIXEL_MEAN) / 255.0).expand(1, 96, 96, 3).clone()
    pad[:, :70, :90] = x
    with torch.no_grad():
        got, full = model(x), model(pad)
    assert got.shape == (1, 70, 90, 10) and full.shape == (1, 96, 96, 10)
    assert (got - full[:, :70, :90]).abs().max() < 1e-5


def test_segmenter2d_builds_either_family():
    seg = get2dseg.Segmenter2D(config=TINY, input_hw=HW, batch_size=2, seed=3, device="cpu")
    assert isinstance(seg.model, m2f.Mask2Former) and seg.nclasses == 10
    assert m2f.test_resize_hw(480, 640) == (800, 1067)
    assert get2dseg.Segmenter2D(config=TINY, device="cpu").input_hw == (800, 1067)
    with pytest.raises(ValueError, match="SegFormer only"):
        get2dseg.Segmenter2D(config=TINY, checkpoint_dir=ROOT / "checkpoints", device="cpu")
    # the unclassified id is the class count: 10, not the last channel (9)
    frames = (_images(8, (24, 30)) * 255).to(torch.uint8).numpy()
    assert seg.predict_batch(frames, conf_threshold=1.1).max() == 10
    assert seg.predict_batch(frames, conf_threshold=0.0).max() < 10


def _stream_masks(ref, colors, input_hw, conf, hw):
    """The stream's rule on the reference's scores: resize, argmax,
    softmax confidence, nearest-exact back to the frames' size."""
    x = F.interpolate(colors.permute(0, 3, 1, 2), size=input_hw, mode="bilinear",
                      align_corners=False).permute(0, 2, 3, 1)
    s = ref(x)
    sem = torch.where(torch.softmax(s, -1).amax(-1) < conf, s.shape[-1], s.argmax(-1))
    sem = F.interpolate(sem[:, None].float(), size=hw, mode="nearest-exact")
    return sem[:, 0].reshape(len(s), -1).to(torch.uint8).numpy()


def test_segment_session_fast_with_mask2former():
    """The main path with the tiny Mask2Former in the loop: stages and
    counters recorded, and the classes those of the plain reference's
    masks voted through the masks route."""
    F_, (H, W) = 4, (48, 36)
    sess = synthetic.make_session(nframes=F_, depth_hw=(H, W), appearance="textured",
                                  room=synthetic.RoomSpec(seed=31))
    sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                      sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                      device="cpu")
    seg = get2dseg.Segmenter2D(config=TINY, input_hw=HW, batch_size=2, seed=6, device="cpu")
    kw = dict(radius=0.1, angle=25.0, min_pts_per_inst=20, capacity=1 << 13, window=None,
              nclasses=10, conf_threshold=0.15, device="cpu")
    res = segment_session_fast(sd, segmenter=seg, **kw)
    st = res.stage_seconds
    # one forward: `stream_segment` takes frames 8 at a time
    assert st["m2f.images"] == F_ and st["m2f.msda_calls"] == TINY.enc_layers
    assert st["m2f.padded_pixels"] == F_ * 96 * 96
    assert st["stream"] > 0 and res.classes.shape == (res.n,)
    masks = _stream_masks(_reference(seg.model), sd.colors.reshape(F_, H, W, 3), HW,
                          np.float32(0.15), (H, W))
    assert (masks == 10).any() and (masks < 10).any()
    via_masks = segment_session_fast(sd, masks=masks, **kw)
    assert via_masks.n == res.n
    assert np.mean(via_masks.classes == res.classes) > 0.99


def test_segformer_confidence_rule_unchanged():
    """B2 (the shipped checkpoint) on the shared test session: masks byte
    for byte those of the rule before the class count came from the model
    (the unclassified id the logits' last channel), here and in
    `predict`'s 133 channels."""
    (_, _, _, _, _, colors, _), _ = session_arrays(4, appearance="textured")
    frames = (colors.reshape(4, 48, 36, 3) * 255).round().astype(np.uint8)
    seg = get2dseg.Segmenter2D(config=SegFormerConfig.named("b2"), input_hw=(64, 64),
                               checkpoint_dir=ROOT / "checkpoints/shipped_b2_textured.npz",
                               device="cpu")
    assert seg.nclasses == 133
    for conf in (0.017, 0.5):
        got = seg.predict_batch(frames, conf_threshold=conf)
        with torch.no_grad():
            logits = get2dseg.resize_bilinear(seg.model(seg._model_input(frames)), (48, 36),
                                              antialias=True)
        c = torch.softmax(logits, -1).amax(-1)
        want = torch.where(c < np.float32(conf), logits.shape[-1] - 1, logits.argmax(-1))
        assert np.array_equal(got, want.to(torch.uint8).numpy())
    assert seg.predict(frames[0][:, :, ::-1])["sem_seg"].shape == (133, 48, 36)
    # and the stream's rule on the same frames, through the vote
    sd = rtab.SessionData.from_arrays(frames, np.full((4, 48, 36), 1.5, np.float32),
                                      np.array([[40.0, 0, 18], [0, 40.0, 24], [0, 0, 1]]),
                                      np.tile([0, 0, 0, 1.0], (4, 1)), np.zeros((4, 3)),
                                      device="cpu")
    uv2pt = np.tile(np.arange(48 * 36, dtype=np.int32), (4, 1))
    votes, _ = stream_segment(sd, seg, uv2pt, npts=48 * 36, nclasses=133, batch_size=4)
    assert votes.shape == (48 * 36, 134) and votes.sum() == 4 * 48 * 36
