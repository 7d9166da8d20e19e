"""The plain references against the program's CPU path at tiny sizes, the
controls that `correct` must refuse, and the faults a run must catch."""

import json
import math

import numpy as np
import pytest
import torch
from conftest import BENCH, tiny_cell

import control
from f3sbench import core
from reference import segformer_ref

ROOT = BENCH.parent
MASK_CELLS = ["scan-masks-tum640", "relabel-1m-300f"]


def _run(name, seed=2 ** 31 + 21, seconds=0.3, limits=None):
    spec, cell, config, traffic, driver = tiny_cell(name, limits)
    return core.run_cell(spec, cell, config, traffic, driver, seed, seconds, False, "cpu",
                         core.since_boot())


@pytest.mark.parametrize("name", MASK_CELLS)
def test_program_matches_reference(name):
    out = _run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", MASK_CELLS)
def test_control_is_refused(name):
    """The reference one precision step down (TF32 products) in the
    program's place fails one of the cell's limits, on two seeds."""
    _, _, config, traffic, _ = tiny_cell(name)
    limits = traffic["limits"][config["name"]]
    from conftest import TINY

    rows = control.readings(name, [5, 2 ** 31 + 5], device="cpu", overrides=TINY[name])
    for row in rows:
        assert any(row["control"][n] > lim for n, lim in limits.items()), row
        assert all(row["program"][n] <= lim for n, lim in limits.items()), row


def test_segformer_reference_is_the_programs_model():
    """The plain B2 forward against the program's SegFormer, both float32,
    on the shipped checkpoint at a small input."""
    from fusion3dseg_tpu_torch.models.segformer import SegFormerConfig
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    seg = json.loads((ROOT / "benchmark/configs/rtab-segformer-b2.json").read_text())["segmenter"]
    cfg = SegFormerConfig(num_classes=seg["num_classes"], embed_dims=tuple(seg["embed_dims"]),
                          depths=tuple(seg["depths"]), num_heads=tuple(seg["num_heads"]),
                          sr_ratios=tuple(seg["sr_ratios"]), decoder_dim=seg["decoder_dim"],
                          dtype=torch.float32)
    prog = Segmenter2D(config=cfg, checkpoint_dir=ROOT / seg["checkpoint"], input_hw=(64, 96),
                       device="cpu")
    ref = segformer_ref.SegFormerRef(segformer_ref.load_npz(ROOT / seg["checkpoint"], "cpu"), seg)
    x = torch.rand((2, 64, 96, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, b = prog.model(x), ref(x)
    assert a.shape == b.shape == (2, 64, 96, 134)
    assert (a - b).abs().max() < 1e-3 * b.abs().max()
    fp8 = segformer_ref.SegFormerRef(ref.p, seg, mode="fp8")(x)
    assert (fp8 - b).abs().max() > 10 * (a - b).abs().max()


# ------------------------------------------------------------------ faults


def _scan_faults():
    from fusion3dseg_tpu_torch.ops import voting
    from fusion3dseg_tpu_torch.pipeline import fast

    classify, vote_all, segment = voting.classify, voting.vote_all_frames, \
        fast.segment_session_fast

    def altered(votes, threshold, nclasses, filter_classes=None):
        c = classify(votes, threshold, nclasses, filter_classes)
        return torch.where(torch.arange(len(c)) % 7 == 0, (c + 1) % nclasses, c)

    def half(uv2pt, masks, npts, nclasses, dedup=True, device="cuda"):
        uv = torch.as_tensor(uv2pt).clone()
        uv[1::2] = -1  # every other frame's votes left out
        return vote_all(uv, masks, npts, nclasses, dedup, device)

    first = {}

    def stale(*a, **k):  # the first answer, returned for every session
        if "r" not in first:
            first["r"] = segment(*a, **k)
        return first["r"]

    return {"answer altered": (voting, "classify", altered),
            "half the frames left out": (voting, "vote_all_frames", half),
            "state unchanged": (fast, "segment_session_fast", stale)}


def _relabel_faults():
    from fusion3dseg_tpu_torch.ops import label_fuse as lf

    hist, set_row, cells = lf._histogram_classify, lf._set_row, lf.tpu_label_fuse_cells

    def altered(C, nclasses, threshold, use_cuda_hist=True):
        (t, v), c = hist(C, nclasses, threshold, use_cuda_hist)
        return (t, v), torch.where(torch.arange(len(c)) % 7 == 0, (c + 1) % nclasses, c)

    def half(C, f, win_id, has, mask, npts):
        if f % 2 == 0:  # every other frame's winners left out
            set_row(C, f, win_id, has, mask, npts)

    def stale_cells(*a, **k):
        run = cells(*a, **k)
        first = {}

        def again(*args):
            if "r" not in first:
                first["r"] = run(*args)
            return first["r"]

        return again

    return {"answer altered": (lf, "_histogram_classify", altered),
            "half the frames left out": (lf, "_set_row", half),
            "state unchanged": (lf, "tpu_label_fuse_cells", stale_cells)}


FAULTS = [(c, f) for c in ("scan-masks-tum640", "relabel-1m-300f")
          for f in ("answer altered", "half the frames left out", "state unchanged")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_refused(name, fault, monkeypatch):
    """The harness's run with the timed path broken underneath reads
    `correct` false (the look for a card skipped: the run is on the CPU)."""
    faults = _scan_faults() if name.startswith("scan") else _relabel_faults()
    module, attr, broken = faults[fault]
    monkeypatch.setattr(module, attr, broken)
    out = _run(name, seconds=3.0 if name.startswith("scan") else 1.0)
    # every checked request ran: each number compared is a reading
    assert all(math.isfinite(c["value"]) for c in out["checks"].values()), out
    assert not out["correct"], out["checks"]


def test_tf32_rounding():
    from reference import relabel_ref, scan_ref

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -9],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -10, -3.0 - 2 ** -9])
    assert torch.equal(scan_ref.tf32(x), want) and torch.equal(relabel_ref.tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    r = scan_ref.tf32(y)
    assert ((r - y).abs() <= y.abs() * 2 ** -11).all()
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert np.isfinite(r.numpy()).all()


@pytest.mark.parametrize("filter_classes", [None, (86, 114, 115)])
def test_reference_vote_is_the_programs_rule(filter_classes):
    """The plain vote and classification against the program's, with and
    without get3DSeg's class filter, on random masks with ties."""
    from fusion3dseg_tpu_torch.ops import voting
    from reference import scan_ref

    g = torch.Generator().manual_seed(7)
    F_, P, npts, nc = 6, 400, 300, 133
    uv2pt = torch.randint(-1, npts, (F_, P), generator=g)
    pick = torch.tensor([86, 114, 115, 3, 40])
    masks = pick[torch.randint(0, len(pick), (F_, P), generator=g)]
    want = voting.classify(voting.vote_all_frames(uv2pt, masks, npts, nc, True, "cpu"), 0.5, nc,
                           filter_classes)
    got = scan_ref.vote_classify(uv2pt, masks, npts, nc, 0.5, filter_classes)
    assert torch.equal(got, want.long())
