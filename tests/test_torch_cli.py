"""The port's command line against the JAX package's, on the CPU.

A toy session (6 frames at 64x48) goes through both CLIs: `synth`, then on
one shared copy of JAX's session `fuse`, `seg3d`, `remove-classes`,
`doorwindow`, `refine` (depth and colour) and `all` (masks given). The
artifact trees must be byte-identical for .npy / .json / .pkl / .ply and
the text files, PNGs decode equal. JPEG encoders differ in their bytes:
the port's q95 JPEG must lie as close to the source as OpenCV's (within
0.1 dB of PSNR) and decode within 45 dB of OpenCV's file (measured 49-73 dB
on these flat-shaded frames, whose hard edges keep both encoders near 32-37
dB of the source: PERF.md's 35 dB bar is for textured frames). Then the
TUM path (`write_tum_dir`, `degrade_session`, `tum`),
`import-hf` of a random MiT-b0 -> `seg2d` / `calibrate`, `train` for two
steps, and `config.py`'s defaults pinned to the port's stage signatures."""

import filecmp
import inspect
import json
import shutil

import cv2
import numpy as np
import pytest
import torch

from fusion3dseg_tpu import cli as jcli
from fusion3dseg_tpu.io import synthetic as jsyn
from fusion3dseg_tpu_torch import cli as tcli, config as tconfig
from fusion3dseg_tpu_torch.io import image, synthetic as tsyn
from fusion3dseg_tpu_torch.pipeline.door_window import DOOR_WINDOW_CATEGORIES, fit_plane

JPEG_PAIR_BAR = 45.0  # dB between the port's and OpenCV's decodes of one frame
DEV = ["--device", "cpu"]
CMP_SUFFIXES = {".npy", ".json", ".pkl", ".ply", ".txt", ".yaml", ".csv"}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _jpeg_as_opencv(port, opencv, src):
    assert _psnr(port, src) >= _psnr(opencv, src) - 0.1
    assert _psnr(port, opencv) >= JPEG_PAIR_BAR


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


def _same_tree(a, b):
    """Same file names; data files byte-identical; PNGs decode equal; JPEGs
    within the PSNR bar of each other."""
    fa, fb = _files(a), _files(b)
    assert fa == fb and fa
    differ = [str(f) for f in fa if f.suffix in CMP_SUFFIXES
              and not filecmp.cmp(a / f, b / f, shallow=False)]
    assert differ == []
    for f in fa:
        if f.suffix == ".png":
            np.testing.assert_array_equal(image.read(a / f, unchanged=True),
                                          image.read(b / f, unchanged=True))
        elif f.suffix == ".jpg":
            assert _psnr(image.read(a / f), image.read(b / f)) >= JPEG_PAIR_BAR


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    synth = ["synth", "--frames", "6", "--height", "64", "--width", "48"]
    jcli.main(synth[:1] + [str(root / "synth_jax")] + synth[1:])
    tcli.main(synth[:1] + [str(root / "synth_port")] + synth[1:])
    for name, main, dev in (("jax", jcli.main, []), ("port", tcli.main, DEV)):
        d = root / name
        shutil.copytree(root / "synth_jax", d / "session")
        s, masks = str(d / "session"), str(d / "session" / "masks")
        main(["fuse", s, str(d / "fused")] + dev)
        main(["seg3d", str(d / "fused"), masks] + dev)
        main(["remove-classes", str(d / "fused"), masks] + dev)
        main(["all", s, str(d / "out"), "--mask-dir", masks] + dev)
        main(["doorwindow", str(d / "out")])
    # refine from a point of the first door/window instance, on its fitted plane
    pan = root / "jax" / "out" / "panoptic_segmentation"
    ids = np.load(pan / "ids.npy")
    door = [i["id"] for i in json.loads((pan / "info.json").read_text())
            if i["category_id"] in DOOR_WINDOW_CATEGORIES][0]
    from fusion3dseg_tpu_torch.io import ply

    pts = ply.read_point_cloud(pan / "pcd.ply")[0]
    c, n = fit_plane(pts[ids == door].astype(np.float64))
    seed = str(int(np.nonzero(ids == door)[0][0]))
    for name, main, dev in (("jax", jcli.main, []), ("port", tcli.main, DEV)):
        out = str(root / name / "out")
        main(["refine", out, seed, "--from-point", "--wall-point", *map(str, c),
              "--wall-normal", *map(str, n)] + dev)
        main(["refine", out, seed, "--mode", "color", "--from-point", "--threshold", "0.2"] + dev)
    return root


def test_synth_writes_the_same_session(runs):
    a, b = runs / "synth_jax", runs / "synth_port"
    assert _files(a) == _files(b)
    for f in ("poses.txt", "calibration.yaml"):
        assert (a / f).read_bytes() == (b / f).read_bytes()
    sess = jsyn.make_session(nframes=6, depth_hw=(64, 48))
    for i in range(6):
        for sub in ("depth", "masks"):
            np.testing.assert_array_equal(image.read(b / sub / f"{i}.png", unchanged=True),
                                          cv2.imread(str(a / sub / f"{i}.png"),
                                                     cv2.IMREAD_UNCHANGED))
        _jpeg_as_opencv(image.read(b / "rgb" / f"{i}.jpg"),
                        cv2.imread(str(a / "rgb" / f"{i}.jpg"))[:, :, ::-1], sess.colors[i])


@pytest.mark.parametrize("sub", ["fused", "out"])
def test_stage_trees_byte_identical(runs, sub):
    _same_tree(runs / "jax" / sub, runs / "port" / sub)
    assert (runs / "port" / "out" / "panoptic_segmentation" / "door_window_mesh.ply").is_file()
    assert (runs / "port" / "out" / "cv_segmentation" / "ids.npy").is_file()


def test_printed_summaries(runs, capsys):
    tcli.main(["doorwindow", str(runs / "port" / "out")])
    tcli.main(["ingest", str(runs / "port" / "session")] + DEV)
    out = capsys.readouterr().out
    assert "door/window quads" in out and "6 frames, depth (64, 48), rgb (64, 48)" in out
    with pytest.raises(SystemExit, match="wall-point"):
        tcli.main(["refine", str(runs / "port" / "out"), "0"] + DEV)
    with pytest.raises(SystemExit):
        tcli.main(["train", "--render-hws", "0x4"])


def test_tum_path(runs, tmp_path):
    sess = jsyn.make_session(nframes=5, depth_hw=(48, 64))
    jd = jsyn.degrade_session(sess, seed=3, pose_drift=0.01, mask_error=0.05)
    td = tsyn.degrade_session(sess, seed=3, pose_drift=0.01, mask_error=0.05)
    for f in ("depth", "gt_mask", "colors", "quats_wxyz", "translations"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
    kw = dict(drop_depth=(2,), seed=4)
    jsyn.write_tum_dir(jd, tmp_path / "tum_jax", **kw)
    tsyn.write_tum_dir(jd, tmp_path / "tum_port", **kw)
    _same_tree(tmp_path / "tum_jax", tmp_path / "tum_port")
    for name, main, dev in (("jax", jcli.main, []), ("port", tcli.main, DEV)):
        main(["tum", str(tmp_path / "tum_jax"), str(tmp_path / f"exp_{name}"),
              "--intrinsics", "fr1"])
        main(["tum", str(tmp_path / "tum_jax")] + dev)
    a, b = tmp_path / "exp_jax", tmp_path / "exp_port"
    _same_tree(a, b)
    from fusion3dseg_tpu.io import tum as jtum
    from fusion3dseg_tpu_torch.io import tum as ttum

    want, wst = jtum.load_session(tmp_path / "tum_jax", "fr1")
    got, gst = ttum.load_session(tmp_path / "tum_jax", "fr1", device="cpu")
    np.testing.assert_array_equal(gst, wst)
    for f in ("points", "normals", "colors", "depth"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(ttum.intrinsics_matrix("fr2"), jtum.intrinsics_matrix("fr2"))
    assert ttum.associate([1.0, 2.0, 3.0], [1.01, 2.5, 2.99]) == \
        jtum.associate([1.0, 2.0, 3.0], [1.01, 2.5, 2.99])


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)  # a random MiT-b0 encoder (the config's defaults), no download
    model = transformers.SegformerForSemanticSegmentation(transformers.SegformerConfig())
    torch.save(model.state_dict(), d / "hf.pth")
    tcli.main(["import-hf", str(d / "hf.pth"), str(d / "b0.npz"), "--input-size", "64"])
    return d / "b0.npz"


def test_import_hf_seg2d_and_calibrate(toy_npz, runs, tmp_path, capsys):
    from fusion3dseg_tpu_torch.models import convert

    assert convert.checkpoint_input_hw(toy_npz) == (64, 64)
    tcli.main(["seg2d", str(runs / "synth_jax" / "rgb"), str(tmp_path / "masks"), "--model",
               "b0", "--checkpoint", str(toy_npz), "--batch-size", "4"] + DEV)
    masks = sorted((tmp_path / "masks").glob("*.png"))
    assert len(masks) == 6 and image.read(masks[0], gray=True).shape == (64, 48)
    tcli.main(["calibrate", "--model", "b0", "--checkpoint", str(toy_npz), "--sessions", "1",
               "--frames", "4"] + DEV)
    out = capsys.readouterr().out
    assert "input size: 64x64" in out and "calibrated:" in out


def test_train_two_steps(tmp_path, capsys):
    ck = tmp_path / "run"
    tcli.main(["train", "--steps", "2", "--batch-size", "2", "--input-size", "32",
               "--render-hws", "32x24", "--warmup-steps", "1", "--prefetch", "0",
               "--checkpoint-dir", str(ck), "--ema-decay", "0.9"] + DEV)
    assert "final loss:" in capsys.readouterr().out
    assert (ck / "step.txt").read_text() == "2"
    assert (ck / "params").resolve().name == "params_00000002.npz"
    assert (ck / "opt_state_00000002.pt").is_file() and (ck / "ema" / "params").exists()
    assert json.loads((ck / "meta.json").read_text())["input_hw"] == [32, 32]


def test_config_defaults_match_the_port_stage_signatures():
    from fusion3dseg_tpu_torch.fusion import Fusion
    from fusion3dseg_tpu_torch.ops import components
    from fusion3dseg_tpu_torch.pipeline.get2dseg import SegmentImage
    from fusion3dseg_tpu_torch.pipeline.get3dseg import segment
    from fusion3dseg_tpu_torch.pipeline.process3d import process3DSeg

    def defaults(fn):
        return {k: v.default for k, v in inspect.signature(fn).parameters.items()
                if v.default is not inspect.Parameter.empty}

    d, f = defaults(process3DSeg), tconfig.FusionConfig()
    assert (f.radius, f.angle, f.stride, f.point_range, f.decimation, f.min_occ, f.capacity) == (
        d["radius"], d["angle"], d["stride"], d["point_range"], d["decimation"], d["min_occ"],
        d["capacity"])
    assert f.max_depth is None and f.window_policy == Fusion.window_policy
    d, v = defaults(segment), tconfig.VotingConfig()
    assert (v.threshold, v.nclasses, tuple(v.filter_classes), v.min_pts_per_inst) == (
        d["threshold"], d["nclasses"], tuple(d["filter_classes"]), d["min_pts_per_inst"])
    d, s2 = defaults(SegmentImage), tconfig.Seg2DConfig()
    assert (s2.extension, s2.conf_threshold, s2.filter_classes) == (
        d["extension"], d["conf_threshold"], d["filter_classes"])
    assert tconfig.InstanceConfig().max_iters == defaults(
        components.split_into_instances)["max_iters"]
    assert tconfig.UNCLASSIFIED == tconfig.NUM_CLASSES == 133


def test_trace_writes_a_profile(tmp_path):
    from fusion3dseg_tpu_torch.utils import timing

    with timing.trace(None) as prof:
        assert prof is None
    with timing.trace(tmp_path / "trace") as prof:
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])
