"""Port hygiene: the package and chip_smoke.py import no JAX, nothing of the
JAX package and no image or YAML library (the card's machine has none),
and a CUDA request without a card raises."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fusion3dseg_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "cv2", "PIL", "yaml", "fusion3dseg_tpu"))
print(len(names), "modules;", "bad:", bad)
assert len(names) >= 49 and not bad, bad

import numpy as np, pytest
from fusion3dseg_tpu_torch.ops import label_fuse
assert not __import__("torch").cuda.is_available()
pts = np.zeros((4, 3), np.float32)
from types import SimpleNamespace
from fusion3dseg_tpu_torch import fusion
from fusion3dseg_tpu_torch.pipeline import fast, get2dseg, get3dseg, process3d
import tempfile
tmp = tempfile.mkdtemp()
session = (np.eye(3), np.tile([1.0, 0, 0, 0], (2, 1)), np.zeros((2, 3)), np.zeros((2, 12, 3)),
           np.zeros((2, 12, 3)), np.zeros((2, 12, 3)), np.ones((2, 12), bool))
fkw = dict(height=3, width=4, radius=0.1, min_cosine=0.5, max_depth=8.0, capacity=64)
sd = SimpleNamespace(depth_hw=(3, 4), depth=np.ones((2, 12), np.float32), nframes=2,
                     Ks=np.eye(3), quats_wxyz=session[1], translations=session[2],
                     points=session[3], normals=session[4], colors=session[5])
for call in (
    lambda: label_fuse.label_fuse_session(
        pts, np.eye(3), np.tile([1.0, 0, 0, 0], (2, 1)), np.zeros((2, 3)),
        np.zeros((2, 12), np.uint8), (3, 4), device="cuda"),
    lambda: label_fuse.tpu_label_fuse(4, 10, (3, 4)),  # the default device
    lambda: __import__("fusion3dseg_tpu_torch.pipeline.get2dseg", fromlist=["x"]).Segmenter2D(),
    lambda: __import__("fusion3dseg_tpu_torch.ops.voting", fromlist=["x"]).vote_and_classify(
        np.zeros((1, 4), np.int32), np.zeros((1, 4), np.uint8), 3, 5),
    # the main path's entry points, each on its default device
    lambda: fusion.fuse_session(*session, **fkw),
    lambda: fusion.fuse_session_and_vote(*session, np.zeros((2, 12), np.uint8), nclasses=5,
                                         **fkw),
    lambda: fast.segment_session_fast(sd, masks=np.zeros((2, 12), np.uint8)),
    # the file path's entry points, on their default device
    lambda: process3d.process3DSeg(tmp, tmp + "/out"),
    lambda: get3dseg.segment(tmp, tmp + "/masks"),
    lambda: get2dseg.SegmentImage(tmp, tmp + "/seg"),
    # the graph ops and post-processing, and the CLI, on their default device
    lambda: __import__("fusion3dseg_tpu_torch.ops.neighbors", fromlist=["x"]).radius_graph(
        pts, 0.1),
    lambda: __import__("fusion3dseg_tpu_torch.ops.components", fromlist=["x"]).propagate_labels(
        np.full((4, 2), -1, np.int32), np.zeros(4, np.int32)),
    lambda: __import__("fusion3dseg_tpu_torch.ops.components", fromlist=["x"]).floodfill_level(
        np.full((4, 2), -1, np.int32), np.zeros(4, bool), 2),
    lambda: __import__("fusion3dseg_tpu_torch.pipeline.refinement",
                       fromlist=["x"]).gated_floodfill(
        np.full((4, 2), -1, np.int32), np.zeros(4, bool), np.zeros(4, np.float32), 0.1),
    lambda: __import__("fusion3dseg_tpu_torch.cli", fromlist=["x"]).main(
        ["fuse", tmp, tmp + "/out"]),
):
    with pytest.raises(RuntimeError, match="is_available"):
        call()
print("ok")
"""


def _run(args, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=env, timeout=240, **kw)


def test_package_imports_no_jax_and_cuda_without_card_raises():
    r = _run(["-c", _IMPORT_ALL], cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("ok")


def test_chip_smoke_imports_and_refusals(tmp_path):
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    for m in mods:
        assert m.split(".")[0] not in ("jax", "flax", "cv2", "PIL", "yaml", "fusion3dseg_tpu",
                                       "bench"), m
    # without a card: non-zero exit and no result line
    r = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout, r.stdout + r.stderr
    # alone in a directory, without the rest of the repository
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                       env=env, cwd=tmp_path, timeout=240)
    assert r.returncode != 0 and '"ok"' not in r.stdout, r.stdout + r.stderr
