"""The port's uint8 resizes against OpenCV, which the JAX package calls.

`io/image.resize_linear_uint8` is OpenCV's fixed-point INTER_LINEAR and
`io/image.resize_area_uint8` its INTER_AREA (the 2x2 block path, the
integer-factor path and the fractional path): both must equal `cv2.resize`
exactly. Then `process3DSeg` on a session written with RGB at twice the
depth size, where `from_export_dir` shrinks every frame: the artifact tree
must be byte-identical to the JAX package's."""

import filecmp

import cv2
import dataclasses
import numpy as np
import pytest
import torch

from fusion3dseg_tpu.io import synthetic as jsyn
from fusion3dseg_tpu.pipeline import get3dseg as jget3d, process3d as jp3d
from fusion3dseg_tpu_torch.io import image, rtab as trtab, synthetic as tsyn
from fusion3dseg_tpu_torch.pipeline import get3dseg as tget3d, process3d as tp3d

LINEAR_SHAPES = [
    # (source hw, output hw): upscales, the trainer's render -> model resize,
    # odd factors, one-pixel changes, the exact 2x (OpenCV's INTER_AREA
    # route) and 4x shrinks
    ((36, 48), (64, 64)), ((5, 7), (29, 33)), ((96, 72), (256, 256)),
    ((72, 96), (256, 256)), ((192, 256), (240, 320)), ((200, 300), (199, 301)),
    ((480, 640), (256, 256)), ((192, 256), (256, 256)), ((256, 192), (256, 256)),
    ((100, 130), (72, 96)), ((384, 512), (192, 256)), ((384, 512), (96, 128)),
]
AREA_SHAPES = [  # factors 2, 2.5, 3.75, 4 and 7.5
    ((384, 512), (192, 256)), ((480, 640), (192, 256)), ((360, 480), (96, 128)),
    ((384, 512), (96, 128)), ((720, 960), (96, 128)),
]


@pytest.mark.parametrize("src,dst", LINEAR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_linear_equals_cv2(src, dst):
    rgb = np.random.default_rng(sum(src) + sum(dst)).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(rgb, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = image.resize_linear_uint8(torch.from_numpy(rgb), dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear_batched_and_identity():
    rgb = np.random.default_rng(1).integers(0, 256, (3, 30, 40, 3), dtype=np.uint8)
    got = image.resize_linear_uint8(torch.from_numpy(rgb), (17, 53)).numpy()
    np.testing.assert_array_equal(
        got, np.stack([cv2.resize(r, (53, 17), interpolation=cv2.INTER_LINEAR) for r in rgb]))
    same = torch.from_numpy(rgb)
    assert image.resize_linear_uint8(same, (30, 40)) is same


@pytest.mark.parametrize("src,dst", AREA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_area_equals_cv2(src, dst):
    rgb = np.random.default_rng(sum(src)).integers(0, 256, (2, *src, 3), dtype=np.uint8)
    want = np.stack([cv2.resize(r, dst[::-1], interpolation=cv2.INTER_AREA) for r in rgb])
    got = trtab.area_resize_uint8(torch.from_numpy(rgb), dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_area_refuses_upscale():
    with pytest.raises(ValueError, match="only shrinks"):
        image.resize_area_uint8(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), (8, 8))


def _two_x_session():
    """The contracts room at 48x36 depth with its colours rendered at 96x72
    (intrinsics of the colour size, as an RGB-D camera records them)."""
    lo = jsyn.make_session(nframes=6, depth_hw=(48, 36), appearance="textured")
    hi = jsyn.make_session(nframes=6, depth_hw=(96, 72), appearance="textured")
    return dataclasses.replace(lo, colors=hi.colors, K=hi.K)


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


def test_process3d_tree_byte_identical_with_rgb_at_twice_depth(tmp_path):
    sess = _two_x_session()
    src = tsyn.write_session_dir(sess, tmp_path / "session")
    for name, p3d, g3d, kw in (("jax", jp3d, jget3d, {}),
                               ("port", tp3d, tget3d, {"device": "cpu"})):
        p3d.process3DSeg(src, tmp_path / name, capacity=1 << 14, **kw)
        g3d.segment(tmp_path / name, src / "masks", verbose=False, **kw)
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert jfiles == tfiles and len(jfiles) > 10
    differ = [str(f) for f in jfiles
              if not filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False)]
    assert differ == []
