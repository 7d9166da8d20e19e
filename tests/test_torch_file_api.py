"""The port's file side against the JAX package on the CPU: PLY files,
calibration and poses, `SessionData.from_export_dir`, the pickle cache
both ways, pose perturbation, the adjacency helpers and the instance split
over stored adjacency."""

import pickle

import numpy as np
import pytest
import torch

from fusion3dseg_tpu.io import ply as jply, rtab as jrtab, synthetic as jsyn
from fusion3dseg_tpu.ops import components as jcomp, neighbors as jnb
from fusion3dseg_tpu_torch.io import native, ply as tply, rtab as trtab, synthetic as tsyn
from fusion3dseg_tpu_torch.ops import components as tcomp, neighbors as tnb


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """One textured session written by each package's writer."""
    sess = jsyn.make_session(nframes=6, depth_hw=(48, 36), appearance="textured")
    jdir = jsyn.write_session_dir(sess, tmp_path_factory.mktemp("jax_written"))
    tdir = tsyn.write_session_dir(sess, tmp_path_factory.mktemp("port_written"))
    return sess, jdir, tdir


@pytest.fixture(scope="module")
def sessions(dirs):
    _, jdir, tdir = dirs
    return {name: (jrtab.SessionData.from_export_dir(d),
                   trtab.SessionData.from_export_dir(d, device="cpu"))
            for name, d in (("jax_written", jdir), ("port_written", tdir))}


def _cloud(rng, n=500):
    return ((rng.normal(size=(n, 3)) * 2).astype(np.float32),
            rng.random((n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("fields", ["xyz", "colors01", "colors_u8", "all"])
def test_ply_point_cloud_bytes_and_round_trip(rng, tmp_path, fields):
    pts, clr, nrm = _cloud(rng)
    kw = {"xyz": {}, "colors01": {"colors": clr}, "colors_u8": {"colors": (clr * 255).astype(
        np.uint8)}, "all": {"colors": clr, "normals": nrm}}[fields]
    jply.write_point_cloud(tmp_path / "j.ply", pts, **kw)
    tply.write_point_cloud(tmp_path / "t.ply", pts, **kw)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    for got, want in zip(tply.read_point_cloud(tmp_path / "j.ply"),
                         jply.read_point_cloud(tmp_path / "j.ply")):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colored", [False, True])
def test_ply_mesh_bytes_and_round_trip(rng, tmp_path, colored):
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    tris = rng.integers(0, 40, (30, 3)).astype(np.int32)
    cols = rng.random((40, 3)) if colored else None
    jply.write_mesh(tmp_path / "j.ply", verts, tris, cols)
    tply.write_mesh(tmp_path / "t.ply", verts, tris, cols)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    for got, want in zip(tply.read_mesh(tmp_path / "t.ply"), jply.read_mesh(tmp_path / "j.ply")):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_calibration_and_poses(dirs, tmp_path):
    _, jdir, _ = dirs
    for f in (jdir / "calibration.yaml", trtab.DEFAULT_CALIBRATION):
        np.testing.assert_array_equal(trtab.read_calibration(f), jrtab.read_calibration(f))
    # an OpenCV-written file: tagged matrix, the list wrapped over lines
    f = tmp_path / "cv.yaml"
    f.write_text("%YAML:1.0\n---\nimage_width: 640\ncamera_matrix: !!opencv-matrix\n"
                 "   rows: 3\n   cols: 3\n   dt: d\n   data: [ 5.2e+02, 0., 3.195e+02,\n"
                 "       0., 5.21e+02, 2.395e+02, 0., 0., 1. ]\n"
                 "distortion_coefficients: !!opencv-matrix\n   data: [0., 0., 0., 0., 0.]\n")
    # (PyYAML, the JAX package's reader, refuses the tag)
    np.testing.assert_array_equal(trtab.read_calibration(f),
                                  [[520.0, 0, 319.5], [0, 521.0, 239.5], [0, 0, 1]])
    for a, b in zip(trtab.read_poses(jdir / "poses.txt", 1, 5),
                    jrtab.read_poses(jdir / "poses.txt", 1, 5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax_written", "port_written"])
def test_from_export_dir_matches_jax(sessions, writer):
    jsd, tsd = sessions[writer]
    for name in ("frame_numbers", "K", "Ks", "quats_wxyz", "translations"):
        np.testing.assert_array_equal(getattr(tsd, name), getattr(jsd, name))
    assert tsd.depth_hw == jsd.depth_hw and tsd.rgb_hw == jsd.rgb_hw
    for name in ("depth", "points", "normals"):
        np.testing.assert_array_equal(getattr(tsd, name).numpy(), getattr(jsd, name))
    # the codec reads the JPEGs as OpenCV does and the frames need no resize
    np.testing.assert_array_equal(tsd.colors.numpy(), jsd.colors)


def test_from_export_dir_skips_unreadable_frames_and_steps(dirs, tmp_path):
    sess, _, _ = dirs
    d = tsyn.write_session_dir(sess, tmp_path / "s")
    (d / "rgb" / "2.jpg").write_bytes(b"not an image")
    (d / "depth" / "4.png").unlink()
    j = jrtab.SessionData.from_export_dir(d, stepf=1, padding=True)
    t = trtab.SessionData.from_export_dir(d, stepf=1, padding=True, device="cpu")
    np.testing.assert_array_equal(t.frame_numbers, [0, 1, 3, 5])
    np.testing.assert_array_equal(t.frame_numbers, j.frame_numbers)
    np.testing.assert_array_equal(t.points.numpy(), j.points)
    t2 = trtab.SessionData.from_export_dir(d, stepf=3, device="cpu")
    np.testing.assert_array_equal(t2.frame_numbers, [0, 3])


def test_pickle_cache_both_ways(sessions, tmp_path):
    jsd, tsd = sessions["jax_written"]
    jsub = jsd.write_cache(tmp_path / "j")
    tsub = tsd.write_cache(tmp_path / "t")
    assert jsub == tsub
    merge = "PointcloudMergeResults"
    for src, sub in ((tmp_path / "j", jsub), (tmp_path / "t", tsub)):
        idx, rts = src / merge / f"tofsegment_{sub}.pkl", src / merge / f"rtscameradata_{sub}.pkl"
        j = jrtab.SessionData.from_cache(idx, rts)
        t = trtab.SessionData.from_cache(idx, rts, device="cpu")
        for name in ("points", "normals", "colors", "depth"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name))
        for name in ("frame_numbers", "K", "Ks", "quats_wxyz", "translations"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(t.points.numpy(), tsd.points.numpy())
    # the port's cache holds NumPy arrays only (JAX reads it without torch)
    with open(tmp_path / "t" / merge / f"Segments_{tsub}" / f"tofcameradata_segments_{tsub}_0.pkl",
              "rb") as fp:
        frame = pickle.load(fp)
    assert all(isinstance(v, (int, np.ndarray)) for v in frame.values())
    # camera-frame points: the inverse rotation, within an ulp of JAX's
    t_cam = trtab.SessionData.from_cache(
        tmp_path / "t" / merge / f"tofsegment_{tsub}.pkl",
        tmp_path / "t" / merge / f"rtscameradata_{tsub}.pkl", device="cpu").depth.numpy()
    np.testing.assert_allclose(t_cam, jsd.depth, rtol=1e-6, atol=1e-6)


def test_perturb_and_retransform(sessions, rng):
    jsd, _ = sessions["jax_written"]
    xyzw = jsd.quats_wxyz[:, [1, 2, 3, 0]]
    rot = np.asarray([0.0, np.sin(0.05), 0.0, np.cos(0.05)])
    jq, jt = jrtab.perturb_poses(xyzw, jsd.translations, rot, [0.1, 0, -0.2], [1, 3])
    tq, tt = trtab.perturb_poses(xyzw, jsd.translations, rot, [0.1, 0, -0.2], [1, 3])
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(tt, jt)
    cam = (rng.normal(size=(len(jq), 200, 3)) + [0, 0, 3]).astype(np.float32)
    got = trtab.retransform_points(cam, tq, tt, device="cpu")
    want = jrtab.retransform_points(cam, jq, jt)
    assert got.dtype == np.float32 and got.shape == want.shape
    # JAX runs the rotation op by op here (no fused multiply-adds): 1 ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_neighbor_helpers(rng):
    pts = rng.random((300, 3)).astype(np.float32)
    lists = native.radius_graph_lists(pts, 0.15)
    offs_t, flat_t = tnb.lists_to_csr(lists)
    offs_j, flat_j = jnb.lists_to_csr(lists)
    np.testing.assert_array_equal(offs_t, offs_j)
    np.testing.assert_array_equal(flat_t, flat_j)
    dense_t = tnb.csr_to_adjacency(offs_t, flat_t)
    np.testing.assert_array_equal(dense_t, jnb.csr_to_adjacency(offs_j, flat_j))
    np.testing.assert_array_equal(tnb.lists_to_adjacency(lists, 5), jnb.lists_to_adjacency(lists, 5))
    back_t, back_j = tnb.adjacency_to_lists(dense_t), jnb.adjacency_to_lists(dense_t)
    assert len(back_t) == len(back_j) == len(lists)
    for a, b, c in zip(back_t, back_j, lists):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    capped = tnb.lists_to_adjacency(lists, 3)
    np.testing.assert_array_equal(tcomp.symmetrize_adjacency(capped),
                                  jcomp.symmetrize_adjacency(capped))


@pytest.mark.parametrize("layout", ["csr", "dense", "dense_capped"])
def test_split_into_instances_matches_jax(rng, layout):
    pts = rng.random((2000, 3)).astype(np.float32) * [4, 4, 1]
    classes = rng.choice([3, 7, 9, 133], size=2000, p=[0.4, 0.3, 0.2, 0.1]).astype(np.int64)
    lists = native.radius_graph_lists(pts, 0.12)
    adj = {"csr": lambda: tnb.lists_to_csr(lists),
           "dense": lambda: tnb.lists_to_adjacency(lists, 64),
           "dense_capped": lambda: tnb.lists_to_adjacency(lists, 4)}[layout]()
    for kw in ({}, {"instance_classes": [3, 7], "minimum_points": 20}):
        t = tcomp.split_into_instances(classes, adj, 133, **kw)
        j = jcomp.split_into_instances(classes, adj, 133, **kw)
        for a, b in zip((t[0], t[1], t[3]), (j[0], j[1], j[3])):
            np.testing.assert_array_equal(a, b)
        assert t[2] == j[2]


def test_split_device_backend_waits():
    with pytest.raises(NotImplementedError, match="item 14"):
        tcomp.split_into_instances(np.zeros(3, np.int64), np.full((3, 2), -1, np.int32),
                                   backend="device")
    assert torch.zeros(1).device.type == "cpu"
