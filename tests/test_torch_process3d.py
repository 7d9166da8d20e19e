"""The file-artifact path through both packages on the CPU:
`process3DSeg` -> `segment` -> `remove_classes` over an rtabmap-export
directory, artifact for artifact, plus the `Fusion` driver's chunked,
checkpointed and state-file paths, the correspondence lookups and
`SegmentImage`.

Two sessions: the 8-frame 48x36 room of tests/test_contracts.py at
capacity 2^14 (no merge window), and 16 frames of the e2e room circled
twice at radius 0.1 and the default capacity 2^20, where the auto window
(2^13) overflows at loop closure and the repair runs. The frames need no
resize and the codec reads the JPEGs as OpenCV does, so every file is
byte-identical, the pickles included."""

import filecmp
import json
import pickle

import numpy as np
import pytest
import torch

from fusion3dseg_tpu.fusion import fusion as jfusion
from fusion3dseg_tpu.io import rtab as jrtab, synthetic as jsyn
from fusion3dseg_tpu.pipeline import correspondence as jcorr, get3dseg as jget3d, \
    process3d as jp3d
from fusion3dseg_tpu_torch.fusion import fusion as tfusion
from fusion3dseg_tpu_torch.io import rtab as trtab, synthetic as tsyn
from fusion3dseg_tpu_torch.models import SegFormerConfig
from fusion3dseg_tpu_torch.pipeline import correspondence as tcorr, get2dseg, \
    get3dseg as tget3d, process3d as tp3d
from torch_seg_pair import TINY

SESSIONS = {
    # (make_session kwargs, writer, process3DSeg kwargs)
    "contracts8": (dict(nframes=8, depth_hw=(48, 36)), tsyn, dict(capacity=1 << 14)),
    "loop16": (dict(nframes=16, depth_hw=(48, 36), turns=2.0, room=jsyn.RoomSpec(seed=0)),
               jsyn, dict(radius=0.1)),
}


@pytest.fixture(scope="module", params=list(SESSIONS))
def trees(request, tmp_path_factory):
    skw, writer, pkw = SESSIONS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    sess = jsyn.make_session(**skw)
    src = writer.write_session_dir(sess, root / "session")
    out = {}
    for name, p3d, g3d, dkw in (("jax", jp3d, jget3d, {}), ("port", tp3d, tget3d, {"device": "cpu"})):
        ret = p3d.process3DSeg(src, root / name, **pkw, **dkw)
        g3d.segment(root / name, src / "masks", verbose=False, **dkw)
        g3d.remove_classes(root / name, src / "masks", verbose=False, **dkw)
        out[name] = ret
    return request.param, root, src, out


def _files(d):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


def test_artifact_tree_byte_identical(trees):
    name, root, _, _ = trees
    jfiles, tfiles = _files(root / "jax"), _files(root / "port")
    assert jfiles == tfiles
    assert len([f for f in jfiles if f.parts[:2] == ("fusion", "uv2pt")]) == SESSIONS[name][0][
        "nframes"]
    differ = [str(f) for f in jfiles
              if not filecmp.cmp(root / "jax" / f, root / "port" / f, shallow=False)]
    assert differ == []


def test_fusion_data_and_adjacency(trees):
    _, root, _, out = trees
    j, t = out["jax"], out["port"]
    for a, b in zip(j[:5], t[:5]):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(t[0], j[0])  # points
    np.testing.assert_array_equal(t[1], j[1])  # normals
    assert np.abs(t[2] - j[2]).max() <= 1.0 / 255  # colours: the codec's bar
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[4], j[4])
    assert t[4].dtype == np.uint32 and t[5] == j[5] and tuple(t[6]) == tuple(j[6])
    assert t[7].dtype == object and len(t[7]) == len(t[0])
    for a, b in zip(t[7], j[7]):
        np.testing.assert_array_equal(a, b)
    with open(root / "port" / "fusion" / "fusion_data.pkl", "rb") as fp:
        data = pickle.load(fp)
    assert all(v is None or not isinstance(v, torch.Tensor) for v in data.values())


def test_overflow_repair_runs_on_loop_session(tmp_path):
    skw, writer, pkw = SESSIONS["loop16"]
    src = tsyn.write_session_dir(jsyn.make_session(**skw), tmp_path / "s", write_masks=False)
    f = tfusion.Fusion(tp3d.load_session(src, device="cpu"), point_range=(0.1, 4.0))
    f.fuse(pkw["radius"], 10.0, max_depth=4.0)
    assert f.last_overflow_frames > 0 and f.last_spans.max() > 8192


def test_contract_dtypes(trees):
    _, root, _, _ = trees
    d = root / "port"
    uv = np.load(sorted((d / "fusion" / "uv2pt").glob("*.npy"))[0])
    assert uv.dtype == np.int32 and uv.shape == (48 * 36,)
    votes = np.load(d / "segmentation" / "votes.npy")
    n = len(np.load(d / "segmentation" / "classes.npy"))
    assert votes.shape == (n, 134) and votes.dtype == np.int32
    ids = np.load(d / "panoptic_segmentation" / "ids.npy")
    assert ids.shape == (n,)
    final = json.loads((d / "panoptic_segmentation" / "final_info.json").read_text())
    assert {"id", "category_id", "area", "parent_id"} <= set(final[0])
    boxes = [i["bbox"] for i in final if i.get("bbox") is not None]
    assert boxes and all(np.asarray(b).shape == (8, 3) for b in boxes)
    assert np.load(d / "segmentation" / "remaining_mask.npy").dtype == bool


@pytest.fixture(scope="module")
def arrays():
    """A 12-frame two-turn session through both packages' from_arrays."""
    sess = jsyn.make_session(nframes=12, depth_hw=(48, 36), turns=2.0, room=jsyn.RoomSpec(seed=3))
    args = (sess.colors, sess.depth, sess.K, sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations)
    return jrtab.SessionData.from_arrays(*args), trtab.SessionData.from_arrays(*args, device="cpu")


KW = dict(height=48, width=36, radius=0.05, min_cosine=float(np.cos(np.deg2rad(10.0))),
          max_depth=8.0, capacity=1 << 15, window=4096, window_policy="split")


def _engine_args(sd):
    valid = (np.asarray(sd.depth) > 0.1) & (np.asarray(sd.depth) <= 8.0)
    return (np.asarray(sd.Ks, np.float32), sd.quats_wxyz, sd.translations, np.asarray(sd.points),
            np.asarray(sd.normals), np.asarray(sd.colors), valid)


def test_fusion_from_the_ports_own_session_arrays(arrays):
    # the port's from_arrays gives the JAX package's bits, so fusing from it
    # gives the JAX engine's cloud and lookups
    jsd, tsd = arrays
    jstate, juv = jfusion.fuse_session(*_engine_args(jsd), **KW)
    tstate, tuv = tfusion.fuse_session(*_engine_args(tsd), device="cpu", **KW)
    assert int(tstate.n) == int(jstate.n)
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    n = int(jstate.n)
    np.testing.assert_array_equal(tstate.points[:n].numpy(), np.asarray(jstate.points)[:n])


def test_chunked_checkpointed_and_state_files(arrays, tmp_path):
    _, tsd = arrays
    args = _engine_args(tsd)
    one_state, one_uv = tfusion.fuse_session(*args, device="cpu", **KW)
    # seed + chunks of 4, 1 and the rest
    state, uv0 = tfusion._seed_frame(tfusion._empty_state(KW["capacity"], torch.device("cpu")),
                                     *(torch.as_tensor(a[0]) for a in args[3:]),
                                     **{k: KW[k] for k in ("height", "width", "radius",
                                                           "min_cosine", "max_depth",
                                                           "capacity")})
    rows = [uv0[None]]
    for lo, hi in ((1, 5), (5, 6), (6, 12)):
        state, uv = tfusion.fuse_chunk(state, args[0], *(a[lo:hi] for a in args[1:]), **KW)
        rows.append(uv)
    np.testing.assert_array_equal(torch.cat(rows).numpy(), one_uv.numpy())
    for a, b in zip(state, one_state):
        assert torch.equal(a, b)
    # checkpointed: one chunk, then a resume from the marker
    ck = tmp_path / "ckpt"
    ckw = dict(KW, chunk_frames=4, ckpt_dir=ck, device="cpu")
    _, part = tfusion.fuse_session_checkpointed(*args, max_chunks=1, **ckw)
    assert part.shape == (5, 48 * 36)
    marker = json.loads((ck / "progress.json").read_text())
    assert marker["next_frame"] == 5 and (ck / marker["state_dir"]).is_dir()
    state, uv = tfusion.fuse_session_checkpointed(*args, **ckw)
    np.testing.assert_array_equal(uv, one_uv.numpy())
    for a, b in zip(state, one_state):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="radius"):
        tfusion.fuse_session_checkpointed(*args, **dict(ckw, radius=0.06))
    # state files
    tfusion.save_state(one_state, tmp_path / "st")
    back = tfusion.load_state(tmp_path / "st", device="cpu")
    for a, b in zip(back, one_state):
        assert torch.equal(a, b) and a.dtype == b.dtype
    # a batch of two sessions
    bstate, buv = tfusion.fuse_sessions_batch(*(np.stack([a, a]) for a in args), device="cpu",
                                              **KW)
    assert buv.shape == (2, 12, 48 * 36) and torch.equal(buv[1], one_uv)
    assert torch.equal(bstate.n[0], one_state.n)


def test_fusion_class_matches_jax(arrays, tmp_path):
    jsd, tsd = arrays
    jf = jfusion.Fusion(jsd, point_range=(0.1, 8.0), capacity=None, out_dir=str(tmp_path / "j"))
    tf = tfusion.Fusion(tsd, point_range=(0.1, 8.0), capacity=None, out_dir=str(tmp_path / "t"))
    jout = jf.fuse(0.05, 10.0, max_depth=8.0)
    tout = tf.fuse(0.05, 10.0, max_depth=8.0)
    assert tf.capacity == jf.capacity
    np.testing.assert_array_equal(tf.last_spans, jf.last_spans)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf._last_uv2pt, jf._last_uv2pt)


def test_correspondence_matches_jax(trees, rng):
    _, root, _, out = trees
    jc = jcorr.Correspondence.from_session_dir(root / "jax", (48, 36))
    tc = tcorr.Correspondence.from_session_dir(root / "port", (48, 36))
    assert tc.npts == jc.npts and tc.frame_names == jc.frame_names
    imgs = rng.integers(0, tc.nframes, 50)
    coords = np.stack([rng.integers(0, 36, 50), rng.integers(0, 48, 50)], 1)
    np.testing.assert_array_equal(tc.get_point(imgs, coords), jc.get_point(imgs, coords))
    for a, b in zip(tc.get_pixel([0, 5, tc.npts - 1]), jc.get_pixel([0, 5, jc.npts - 1])):
        np.testing.assert_array_equal(a, b)
    pts = out["port"][0]
    sd = tp3d.load_session(root / "session", device="cpu")
    dense = sd.points[:3].reshape(-1, 3).numpy()
    jp = jcorr.PointCorrespondence(pts, dense, 0.05, 3, (48, 36))
    tp = tcorr.PointCorrespondence(pts, dense, 0.05, 3, (48, 36))
    for a, b in zip(tp.get_point(imgs % 3, coords), jp.get_point(imgs % 3, coords)):
        np.testing.assert_array_equal(a, b)
    masks = rng.integers(0, 12, (3, 48 * 36))
    np.testing.assert_array_equal(tp.vote(masks, len(pts), 10), jp.vote(masks, len(pts), 10))


def test_segment_image_writes_predict_batch(tmp_path):
    sess = jsyn.make_session(nframes=5, depth_hw=(48, 36), appearance="textured")
    src = tsyn.write_session_dir(sess, tmp_path / "s", write_masks=False)
    seg = get2dseg.Segmenter2D(config=SegFormerConfig(**TINY, dtype=torch.float32),
                               input_hw=(64, 64), batch_size=2, device="cpu")
    get2dseg.SegmentImage(src / "rgb", tmp_path / "m", segmenter=seg, conf_threshold=0.0)
    from fusion3dseg_tpu_torch.io import image
    frames = np.stack([image.read(src / "rgb" / f"{i}.jpg") for i in range(5)])
    want = seg.predict_batch(frames, 0.0)
    for i in range(5):
        np.testing.assert_array_equal(image.read(tmp_path / "m" / f"{i}.png", gray=True), want[i])
        assert image.read(tmp_path / "m" / "viz" / f"{i}.png").shape == (48, 36, 3)


def test_apply_min_occ_and_semantic_loader(tmp_path):
    # the occurrence filter applied: points dropped and every uv2pt file
    # remapped, the same bytes in both packages
    skw, writer, pkw = SESSIONS["contracts8"]
    src = writer.write_session_dir(jsyn.make_session(**skw), tmp_path / "s")
    kw = dict(pkw, min_occ=2, apply_min_occ=True)
    j = jp3d.process3DSeg(src, tmp_path / "j", **kw)
    t = tp3d.process3DSeg(src, tmp_path / "t", device="cpu", **kw)
    assert len(t[0]) == len(j[0]) and (t[3] >= 2).all()
    for f in _files(tmp_path / "j"):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f, shallow=False), f
    jget3d.segment(tmp_path / "j", src / "masks", verbose=False)
    tget3d.segment(tmp_path / "t", src / "masks", verbose=False, device="cpu")
    for a, b in zip(tget3d.load_semantic_segmentation(tmp_path / "t" / "segmentation"),
                    jget3d.load_semantic_segmentation(tmp_path / "j" / "segmentation")):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_viz_helpers_write_through_the_codec(tmp_path, rng):
    from fusion3dseg_tpu_torch.io import image, ply

    frames = rng.integers(0, 256, (3, 48, 36, 3), dtype=np.uint8)
    coords = np.array([[1, 2], [35, 47], [0, 0]])
    tcorr.Correspondence.viz_proj([0, 2, 2], coords, frames, clr=(255, 0, 0), outdir=tmp_path)
    painted = frames.copy()
    painted[[0, 2, 2], coords[:, 1], coords[:, 0]] = (255, 0, 0)
    for fid in (0, 2):
        np.testing.assert_array_equal(image.read(tmp_path / f"{fid + 1}.png"), painted[fid])
    assert not (tmp_path / "2.png").exists()
    pts = rng.random((20, 3)).astype(np.float32)
    colors = tcorr.Correspondence.viz_reproj(pts, np.zeros((20, 3)), [3, 4], save=tmp_path / "r.ply")
    want = jcorr.Correspondence.viz_reproj(pts, np.zeros((20, 3)), [3, 4])
    np.testing.assert_array_equal(colors, want)
    np.testing.assert_array_equal(ply.read_point_cloud(tmp_path / "r.ply")[1][[3, 4]],
                                  [[1, 0, 0], [1, 0, 0]])
