"""The port's counterparts of the two examples, on the CPU against the JAX
package: `tools/soak.py` (examples/soak_long_session.py) on a short
session, and `tools/model_in_the_loop.py` (examples/model_in_the_loop.py,
bench.py's config 4) with a tiny random-init segmenter pair in place of the
shipped B2. The bars are those of tests/test_torch_fusion.py: n within 1%,
classes on >= 0.999 of the points (in practice both are exact)."""

import numpy as np
import jax.numpy as jnp
import pytest

from fusion3dseg_tpu.fusion import fusion as jf
from fusion3dseg_tpu.io import rtab, synthetic
from fusion3dseg_tpu.ops import sparsify as jsparsify
from fusion3dseg_tpu.ops import voting as jv
from fusion3dseg_tpu.pipeline.streaming import stream_segment as jstream
from fusion3dseg_tpu_torch.tools import model_in_the_loop, soak
from torch_seg_pair import segmenter_pair

SOAK_FRAMES, SOAK_CHUNK, SOAK_CAP = 48, 8, 1 << 14
EXAMPLE_KEYS = {"frames", "points", "capacity", "window", "soak_fps", "full_run_seconds",
                "resume_equals_oneshot_state", "resume_equals_oneshot_uv2pt", "max_nmerges",
                "saturated"}


def _jax_session(nframes, hw, **kw):
    sess = synthetic.make_session(nframes=nframes, depth_hw=hw, **kw)
    sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                      sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations)
    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    return sess, sd, valid


@pytest.fixture(scope="module")
def soak_run(tmp_path_factory):
    return soak.soak(SOAK_FRAMES, tmp_path_factory.mktemp("soak"), device="cpu",
                     capacity=SOAK_CAP, chunk_frames=SOAK_CHUNK)


def test_soak_resumes_bit_for_bit(soak_run):
    res = soak_run.result
    assert EXAMPLE_KEYS <= set(res) and res["device"] == "cpu"
    assert res["frames"] == SOAK_FRAMES and res["capacity"] == SOAK_CAP
    assert res["resume_equals_oneshot_state"] and res["resume_equals_oneshot_uv2pt"]
    # at 2^14 the buffer fills (drop-at-capacity appends) before the crash
    assert 0 < res["interrupted_at_points"] <= res["points"] <= SOAK_CAP
    assert res["saturated"] == (res["points"] >= SOAK_CAP)
    assert soak_run.uv2pt.shape == (SOAK_FRAMES, 128 * 96)
    assert str(soak_run.state.nmerges.dtype) == str(soak_run.state.occurences.dtype) \
        == "torch.int32"


def test_soak_matches_jax_checkpointed_fusion(soak_run, tmp_path):
    _, sd, valid = _jax_session(SOAK_FRAMES, soak.HW, turns=4.0,
                                room=synthetic.RoomSpec(seed=11, num_objects=10))
    h, w = soak.HW
    radius, min_cos = 0.05, float(np.cos(np.deg2rad(10.0)))
    sp0 = jsparsify.patch_sparsify(jnp.asarray(sd.points[0]), jnp.asarray(sd.normals[0]),
                                   jnp.asarray(sd.colors[0]), jnp.asarray(valid[0]), h, w,
                                   radius, min_cos)
    window = jf.auto_window(int(jnp.sum(sp0.counts > 0)), SOAK_CAP)
    assert window == soak_run.result["window"]
    st, uv = jf.fuse_session_checkpointed(
        sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations, sd.points, sd.normals,
        sd.colors, valid, height=h, width=w, radius=radius, min_cosine=min_cos,
        max_depth=8.0, capacity=SOAK_CAP, window=window, chunk_frames=SOAK_CHUNK,
        ckpt_dir=tmp_path / "jax")
    jn, tn = int(st.n), soak_run.result["points"]
    assert abs(tn - jn) <= 0.01 * jn
    assert soak_run.result["max_nmerges"] == int(np.asarray(st.nmerges).max())
    assert uv.shape == soak_run.uv2pt.shape


def test_model_in_the_loop_matches_jax(tmp_path):
    jseg, tseg = segmenter_pair(tmp_path, input_hw=(64, 64), batch_size=8)
    result, classes_m, classes_g = model_in_the_loop.in_the_loop(tseg)
    assert result["device"] == "cpu" and result["frames"] == 24
    assert 0.0 <= result["model_in_loop_3d_agreement"] <= 1.0

    # bench.py's config 4 protocol through the JAX package, same session
    sess, sd, valid = _jax_session(24, (128, 96), room=synthetic.RoomSpec(seed=777),
                                   appearance="textured")
    cap = 1 << 16
    st, uv2pt = jf.fuse_session(
        *(jnp.asarray(a) for a in (sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations,
                                   sd.points, sd.normals, sd.colors, valid)),
        height=128, width=96, radius=0.08, min_cosine=float(np.cos(np.deg2rad(20.0))),
        max_depth=8.0, capacity=cap)
    n = int(st.n)
    _, jm = jstream(sd, jseg, np.asarray(uv2pt), npts=cap, nclasses=133, threshold=0.5,
                    batch_size=8)
    _, jg = jv.vote_and_classify(uv2pt, jnp.asarray(sess.gt_mask.reshape(24, -1)), cap, 133,
                                 threshold=0.5, filter_classes=None)
    assert abs(result["points"] - n) <= 0.01 * n
    m = min(n, result["points"])
    assert (classes_m[:m] == np.asarray(jm)[:m]).mean() >= 0.999
    assert (classes_g[:m] == np.asarray(jg)[:m]).mean() >= 0.999
    assert result["model_in_loop_3d_agreement"] == pytest.approx(
        float(np.mean(np.asarray(jm)[:n] == np.asarray(jg)[:n])), abs=1e-3)


def test_model_in_the_loop_files_matches_jax_example(tmp_path):
    # examples/model_in_the_loop.py's file path through the JAX package, with
    # the tiny pair's JAX segmenter in place of a trained one
    import cv2
    from fusion3dseg_tpu.pipeline import get3dseg, process3d
    from fusion3dseg_tpu.pipeline.get2dseg import SegmentImage

    jseg, tseg = segmenter_pair(tmp_path, input_hw=(64, 64), batch_size=8)
    got = model_in_the_loop.from_files(tseg)
    assert got["device"] == "cpu" and got["frames"] == 32

    sess = synthetic.make_session(nframes=32, depth_hw=(128, 96),
                                  room=synthetic.RoomSpec(seed=777), appearance="textured")
    out, work_m, work_g = (tmp_path / d for d in ("session", "model", "gt"))
    synthetic.write_session_dir(sess, out)
    SegmentImage(str(out / "rgb"), str(out / "model_masks"), segmenter=jseg, batch_size=8)
    acc = np.mean([(cv2.imread(str(out / "model_masks" / f"{i}.png"), 0) == sess.gt_mask[i]).mean()
                   for i in range(32)])
    kw = dict(radius=0.08, angle=20, stride=8, point_range=(0.1, 8.0), capacity=1 << 17)
    for work, masks in ((work_m, out / "model_masks"), (work_g, out / "masks")):
        process3d.process3DSeg(out, work, **kw)
        get3dseg.segment(work, masks, filter_classes=None, min_pts_per_inst=30, verbose=False)
    cm = np.load(work_m / "segmentation" / "classes.npy")
    cg = np.load(work_g / "segmentation" / "classes.npy")
    assert got["points"] == len(cm)
    assert got["pixel_accuracy_2d"] == pytest.approx(float(acc), abs=1e-3)
    assert got["model_masks_3d_agreement"] == pytest.approx(float(np.mean(cm == cg)), abs=1e-3)
    assert got["model_masks_unclassified"] == pytest.approx(float(np.mean(cm == 133)), abs=1e-3)
