"""The port's session arrays and streaming voter against the JAX package on
the CPU. Mirrors tests/test_streaming.py and the from_arrays cases of
tests/test_fast_pipeline.py."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.io import rtab as jrtab, synthetic as jsynthetic
from fusion3dseg_tpu.pipeline import streaming as jstream
from fusion3dseg_tpu_torch.io import rtab as trtab
from fusion3dseg_tpu_torch.pipeline import streaming as tstream
from torch_seg_pair import segmenter_pair


def _uv2pt(F, P, npts, seed=0):
    # per-frame injective pixel->point maps, as a real z-buffer gives
    rng = np.random.default_rng(seed)
    uv2pt = np.full((F, P), -1, np.int32)
    for f in range(F):
        uv2pt[f, rng.choice(P, size=npts, replace=False)] = rng.permutation(npts)
    return uv2pt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    sess = jsynthetic.make_session(nframes=5, depth_hw=(48, 36), appearance="textured")
    args = (sess.colors, sess.depth, sess.K, sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations)
    jsd = jrtab.SessionData.from_arrays(*args)
    tsd = trtab.SessionData.from_arrays(*args, device="cpu")
    jseg, tseg = segmenter_pair(tmp_path_factory.mktemp("ckpt"))
    return jsd, tsd, jseg, tseg, _uv2pt(5, 48 * 36, 500)


class TestSessionData:
    def test_from_arrays_fields_match_jax(self, setup):
        jsd, tsd = setup[:2]
        assert tsd.nframes == jsd.nframes == 5
        assert tsd.depth_hw == jsd.depth_hw and tsd.rgb_hw == jsd.rgb_hw
        for name in ("frame_numbers", "K", "Ks", "quats_wxyz", "translations"):
            np.testing.assert_array_equal(getattr(tsd, name), getattr(jsd, name))
        # equal sizes: colours pass through untouched
        np.testing.assert_array_equal(tsd.colors.numpy(), jsd.colors)
        np.testing.assert_array_equal(tsd.depth.numpy(), jsd.depth)
        # the port reproduces the FMAs XLA's CPU code contracts in the
        # rotation, the normals' cross product, norm and sign test: exact
        np.testing.assert_array_equal(tsd.points.numpy(), jsd.points)
        np.testing.assert_array_equal(tsd.normals.numpy(), jsd.normals)
        assert tsd.points.dtype == torch.float32 and tuple(tsd.points.shape) == (5, 48 * 36, 3)

    def test_normals_from_grid_matches_jax(self, rng):
        pts = rng.normal(size=(7, 9, 3)).astype(np.float32) + np.float32([0, 0, 3])
        want = np.asarray(jrtab._normals_from_grid(jnp.asarray(pts)))
        got = trtab._normals_from_grid(torch.from_numpy(pts)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("hw,out", [((96, 72), (48, 36)), ((96, 72), (32, 24)),
                                        ((50, 70), (20, 30))],
                             ids=["factor2", "factor3", "fractional"])
    def test_area_resize_matches_cv2(self, rng, hw, out):
        rgb = rng.integers(0, 256, size=(2, *hw, 3), dtype=np.uint8)
        want = np.stack([cv2.resize(r, out[::-1], interpolation=cv2.INTER_AREA) for r in rgb])
        got = trtab.area_resize_uint8(torch.from_numpy(rgb), out).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)  # OpenCV's own paths: exact

    def test_from_arrays_shrinks_rgb_to_depth_size(self, rng):
        sess = jsynthetic.make_session(nframes=2, depth_hw=(24, 18))
        rgb = rng.integers(0, 256, size=(2, 48, 36, 3), dtype=np.uint8)
        args = (rgb, sess.depth, sess.K * [[2], [2], [1]], sess.quats_wxyz[:, [1, 2, 3, 0]],
                sess.translations)
        jsd = jrtab.SessionData.from_arrays(*args)
        tsd = trtab.SessionData.from_arrays(*args, device="cpu")
        np.testing.assert_allclose(tsd.Ks, jsd.Ks)
        assert np.abs(tsd.colors.numpy() - jsd.colors).max() <= 1.0 / 255 + 1e-6

    def test_default_device_refuses_without_card(self, rng):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        sess = jsynthetic.make_session(nframes=1, depth_hw=(8, 6))
        with pytest.raises(RuntimeError, match="is_available"):
            trtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                          sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations)


class TestStreamSegment:
    def test_vote_logits_matches_jax_exactly(self, rng):
        # the same logits through both: threshold, nearest resize, dedup votes
        logits = rng.normal(size=(3, 16, 20, 10)).astype(np.float32)
        uv = _uv2pt(3, 8 * 6, 30, seed=1)
        want = jstream._vote_logits(jnp.zeros((30, 10), jnp.int32), jnp.asarray(logits),
                                    jnp.asarray(uv), (8, 6), 9, 0.2)
        got = tstream._vote_logits(torch.zeros((30, 10), dtype=torch.int32),
                                   torch.from_numpy(logits), torch.from_numpy(uv), (8, 6), 9, 0.2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got[:, 9].sum() < got.sum()  # both sides of the confidence rule

    def test_votes_and_classes_match_jax(self, setup):
        jsd, tsd, jseg, tseg, uv2pt = setup
        wv, wc = jstream.stream_segment(jsd, jseg, uv2pt, npts=500, nclasses=133,
                                        batch_size=2, conf_threshold=0.0)
        gv, gc = tstream.stream_segment(tsd, tseg, uv2pt, npts=500, nclasses=133,
                                        batch_size=2, conf_threshold=0.0)
        assert gv.shape == (500, 134) and gv.dtype == np.int32 and gc.shape == (500,)
        assert gv.sum(axis=1).max() <= 5  # dedup: one vote per (point, frame)
        np.testing.assert_array_equal(gv.sum(axis=1), wv.sum(axis=1))
        # float32 logits differ in the last bits; with random weights a few
        # near-ties of the argmax flip
        assert (gv == wv).mean() >= 0.999
        assert (gc == wc).mean() >= 0.98
        v2, c2 = tstream.stream_segment(tsd, tseg, uv2pt, npts=500, nclasses=133,
                                        batch_size=2, conf_threshold=0.0)
        np.testing.assert_array_equal(gv, v2)
        np.testing.assert_array_equal(gc, c2)

    def test_confidence_rule_all_unclassified(self, setup):
        _, tsd, _, tseg, uv2pt = setup
        votes, classes = tstream.stream_segment(tsd, tseg, uv2pt, npts=500, nclasses=133,
                                                batch_size=2, conf_threshold=1.1)
        voted = votes.sum(axis=1) > 0
        assert voted.any() and votes[:, :133].sum() == 0
        assert (classes[voted] == 133).all()

    def test_stream_matches_mask_route(self, setup):
        from fusion3dseg_tpu_torch.ops.voting import vote_and_classify

        _, tsd, _, tseg, uv2pt = setup
        _, classes = tstream.stream_segment(tsd, tseg, uv2pt, npts=500, nclasses=133,
                                            batch_size=2, conf_threshold=0.0)
        frames = (tsd.colors.reshape(5, 48, 36, 3) * 255).round().to(torch.uint8).numpy()
        masks = tseg.predict_batch(frames, conf_threshold=0.0)
        _, classes_m = vote_and_classify(uv2pt, masks.reshape(5, -1), 500, 133, device="cpu")
        # the resize happens at a different stage in each route
        assert (classes_m.numpy() == classes).mean() > 0.9
