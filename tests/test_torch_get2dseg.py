"""The port's 2D segmenter entry points against the JAX package on the CPU.
Mirrors tests/test_components2d.py, tests/test_shipped_weights.py (npz
snapshots) and the Segmenter2D cases of tests/test_pipeline.py."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.io import synthetic as jsynthetic
from fusion3dseg_tpu.ops import components2d as jc2d
from fusion3dseg_tpu.pipeline import get2dseg as jget
from fusion3dseg_tpu.utils import palette as jpal, taxonomy as jtax
from fusion3dseg_tpu_torch.models import convert
from fusion3dseg_tpu_torch.ops import components2d as tc2d
from fusion3dseg_tpu_torch.pipeline import get2dseg as tget
from fusion3dseg_tpu_torch.utils import palette as tpal, taxonomy as ttax
from torch_seg_pair import segmenter_pair


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return segmenter_pair(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def frames():
    # 48x36 frames through a 64x64 model: the logits are resized DOWN to the
    # frame, the antialiased case of the shared semantic path
    sess = jsynthetic.make_session(nframes=2, depth_hw=(48, 36), appearance="textured")
    return sess.colors


class TestSegmenter2D:
    def test_model_input_matches_cv2_linear(self, pair, frames):
        _, tseg = pair
        want = np.stack([cv2.resize(im, (64, 64), interpolation=cv2.INTER_LINEAR)
                         for im in frames]).astype(np.int32)
        got = (tseg._model_input(frames) * 255.0).round().numpy().astype(np.int32)
        # the port reproduces cv2's fixed-point uint8 path: exact
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("out_hw", [(48, 36), (96, 80), (64, 64)],
                             ids=["downsample", "upsample", "same"])
    def test_logits_sem_conf_matches_jax(self, pair, frames, out_hw):
        jseg, tseg = pair
        x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
        _, conf0 = jseg._infer_conf(jseg.params, jnp.asarray(x), jnp.float32(0.0), *out_hw)
        thr = float(np.median(np.asarray(conf0)))  # half the pixels fall below it
        jl, jsem, jconf = jseg._infer_full(jseg.params, jnp.asarray(x), jnp.float32(thr),
                                           *out_hw, jnp.float32(2.0))[:3]
        tl, tsem, tconf = tseg._logits_sem_conf(torch.from_numpy(x), thr, out_hw)
        assert tsem.dtype == torch.uint8 and tuple(tl.shape) == (2, *out_hw, 134)
        # float32 both sides; the resize weights and sums differ in the last bits
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(tconf.numpy(), np.asarray(jconf), atol=1e-6)
        # random weights give near-flat logits: allow a few argmax ties to flip
        assert (tsem.numpy() == np.asarray(jsem)).mean() >= 0.995
        assert (tsem.numpy() == 133).any() and (tsem.numpy() != 133).any()

    def test_predict_batch_matches_jax(self, pair, frames):
        jseg, tseg = pair
        want = jseg.predict_batch(frames, conf_threshold=0.0)
        got = tseg.predict_batch(frames, conf_threshold=0.0)
        assert got.shape == want.shape == frames.shape[:3] and got.dtype == np.uint8
        # equal model inputs (the port's resize is cv2's); float32 logits
        # within 1e-6 of each other: every pixel agrees (measured 1.0)
        assert (got == want).mean() == 1.0

    def test_predict_contract_matches_jax(self, pair, frames):
        jseg, tseg = pair
        bgr = np.ascontiguousarray(frames[0][:, :, ::-1])
        want, got = jseg.predict(bgr, 0.0), tseg.predict(bgr, 0.0)
        sem, (idimage, info), inst = got.values()
        assert list(got) == list(want)
        assert sem.shape == (133, 48, 36) and sem.dtype == np.float32
        # equal model inputs; float32 arithmetic in another order (9e-7)
        np.testing.assert_allclose(sem, want["sem_seg"], atol=1e-5)
        assert idimage.shape == (48, 36) and idimage.dtype == np.int32
        assert [s["id"] for s in info] == list(range(1, len(info) + 1))
        assert sum(s["area"] for s in info) == (idimage > 0).sum()
        assert set(inst) == {"pred_classes", "pred_masks", "scores"}
        assert inst["pred_masks"].shape == (len(inst["pred_classes"]), 48, 36)

    def test_predict_batch_full_splits_on_colour(self, pair, frames):
        _, tseg = pair
        sem, pans, insts = tseg.predict_batch_full(frames, 0.0)
        sem2, pans2, _ = tseg.predict_batch_full(frames, 0.0, split_color_jump=0.02)
        assert np.array_equal(sem, sem2) and len(pans) == len(insts) == 2
        n = [sum(s["isthing"] for s in p[1]) for p in pans]
        n2 = [sum(s["isthing"] for s in p[1]) for p in pans2]
        assert all(b >= a for a, b in zip(n, n2))

    def test_default_device_refuses_without_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="is_available"):
            tget.Segmenter2D()


class TestComponents2D:
    @pytest.mark.parametrize("seed,hw,ncls", [(0, (17, 23), 3), (1, (32, 32), 2), (2, (5, 40), 4)])
    def test_labels_match_jax_exactly(self, seed, hw, ncls):
        rng = np.random.default_rng(seed)
        cls = rng.integers(0, ncls, size=hw)
        want = np.asarray(jc2d.label_components_2d(jnp.asarray(cls)))
        got = tc2d.label_components_2d(torch.from_numpy(cls))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("channels", [0, 3])
    def test_guided_batch_matches_jax_exactly(self, channels):
        rng = np.random.default_rng(3)
        cls = rng.integers(0, 2, size=(3, 20, 24))
        shape = (3, 20, 24, channels) if channels else (3, 20, 24)
        guide = rng.random(shape).astype(np.float32)
        want = np.asarray(jc2d.label_components_2d_batch(
            jnp.asarray(cls), guide=jnp.asarray(guide), guide_jump=0.4))
        got = tc2d.label_components_2d_batch(torch.from_numpy(cls),
                                             guide=torch.from_numpy(guide), guide_jump=0.4)
        np.testing.assert_array_equal(got.numpy(), want)
        plain = tc2d.label_components_2d_batch(torch.from_numpy(cls))
        assert len(np.unique(got.numpy())) > len(np.unique(plain.numpy()))

    def test_panoptic_and_instances_match_jax(self):
        rng = np.random.default_rng(4)
        sem = rng.choice([3, 56, 87, 131, 133], size=(24, 30)).astype(np.uint8)
        conf = rng.random((24, 30)).astype(np.float32)
        jid, jinfo = jc2d.panoptic_from_semantic(sem, min_area=2)
        tid, tinfo = tc2d.panoptic_from_semantic(sem, min_area=2)
        np.testing.assert_array_equal(tid, jid)
        assert tinfo == jinfo
        jin = jc2d.instances_from_panoptic(jid, jinfo, conf)
        tin = tc2d.instances_from_panoptic(tid, tinfo, conf)
        for k in jin:
            np.testing.assert_array_equal(tin[k], jin[k])


class TestSnapshots:
    def test_npz_round_trip_both_ways(self, tmp_path):
        params = {"layer": {"kernel": np.random.default_rng(0).random((4, 4)).astype(np.float32),
                            "step": np.asarray(7, np.int32)},
                  "head": {"bias": np.zeros(3, np.float32)}}
        p, q = tmp_path / "port.npz", tmp_path / "jax.npz"
        convert.save_params_npz(p, params, input_hw=(256, 256))
        jget.save_params_npz(q, params, input_hw=(256, 256))
        for path in (p, q):
            assert convert.load_npz_meta(path) == jget.load_npz_meta(path) == {"input_hw": (256, 256)}
            assert convert.checkpoint_input_hw(path) == (256, 256)
            a, b = convert.load_params_npz(path), jget.load_params_npz(path)
            assert set(a) == set(b) == {"layer", "head"}
            assert a["layer"]["step"] == 7 and a["layer"]["kernel"].dtype == np.float32
            np.testing.assert_array_equal(a["layer"]["kernel"], b["layer"]["kernel"])
        convert.save_params_npz(p, params)
        assert convert.checkpoint_input_hw(p) is None and convert.checkpoint_config(p) is None

    def test_config_meta_crosses_packages(self, tmp_path):
        from fusion3dseg_tpu.models import SegFormerConfig as JConfig
        from fusion3dseg_tpu_torch.models import SegFormerConfig as TConfig

        params = {"head": {"bias": np.zeros(3, np.float32)}}
        p, q = tmp_path / "port.npz", tmp_path / "jax.npz"
        tcfg = TConfig(num_classes=150, head="hf", nat_windows=(5, 0, 0, 0), dtype=torch.float32)
        jcfg = JConfig(num_classes=150, head="hf", nat_windows=(5, 0, 0, 0), dtype=jnp.float32)
        convert.save_params_npz(p, params, config=tcfg)
        jget.save_params_npz(q, params, config=jcfg)
        assert convert.checkpoint_config(p) == convert.checkpoint_config(q) == tcfg
        assert jget.checkpoint_config(p) == jcfg

    def test_shipped_paths_and_directory_refusal(self, tmp_path):
        assert convert.shipped_checkpoint("b2") == jget.shipped_checkpoint("b2")
        assert convert.best_shipped_checkpoint() == jget.best_shipped_checkpoint()
        assert convert.shipped_checkpoint("b9") is None
        with pytest.raises(NotImplementedError, match="Orbax"):
            convert.load_params_npz(tmp_path)


def test_tables_are_the_jax_packages():
    assert ttax.COCO_133_CLASSES == jtax.COCO_133_CLASSES
    assert ttax.N_THING_CLASSES == jtax.N_THING_CLASSES == 80
    assert ttax.Taxonomy().as_load_csv_tuple() == jtax.Taxonomy().as_load_csv_tuple()
    np.testing.assert_array_equal(tpal.random_palette(134, seed=0), jpal.random_palette(134, seed=0))
    assert tpal.to_css_hex([255, 0, 16]) == jpal.to_css_hex([255, 0, 16]) == "#ff0010"


def test_segment_image_writes_masks(tmp_path, pair):
    _, tseg = pair
    sess = jsynthetic.make_session(nframes=3, depth_hw=(48, 36))
    rgb_dir, out = tmp_path / "rgb", tmp_path / "masks"
    rgb_dir.mkdir()
    for i, im in enumerate(sess.colors):
        cv2.imwrite(str(rgb_dir / f"{i:04d}.png"), im[:, :, ::-1])
    tget.SegmentImage(str(rgb_dir), str(out), extension="png", segmenter=tseg,
                      conf_threshold=0.0)
    want = tseg.predict_batch(sess.colors, 0.0)
    for i in range(3):
        m = cv2.imread(str(out / f"{i:04d}.png"), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(m, want[i])
        assert (out / "viz" / f"{i:04d}.png").is_file()
