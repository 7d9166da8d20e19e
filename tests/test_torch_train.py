"""The port's trainer (`models/train.py`) and calibration sweep
(`models/calibrate.py`) against the JAX package on the CPU: the datasets
and augmentation byte for byte, the evaluation metrics, the checkpoint
commit protocol and a bit-exact resume, the snapshots `Segmenter2D` reads,
the Orbax bridge, and a short training run. Toy sizes throughout: embed
dims 8-32, 32x32 inputs, batch 2."""

import dataclasses
import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

from fusion3dseg_tpu.io import synthetic as jsyn
from fusion3dseg_tpu.models import calibrate as jcal, train as jtrain
from fusion3dseg_tpu_torch.io import synthetic as tsyn
from fusion3dseg_tpu_torch.models import SegFormerConfig, calibrate as tcal, convert
from fusion3dseg_tpu_torch.models import train as ttrain
from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D
from torch_seg_pair import TINY, segmenter_pair

HW = (32, 32)


def _cfg(**kw):
    base = dict(model=SegFormerConfig(**TINY, dtype=torch.float32), input_hw=HW, batch_size=2,
                steps=4, log_every=100, learning_rate=1e-3, warmup_steps=1, prefetch=0)
    base.update(kw)
    return ttrain.TrainConfig(**base)


def _batch(seed=0):
    sess = tsyn.make_session(nframes=2, depth_hw=HW, appearance="textured",
                             room=tsyn.RoomSpec(seed=seed))
    return sess.colors, sess.gt_mask


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return segmenter_pair(tmp_path_factory.mktemp("ckpt"))


class TestDatasets:
    @pytest.mark.parametrize("kw", [dict(appearance="flat"),
                                    dict(appearance="textured", render_hws=((96, 72), (48, 64))),
                                    dict(appearance="textured", upright=True)],
                             ids=["flat", "textured_two_sizes", "upright"])
    def test_synthetic_dataset_bytes_equal_jax(self, kw):
        j = jtrain.synthetic_dataset((64, 64), 4, seed=3, nframes_per_session=8, **kw)
        t = ttrain.synthetic_dataset((64, 64), 4, seed=3, nframes_per_session=8, **kw)
        for _ in range(4):  # two sessions
            (ji, jm), (ti, tm) = next(j), next(t)
            assert ti.dtype == tm.dtype == np.uint8 and ti.shape == (4, 64, 64, 3)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)

    def test_directory_dataset_bytes_equal_jax(self, tmp_path):
        sess = jsyn.make_session(nframes=5, depth_hw=(48, 36), appearance="textured")
        d = tsyn.write_session_dir(sess, tmp_path / "s")
        j = jtrain.directory_dataset(d / "rgb", d / "masks", (40, 56), 2, seed=1)
        t = ttrain.directory_dataset(d / "rgb", d / "masks", (40, 56), 2, seed=1)
        for _ in range(3):
            (ji, jm), (ti, tm) = next(j), next(t)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
        with pytest.raises(ValueError, match="fewer than"):
            next(ttrain.directory_dataset(d / "rgb", d / "masks", (40, 56), 8))

    @pytest.mark.parametrize("strength", [1.0, 1.8])
    def test_augment_batch_bytes_equal_jax(self, strength, monkeypatch):
        # both noise pools fresh: an earlier, larger batch in this process
        # would have grown one of them, and the pool's size draws the offsets
        monkeypatch.setattr(jtrain, "_NOISE_POOL", None)
        monkeypatch.setattr(ttrain, "_NOISE_POOL", None)
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (6, 24, 20, 3), dtype=np.uint8)
        masks = rng.integers(0, 20, (6, 24, 20), dtype=np.uint8)
        ja = jtrain.augment_batch(imgs, masks, np.random.default_rng(9), strength)
        ta = ttrain.augment_batch(imgs, masks, np.random.default_rng(9), strength)
        np.testing.assert_array_equal(ta[0], ja[0])
        np.testing.assert_array_equal(ta[1], ja[1])
        assert not np.array_equal(ta[0], imgs)


class TestPrefetch:
    def test_order_and_end(self):
        assert list(ttrain.prefetch_batches(iter(range(20)), depth=3)) == list(range(20))

    def test_exception_reaches_the_consumer(self):
        def source():
            yield 1
            raise RuntimeError("boom")

        it = ttrain.prefetch_batches(source())
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="boom"):
            next(it)

    def test_close_stops_the_producer_and_its_source(self):
        closed = threading.Event()

        def source():
            try:
                for i in itertools.count():
                    yield i
            finally:
                closed.set()

        it = ttrain.prefetch_batches(source(), depth=1)
        assert [next(it) for _ in range(3)] == [0, 1, 2]
        it.close()
        assert closed.wait(5.0)
        time.sleep(0.05)
        assert not any(t.name == "train-batch-prefetch" for t in threading.enumerate())


class TestEvaluation:
    def test_mean_iou_matches_jax(self):
        rng = np.random.default_rng(2)
        logits = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
        labels = rng.integers(0, 5, (2, 9, 9))
        assert ttrain.mean_iou(logits, labels, 6) == jtrain.mean_iou(logits, labels, 6)

    def test_evaluate_synthetic_matches_jax(self, pair):
        jseg, tseg = pair
        want = jtrain.evaluate_synthetic(jseg, nsessions=2, nframes=4)
        got = ttrain.evaluate_synthetic(tseg, nsessions=2, nframes=4)
        assert got == want

    def test_sweep_conf_threshold_matches_jax(self, pair):
        jseg, tseg = pair
        kw = dict(thresholds=(0.0, 0.01, 0.2), session_seeds=(777,), nframes=4,
                  depth_hw=(48, 36), capacity=1 << 13)
        want = jcal.sweep_conf_threshold(jseg, **kw)
        got = tcal.sweep_conf_threshold(tseg, **kw)
        assert [r["conf_threshold"] for r in got] == [0.0, 0.01, 0.2]
        for g, w in zip(got, want):
            # float32 logits 1e-6 apart: every pixel's class and confidence
            # side agree, so the votes are the same
            assert g == w
        assert tcal.pick_threshold(got) == jcal.pick_threshold(want)


class TestCheckpoints:
    def test_commit_layout_links_and_pruning(self, tmp_path):
        ck = tmp_path / "run"
        ttrain.train(_cfg(checkpoint_dir=str(ck), checkpoint_every=2, ema_decay=0.9),
                     device="cpu", verbose=False)
        assert (ck / "step.txt").read_text() == "4"
        assert os.readlink(ck / "params") == "params_00000004.npz"
        assert os.readlink(ck / "ema" / "params") == os.path.join("..", "ema_params_00000004.npz")
        names = sorted(p.name for p in ck.iterdir())
        assert names == ["ema", "ema_params_00000004.npz", "meta.json", "opt_state_00000004.pt",
                         "params", "params_00000004.npz", "step.txt"]
        assert convert.checkpoint_input_hw(ck) == convert.checkpoint_input_hw(ck / "ema") == HW
        assert convert.checkpoint_config(ck / "ema") == _cfg().model

    def test_crash_before_commit_keeps_the_last_commit(self, tmp_path, monkeypatch):
        ck = tmp_path / "run"
        cfg = _cfg(checkpoint_dir=str(ck), checkpoint_every=2)
        real = os.replace

        def crash_on_second_commit(src, dst):
            if str(dst).endswith("step.txt") and (ck / "step.txt").exists():
                raise OSError("crash at the commit point")
            real(src, dst)

        monkeypatch.setattr(ttrain.os, "replace", crash_on_second_commit)
        with pytest.raises(OSError, match="commit point"):
            ttrain.train(cfg, device="cpu", verbose=False)
        monkeypatch.setattr(ttrain.os, "replace", real)
        assert (ck / "step.txt").read_text() == "2"
        assert os.readlink(ck / "params") == "params_00000002.npz"
        assert (ck / "params_00000004.npz").exists()  # written, never committed
        params, _, it = ttrain.load_train_state(ck)
        assert it == 2
        np.testing.assert_array_equal(
            convert.load_params_npz(ck)["classifier"]["bias"], params["classifier"]["bias"])
        # a resume continues from the commit and commits over the orphan
        ttrain.train(dataclasses.replace(cfg, resume=True), device="cpu", verbose=False)
        assert (ck / "step.txt").read_text() == "4"

    def test_resume_is_bit_exact(self, tmp_path):
        """A run interrupted after its step-2 commit and resumed gives the
        bits of the uninterrupted run at step 4: params, moving average and
        optimizer state."""
        batch = _batch()
        cfg = _cfg(ema_decay=0.5, lr_schedule="cosine", steps=4, checkpoint_every=2)

        def interrupted():
            yield batch
            yield batch
            raise KeyboardInterrupt

        straight, _ = ttrain.train(dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "a")),
                                   dataset=itertools.repeat(batch), device="cpu", verbose=False)
        b = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "b"))
        with pytest.raises(KeyboardInterrupt):
            ttrain.train(b, dataset=interrupted(), device="cpu", verbose=False)
        assert ttrain.committed_step(tmp_path / "b") == 2
        resumed, _ = ttrain.train(dataclasses.replace(b, resume=True),
                                  dataset=itertools.repeat(batch), device="cpu", verbose=False)
        for k, v in straight.items():
            assert torch.equal(resumed[k], v), k
        ea, eb = ttrain.load_ema(tmp_path / "a"), ttrain.load_ema(tmp_path / "b")
        for k, v in convert.flatten_params(ea).items():
            np.testing.assert_array_equal(convert.flatten_params(eb)[k], v)
        oa = ttrain.load_train_state(tmp_path / "a")[1]
        ob = ttrain.load_train_state(tmp_path / "b")[1]
        assert oa["scheduler"]["last_epoch"] == ob["scheduler"]["last_epoch"] == 4
        for i, st in oa["optimizer"]["state"].items():
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(ob["optimizer"]["state"][i][k], st[k])

    def test_snapshot_restores_the_state_bit_for_bit(self, tmp_path):
        params, _ = ttrain.train(_cfg(checkpoint_dir=str(tmp_path)), device="cpu",
                                 verbose=False)
        flat, opt_state, it = ttrain.load_train_state(tmp_path)
        assert it == 4 and opt_state["scheduler"]["last_epoch"] == 4
        restored = convert.from_flax_params(flat, _cfg().model, torch.float32)
        assert all(torch.equal(restored[k], v) for k, v in params.items())

    def test_segmenter_loads_params_and_ema(self, tmp_path):
        cfg = _cfg(checkpoint_dir=str(tmp_path), ema_decay=0.9,
                   model=SegFormerConfig(**TINY))  # bfloat16 compute
        params, _ = ttrain.train(cfg, device="cpu", verbose=False)
        frames = _batch(5)[0]
        for d in (tmp_path, tmp_path / "ema"):
            seg = Segmenter2D(checkpoint_dir=d, device="cpu")  # config, size from meta.json
            assert seg.config == cfg.model and seg.input_hw == HW
            sem = seg.predict_batch(frames)
            assert sem.shape == frames.shape[:3] and sem.dtype == np.uint8
        seg = Segmenter2D(checkpoint_dir=tmp_path, device="cpu")
        w = seg.model.state_dict()["classifier.weight"]
        assert torch.equal(w, params["classifier.weight"])  # float32 layer, exact
        q = seg.model.state_dict()["stage0_block0.attn.q.weight"]
        assert q.dtype == torch.bfloat16
        assert torch.equal(q, params["stage0_block0.attn.q.weight"].to(torch.bfloat16))

    def test_orbax_reaches_the_port_through_the_jax_bridge(self, pair, tmp_path):
        from fusion3dseg_tpu.pipeline import get2dseg as jget

        jseg, tseg = pair
        jget.save_checkpoint(tmp_path / "orbax", jseg.params)
        with pytest.raises(NotImplementedError, match="Orbax"):
            Segmenter2D(config=tseg.config, checkpoint_dir=tmp_path / "orbax", device="cpu")
        restored = jget.load_checkpoint(tmp_path / "orbax", jseg.params)
        jget.save_params_npz(tmp_path / "bridge.npz", restored, input_hw=jseg.input_hw)
        seg = Segmenter2D(config=tseg.config, checkpoint_dir=tmp_path / "bridge.npz",
                          device="cpu")
        frames = _batch(6)[0]
        np.testing.assert_array_equal(seg.predict_batch(frames), tseg.predict_batch(frames))


class TestTrain:
    def test_loss_finite_and_descending(self):
        """Overfit one fixed batch: the last step's loss falls below the
        first's (both read before their update)."""
        batch = _batch(1)
        cfg = _cfg(boundary_weight=2.0, augment=False, lr_schedule="constant")
        _, first = ttrain.train(dataclasses.replace(cfg, steps=1), itertools.repeat(batch),
                                device="cpu", verbose=False)
        _, last = ttrain.train(dataclasses.replace(cfg, steps=12), itertools.repeat(batch),
                               device="cpu", verbose=False)
        assert np.isfinite(first) and np.isfinite(last) and last < 0.8 * first

    def test_synthetic_prefetched_augmented_run(self, tmp_path):
        params, loss = ttrain.train(
            _cfg(steps=3, prefetch=2, augment=True, aug_strength=1.5, appearance="textured",
                 render_hws=((32, 24),), init_params_npz=None), device="cpu", verbose=False)
        assert np.isfinite(loss) and all(v.dtype == torch.float32 for v in params.values())

    def test_init_params_npz_warm_start(self, tmp_path):
        params, loss = ttrain.train(_cfg(steps=0), device="cpu", verbose=False)  # seed 0 init
        assert loss is None
        convert.save_params_npz(tmp_path / "w.npz", convert.to_flax_params(params),
                                full_precision=True)
        got, _ = ttrain.train(_cfg(steps=0, seed=7, init_params_npz=str(tmp_path / "w.npz")),
                              device="cpu", verbose=False)
        assert all(torch.equal(got[k], v) for k, v in params.items())

    def test_default_device_refuses_without_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="is_available"):
            ttrain.train(_cfg())
