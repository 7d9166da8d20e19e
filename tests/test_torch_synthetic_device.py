"""The port's device renderer (`io/synthetic_device.py`) on the CPU against
the host renderer it replaces (`io/synthetic.make_session`, the port's and
the JAX package's) and the trainer's host resize, and the device augment's
invariants (tests/test_synthetic_device.py's checks)."""

import numpy as np
import pytest
import torch

from fusion3dseg_tpu.io import synthetic as jsyn
from fusion3dseg_tpu_torch.io import synthetic as tsyn, synthetic_device as sd
from fusion3dseg_tpu_torch.models import SegFormerConfig
from fusion3dseg_tpu_torch.models import train as ttrain
from torch_seg_pair import TINY


def _render(room, nframes, hw, model_hw=None):
    tables = sd.session_tables(room, nframes, "cpu")
    return sd.render_session_device(*tables, render_hw=hw, model_hw=model_hw or hw)


@pytest.mark.parametrize("seed,hw", [(11, (48, 36)), (4096, (48, 36)), (7, (96, 72))])
def test_render_bit_exact_with_host_renderer(seed, hw):
    room = tsyn.RoomSpec(seed=seed)
    imgs, masks = _render(room, 4, hw)
    assert imgs.dtype == masks.dtype == torch.uint8 and tuple(imgs.shape) == (4, *hw, 3)
    for pkg in (tsyn, jsyn):
        sess = pkg.make_session(nframes=4, depth_hw=hw, room=pkg.RoomSpec(seed=seed),
                                appearance="textured")
        np.testing.assert_array_equal(masks.numpy(), sess.gt_mask)
        np.testing.assert_array_equal(imgs.numpy(), sess.colors)


@pytest.mark.parametrize("model_hw", [(64, 64), (40, 30)], ids=["up", "down"])
def test_resized_frames_equal_the_host_resize(model_hw):
    """Quantized at render size, then OpenCV's INTER_LINEAR / INTER_NEAREST:
    the trainer's host batches exactly."""
    room = tsyn.RoomSpec(seed=7)
    sess = tsyn.make_session(nframes=3, depth_hw=(96, 72), room=room, appearance="textured")
    imgs, masks = _render(room, 3, (96, 72), model_hw)
    want_i, want_m = ttrain._resize_frames(sess.colors, sess.gt_mask, model_hw)
    np.testing.assert_array_equal(imgs.numpy(), want_i)
    np.testing.assert_array_equal(masks.numpy(), want_m)


def test_dataset_batches_are_the_host_sessions():
    it = sd.device_dataset((64, 64), 4, seed=3, nframes_per_session=8, device="cpu")
    b1, m1 = next(it)
    b2, _ = next(it)
    assert b1.shape == (4, 64, 64, 3) and b1.dtype == torch.uint8
    assert m1.shape == (4, 64, 64) and m1.dtype == torch.uint8
    assert {87, 118, 131} <= set(np.unique(m1.numpy()).tolist())  # the room's surfaces
    assert not torch.equal(b1, b2)  # shuffled frames
    # the same draws by hand: room seed, render size, frame order
    rng = np.random.default_rng(3)
    room = tsyn.RoomSpec(seed=int(rng.integers(1 << 30)))
    hw = ((96, 72),)[int(rng.integers(1))]
    sess = tsyn.make_session(nframes=8, depth_hw=hw, room=room, appearance="textured")
    imgs, masks = ttrain._resize_frames(sess.colors, sess.gt_mask, (64, 64))
    sel = rng.permutation(8)[:4]
    np.testing.assert_array_equal(b1.numpy(), imgs[sel])
    np.testing.assert_array_equal(m1.numpy(), masks[sel])


class TestAugmentDevice:
    @pytest.fixture
    def batch(self):
        rng = np.random.default_rng(0)
        return (torch.from_numpy(rng.integers(0, 255, (6, 32, 32, 3), dtype=np.uint8)),
                torch.from_numpy(rng.integers(0, 20, (6, 32, 32), dtype=np.uint8)))

    @pytest.mark.parametrize("strength", [1.0, 1.6])
    def test_invariants(self, batch, strength):
        imgs, masks = batch
        out, om = sd.augment_batch_device(imgs, masks, torch.Generator().manual_seed(1),
                                          strength)
        assert out.dtype == om.dtype == torch.uint8 and out.shape == imgs.shape
        for i in range(6):  # labels only ever flipped, with their image
            flipped = torch.equal(om[i], masks[i].flip(1))
            assert torch.equal(om[i], masks[i]) or flipped
        assert not torch.equal(out, imgs)

    def test_generator_decides_the_draws(self, batch):
        a = sd.augment_batch_device(*batch, torch.Generator().manual_seed(5))[0]
        b = sd.augment_batch_device(*batch, torch.Generator().manual_seed(5))[0]
        c = sd.augment_batch_device(*batch, torch.Generator().manual_seed(6))[0]
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_distribution_matches_host_augment(self):
        """Same jitter ranges as augment_batch: over many images the mean
        level shift and spread agree with the host's within a few levels."""
        imgs = np.full((256, 8, 8, 3), 128, np.uint8)
        masks = np.zeros((256, 8, 8), np.uint8)
        host = ttrain.augment_batch(imgs, masks, np.random.default_rng(0))[0].astype(float)
        dev = sd.augment_batch_device(torch.from_numpy(imgs), torch.from_numpy(masks),
                                      torch.Generator().manual_seed(0))[0].numpy().astype(float)
        assert abs(host.mean() - dev.mean()) < 4.0
        assert abs(host.std() - dev.std()) < 4.0


def test_train_loop_with_device_datagen():
    cfg = ttrain.TrainConfig(
        model=SegFormerConfig(**TINY, dtype=torch.float32), steps=2, batch_size=2,
        input_hw=(64, 64), render_hws=((64, 48),), device_datagen=True, augment=True,
        warmup_steps=1, prefetch=0, log_every=100)
    _, loss = ttrain.train(cfg, device="cpu", verbose=False)
    assert np.isfinite(loss)
