"""The engine's pixel match (`fusion._match_pixels`) on the CPU.

CPU tensors take the plain version, `_match_pixels_plain`, which the card's
kernel (`csrc/match_pixels.cu`) repeats operation by operation; the card
tests hold the kernel to it. Here the plain version meets the JAX
package's `_match_pixels`, jitted as the session's step is, at every cell
size the engine takes, with ties and with distances and cosines placed
exactly on the limits. The engine's counter of frames matched by the
kernel reads 0 on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion3dseg_tpu.fusion import fusion as jf
from fusion3dseg_tpu.io import synthetic
from fusion3dseg_tpu_torch.fusion import fusion as tf
from fusion3dseg_tpu_torch.utils import timing
from torch_match_inputs import CASES, MIN_COS, RADIUS, random_case
from torch_sessions import H, W, session_arrays


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("half", [1, 2, 3])
def test_plain_match_matches_jax(case, half):
    height, width = 23, 31  # ragged at every half
    arrays = CASES[case](np.random.default_rng(10 * half + len(case)), height, width, half)
    kw = dict(height=height, width=width, half=half, radius=RADIUS, min_cosine=MIN_COS)
    want = jax.jit(functools.partial(jf._match_pixels, **kw))(*map(jnp.asarray, arrays))
    got = tf._match_pixels(*map(torch.from_numpy, arrays), **kw)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[1].sum()) < height * width
    if case == "boundaries":  # the limits are met exactly, and hold
        grid = arrays[0]
        on_radius = np.abs(grid.reshape(-1, 2, 6)[..., :3]).max(-1) == np.float32(RADIUS)
        on_cos = grid.reshape(-1, 2, 6)[..., 3] == np.float32(MIN_COS)
        assert on_radius.any() and on_cos.any()


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel's launcher was called for CPU tensors")

    monkeypatch.setattr(tf, "_match_kernel", refuse)
    arrays = random_case(np.random.default_rng(3), 17, 20, 2)
    kw = dict(height=17, width=20, half=2, radius=RADIUS, min_cosine=MIN_COS)
    got = tf._match_pixels(*map(torch.from_numpy, arrays), **kw)
    want = tf._match_pixels_plain(*map(torch.from_numpy, arrays), **kw)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_kernel_frames_counter_reads_zero_on_the_cpu():
    args, _ = session_arrays(4, room=synthetic.RoomSpec(seed=21))
    launches = tf._match_kernel.launches
    with timing.record() as rec:
        tf.fuse_session(*args, height=H, width=W, radius=0.1,
                        min_cosine=float(np.cos(np.deg2rad(25.0))), max_depth=8.0,
                        capacity=1 << 14, window=1024, window_policy="split", device="cpu")
    assert rec["fuse_match.kernel_frames"] == 0 and rec["fuse_graph.frames"] == 0
    assert timing.METRICS.counts.get("fuse_match.kernel_frames", 0) == 0
    assert tf._match_kernel.launches == launches


def test_kernel_frames_counter_follows_the_dispatch(monkeypatch):
    """The counter counts the frames whose match took the kernel's launcher,
    not the frames of a device: a step dispatched to the launcher counts
    (here a stand-in on the CPU that runs the plain version)."""
    def launcher(*a, **kw):
        tf._match_kernel.launches += 1
        return tf._match_pixels_plain(*a, **kw)

    monkeypatch.setattr(tf, "_match_pixels", launcher)
    monkeypatch.setattr(tf._match_kernel, "launches", 0)
    args, _ = session_arrays(4, room=synthetic.RoomSpec(seed=21))
    with timing.record() as rec:
        tf.fuse_session(*args, height=H, width=W, radius=0.1,
                        min_cosine=float(np.cos(np.deg2rad(25.0))), max_depth=8.0,
                        capacity=1 << 14, window=1024, window_policy="split", device="cpu")
    assert rec["fuse_match.kernel_frames"] == tf._match_kernel.launches == 3
