"""The port's voting ops against the JAX package on the CPU: integer votes
and classes, compared exactly. Mirrors the voting cases of tests/test_ops.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import voting as jv
from fusion3dseg_tpu_torch.ops import voting as tv


def _session(rng, F=6, P=300, npts=40, nclasses=9, max_class=None):
    """Pixel->point maps with repeats (several pixels of a frame on one
    point) and unmapped pixels; masks may exceed nclasses (clipped)."""
    uv2pt = rng.integers(-1, npts, size=(F, P)).astype(np.int32)
    uv2pt[rng.random((F, P)) < 0.3] = -1
    masks = rng.integers(0, (max_class or nclasses) + 1, size=(F, P)).astype(np.uint8)
    return uv2pt, masks, npts, nclasses


@pytest.mark.parametrize("dedup", [True, False])
def test_vote_frame_matches_jax(rng, dedup):
    uv2pt, masks, npts, nc = _session(rng)
    want = jnp.zeros((npts, nc + 1), jnp.int32)
    got = torch.zeros((npts, nc + 1), dtype=torch.int32)
    for f in range(len(uv2pt)):
        want = jv.vote_frame(want, jnp.asarray(uv2pt[f]), jnp.asarray(masks[f]), dedup=dedup)
        out = tv.vote_frame(got, torch.from_numpy(uv2pt[f]), torch.from_numpy(masks[f]),
                            dedup=dedup)
        assert out is got  # the table is updated in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if dedup:
        assert got.sum(1).max() <= len(uv2pt) * (nc + 1)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("max_class", [None, 200], ids=["in_range", "clipped"])
def test_vote_all_frames_matches_jax(rng, dedup, max_class):
    uv2pt, masks, npts, nc = _session(rng, max_class=max_class)
    want = jv.vote_all_frames(jnp.asarray(uv2pt), jnp.asarray(masks), npts, nc, dedup)
    got = tv.vote_all_frames(uv2pt, masks, npts, nc, dedup, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (npts, nc + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("threshold", [0.5, 0.6, 1.0 / 3.0])
@pytest.mark.parametrize("filter_classes", [None, (2, 5, 7), (7, 2)])
def test_classify_matches_jax(rng, threshold, filter_classes):
    # small counts: many exact ties and ratios that sit on the threshold
    votes = rng.integers(0, 4, size=(500, 10)).astype(np.int32)
    votes[rng.random(500) < 0.1] = 0
    want = jv.classify(jnp.asarray(votes), threshold, 9, filter_classes)
    got = tv.classify(torch.from_numpy(votes), threshold, 9, filter_classes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dedup", [True, False])
def test_vote_and_classify_matches_jax(rng, dedup):
    uv2pt, masks, npts, nc = _session(rng, F=8, P=500, npts=60, nclasses=133)
    wv, wc = jv.vote_and_classify(jnp.asarray(uv2pt), jnp.asarray(masks), npts=npts,
                                  nclasses=nc, threshold=0.5, filter_classes=None, dedup=dedup)
    gv, gc = tv.vote_and_classify(uv2pt, masks, npts, nc, 0.5, None, dedup, device="cpu")
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_default_device_refuses_without_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    uv2pt, masks, npts, nc = _session(rng)
    with pytest.raises(RuntimeError, match="is_available"):
        tv.vote_and_classify(uv2pt, masks, npts, nc)
