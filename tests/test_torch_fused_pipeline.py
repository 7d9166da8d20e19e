"""The port's fusion + voting pipeline against the JAX package on the CPU:
given the same uv2pt, votes and classes are exact; the overflow repair on
a loop-closure session (two turns) matches the JAX repair."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.fusion import fused_pipeline as jfp
from fusion3dseg_tpu.ops import voting as jv
from fusion3dseg_tpu_torch.fusion import fused_pipeline as tfp, fusion as tf
from fusion3dseg_tpu_torch.ops import voting as tv
from torch_sessions import H, W, session_arrays

RADIUS, CAP, WIN = 0.08, 1 << 15, 1 << 12
MIN_COS = float(np.cos(np.deg2rad(20.0)))
KW = dict(height=H, width=W, radius=RADIUS, min_cosine=MIN_COS, max_depth=8.0, capacity=CAP)


@pytest.fixture(scope="module")
def loop():
    """The loop-closure session of tests/test_fast_pipeline.py, fused by
    the JAX engine with a window it overflows."""
    args, masks = session_arrays(16, turns=2.0)
    masks = np.minimum(masks, 19)
    out = jfp.fuse_session_and_vote(*map(jnp.asarray, args), jnp.asarray(masks), nclasses=20,
                                    window=WIN, with_stats=True, **KW)
    return args, masks, out


def test_fuse_session_and_vote_matches_jax(loop):
    args, masks, (jstate, juv, jvotes, jcls, jspans) = loop
    state, uv2pt, votes, classes, spans = tfp.fuse_session_and_vote(
        *args, masks, nclasses=20, window=WIN, with_stats=True, device="cpu", **KW)
    np.testing.assert_array_equal(spans.numpy(), np.asarray(jspans))
    assert int(spans.max()) > WIN  # the window overflows
    assert abs(int(state.n) - int(jstate.n)) <= 0.01 * int(jstate.n)
    assert votes.shape == (CAP, 21) and votes.dtype == torch.int32
    assert classes.dtype == torch.uint8 and jcls.dtype == jnp.uint8
    if torch.equal(uv2pt, torch.from_numpy(np.array(juv))):
        np.testing.assert_array_equal(votes.numpy(), np.asarray(jvotes))
        np.testing.assert_array_equal(classes.numpy(), np.asarray(jcls))


@pytest.mark.parametrize("nclasses,dedup", [(20, True), (20, False), (300, True)],
                         ids=["uint8", "no_dedup", "int32"])
def test_votes_and_classes_exact_given_jax_uv2pt(loop, nclasses, dedup):
    _, masks, (_, juv, _, _, _) = loop
    want_v, want_c = jv.vote_and_classify(juv, jnp.asarray(masks), CAP, nclasses, dedup=dedup)
    got_v, got_c = tv.vote_and_classify(np.array(juv), masks, CAP, nclasses, dedup=dedup,
                                        device="cpu")
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    # the pipeline's class dtype rule: uint8 while nclasses <= 255
    assert tfp._classes_dtype(got_c, nclasses).dtype == (
        torch.uint8 if nclasses <= 255 else torch.int32)


def test_dedup_and_revote_matches_jax(loop):
    _, masks, (jstate, juv, _, _, _) = loop
    want = jfp.dedup_and_revote(jstate, juv, jnp.asarray(masks), RADIUS, MIN_COS,
                                capacity=CAP, nclasses=20)
    state = tf.state_from_arrays(*map(np.asarray, jstate), device="cpu")
    got = tfp.dedup_and_revote(state, torch.from_numpy(np.array(juv)), torch.from_numpy(masks),
                               RADIUS, MIN_COS, capacity=CAP, nclasses=20)
    assert int(got[0].n) == int(want[0].n) < int(jstate.n)
    for g, w in zip(got[1:], want[1:]):  # uv2pt, votes, classes
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].points.numpy(), np.asarray(want[0].points), rtol=1e-6,
                               atol=1e-6)


def test_repair_lands_at_or_below_the_full_merge(loop):
    # the JAX bar (tests/test_fast_pipeline.py): repaired n <= 1.02 x full merge
    args, masks, (jstate, _, _, _, _) = loop
    full, _ = tf.fuse_session(*args, device="cpu", **KW)
    state = tf.state_from_arrays(*map(np.asarray, jstate), device="cpu")
    repaired = tfp.dedup_and_revote(state, torch.zeros((16, H * W), dtype=torch.int32),
                                    torch.from_numpy(masks), RADIUS, MIN_COS, capacity=CAP,
                                    nclasses=20)[0]
    assert int(jstate.n) > 1.2 * int(full.n)
    assert int(repaired.n) <= 1.02 * int(full.n)
