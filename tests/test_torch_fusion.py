"""The port's fusion engine against the JAX package on the CPU.

The session is the room of tests/test_fast_pipeline.py (seed 21, 48x36,
radius 0.1, angle 25) over 16 frames: at 6 frames, 60 degrees apart, no
frame sees an earlier frame's points, spans are all 0 and nothing merges
across frames. Both engines get the same session arrays (the JAX
package's). Seeds, spans and window sizes are held exactly; `n` within 1%
and voted classes per pixel on >= 0.999 (in practice both are exact).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.fusion import fusion as jf
from fusion3dseg_tpu.io import synthetic
from fusion3dseg_tpu.ops import voting as jv
from fusion3dseg_tpu_torch.fusion import fusion as tf
from fusion3dseg_tpu_torch.ops import voting as tv
from fusion3dseg_tpu_torch.utils import timing
from torch_sessions import H, W, session_arrays

RADIUS = 0.1
MIN_COS = float(np.cos(np.deg2rad(25.0)))
CAP = 1 << 14
KW = dict(height=H, width=W, radius=RADIUS, min_cosine=MIN_COS, max_depth=8.0)
RUNS = {  # (window, policy, capacity, candidate_px); 1<<13 fills up: drop-at-capacity
    "unwindowed": (None, "newest", CAP, 1),
    "newest": (1024, "newest", CAP, 1),
    "split": (1024, "split", CAP, 1),
    "full_buffer": (None, "newest", 1 << 13, 1),
    "cells_2px": (1024, "split", CAP, 2),
}


@pytest.fixture(scope="module")
def session():
    return session_arrays(16, room=synthetic.RoomSpec(seed=21))


@pytest.fixture(scope="module")
def runs(session):
    """Each configuration through both engines, once for the module."""
    args, _ = session
    out = {}
    for name, (window, policy, cap, px) in RUNS.items():
        kw = dict(KW, capacity=cap, window=window, window_policy=policy, candidate_px=px,
                  with_stats=True)
        out[name] = (jf.fuse_session(*map(jnp.asarray, args), **kw),
                     tf.fuse_session(*args, device="cpu", **kw))
    return out


def _pixel_classes(uv2pt, classes):
    return np.where(uv2pt >= 0, classes[np.clip(uv2pt, 0, None)], -1)


@pytest.mark.parametrize("name", list(RUNS))
def test_fuse_session_matches_jax(session, runs, name):
    _, masks = session
    (js, juv, jsp), (ts, tuv, tsp) = runs[name]
    cap = RUNS[name][2]
    assert tuv.dtype == torch.int32 and tuple(tuv.shape) == (16, H * W)
    assert ts.n.dtype == torch.int32 and ts.n.dim() == 0
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))  # spans exact
    jn, tn = int(js.n), int(ts.n)
    assert abs(tn - jn) <= 0.01 * jn
    assert tn <= cap and int(tuv.max()) < tn
    # classes voted from each engine's own uv2pt, read back per pixel
    _, jc = jv.vote_and_classify(juv, jnp.asarray(masks), cap, 133)
    _, tc = tv.vote_and_classify(tuv, torch.from_numpy(masks), cap, 133, device="cpu")
    jpix, tpix = _pixel_classes(np.asarray(juv), np.asarray(jc)), _pixel_classes(
        tuv.numpy(), tc.numpy())
    both = (jpix >= 0) & (tpix >= 0)
    assert both.mean() > 0.8
    assert (jpix[both] == tpix[both]).mean() >= 0.999
    if jn == tn:
        np.testing.assert_allclose(ts.points.numpy(), np.asarray(js.points), atol=1e-5)


def test_runs_merge_across_frames_and_overflow(runs):
    # the configurations exercise what they name
    spans = runs["newest"][1][2].numpy()
    assert spans[1:].min() > 0 and spans.max() > 1024  # windows overflow
    assert int(runs["full_buffer"][1][0].n) == 1 << 13  # the buffer fills, appends drop
    ts = runs["unwindowed"][1][0]
    n = int(ts.n)
    assert (ts.occurences[:n] > 1).float().mean() > 0.3  # points merged across frames
    assert int(runs["split"][1][0].n) != int(runs["newest"][1][0].n)


@pytest.mark.parametrize("name", list(RUNS))
def test_state_and_lookups_equal_jax(runs, name):
    """The frame loop writes its own buffer in place, appends past capacity
    into its trash row (`full_buffer` fills up), and still gives the JAX
    package's state and lookups exactly."""
    (js, juv, jsp), (ts, tuv, tsp) = runs[name]
    cap = RUNS[name][2]
    n = int(js.n)
    assert int(ts.n) == n and all(v.shape[0] == cap for v in ts[:5])
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    for field in ("points", "normals", "colors", "nmerges", "occurences"):
        np.testing.assert_array_equal(getattr(ts, field)[:n].numpy(),
                                      np.asarray(getattr(js, field))[:n], err_msg=field)


def _chunk_kw(name):
    window, policy, cap, px = RUNS[name]
    return dict(KW, capacity=cap, window=window, window_policy=policy, candidate_px=px)


@pytest.mark.parametrize("name", list(RUNS))
def test_fuse_chunk_keeps_its_input_state(session, runs, name):
    """`fuse_chunk` from the seed frame, in two chunks, inside a record: the
    state it is given is left as it was, the chunks give the one-shot
    session's bits, and the CPU replays no graph."""
    args, _ = session
    kw = _chunk_kw(name)
    seed, _ = tf._seed_frame(tf._empty_state(kw["capacity"], "cpu"),
                             *(torch.from_numpy(a[0]) for a in args[3:]),
                             **{k: kw[k] for k in ("height", "width", "radius", "min_cosine",
                                                   "max_depth", "capacity")})
    before = [v.clone() for v in seed]
    rows = [slice(1, 9), slice(9, 16)]
    with timing.record() as rec:
        state, uv_a, sp_a = tf.fuse_chunk(seed, args[0], *(a[rows[0]] for a in args[1:]),
                                          with_stats=True, **kw)
        for v, b in zip(seed, before):
            assert torch.equal(v, b)
        mid = [v.clone() for v in state]
        state, uv_b, sp_b = tf.fuse_chunk(state, args[0], *(a[rows[1]] for a in args[1:]),
                                          with_stats=True, **kw)
    for v, b in zip(seed, before):
        assert torch.equal(v, b)
    assert not any(torch.equal(v, m) for v, m in zip(state[:3], mid[:3]))
    _, (ts, tuv, tsp) = runs[name]
    for a, b in zip(state, ts):
        assert torch.equal(a, b)
    assert torch.equal(torch.cat([uv_a, uv_b]), tuv[1:])
    assert torch.equal(torch.cat([sp_a, sp_b]), tsp[1:])
    assert rec["fuse_graph.frames"] == 0 and rec["fuse_graph.captures"] == 0


def _storages(*tensors):
    return [t.untyped_storage().data_ptr() for t in tensors]


@pytest.mark.parametrize("name", list(RUNS))
def test_calls_share_no_storage(session, runs, name):
    """Two calls back to back return the same bits in tensors of their
    own: no state or lookup of one call is a view of another's."""
    args, _ = session
    kw = dict(_chunk_kw(name), with_stats=True, device="cpu")
    first = tf.fuse_session(*args, **kw)
    second = tf.fuse_session(*args, **kw)
    ptrs = [_storages(*out[0], out[1], out[2]) for out in (first, second, runs[name][1])]
    assert not set(ptrs[0]) & set(ptrs[1]) and not set(ptrs[1]) & set(ptrs[2])
    for a, b in zip((*first[0], first[1], first[2]), (*second[0], second[1], second[2])):
        assert torch.equal(a, b)


def test_seed_frame_matches_jax(session):
    args, _ = session
    p, nrm, c, v = (a[0] for a in args[3:])
    kw = dict(KW, capacity=CAP)
    jstate, juv = jf._seed_frame(jf._empty_state(CAP), *map(jnp.asarray, (p, nrm, c, v)), **kw)
    tstate, tuv = tf._seed_frame(tf._empty_state(CAP, "cpu"), *map(torch.from_numpy,
                                                                    (p, nrm, c, v)), **kw)
    np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
    got = tf.state_to_arrays(tstate)
    for name, want in jstate._asdict().items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype, name
        np.testing.assert_allclose(got[name], want, rtol=1e-6, atol=1e-6, err_msg=name)


def test_seed_cells_and_auto_window_match_jax(session):
    args, _ = session
    frame = [a[0] for a in args[3:]]
    for max_depth in (8.0, None, 0.5):  # 0.5: a packed extent that drops points
        want = jf.seed_cells_for_frame(*map(jnp.asarray, frame), H, W, RADIUS, MIN_COS,
                                       max_depth=max_depth)
        got = tf.seed_cells_for_frame(*map(torch.from_numpy, frame), H, W, RADIUS, MIN_COS,
                                      max_depth=max_depth)
        assert got == want and got > 0
    for cells in (0, 1, 500, 3500, 16000, 100_000):
        for cap in (1 << 13, 1 << 16, 1 << 17, 1 << 20):
            assert tf.auto_window(cells, cap) == jf.auto_window(cells, cap)


def test_match_pixels_matches_jax(rng):
    # random candidates on a coarse grid (half=2), with ties in distance
    gh, gw, half = 6, 5, 2
    grid = rng.normal(size=(gh, gw, 12)).astype(np.float32) * 0.05
    grid[1, 1, 6:] = grid[1, 1, :6]  # two equal candidates: argmin's tie-break
    slotg = rng.integers(-1, 50, size=(gh, gw, 2)).astype(np.int32)
    P = 11 * 9
    fpts = rng.normal(size=(P, 3)).astype(np.float32) * 0.05
    fnrm = rng.normal(size=(P, 3)).astype(np.float32)
    fvalid = rng.random(P) < 0.9
    kw = dict(height=11, width=9, half=half, radius=0.08, min_cosine=-0.5)
    want = jf._match_pixels(*map(jnp.asarray, (grid, slotg, fpts, fnrm, fvalid)), **kw)
    got = tf._match_pixels(*map(torch.from_numpy, (grid, slotg, fpts, fnrm, fvalid)), **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < got[1].sum() < P


@pytest.mark.parametrize("id_bits", [12, 24], ids=["packed", "argmin_rounds"])
def test_cell_candidates_two_nearest_lowest_id(rng, id_bits):
    # the wide-window branch (under 8 depth bits) runs only past 2^23 window
    # slots; both branches against a NumPy sort of (depth, id) per cell
    n, ncells, max_depth = 3000, 200, 8.0
    z = (rng.random(n) * 7.9 + 0.1).astype(np.float32)
    z[1::7] = z[::7][: len(z[1::7])]  # equal depths: ties go to the lowest id
    cell = rng.integers(0, ncells + 1, n).astype(np.int32)  # ncells: not ok
    ok = cell < ncells
    zbits = 31 - id_bits
    key = (np.clip(z * np.float32((1 << zbits) / max_depth), 0, (1 << zbits) - 1)
           .astype(np.int64) if zbits >= 8 else z)
    want = np.full((2, ncells), -1)
    for c in range(ncells):
        members = np.nonzero(cell == c)[0]
        order = members[np.lexsort((members, key[members]))]
        want[: len(order[:2]), c] = order[:2]
    got = tf._cell_candidates(*map(torch.from_numpy, (ok, z, cell)), ncells, id_bits, max_depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_dedup_state_and_remap_match_jax(runs):
    # the JAX engine's overflowed state, carried into the port
    (js, juv, _), _ = runs["newest"]
    jd, jmap = jf.dedup_state(js, RADIUS, MIN_COS, capacity=CAP)
    state = tf.state_from_arrays(*map(np.asarray, js), device="cpu")
    td, tmap = tf.dedup_state(state, RADIUS, MIN_COS, capacity=CAP)
    assert int(td.n) == int(jd.n) < int(js.n)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    got, want = tf.state_to_arrays(td), {k: np.asarray(v) for k, v in jd._asdict().items()}
    for name in ("nmerges", "occurences", "n"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("points", "normals", "colors"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tf.remap_uv2pt(torch.from_numpy(np.array(juv)), tmap).numpy(),
                                  np.asarray(jf.remap_uv2pt(juv, jmap)))
    for passes in (1, 2):
        _, m1 = tf.dedup_state(state, RADIUS, MIN_COS, capacity=CAP, passes=passes)
        np.testing.assert_array_equal(
            m1.numpy(), np.asarray(jf.dedup_state(js, RADIUS, MIN_COS, capacity=CAP,
                                                  passes=passes)[1]))


def test_state_arrays_round_trip_and_span_helper(runs):
    (js, juv, _), (ts, tuv, _) = runs["split"]
    arrays = tf.state_to_arrays(ts)
    back = tf.state_from_arrays(*arrays.values(), device="cpu")
    for a, b in zip(back, ts):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tf.visible_span_from_uv2pt(tuv),
                                  jf.visible_span_from_uv2pt(np.asarray(juv)))


def test_unknown_window_policy_and_default_device_refuse(session):
    args, _ = session
    with pytest.raises(ValueError, match="window_policy"):
        tf.fuse_session(*args, capacity=CAP, window_policy="oldest", device="cpu", **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tf.fuse_session(*args, capacity=CAP, **KW)
