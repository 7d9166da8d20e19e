"""The port's sharded fusion engines over 4 gloo ranks on the CPU, against
the JAX package's over 4 of the 8 virtual CPU devices
(`fusion3dseg_tpu/parallel/fusion.py`), on the 48x36 synthetic session of
the JAX package's own parallel tests.

One `launch.spawn` runs every case in one group of 4 ranks
(`torch_parallel_ranks.fusion_cases`): the spatially sharded engine (full
merge, and a split window that overflows), the frame-sharded engine with
its 2-frame halo, and the drift guard of tests/test_model_parallel.py:
498-570 (one rank spatially sharded bit-identical to the port's
`fuse_session`, for the full merge, a window and the split policy), one
case a rank. n, counters and uv2pt exact; float state bit-exact but for the
frame-sharded engine's final merge (1e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from fusion3dseg_tpu.parallel import fusion as jpfusion
from fusion3dseg_tpu_torch.parallel import launch

import torch_parallel_ranks as ranks
from torch_sessions import H, W, session_arrays

D = 4
KW = dict(height=H, width=W, radius=0.08, min_cosine=float(np.cos(np.deg2rad(20.0))),
          max_depth=8.0)
CAP_SPATIAL = (1 << 15) // D  # unsaturated: the session fuses to about 13k points
CAP_FRAMES = 1 << 13
SPLIT = dict(capacity=1 << 11, window=1 << 8, window_policy="split")
INTS = ("nmerges", "occurences", "uv2pt")
FLOATS = ("points", "normals", "colors")
# the frame-sharded engine's last voxel merge is an eager call in the
# reference, whose float sums round 1 ulp apart from the port's in about
# 0.07% of the merged coordinates (measured 1.7e-7 relative at most)
FLOAT_RTOL = {"spatial": 0.0, "split": 0.0, "frames": 1e-6}


@pytest.fixture(scope="module")
def inputs():
    args, _ = session_arrays(16)
    short = tuple(a if a.ndim == 2 and a.shape == (3, 3) else a[:8] for a in args)
    return dict(args=args, short=short, kw=KW, cap_spatial=CAP_SPATIAL, cap_frames=CAP_FRAMES,
                split=SPLIT)


@pytest.fixture(scope="module")
def jax_out(inputs):
    mesh = Mesh(np.array(jax.devices()[:D]), ("dp",))
    args = [jnp.asarray(a) for a in inputs["args"]]
    short = [jnp.asarray(a) for a in inputs["short"]]

    def arrays(out):
        state, uv2pt = out
        return {**{k: np.asarray(v) for k, v in state._asdict().items()},
                "uv2pt": np.asarray(uv2pt)}

    return {
        "spatial": arrays(jpfusion.fuse_session_spatial_sharded(mesh, *args, **KW,
                                                                capacity=CAP_SPATIAL)),
        "split": arrays(jpfusion.fuse_session_spatial_sharded(mesh, *short, **KW, **SPLIT)),
        "frames": arrays(jpfusion.fuse_session_sharded(mesh, *args, **KW,
                                                       capacity=CAP_FRAMES)),
    }


@pytest.fixture(scope="module")
def port(inputs):
    return launch.spawn(ranks.fusion_cases, D, (inputs,), device_type="cpu", timeout=180.0)


def _assert_equal(got, want, what, rtol=0.0):
    assert int(got["n"]) == int(want["n"]) > 0, (what, int(got["n"]), int(want["n"]))
    for k in INTS + FLOATS:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (what, k)
        if k in INTS or rtol == 0.0:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", ["spatial", "split", "frames"])
def test_sharded_engines_equal_jax(port, jax_out, case):
    for r, out in enumerate(port):
        _assert_equal(out[case], jax_out[case], f"{case}, rank {r}", FLOAT_RTOL[case])


@pytest.mark.parametrize("case", range(len(ranks.DRIFT_CASES)),
                         ids=["full_merge", "windowed", "split_policy"])
def test_one_rank_spatial_is_fuse_session_bit_for_bit(port, case):
    one, sharded = port[case]["drift"]
    _assert_equal(sharded, one, f"drift guard {ranks.DRIFT_CASES[case]}")


def test_collectives_per_frame(port):
    """Spatial: a psum at the seed, 5 collectives a frame, 3 gathers; frame-
    sharded: 5 gathers; the 16- and 8-frame sessions."""
    want = (1 + 5 * 15 + 3) + (1 + 5 * 7 + 3) + 5
    drift = (1 + 5 * 7 + 3)
    for r, out in enumerate(port):
        assert out["collectives"]["calls"] == want + (drift if r < 3 else 0), r
