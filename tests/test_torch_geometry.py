"""Port parity: geometry/quaternion.py and geometry/camera.py against JAX.

Inputs are made from a seed with NumPy and handed to both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.geometry import camera as jcam
from fusion3dseg_tpu.geometry import quaternion as jquat
from fusion3dseg_tpu_torch.geometry import camera as tcam
from fusion3dseg_tpu_torch.geometry import quaternion as tquat


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return np.asarray(x)


class TestQuaternion:
    def test_exact_ops(self, rng):
        # elementwise forms XLA evaluates in the same order as torch
        q1, q2 = _unit_quats(rng, 64), _unit_quats(rng, 64)
        pairs = [
            (jquat.conjugate(q1), tquat.conjugate(_t(q1))),
            (jquat.multiply(q1, q2), tquat.multiply(_t(q1), _t(q2))),
            (jquat.to_rotation_matrix(q1), tquat.to_rotation_matrix(_t(q1))),
        ]
        for a, b in pairs:
            np.testing.assert_array_equal(_j(a), b.numpy())

    def test_rotate_and_constructors(self, rng):
        # the norm's squares sum as an FMA chain in XLA's CPU code and in the
        # port (`quat.fma`): exact
        q1 = _unit_quats(rng, 64)
        np.testing.assert_array_equal(
            _j(jquat.normalize(q1 * 3)), tquat.normalize(_t(q1 * 3)).numpy())
        q = _unit_quats(rng, 1)[0]
        p = (rng.normal(size=(500, 3)) * 3).astype(np.float32)
        # compiled, XLA contracts rotate's cross products and sum into FMAs
        # as in the session program, which the port reproduces: exact
        np.testing.assert_array_equal(
            _j(jax.jit(jquat.rotate)(q, p)), tquat.rotate(_t(q), _t(p)).numpy())
        np.testing.assert_array_equal(
            _j(jax.jit(jquat.rotate_inverse)(q, p)),
            tquat.rotate_inverse(_t(q), _t(p)).numpy())
        # called op by op, JAX rounds every product instead; the port keeps
        # the session program's form, 1 ulp apart, hence rtol 1e-6
        np.testing.assert_allclose(
            _j(jquat.rotate(q, p)), tquat.rotate(_t(q), _t(p)).numpy(),
            rtol=1e-6, atol=1e-6)
        axis = rng.normal(size=(8, 3)).astype(np.float32)
        ang = rng.uniform(-3, 3, 8).astype(np.float32)
        np.testing.assert_allclose(
            _j(jquat.from_axis_angle(axis, ang)),
            tquat.from_axis_angle(_t(axis), _t(ang)).numpy(), rtol=1e-6, atol=1e-7)
        v1 = rng.normal(size=(8, 3)).astype(np.float32)
        v2 = rng.normal(size=(8, 3)).astype(np.float32)
        v2[0] = -v1[0]  # antiparallel: the 180-degree branch
        np.testing.assert_allclose(
            _j(jquat.between_vectors(v1, v2)),
            tquat.between_vectors(_t(v1), _t(v2)).numpy(), rtol=1e-6, atol=1e-6)
        r, pch, y = (rng.uniform(-3, 3, 8).astype(np.float32) for _ in range(3))
        np.testing.assert_allclose(
            _j(jquat.from_euler(r, pch, y)),
            tquat.from_euler(_t(r), _t(pch), _t(y)).numpy(), rtol=1e-6, atol=1e-7)


class TestProjectPoints:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_exact(self, seed):
        # u, v from a float32 matmul round like XLA's dot; z is the forward
        # FMA-ordered sum XLA computes, so a depth never moves by an ulp
        # across an 11-bit z-buffer bin: every output is bit-identical
        rng = np.random.default_rng(seed)
        pts = (rng.normal(size=(4000, 3)) * 3).astype(np.float32)
        K = np.array([[150.0, 0, 96], [0, 150.0, 128], [0, 0, 1]], np.float32)
        q = _unit_quats(rng, 1)[0]
        t = rng.normal(size=3).astype(np.float32)
        pts[:4] = t  # rel = 0: the 0/0 pixel goes through the saturating cast
        ju, jv, jz = jcam.project_points(pts, K, q, t)
        tu, tv, tz = tcam.project_points(_t(pts), _t(K), _t(q), _t(t))
        assert tu.dtype == torch.int32 and tz.dtype == torch.float32
        np.testing.assert_array_equal(_j(ju), tu.numpy())
        np.testing.assert_array_equal(_j(jv), tv.numpy())
        np.testing.assert_array_equal(_j(jz), tz.numpy())


class TestCameraHelpers:
    def test_backproject_and_to_world(self, rng):
        depth = (1.0 + rng.random((24, 32))).astype(np.float32)
        K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
        jp = jcam.backproject_depth(jnp.asarray(depth), jnp.asarray(K))
        tp = tcam.backproject_depth(_t(depth), _t(K))
        np.testing.assert_allclose(_j(jp), tp.numpy(), rtol=1e-6)
        q = _unit_quats(rng, 3)
        t = rng.normal(size=(3, 3)).astype(np.float32)
        pts = np.broadcast_to(_j(jp), (3,) + jp.shape).copy()
        np.testing.assert_allclose(
            _j(jcam.camera_to_world(pts, q, t)),
            tcam.camera_to_world(_t(pts), _t(q), _t(t)).numpy(), rtol=1e-6, atol=1e-6)

    def test_frustum(self, rng):
        K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
        q = _unit_quats(rng, 4)
        t = rng.normal(size=(4, 3)).astype(np.float32)
        np.testing.assert_allclose(
            _j(jcam.camera_frustum_corners(jnp.asarray(K), 32, 24)),
            tcam.camera_frustum_corners(_t(K), 32, 24).numpy(), rtol=1e-6, atol=1e-7)
        jpp, jpn = jcam.frustum_world_planes(jnp.asarray(K), 32, 24, q, t, 8.0)
        tpp, tpn = tcam.frustum_world_planes(_t(K), 32, 24, _t(q), _t(t), 8.0)
        np.testing.assert_allclose(_j(jpp), tpp.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_j(jpn), tpn.numpy(), rtol=1e-6, atol=1e-6)
