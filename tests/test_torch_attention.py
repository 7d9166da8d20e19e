"""The port's attention ops (kernels K3 and K2) against the JAX package on
the CPU: the same numpy inputs go through the plain PyTorch versions (what
the wrappers run on CPU tensors) and through the Pallas kernels in interpret
mode and their XLA references. Mirrors tests/test_attention.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.ops import attention as tattn

# float32 bars are those of tests/test_attention.py (2e-3 for the dense
# kernel, 2e-5 for the windowed one). bfloat16: outputs are O(1) with a
# 2^-8 relative rounding step, and the two frameworks round the scores at
# different places, so a few steps: 3e-2.
F32_SR, F32_NAT, BF16 = 2e-3, 2e-5, 3e-2


def _qkv(rng, shape_q, shape_kv, dtype):
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv))
    tj = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, tj) for a in (q, k, v)],
            [torch.from_numpy(a).to(tt) for a in (q, k, v)])


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


class TestSRAttention:
    @pytest.mark.parametrize("dtype,atol", [("f32", F32_SR), ("bf16", BF16)])
    @pytest.mark.parametrize("B,N,H,D,M", [(1, 1024, 2, 32, 64), (2, 512, 1, 64, 16)])
    def test_plain_matches_pallas_interpret(self, rng, dtype, atol, B, N, H, D, M):
        (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (B, N, H, D), (B, M, H, D), dtype)
        want = jattn.sr_attention(qj, kj, vj, interpret=True)
        got = tattn.sr_attention(qt, kt, vt)  # CPU tensors: the plain version
        assert got.dtype == qt.dtype and got.shape == (B, N, H, D)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol)

    @pytest.mark.parametrize("dtype,atol", [("f32", F32_SR), ("bf16", BF16)])
    def test_plain_matches_xla_path(self, rng, dtype, atol):
        (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (2, 1024, 2, 32), (2, 64, 2, 32), dtype)
        want = jattn.sr_attention(qj, kj, vj)
        np.testing.assert_allclose(_np(tattn.sr_attention_reference(qt, kt, vt)),
                                   _np(want), atol=atol)

    def test_ragged_shapes_match_dense_softmax(self, rng):
        # shapes the TPU kernel refuses (N % 512 != 0): any N, M, H, D
        _, (q, k, v) = _qkv(rng, (1, 1000, 3, 24), (1, 37, 3, 24), "f32")
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) / 24 ** 0.5
        want = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v)
        np.testing.assert_allclose(tattn.sr_attention(q, k, v).numpy(), want.numpy(), atol=2e-5)

    def test_forward_only_and_input_checks(self, rng):
        _, (q, k, v) = _qkv(rng, (1, 8, 1, 4), (1, 4, 1, 4), "f32")
        with pytest.raises(RuntimeError, match="forward only"):
            tattn.sr_attention(q.requires_grad_(True), k, v)
        with torch.no_grad():
            tattn.sr_attention(q, k, v)
        with pytest.raises(TypeError):  # float16 is taken (tests/test_torch_float16.py)
            tattn.sr_attention(q.detach().double(), k.double(), v.double())
        with pytest.raises(TypeError):
            tattn.sr_attention(q.detach().half(), k.float(), v.half())
        with pytest.raises(ValueError):
            tattn.sr_attention(q.detach(), k[..., :2], v[..., :2])
        assert tattn.sr_attention.launches == 0  # the CPU never counts a launch


class TestNeighborhoodAttention:
    @pytest.mark.parametrize("dtype,atol", [("f32", F32_NAT), ("bf16", BF16)])
    @pytest.mark.parametrize("B,Hh,D,H,W,K,rt", [(2, 2, 16, 16, 24, 5, 8), (1, 1, 8, 8, 8, 3, 4)])
    def test_plain_matches_pallas_interpret(self, rng, dtype, atol, B, Hh, D, H, W, K, rt):
        (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (B, H * W, Hh, D), (B, H * W, Hh, D), dtype)
        want = jattn.neighborhood_attention(qj, kj, vj, H, W, window=K, row_tile=rt,
                                            interpret=True)
        got = tattn.neighborhood_attention(qt, kt, vt, H, W, window=K)
        assert got.dtype == qt.dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=atol)

    @pytest.mark.parametrize("dtype,atol", [("f32", F32_NAT), ("bf16", BF16)])
    def test_plain_matches_xla_reference_odd_grid(self, rng, dtype, atol):
        # 9 x 11 divides by no row tile: only the references take it
        B, Hh, D, H, W, K = 1, 2, 8, 9, 11, 5
        (qj, kj, vj), (qt, kt, vt) = _qkv(rng, (B, H * W, Hh, D), (B, H * W, Hh, D), dtype)
        want = jattn.neighborhood_attention_reference(qj, kj, vj, H, W, K)
        got = tattn.neighborhood_attention_reference(qt, kt, vt, H, W, K)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol)

    def test_gradients_match_jax(self, rng):
        B, Hh, D, H, W, K = 1, 2, 8, 8, 8, 3
        (qj, kj, vj), qkv_t = _qkv(rng, (B, H * W, Hh, D), (B, H * W, Hh, D), "f32")
        wgt = rng.normal(size=(B, H * W, Hh, D)).astype(np.float32)

        def loss(q, k, v):
            out = jattn.neighborhood_attention(q, k, v, H, W, K, 4, True)
            return jnp.sum(out * wgt)

        want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
        qkv_t = [t.requires_grad_(True) for t in qkv_t]
        (tattn.neighborhood_attention(*qkv_t, H, W, K) * torch.from_numpy(wgt)).sum().backward()
        for t, w in zip(qkv_t, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5)

    def test_autograd_function_backward_dtypes(self, rng):
        # the kernel's autograd.Function, its forward replaced by the plain
        # version (the CPU has no kernel): gradients come back in the
        # inputs' dtype through the plain version's autograd
        B, Hh, D, H, W, K = 1, 1, 8, 6, 5, 3
        _, qkv = _qkv(rng, (B, H * W, Hh, D), (B, H * W, Hh, D), "bf16")
        ctx = type("Ctx", (), {})()
        ctx.saved_tensors, ctx.geometry = tuple(qkv), (H, W, K)
        g = torch.ones((B, H * W, Hh, D), dtype=torch.float32)
        grads = tattn._NeighborhoodAttention.backward(ctx, g)
        assert [x.dtype for x in grads[:3]] == [torch.bfloat16] * 3
        assert all(x is None for x in grads[3:])
        assert all(torch.isfinite(x.float()).all() for x in grads[:3])

    def test_input_checks(self, rng):
        _, (q, k, v) = _qkv(rng, (1, 12, 1, 4), (1, 12, 1, 4), "f32")
        with pytest.raises(ValueError, match="odd"):
            tattn.neighborhood_attention(q, k, v, 3, 4, window=4)
        with pytest.raises(ValueError, match="height"):
            tattn.neighborhood_attention(q, k, v, 5, 4, window=3)
        assert tattn.neighborhood_attention.launches == 0
