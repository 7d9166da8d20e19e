"""K3's route (which kernel a CUDA call of `sr_attention` launches), decided
on CPU tensors and views, and its plain version against the JAX package at
the 256-key shape that the wgmma kernel treats on its own.

`_sr_route` reads only dtypes, shapes, strides and base addresses, so it
needs no card; the kernels themselves are held to their plain version in
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fusion3dseg_tpu.ops import attention as jattn
from fusion3dseg_tpu_torch.ops import attention as tattn

# the bars of tests/test_torch_attention.py
F32_SR, BF16 = 2e-3, 3e-2


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _aligned_view(shape, offset_elems, row=None):
    """A bfloat16 [B, T, H, D] view into a flat buffer whose base lies
    `offset_elems` elements past a 64-byte boundary; `row` pads the token
    stride (elements a token, default H * D)."""
    B, T, H, D = shape
    row = row or H * D
    flat = _bf16(offset_elems + B * T * row + 64)
    assert flat.data_ptr() % 64 == 0
    return flat.as_strided(shape, (T * row, row, D, 1), offset_elems)


@pytest.mark.parametrize("shape_q,shape_kv,route", [
    ((8, 4096, 1, 64), (8, 64, 1, 64), "wgmma"),  # B2 stage 0
    ((8, 1024, 2, 64), (8, 64, 2, 64), "wgmma"),  # B2 stage 1
    ((2, 16384, 1, 64), (2, 256, 1, 64), "wgmma"),
    ((2, 512, 1, 64), (2, 257, 1, 64), "wgmma"),  # keys in tiles: any M
    ((1, 512, 1, 128), (1, 300, 1, 128), "wgmma"),
    ((1, 300, 2, 24), (1, 40, 2, 24), "wgmma"),  # D a multiple of 8
    ((1, 300, 2, 20), (1, 40, 2, 20), "mma"),  # D, and the head stride, not
    ((2, 700, 2, 64), (2, 1, 2, 64), "wgmma"),  # one key
    ((8, 65536, 1, 64), (8, 1024, 1, 64), "wgmma"),  # B2 stage 0 at 1024x1024
    ((1, 300, 2, 20), (1, 1600, 2, 20), "mma"),  # the most keys mma.sync holds at D = 20
    ((1, 300, 2, 20), (1, 1601, 2, 20), "wgmma"),  # one more: copied into a TMA layout
])
def test_route_by_shape(shape_q, shape_kv, route):
    q, k, v = _bf16(*shape_q), _bf16(*shape_kv), _bf16(*shape_kv)
    assert tattn._sr_route(q, k, v) == route


@pytest.mark.parametrize("M,D,fits", [(848, 64, True), (849, 64, False), (432, 128, True),
                                        (433, 128, False), (1600, 20, True), (1601, 20, False)])
def test_mma_shared_memory(M, D, fits):
    # K [Mp, 16 NK + 8] and V transposed [16 NK, Mp + 8] in bfloat16 against
    # an SM's 232,448 bytes (Mp = M rounded up to 16, NK = D / 16 rounded
    # up to a power of two)
    assert tattn._mma_fits(M, D) == fits


@pytest.mark.parametrize("D,width", [(64, 64), (20, 24), (3, 8)])
def test_tma_copy(D, width):
    # a layout TMA cannot describe, copied into rows of whole 16-byte pieces
    t = _aligned_view((2, 30, 3, D), 1, row=3 * D + 1)
    assert not tattn._tma_layout(t)
    c = tattn._tma_copy(t, width)
    assert c.shape == t.shape and torch.equal(c, t)
    assert c.stride() == (30 * 3 * width, 3 * width, width, 1) and tattn._tma_layout(c)


def test_route_by_dtype():
    q, k = torch.zeros((1, 64, 1, 64)), torch.zeros((1, 64, 1, 64))
    assert tattn._sr_route(q, k, k) == "f32"
    assert tattn._sr_route(q.bfloat16(), k.bfloat16(), k.bfloat16()) == "wgmma"


@pytest.mark.parametrize("offset,route", [(0, "wgmma"), (8, "wgmma"), (4, "mma"), (1, "mma")])
def test_route_by_base_alignment(offset, route):
    # a base 2 * offset bytes past a 64-byte boundary: TMA needs 16
    q = _aligned_view((2, 300, 1, 64), offset)
    k = _bf16(2, 40, 1, 64)
    assert tattn._sr_route(q, k, k) == route
    assert tattn._sr_route(k[:, :30], q[:, :40], k) == route  # k's base as well


def test_route_by_strides():
    k = _bf16(2, 40, 2, 64)
    # slices of one fused projection [B, N, 3, H, D]: strides of whole
    # 16-byte pieces, bases 2 * H * D bytes apart
    fused = _bf16(2, 640, 3, 2, 16)
    q, kf, vf = fused[:, :, 0], fused[:, :40, 1], fused[:, :40, 2]
    assert tattn._sr_route(q, kf, vf) == "wgmma"
    # a token stride of 68 elements (136 bytes) is not whole 16-byte pieces
    padded = _aligned_view((2, 300, 1, 64), 0, row=68)
    assert padded.stride(1) == 68
    assert tattn._sr_route(padded, k[:, :, :1], k[:, :, :1]) == "mma"
    # a head stride of 68 elements, likewise
    heads = _bf16(2, 300, 2, 68)[..., :64]
    assert tattn._sr_route(heads, k, k) == "mma"
    # the stride of an axis of extent 1 is never stepped: any value will do
    one = _bf16(300 * 64).as_strided((1, 300, 1, 64), (300 * 64, 64, 68, 1))
    assert one.stride(2) == 68 and tattn._sr_route(one, k[:1, :, :1], k[:1, :, :1]) == "wgmma"
    # a broadcast axis (stride 0) cannot be described
    wide = _bf16(1, 300, 1, 64).expand(3, 300, 1, 64)
    assert tattn._sr_route(wide, k[:1].expand(3, 40, 2, 64)[:, :, :1],
                           k[:1].expand(3, 40, 2, 64)[:, :, :1]) == "mma"


def test_cpu_call_counts_no_launch():
    tattn.reset_sr_counts()
    q = torch.randn((1, 128, 1, 64)).bfloat16()
    tattn.sr_attention(q, q[:, :64], q[:, :64])
    assert tattn.sr_attention.launches == 0
    assert tattn.sr_attention.routes == {"f32": 0, "mma": 0, "wgmma": 0}
    with pytest.raises(ValueError, match="route"):
        tattn.launch_sr_attention(q.float(), q.float(), q.float(), "wgmma")


@pytest.mark.parametrize("dtype,atol", [("f32", F32_SR), ("bf16", BF16)])
def test_plain_matches_pallas_interpret_256_keys(rng, dtype, atol):
    # [1,512,1,64]x[1,256,1,64]: M = 256, the widest the wgmma kernel takes
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 512, 1, 64), (1, 256, 1, 64), (1, 256, 1, 64)))
    tj = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = jattn.sr_attention(*(jnp.asarray(a, tj) for a in (q, k, v)), interpret=True)
    got = tattn.sr_attention_reference(*(torch.from_numpy(a).to(tt) for a in (q, k, v)))
    assert got.dtype == tt and got.shape == (1, 512, 1, 64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)
