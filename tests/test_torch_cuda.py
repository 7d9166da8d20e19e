"""Card-only tests: the CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so that it runs on a
GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each test decides inside a fixture whether there is a card, and skips
without one.
"""

import numpy as np
import pytest
import torch

from fusion3dseg_tpu_torch.ops import histogram as th
from torch_hist_inputs import hist_matrix


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_c(shape, nclasses, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    C = torch.randint(0, nclasses + 1, shape, generator=g, dtype=torch.int32)
    C = torch.where(torch.rand(shape, generator=g) < 0.4, 255, C).to(torch.uint8)
    return C.to(device)


def _check(C, nclasses, threshold):
    before = th.histogram_classify.launches
    got = th.histogram_classify(C, nclasses, threshold)
    assert th.histogram_classify.launches == before + 1
    want = th.histogram_classify_reference(C, nclasses, threshold)
    torch.cuda.synchronize()
    for w, g in zip((*want[0], want[1]), (*got[0], got[1])):
        assert torch.equal(w, g)  # exact: integer counts, same f32 division


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.5, 0.6])
@pytest.mark.parametrize("ids", ["classes", "above_nclasses"])
def test_histogram_kernel_cpu_test_inputs(cuda_device, threshold, ids):
    # the inputs of tests/test_torch_histogram.py: ragged F=13, N=1000
    rng = np.random.default_rng(0)
    nclasses = 10 if ids == "classes" else 5
    hi = None if ids == "classes" else 255
    C = hist_matrix(rng, 13, 1000, nclasses, hi=hi)
    _check(torch.from_numpy(C).to(cuda_device), nclasses, threshold)


@pytest.mark.cuda
@pytest.mark.parametrize("F,N,nclasses,threshold", [
    (300, 1_000_003, 133, 0.5),
    (31, 4099, 254, 0.5),
])
def test_histogram_kernel_matches_plain(cuda_device, F, N, nclasses, threshold):
    _check(_random_c((F, N), nclasses, seed=F, device=cuda_device), nclasses, threshold)


@pytest.mark.cuda
def test_histogram_kernel_strided_rows(cuda_device):
    # rows `N + 1` bytes apart: the label lifter's trash column
    F, N = 17, 5000
    wide = _random_c((F, N + 1), 20, seed=3, device=cuda_device)
    got = th.histogram_classify(wide[:, :N], 20, 0.5)
    want = th.histogram_classify_reference(wide[:, :N].contiguous(), 20, 0.5)
    torch.cuda.synchronize()
    for w, g in zip((*want[0], want[1]), (*got[0], got[1])):
        assert torch.equal(w, g)


@pytest.mark.cuda
@pytest.mark.parametrize("F,N,nclasses,pitch_of,invalid", [
    (300, 5000, 133, "aligned", 0.85),  # the label lifter's layout, sparse
    (300, 5000, 133, "aligned", 0.10),  # and dense
    (300, 5000, 133, "odd", 0.85),  # rows N + 1 bytes apart: the byte kernel
    (301, 4099, 133, "aligned", 0.4),  # ragged rows and columns, tiled
    (301, 4099, 133, "contiguous", 0.4),  # and on an odd pitch
    (65535, 37, 3, "aligned", 0.1),  # the 16-bit counters' limit, a few columns
    (65535, 37, 3, "odd", 0.1),
    (9, 5, 10, "aligned", 0.3),  # fewer columns than one block
    (1, 1, 0, "aligned", 0.0),
    (13, 1000, 254, "aligned", 0.3),  # the most classes
    (24, 700, 10, "aligned", 0.9),
])
def test_histogram_kernel_layouts(cuda_device, F, N, nclasses, pitch_of, invalid):
    pitch = {"aligned": th.row_pitch(N + 1), "odd": N + 1 + (N % 2), "contiguous": N}[pitch_of]
    g = torch.Generator(device="cpu").manual_seed(F + N)
    wide = torch.randint(0, nclasses + 1, (F, pitch), generator=g, dtype=torch.int32)
    wide = torch.where(torch.rand((F, pitch), generator=g) < invalid, 255, wide).to(torch.uint8)
    wide[:, N // 2] = nclasses  # the last class wins a column
    wide[:, 0] = 255  # an empty column
    C = wide.to(cuda_device)[:, :N]
    assert C.stride(0) == pitch
    assert th.rows_aligned(C.data_ptr(), pitch, F) == (pitch_of == "aligned" or F == 1)
    _check(C, nclasses, 0.5)


@pytest.mark.cuda
def test_histogram_kernel_offset_base(cuda_device):
    # an aligned pitch behind a base pointer one byte off: the byte kernel
    F, N, nclasses = 40, 3000, 20
    pitch = th.row_pitch(N + 2)
    wide = _random_c((F, pitch), nclasses, seed=5, device=cuda_device)
    C = wide[:, 1:N + 1]
    assert C.data_ptr() % 16 == 1 and not th.rows_aligned(C.data_ptr(), pitch, F)
    _check(C, nclasses, 0.5)


@pytest.mark.cuda
def test_label_fuse_session_cuda_matches_cpu(cuda_device):
    # the whole slice on the card against the port on the CPU (which the
    # CPU tests hold exactly to JAX). cuBLAS may round the float32
    # projection differently from the CPU's matmul, moving a point across
    # a pixel edge, so classes are held to >= 0.999 agreement
    from fusion3dseg_tpu_torch.io.workload import make_workload
    from fusion3dseg_tpu_torch.ops.label_fuse import label_fuse_session

    hw = (64, 48)
    args = make_workload(30_000, 8, hw)
    before = th.histogram_classify.launches
    (tot_g, vmax_g), cls_g = label_fuse_session(*args, hw, device="cuda")
    assert th.histogram_classify.launches == before + 1
    (tot_c, vmax_c), cls_c = label_fuse_session(*args, hw, device="cpu")
    assert cls_g.device.type == "cuda"
    agree = (cls_g.cpu() == cls_c).double().mean().item()
    assert agree >= 0.999, agree
    assert (vmax_g.cpu() <= tot_g.cpu()).all()


# ---------------------------------------------------------------- attention

BF16_BAR, F32_BAR = 2e-2, 1e-4  # unit-normal inputs; outputs are O(1)


def _qkv(shape_q, shape_kv, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(device)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,D,M,dtype,route", [
    (8, 4096, 1, 64, 64, torch.bfloat16, "wgmma"),  # B2 stage 0 at 256x256
    (8, 1024, 2, 64, 64, torch.bfloat16, "wgmma"),  # B2 stage 1
    (2, 16384, 1, 64, 256, torch.bfloat16, "wgmma"),  # stage 0 at 512x512
    (1, 1000, 3, 32, 37, torch.float32, "f32"),  # ragged everything
    (2, 77, 2, 8, 5, torch.float32, "f32"),  # the smallest lane chunk
    (1, 512, 1, 128, 300, torch.bfloat16, "wgmma"),  # the largest head dim, M past 256
    (1, 300, 2, 24, 40, torch.bfloat16, "wgmma"),  # D between 64-column blocks: zero-filled
    (2, 700, 2, 64, 1, torch.bfloat16, "wgmma"),  # one key
    (1, 1000, 3, 64, 37, torch.bfloat16, "wgmma"),  # M, N off every tile: masked keys, clipped rows
    (2, 640, 1, 64, 200, torch.bfloat16, "wgmma"),  # two 128-key tiles, the last masked
    (1, 600, 2, 16, 100, torch.bfloat16, "wgmma"),  # one 128-key tile; 1/4 a power of two
    (3, 1000, 5, 64, 64, torch.bfloat16, "wgmma"),  # 240 tiles: runs cross (batch, head)
    (40, 64, 5, 64, 64, torch.bfloat16, "wgmma"),  # a tile per (batch, head)
    (16, 50, 5, 32, 37, torch.bfloat16, "wgmma"),  # and ragged, q rounded in shared memory
    (2, 1024, 2, 32, 64, torch.bfloat16, "wgmma"),  # D = 32
    (2, 1000, 1, 128, 64, torch.bfloat16, "wgmma"),  # D = 128: two column blocks
    (1, 2048, 2, 128, 256, torch.bfloat16, "wgmma"),  # and 256 keys: 4 tiles, 3 stages
    # keys in tiles of 128 (64 at D = 128): one key past two tiles; M where
    # the mma.sync kernel's shared memory gave out (849, 433); the ring
    # holding every key tile (up to 512 at D = 64) or streaming them (1024,
    # 2048, 4096; past 192 at D = 128)
    (2, 700, 2, 64, 257, torch.bfloat16, "wgmma"),
    (2, 640, 1, 64, 400, torch.bfloat16, "wgmma"),  # B2 stage 0 at 640x640
    (1, 1000, 3, 64, 849, torch.bfloat16, "wgmma"),
    (8, 1024, 8, 64, 1024, torch.bfloat16, "wgmma"),  # B2 stage 3 at 1024x1024
    (1, 777, 2, 64, 2048, torch.bfloat16, "wgmma"),  # ragged N
    (1, 512, 1, 64, 4096, torch.bfloat16, "wgmma"),
    (1, 600, 2, 128, 433, torch.bfloat16, "wgmma"),
    (2, 1000, 1, 128, 1024, torch.bfloat16, "wgmma"),
    (3, 450, 5, 32, 1000, torch.bfloat16, "wgmma"),  # items cross (batch, head); q rounded
    (2, 300, 2, 64, 363, torch.float32, "f32"),  # float32 K, V tiles: past the old limits
    (1, 1000, 2, 64, 1024, torch.float32, "f32"),
    (1, 200, 1, 128, 5000, torch.float32, "f32"),
    # head dims past 128: wgmma's third width (D <= 256), and D in chunks
    # with the output in column blocks (wgmma past 256, float32 past 128)
    (1, 777, 2, 160, 64, torch.bfloat16, "wgmma"), (1, 777, 2, 160, 64, torch.float32, "f32"),
    (2, 700, 1, 320, 256, torch.bfloat16, "wgmma"), (2, 700, 1, 320, 256, torch.float32, "f32"),
    # the wide instances at chip_smoke.py's shapes: DP = 192 (D = 160, 192),
    # DP = 320 (key tiles of 32); ragged N and M at both
    (8, 1024, 2, 160, 256, torch.bfloat16, "wgmma"), (8, 1024, 2, 192, 256, torch.bfloat16, "wgmma"),
    (8, 1024, 1, 320, 256, torch.bfloat16, "wgmma"), (8, 4096, 1, 320, 64, torch.bfloat16, "wgmma"),
    (3, 300, 2, 176, 129, torch.bfloat16, "wgmma"), (1, 1000, 1, 320, 300, torch.bfloat16, "wgmma"),
    (1, 999, 3, 288, 1000, torch.bfloat16, "wgmma"),
    # the float32 tile kernel past D = 128: D padded to 192 (129, 160), 256,
    # 320 (the re-headed B2's stage 2 at 512x512) and column chunks and
    # blocks of 320 past it (321, 512); N and M off every tile (64 queries,
    # 32 keys a unit), one key, 5000 keys
    (8, 1024, 1, 320, 256, torch.float32, "f32"), (1, 1000, 1, 129, 37, torch.float32, "f32"),
    (2, 333, 1, 321, 1, torch.float32, "f32"), (1, 200, 1, 320, 5000, torch.float32, "f32"),
    (1, 300, 2, 512, 77, torch.float32, "f32"), (3, 65, 1, 160, 1, torch.float32, "f32"),
    (1, 129, 2, 256, 33, torch.float32, "f32"), (2, 100, 1, 129, 5000, torch.float32, "f32"),
])
def test_sr_attention_kernel_matches_plain(cuda_device, B, N, H, D, M, dtype, route):
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((B, N, H, D), (B, M, H, D), dtype, cuda_device)
    assert attn._sr_route(q, k, v) == route
    before, on_route = attn.sr_attention.launches, attn.sr_attention.routes[route]
    got = attn.sr_attention(q, k, v)
    assert attn.sr_attention.launches == before + 1
    assert attn.sr_attention.routes[route] == on_route + 1
    want = attn.sr_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    bar = BF16_BAR if dtype == torch.bfloat16 else F32_BAR
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,D,M", [
    (8, 4096, 1, 64, 64), (8, 1024, 2, 64, 64), (2, 16384, 1, 64, 256), (1, 1000, 3, 32, 37),
])
def test_sr_attention_mma_kernel_on_wgmma_layouts(cuda_device, B, N, H, D, M):
    # the mma.sync kernel, named explicitly, on layouts _sr_route sends to wgmma
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((B, N, H, D), (B, M, H, D), torch.bfloat16, cuda_device)
    assert attn._sr_route(q, k, v) == "wgmma"
    before = attn.sr_attention.routes["mma"]
    got = attn.launch_sr_attention(q, k, v, "mma")
    assert attn.sr_attention.routes["mma"] == before + 1
    want = attn.sr_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= BF16_BAR


@pytest.mark.cuda
def test_sr_attention_kernel_reads_strides_and_refuses(cuda_device):
    from fusion3dseg_tpu_torch.ops import attention as attn

    # q, k, v as slices of one fused projection: token and head strides differ
    qkv = torch.randn((2, 640, 3, 2, 16), device=cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :40, 1], qkv[:, :40, 2]
    got = attn.sr_attention(q, k, v)
    want = attn.sr_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    assert (got - want).abs().max().item() <= F32_BAR
    # in bfloat16 the same slices are whole 16-byte pieces: the wgmma kernel
    fused = qkv.bfloat16()
    qb, kb, vb = fused[:, :, 0], fused[:, :40, 1], fused[:, :40, 2]
    assert attn._sr_route(qb, kb, vb) == "wgmma"
    got = attn.sr_attention(qb, kb, vb)
    want = attn.sr_attention_reference(qb.contiguous(), kb.contiguous(), vb.contiguous())
    assert (got.float() - want.float()).abs().max().item() <= BF16_BAR
    # a base 8 bytes off a 16-byte boundary: the mma kernel
    flat = torch.randn(4 + 2 * 300 * 64, device=cuda_device).bfloat16()
    qo = flat[4:].view(2, 300, 1, 64)
    kc, vc = (torch.randn((2, 40, 1, 64), device=cuda_device).bfloat16() for _ in range(2))
    assert qo.data_ptr() % 16 == 8 and attn._sr_route(qo, kc, vc) == "mma"
    before = attn.sr_attention.routes["mma"]
    got = attn.sr_attention(qo, kc, vc)
    assert attn.sr_attention.routes["mma"] == before + 1
    want = attn.sr_attention_reference(qo.contiguous(), kc, vc)
    assert (got.float() - want.float()).abs().max().item() <= BF16_BAR
    with pytest.raises(RuntimeError, match="forward only"):
        attn.sr_attention(q.clone().requires_grad_(True), k, v)
    # D = 256, which the kernels once refused, in both dtypes
    for dtype, bar in ((torch.float32, F32_BAR), (torch.bfloat16, BF16_BAR)):
        big = _qkv((1, 8, 1, 256), (1, 8, 1, 256), dtype, cuda_device)
        got = attn.sr_attention(*big)
        assert (got.float() - attn.sr_attention_reference(*big).float()).abs().max().item() <= bar
    # the mma.sync kernel's own domain is D <= 128: named above it, it refuses
    wide = torch.zeros((1, 8, 1, 160), device=cuda_device).bfloat16()
    with pytest.raises(ValueError, match="mma route takes D <= 128"):
        attn.launch_sr_attention(wide, wide, wide, "mma")
    # 5000 keys at D = 128 in float32: the key tiles stream (this raised
    # before K3 took any M)
    many = torch.randn((1, 5000, 1, 128), device=cuda_device)
    got = attn.sr_attention(many, many, many)
    want = attn.sr_attention_reference(many, many, many)
    assert (got - want).abs().max().item() <= F32_BAR
    # a layout TMA cannot describe, with more keys than the mma.sync kernel
    # holds: copied into a TMA layout for the wgmma kernel
    flat = torch.randn(4 + 1024 * 64, device=cuda_device).bfloat16()
    ko = flat[4:].view(1, 1024, 1, 64)
    qc = torch.randn((1, 700, 1, 64), device=cuda_device).bfloat16()
    assert not attn._mma_fits(1024, 64) and attn._sr_route(qc, ko, ko) == "wgmma"
    before = attn.sr_attention.routes["wgmma"]
    got = attn.sr_attention(qc, ko, ko)
    assert attn.sr_attention.routes["wgmma"] == before + 1
    want = attn.sr_attention_reference(qc, ko.contiguous(), ko.contiguous())
    assert (got.float() - want.float()).abs().max().item() <= BF16_BAR
    # and a head dim whose rows are not whole 16-byte pieces (D = 20)
    q20, k20 = (torch.randn((2, s, 2, 20), device=cuda_device).bfloat16() for s in (300, 2000))
    assert attn._sr_route(q20, k20, k20) == "wgmma"
    got = attn.sr_attention(q20, k20, k20)
    want = attn.sr_attention_reference(q20, k20, k20)
    assert got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= BF16_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,H,D,window,dtype", [
    (8, 64, 64, 1, 64, 7, torch.bfloat16),  # B2 stage 0 at 256x256
    (1, 9, 11, 2, 8, 5, torch.float32),  # a grid no tile divides
    (2, 16, 24, 2, 16, 5, torch.float32),
    (1, 20, 7, 1, 24, 3, torch.bfloat16),  # D between chunk sizes
    (1, 5, 5, 1, 128, 9, torch.bfloat16),  # the window wider than the image
    (2, 17, 19, 1, 64, 9, torch.bfloat16),
    (1, 12, 30, 2, 32, 13, torch.bfloat16),  # key slots that do not fill the last step
    (1, 13, 9, 1, 16, 13, torch.float32),
    (2, 10, 12, 2, 128, 5, torch.bfloat16),  # the largest head dim
    (1, 11, 10, 1, 20, 5, torch.bfloat16),  # D that rules out 16-byte copies
    (1, 9, 9, 3, 7, 3, torch.bfloat16),  # and 4-byte accesses
    (1, 9, 9, 3, 7, 3, torch.float32),
    (1, 6, 6, 1, 8, 1, torch.bfloat16),  # a window of the query alone
    # windows whose halo the kernel streams in chunks of rows
    (1, 16, 16, 1, 64, 15, torch.float32), (2, 17, 19, 1, 64, 15, torch.bfloat16),
    (1, 21, 18, 2, 128, 15, torch.bfloat16), (1, 21, 18, 2, 128, 15, torch.float32),
    (2, 64, 64, 1, 64, 23, torch.bfloat16), (2, 40, 37, 1, 64, 23, torch.float32),
    (1, 30, 27, 1, 128, 23, torch.bfloat16), (1, 30, 27, 1, 128, 23, torch.float32),
    (1, 12, 100, 1, 128, 63, torch.bfloat16),  # rows cut into column pieces
    (1, 9, 10, 1, 64, 63, torch.float32),  # the halo clamped far inside the window
    # head dims past 128: D in chunks, the output in column blocks
    (1, 13, 19, 2, 160, 7, torch.bfloat16), (1, 13, 19, 2, 160, 7, torch.float32),
    (1, 17, 16, 1, 320, 7, torch.bfloat16), (1, 17, 16, 1, 320, 7, torch.float32),
    # the bfloat16 wide kernel at chip_smoke.py's shapes; ragged grids at D =
    # 160 and 320; the chunk's scores online over the chunks (window 23); two
    # column blocks (D = 384)
    (8, 16, 16, 1, 320, 7, torch.bfloat16), (8, 16, 16, 1, 256, 7, torch.bfloat16),
    (2, 13, 21, 1, 320, 9, torch.bfloat16), (1, 9, 70, 1, 160, 41, torch.bfloat16),
    (1, 30, 27, 1, 320, 23, torch.bfloat16), (1, 33, 40, 2, 384, 11, torch.bfloat16),
    # the float32 wide kernel: the re-headed B2's stage 2 (16 x 16, D = 320),
    # D not a multiple of 4 (129: element copies), a halo streamed in bands
    # (window 23) and in row pieces (41, 63), two column blocks (384, 512,
    # 321), an image smaller than the window
    (8, 16, 16, 1, 320, 7, torch.float32), (1, 16, 16, 1, 129, 7, torch.float32),
    (1, 30, 27, 1, 320, 23, torch.float32), (1, 9, 70, 1, 160, 41, torch.float32),
    (1, 33, 40, 2, 384, 11, torch.float32), (1, 12, 30, 1, 512, 15, torch.float32),
    (2, 13, 21, 1, 321, 9, torch.float32), (1, 5, 3, 1, 200, 63, torch.float32),
])
def test_neighborhood_attention_kernel_matches_plain(cuda_device, B, h, w, H, D, window, dtype):
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((B, h * w, H, D), (B, h * w, H, D), dtype, cuda_device)
    before = attn.neighborhood_attention.launches
    got = attn.neighborhood_attention(q, k, v, h, w, window)
    assert attn.neighborhood_attention.launches == before + 1
    want = attn.neighborhood_attention_reference(q, k, v, h, w, window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    bar = BF16_BAR if dtype == torch.bfloat16 else F32_BAR
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_neighborhood_attention_kernel_reads_strides_and_refuses(cuda_device, dtype):
    from fusion3dseg_tpu_torch.ops import attention as attn

    # q, k, v as slices of one fused projection: token and head strides
    # differ from the shapes', the bases are offset
    h, w, window = 24, 20, 7
    qkv = torch.randn((2, h * w, 3, 3, 32), device=cuda_device).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = attn.neighborhood_attention.launches
    got = attn.neighborhood_attention(q, k, v, h, w, window)
    assert attn.neighborhood_attention.launches == before + 1
    want = attn.neighborhood_attention_reference(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), h, w, window)
    bar = BF16_BAR if dtype == torch.bfloat16 else F32_BAR
    assert (got.float() - want.float()).abs().max().item() <= bar
    # window 41 at D = 128, whose halo once exceeded a block's shared memory
    # (the launch was refused), streams it now and agrees
    big = _qkv((1, 64, 1, 128), (1, 64, 1, 128), dtype, cuda_device)
    got = attn.neighborhood_attention(*big, 8, 8, 41)
    want = attn.neighborhood_attention_reference(*big, 8, 8, 41)
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("sr f32", torch.float32), ("sr wgmma", torch.bfloat16), ("sr mma", torch.bfloat16),
    ("nat", torch.float32), ("nat", torch.bfloat16)])
def test_attention_kernels_take_any_batch_heads(cuda_device, kernel, dtype):
    # batch x heads past the 65,535 a grid axis holds
    from fusion3dseg_tpu_torch.ops import attention as attn

    def fn(*t):
        if kernel == "nat":
            return attn.neighborhood_attention(*t, 4, 4, 3)
        return attn.launch_sr_attention(*t, kernel.split()[1])

    if kernel == "nat":
        q, k, v = _qkv((65537, 16, 1, 8), (65537, 16, 1, 8), dtype, cuda_device)
        want = attn.neighborhood_attention_reference(q, k, v, 4, 4, 3)
    else:
        q, k, v = _qkv((65537, 16, 1, 16), (65537, 64, 1, 16), dtype, cuda_device)
        want = attn.sr_attention_reference(q, k, v)
    got = fn(q, k, v)
    torch.cuda.synchronize()
    bar = BF16_BAR if dtype == torch.bfloat16 else F32_BAR
    assert (got.float() - want.float()).abs().max().item() <= bar
    # a pair's output does not depend on how many pairs share the call
    parts = [fn(q[s], k[s], v[s]) for s in (slice(0, 65535), slice(65535, None))]
    assert torch.equal(got, torch.cat(parts))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sr", "nat"])
def test_wide_kernels_take_any_batch_heads(cuda_device, kernel):
    # 65,537 (batch, head) pairs at D = 320 in bfloat16: K3's DP = 320
    # instance and K2's wide kernel. On a 2 x 2 image every window of 3 holds
    # all four tokens, so both compute dense attention; each is held to the
    # exact attention of the same inputs (float64, p unrounded) within
    # BF16_BAR, to its plain version within BF16_BAR or two bfloat16 steps of
    # the output (a step is 2^-5, past the bar, at |o| >= 4), and a pair's
    # output does not depend on how many pairs share the call
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((65537, 4, 1, 320), (65537, 4, 1, 320), torch.bfloat16, cuda_device, seed=3)
    if kernel == "sr":
        fn, ref = attn.sr_attention, attn.sr_attention_reference
    else:
        fn = lambda *t: attn.neighborhood_attention(*t, 2, 2, 3)
        ref = lambda *t: attn.neighborhood_attention_reference(*t, 2, 2, 3)
    got = fn(q, k, v)
    parts = torch.cat([fn(q[s], k[s], v[s]) for s in (slice(0, 65535), slice(65535, None))])
    torch.cuda.synchronize()
    assert torch.equal(got, parts)
    got, plain = got.double(), ref(q, k, v).double()
    scores = torch.einsum("bnhd,bmhd->bhnm", attn._scaled(q).double(), k.double())
    exact = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, -1), v.double())
    assert (got - exact).abs().max().item() <= BF16_BAR
    big = torch.maximum(got.abs(), plain.abs()).clamp_min(2.0 ** -126)
    steps = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert ((got - plain).abs() <= torch.maximum(2 * steps, torch.tensor(BF16_BAR))).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sr", "nat"])
def test_f32_kernels_take_any_batch_heads_past_128(cuda_device, kernel):
    # 65,537 (batch, head) pairs in float32 past D = 128: K3's tile kernel
    # at D = 160 (8 keys), K2's wide kernel at D = 129 (element copies) on
    # a 4 x 4 image; a pair's output does not depend on how many pairs
    # share the call
    from fusion3dseg_tpu_torch.ops import attention as attn

    if kernel == "sr":
        q, k, v = _qkv((65537, 16, 1, 160), (65537, 8, 1, 160), torch.float32, cuda_device)
        fn, ref = attn.sr_attention, attn.sr_attention_reference
    else:
        q, k, v = _qkv((65537, 16, 1, 129), (65537, 16, 1, 129), torch.float32, cuda_device)
        fn = lambda *t: attn.neighborhood_attention(*t, 4, 4, 3)
        ref = lambda *t: attn.neighborhood_attention_reference(*t, 4, 4, 3)
    got = fn(q, k, v)
    parts = torch.cat([fn(q[s], k[s], v[s]) for s in (slice(0, 65535), slice(65535, None))])
    torch.cuda.synchronize()
    assert torch.equal(got, parts)
    assert (got - ref(q, k, v)).abs().max().item() <= F32_BAR


@pytest.mark.cuda
def test_f32_kernel_plans_and_registers(cuda_device):
    # the launchers' float32 instances against their mirrors in
    # ops/attention.py, and no float32 kernel spills
    import ctypes

    from fusion3dseg_tpu_torch import cuda
    from fusion3dseg_tpu_torch.ops import attention as attn

    shape_fn = cuda.load("sr_attention").f3s_sr_f32_shape
    shape_fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    got = (ctypes.c_int64 * 4)()
    for D in range(1, 700):
        assert shape_fn(D, got) == 0 and tuple(got) == tuple(attn._sr_f32_shape(D)), D
    plan_fn = cuda.load("neighborhood_attention").f3s_nat_plan
    plan_fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)]
    plan = (ctypes.c_int64 * 4)()
    for D in (7, 64, 128, 129, 320, 512):
        for window in range(1, 128, 2):
            for width in (1, 5, 9, 16, 17, 64, 70, 256):
                assert plan_fn(0, window, D, width, plan) == 0
                assert tuple(plan) == tuple(attn._nat_plan(window, D, torch.float32, width))
    for lib, names in (("sr_attention", [f"f32_tile_{dp}" for dp in (64, 128, 192, 256, 320)]),
                       ("neighborhood_attention", ["f32_wide", "f32_16"])):
        fn = getattr(cuda.load(lib), "f3s_sr_resources" if lib == "sr_attention"
                     else "f3s_nat_resources")
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        for name in names:
            out = (ctypes.c_int * 4)()
            assert fn(name.encode(), out) == 0, name
            assert out[1] == 0, f"{name}: {out[1]} bytes of local memory a thread"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "mma"])
@pytest.mark.parametrize("N,M,D,seed", [(16, 16, 8, 0), (16, 8, 8, 0), (64, 64, 64, 0),
                                        (16, 8, 8, 13)])
def test_sr_attention_batch_heads_against_exact(cuda_device, route, N, M, D, seed):
    # 65,537 pairs in bfloat16, held to the exact attention of the same
    # inputs (float64, p unrounded) within BF16_BAR, as the plain version is.
    # The plain version rounds normalised p, the one-pass wgmma kernel p
    # before the division by the row sum, and each rounds its output once:
    # the two may land on neighbouring bfloat16 values, and a step is 2^-5,
    # past BF16_BAR, at |o| >= 4 (seed 13, drawn on the card, has such an
    # output). So the two are held within BF16_BAR or two steps of the
    # output's magnitude
    from fusion3dseg_tpu_torch.ops import attention as attn

    if seed:
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g, device=cuda_device).bfloat16()
                   for s in ((65537, N, 1, D), (65537, M, 1, D), (65537, M, 1, D)))
    else:
        q, k, v = _qkv((65537, N, 1, D), (65537, M, 1, D), torch.bfloat16, cuda_device)
    got = attn.launch_sr_attention(q, k, v, route).double()
    plain = attn.sr_attention_reference(q, k, v).double()
    scores = torch.einsum("bnhd,bmhd->bhnm", attn._scaled(q).double(), k.double())
    exact = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, -1), v.double())
    assert (plain - exact).abs().max().item() <= BF16_BAR
    assert (got - exact).abs().max().item() <= BF16_BAR
    big = torch.maximum(got.abs(), plain.abs()).clamp_min(2.0 ** -126)
    steps = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert ((got - plain).abs() <= torch.maximum(2 * steps, torch.tensor(BF16_BAR))).all()


# float16 takes the bfloat16 kernels' float16 instances. BF16_BAR assumes
# outputs below 4, where a bfloat16 step is at most 2^-6 (the bar about 1.3
# steps); float16 has three more bits, so F16_BAR is 1.3 float16 steps there
# (2^-9 each): 2.5e-3. The one-pass wgmma kernel rounds p before dividing
# by the row sum, the plain version the normalised p, and each rounds its
# output once: the two may land on neighbouring float16 values, so they are
# held within F16_BAR or two steps of the output's magnitude, and each
# within the same of the exact attention of the same inputs (float64, q *
# scale rounded as the kernels round it, p unrounded).
F16_BAR = 2.5e-3


def _f16_close(got, want):
    """|got - want| within F16_BAR or two float16 steps of their magnitude,
    everywhere."""
    got, want = got.double(), want.double()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -14)
    steps = torch.exp2(torch.floor(torch.log2(big)) - 10)
    return bool(((got - want).abs() <= torch.maximum(2 * steps, torch.tensor(F16_BAR))).all())


def _sr_exact(q, k, v):
    from fusion3dseg_tpu_torch.ops import attention as attn

    scores = torch.einsum("bnhd,bmhd->bhnm", attn._scaled(q).double(), k.double())
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, -1), v.double())


def _nat_exact(q, k, v, h, w, window):
    """float64 windowed attention (dense, masked to the window)."""
    from fusion3dseg_tpu_torch.ops import attention as attn

    r = window // 2
    iy, ix = torch.arange(h, device=q.device), torch.arange(w, device=q.device)
    near = ((iy[:, None] - iy[None, :]).abs() <= r)[:, None, :, None] & \
        ((ix[:, None] - ix[None, :]).abs() <= r)[None, :, None, :]
    scores = torch.einsum("bnhd,bmhd->bhnm", attn._scaled(q).double(), k.double())
    scores = scores.masked_fill(~near.reshape(h * w, h * w), float("-inf"))
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, -1), v.double())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,D,M,route", [
    (8, 4096, 1, 64, 64, "wgmma"),  # B2 stage 0 at 256x256: wgmma on the tensors
    (8, 1024, 2, 64, 64, "wgmma"),  # B2 stage 1
    (1, 1000, 3, 32, 37, "wgmma"),  # ragged N, M; q rounded in shared memory
    (2, 700, 2, 64, 257, "wgmma"),  # keys in tiles, the last masked
    (1, 777, 2, 64, 2048, "wgmma"),  # key tiles streamed
    (1, 300, 2, 20, 40, "mma"),  # rows not whole 16-byte pieces: mma.sync
    (1, 300, 2, 20, 2000, "wgmma"),  # past mma.sync's keys: wgmma on copies
    (8, 1024, 2, 160, 256, "wgmma"),  # DP = 192
    (8, 4096, 1, 256, 64, "wgmma"),  # DP = 256
    (8, 1024, 1, 320, 256, "wgmma"),  # DP = 320, key tiles of 32
    (1, 999, 3, 384, 300, "wgmma"), (1, 600, 1, 512, 100, "wgmma"),  # past 320: column blocks
])
def test_sr_attention_float16_kernels(cuda_device, B, N, H, D, M, route):
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((B, N, H, D), (B, M, H, D), torch.float16, cuda_device)
    assert attn._sr_route(q, k, v) == route
    before, on_route = attn.sr_attention.launches, attn.sr_attention.routes[route]
    got = attn.sr_attention(q, k, v)
    assert attn.sr_attention.launches == before + 1
    assert attn.sr_attention.routes[route] == on_route + 1
    plain, exact = attn.sr_attention_reference(q, k, v), _sr_exact(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and got.shape == plain.shape
    assert torch.isfinite(got).all()
    assert _f16_close(got, plain) and _f16_close(got, exact) and _f16_close(plain, exact)
    if attn._mma_fits(M, D) and route == "wgmma":  # the mma.sync instance, named
        assert _f16_close(attn.launch_sr_attention(q, k, v, "mma"), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,h,w,H,D,window", [
    (8, 64, 64, 1, 64, 7),  # B2 stage 0 at 256x256: the halo staged once
    (2, 64, 64, 1, 64, 23),  # the halo streamed in bands
    (1, 12, 100, 1, 128, 63),  # rows cut into column pieces
    (1, 9, 11, 3, 7, 3),  # element copies, no 4-byte accesses
    (8, 16, 16, 1, 320, 7),  # the wide kernel, the window's score rows
    (1, 30, 27, 1, 320, 23),  # the wide kernel, the chunk's scores online
    (1, 33, 40, 2, 384, 11),  # two column blocks
])
def test_neighborhood_attention_float16_kernels(cuda_device, B, h, w, H, D, window):
    # K2 keeps p float32-grade (a high part and a remainder, both float16):
    # held to the plain version and to the exact attention as K3 is
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((B, h * w, H, D), (B, h * w, H, D), torch.float16, cuda_device)
    before = attn.neighborhood_attention.launches
    got = attn.neighborhood_attention(q, k, v, h, w, window)
    assert attn.neighborhood_attention.launches == before + 1
    plain = attn.neighborhood_attention_reference(q, k, v, h, w, window)
    exact = _nat_exact(q, k, v, h, w, window)
    torch.cuda.synchronize()
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    assert _f16_close(got, plain) and _f16_close(got, exact) and _f16_close(plain, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sr wgmma", "sr mma", "nat", "sr wide", "nat wide"])
def test_float16_kernels_take_any_batch_heads(cuda_device, kernel):
    # 65,537 (batch, head) pairs in float16: each kernel held to its plain
    # version and to the exact attention, and a pair's output does not depend
    # on how many pairs share the call. "wide": D = 320 (K3's DP = 320
    # instance, K2's wide kernel) on a 2 x 2 image, where window 3 holds
    # every token
    from fusion3dseg_tpu_torch.ops import attention as attn

    if kernel.startswith("nat"):
        hw, D = ((2, 2), 320) if kernel == "nat wide" else ((4, 4), 8)
        q, k, v = _qkv((65537, hw[0] * hw[1], 1, D), (65537, hw[0] * hw[1], 1, D),
                       torch.float16, cuda_device)
        fn = lambda *t: attn.neighborhood_attention(*t, *hw, 3)
        plain = attn.neighborhood_attention_reference(q, k, v, *hw, 3)
        exact = _nat_exact(q, k, v, *hw, 3)
    else:
        shapes = ((65537, 4, 1, 320), (65537, 4, 1, 320)) if kernel == "sr wide" else \
            ((65537, 16, 1, 16), (65537, 64, 1, 16))
        q, k, v = _qkv(*shapes, torch.float16, cuda_device)
        route = "mma" if kernel == "sr mma" else "wgmma"
        fn = lambda *t: attn.launch_sr_attention(*t, route)
        plain, exact = attn.sr_attention_reference(q, k, v), _sr_exact(q, k, v)
    got = fn(q, k, v)
    parts = torch.cat([fn(q[s], k[s], v[s]) for s in (slice(0, 65535), slice(65535, None))])
    torch.cuda.synchronize()
    assert torch.equal(got, parts)
    assert _f16_close(got, plain) and _f16_close(got, exact)


@pytest.mark.cuda
def test_float16_launches_a_float16_kernel_only(cuda_device, monkeypatch):
    # a float16 CUDA call launches a float16 kernel (dtype code 2, every
    # tensor handed to it float16), adds one to its count, and never runs
    # the plain version or casts to another dtype
    from fusion3dseg_tpu_torch.ops import attention as attn

    plain_calls, launched = [], []
    real = attn._launch

    def spy(fn_name, lib, tensors, out, ints):
        launched.append((fn_name, {t.dtype for t in (*tensors, out)}, ints))
        return real(fn_name, lib, tensors, out, ints)

    monkeypatch.setattr(attn, "_launch", spy)
    monkeypatch.setattr(attn, "sr_attention_reference", lambda *a: plain_calls.append(a))
    monkeypatch.setattr(attn, "neighborhood_attention_reference",
                        lambda *a: plain_calls.append(a))
    flat = torch.randn(4 + 300 * 64, device=cuda_device).half()
    cases = [("wgmma", _qkv((1, 300, 2, 64), (1, 40, 2, 64), torch.float16, cuda_device)),
             ("mma", (flat[4:].view(1, 300, 1, 64), *_qkv((1, 300, 1, 64), (1, 40, 1, 64),
                                                        torch.float16, cuda_device)[1:])),
             ("wgmma", _qkv((1, 300, 2, 20), (1, 2000, 2, 20), torch.float16, cuda_device)),
             ("wgmma", _qkv((1, 300, 1, 320), (1, 40, 1, 320), torch.float16, cuda_device))]
    for route, (q, k, v) in cases:
        before, on_route = attn.sr_attention.launches, attn.sr_attention.routes[route]
        assert attn._sr_route(q, k, v) == route
        assert attn.sr_attention(q, k, v).dtype == torch.float16
        assert (attn.sr_attention.launches, attn.sr_attention.routes[route]) == \
            (before + 1, on_route + 1)
    for D in (64, 320):
        q, k, v = _qkv((1, 64, 1, D), (1, 64, 1, D), torch.float16, cuda_device)
        before = attn.neighborhood_attention.launches
        assert attn.neighborhood_attention(q, k, v, 8, 8, 7).dtype == torch.float16
        assert attn.neighborhood_attention.launches == before + 1
    torch.cuda.synchronize()
    assert plain_calls == []
    assert len(launched) == 6 and all(dts == {torch.float16} for _, dts, _ in launched)
    codes = [ints[1] if name == "f3s_sr_attention" else ints[0] for name, _, ints in launched]
    assert codes == [attn._DTYPES[torch.float16]] * 6 == [2] * 6


@pytest.mark.cuda
def test_float16_plans_and_registers(cuda_device):
    # float16's wgmma instances equal bfloat16's, K2's plans likewise, and
    # no float16 instance spills more than its bfloat16 twin
    import ctypes

    from fusion3dseg_tpu_torch import cuda
    from fusion3dseg_tpu_torch.ops import attention as attn

    shape_fn = cuda.load("sr_attention").f3s_sr_shape
    shape_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int64)]
    got = (ctypes.c_int64 * 5)()
    for D in range(1, 513, 7):
        for M in (1, 64, 65, 1024):
            for code in (1, 2):
                assert shape_fn(code, D, M, got) == 0
                assert tuple(got) == tuple(attn._sr_shape(D, M)), (code, D, M)
    assert shape_fn(0, 64, 64, got) == -3
    plan_fn = cuda.load("neighborhood_attention").f3s_nat_plan
    plan_fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int64)]
    plan = (ctypes.c_int64 * 4)()
    for D in (7, 64, 128, 129, 320, 512):
        for window in range(1, 64, 2):
            for width in (1, 5, 9, 16, 17, 64, 70, 256):
                assert plan_fn(2, window, D, width, plan) == 0
                assert tuple(plan) == tuple(attn._nat_plan(window, D, torch.float16, width))
    for lib, fn_name, names in (
            ("sr_attention", "f3s_sr_resources",
             [f"wgmma_{s}" for s in ("64_64", "64_128", "128_64", "192_64", "256_64", "320_32")]
             + ["wide", "mma_16", "mma_32", "mma_64", "mma_128"]),
            ("neighborhood_attention", "f3s_nat_resources",
             ["mma_wide", "mma_wide_online", "mma_1", "mma_2", "mma_3", "mma_4"])):
        fn = getattr(cuda.load(lib), fn_name)
        fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        for name in names:
            bf, f16 = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
            assert fn(name.encode(), bf) == 0 and fn(f"{name}_f16".encode(), f16) == 0, name
            assert f16[1] <= bf[1], f"{name}_f16: {f16[1]} bytes of local memory a thread"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_neighborhood_attention_backward(cuda_device, dtype):
    from fusion3dseg_tpu_torch.ops import attention as attn

    h, w, window = 9, 11, 5
    qkv = _qkv((2, h * w, 2, 8), (2, h * w, 2, 8), dtype, cuda_device)
    wgt = torch.randn(qkv[0].shape, device=cuda_device)
    grads = []
    for fn in (attn.neighborhood_attention, attn.neighborhood_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        (fn(*leaves, h, w, window).float() * wgt).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, p in zip(*grads):
        assert g.dtype == dtype
        assert (g.float() - p.float()).abs().max().item() <= (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"use_pallas_attention": True}, {"nat_windows": (5, 0, 0, 0)},
                                {"b2": True, "use_pallas_attention": True}],
                         ids=["sr_kernel", "nat_kernel", "b2_1024"])
def test_segmenter_cuda_matches_cpu(cuda_device, kw):
    # the segmenter on the card (through the kernels) against the port on
    # the CPU (which the CPU tests hold to JAX), float32: a tiny config at
    # 128x128 so that stage 0 has N = 1024 and takes the fused branch; and
    # the shipped B2 at 1024x1024, where every stage has 1024 keys and all
    # 16 blocks take the kernel
    import dataclasses

    from fusion3dseg_tpu_torch.io.synthetic import make_session
    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    kw = dict(kw)
    frames = make_session(nframes=2, depth_hw=(48, 36), appearance="textured").colors
    counter = attn.sr_attention if "use_pallas_attention" in kw else attn.neighborhood_attention
    before = counter.launches
    if kw.pop("b2", False):
        cfg = dataclasses.replace(SegFormerConfig.b2(), dtype=torch.float32, **kw)
        ckpt = convert.shipped_checkpoint("b2")
        on_card, on_cpu = (Segmenter2D(cfg, ckpt, input_hw=(1024, 1024), batch_size=2,
                                       device=dev) for dev in ("cuda", "cpu"))
        got = on_card.predict_batch(frames, 0.0)
        assert counter.launches == before + 16  # 3 + 4 + 6 + 3 blocks, each M = 1024
        agree = (got == on_cpu.predict_batch(frames, 0.0)).mean()
        assert agree >= 0.999, agree
        return
    cfg = SegFormerConfig(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 3, 4), decoder_dim=32, dtype=torch.float32, **kw)
    on_card = Segmenter2D(cfg, input_hw=(128, 128), batch_size=2, seed=0, device="cuda")
    on_cpu = Segmenter2D(cfg, input_hw=(128, 128), batch_size=2, seed=0, device="cpu")
    x = on_cpu._model_input(frames)
    assert torch.equal(on_card._model_input(frames).cpu(), x)
    lc = on_cpu._logits_sem_conf(x, 0.0, (48, 36))[0]
    # PyTorch's default flags: the float32 model turns cuDNN's TF32 off for
    # its forward (TF32 alone moved these logits by 9.45e-4 and 1.08e-3 on an
    # H100; 8e-7 without it) and on again after it
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        lg = on_card._logits_sem_conf(x.cuda(), 0.0, (48, 36))[0].cpu()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert counter.launches == before + 1
    assert (lg - lc).abs().max().item() <= 1e-3
    agree = (on_card.predict_batch(frames, 0.0) == on_cpu.predict_batch(frames, 0.0)).mean()
    assert agree >= 0.98, agree


@pytest.mark.cuda
def test_float32_reheaded_b2_segmenter_cuda_matches_cpu(cuda_device):
    # the float32 path of K3's tile kernel: the shipped B2 with
    # num_heads=(1, 1, 1, 2) (head dims 64, 128, 320, 256; the attention
    # weights do not depend on the heads) in float32 at 512x512, where
    # stage 2 runs K3 at [2,1024,1,320]x256; every launch takes the float32
    # route; masks and logits against the port on the CPU
    import dataclasses

    from fusion3dseg_tpu_torch.io.synthetic import make_session
    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    frames = make_session(nframes=2, depth_hw=(48, 36), appearance="textured").colors
    cfg = dataclasses.replace(SegFormerConfig.b2(), dtype=torch.float32, num_heads=(1, 1, 1, 2),
                              use_pallas_attention=True)
    ckpt = convert.shipped_checkpoint("b2")
    on_card, on_cpu = (Segmenter2D(cfg, ckpt, input_hw=(512, 512), batch_size=2, device=dev)
                       for dev in ("cuda", "cpu"))
    attn.reset_sr_counts()
    got = on_card.predict_batch(frames, 0.0)
    assert attn.sr_attention.launches == attn.sr_attention.routes["f32"] == 13
    agree = (got == on_cpu.predict_batch(frames, 0.0)).mean()
    assert agree >= 0.999, agree
    x = on_cpu._model_input(frames)
    lc = on_cpu._logits_sem_conf(x, 0.0, (48, 36))[0]
    lg = on_card._logits_sem_conf(x.cuda(), 0.0, (48, 36))[0].cpu()
    assert (lg - lc).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"use_pallas_attention": True}, {"nat_windows": (7, 0, 0, 0)}],
                         ids=["sr_kernel", "nat_kernel"])
def test_float16_snapshot_segmenter_on_card(cuda_device, tmp_path, kw):
    # a snapshot whose metadata says "float16": the shipped B1's weights (less
    # stage 0's reduction for the neighbourhood stage) with that config, at
    # 128x128 (stage 0: 1024 tokens, two blocks). Segmenter2D reads the config
    # from the file and runs K3 (or K2) on the card, two launches a forward;
    # masks against the port on the CPU (which tests/test_torch_float16.py
    # holds to the JAX package)
    import dataclasses

    from fusion3dseg_tpu_torch.io.synthetic import make_session
    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    frames = make_session(nframes=2, depth_hw=(96, 72), appearance="textured").colors
    flat = convert.flatten_params(convert.load_params_npz(convert.shipped_checkpoint("b1")))
    if "nat_windows" in kw:
        flat = {k: v for k, v in flat.items() if not (k.startswith("stage0_") and (
            "/sr/" in k or "EfficientAttention_0/LayerNorm_0" in k))}
    cfg = dataclasses.replace(SegFormerConfig.b1(), dtype=torch.float16, **kw)
    path = tmp_path / "b1_float16.npz"
    convert.save_params_npz(path, flat, input_hw=(128, 128), config=cfg)
    on_card, on_cpu = (Segmenter2D(checkpoint_dir=path, batch_size=2, device=dev)
                       for dev in ("cuda", "cpu"))
    assert on_card.config == cfg and on_card.input_hw == (128, 128)
    counter = attn.sr_attention if "use_pallas_attention" in kw else attn.neighborhood_attention
    before = counter.launches
    got = on_card.predict_batch(frames)
    assert counter.launches == before + 2
    agree = (got == on_cpu.predict_batch(frames)).mean()
    assert agree >= 0.999, agree


# ------------------------------------------------------------ fusion engine


def _fusion_session(device, nframes=16, **kw):
    from fusion3dseg_tpu_torch.io.rtab import SessionData
    from fusion3dseg_tpu_torch.io.synthetic import RoomSpec, make_session

    sess = make_session(nframes=nframes, depth_hw=(48, 36), room=RoomSpec(seed=21), **kw)
    sd = SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                 sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                 device=device)
    return sess, sd


def _fuse(sd, device, **kw):
    from fusion3dseg_tpu_torch.fusion import fuse_session

    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    return fuse_session(sd.Ks, sd.quats_wxyz, sd.translations, sd.points, sd.normals, sd.colors,
                        valid, height=48, width=36, radius=0.1,
                        min_cosine=float(np.cos(np.deg2rad(25.0))), max_depth=8.0,
                        capacity=1 << 14, with_stats=True, device=device, **kw)


@pytest.mark.cuda
def test_voxel_merge_cuda_matches_cpu(cuda_device):
    from fusion3dseg_tpu_torch.ops.sparsify import voxel_merge

    rng = np.random.default_rng(0)
    n = 200_000
    pts = (rng.random((n, 3)) * 4).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    arrays = (pts, nrm, rng.random((n, 3)).astype(np.float32),
              rng.integers(1, 5, n).astype(np.int32), rng.integers(1, 3, n).astype(np.int32),
              rng.random(n) < 0.9)
    for extent in (None, 128):
        on_cpu = voxel_merge(*map(torch.from_numpy, arrays), 0.05, 0.5, extent_cells=extent)
        on_card = [voxel_merge(*(torch.from_numpy(a).to(cuda_device) for a in arrays), 0.05,
                               0.5, extent_cells=extent) for _ in range(2)]
        for name in ("counts", "occurences", "cell_of_input"):
            assert torch.equal(getattr(on_card[0], name).cpu(), getattr(on_cpu, name)), name
        for name in ("points", "normals", "colors", "counts", "cell_of_input"):
            assert torch.equal(getattr(on_card[0], name), getattr(on_card[1], name)), name
            if name in ("points", "normals", "colors"):
                diff = (getattr(on_card[0], name).cpu() - getattr(on_cpu, name)).abs().max()
                assert diff.item() <= 1e-6, name


@pytest.mark.cuda
@pytest.mark.parametrize("window,policy", [(None, "newest"), (1024, "split")])
def test_fuse_session_cuda_matches_cpu(cuda_device, window, policy):
    from fusion3dseg_tpu_torch.ops.voting import vote_and_classify

    sess, sd_cpu = _fusion_session("cpu")
    _, sd_card = _fusion_session("cuda")
    cpu = _fuse(sd_cpu, "cpu", window=window, window_policy=policy)
    card = [_fuse(sd_card, "cuda", window=window, window_policy=policy) for _ in range(2)]
    # two runs on the card: the same bits
    for a, b in zip((*card[0][0], card[0][1], card[0][2]), (*card[1][0], card[1][1], card[1][2])):
        assert torch.equal(a, b)
    n_cpu, n_card = int(cpu[0].n), int(card[0][0].n)
    assert abs(n_card - n_cpu) <= 0.01 * n_cpu
    spans_cpu, spans_card = cpu[2].numpy(), card[0][2].cpu().numpy()
    assert np.abs(spans_card - spans_cpu).max() <= 0.01 * spans_cpu.max()
    masks = torch.as_tensor(sess.gt_mask.reshape(16, -1))
    pix = []
    for state, uv2pt, _ in (cpu, card[0]):
        _, cls = vote_and_classify(uv2pt, masks.to(uv2pt.device), 1 << 14, 133,
                                   device=uv2pt.device)
        uv = uv2pt.cpu()
        pix.append(torch.where(uv >= 0, cls.cpu()[uv.clamp(min=0).long()], -1))
    both = (pix[0] >= 0) & (pix[1] >= 0)
    assert (pix[0][both] == pix[1][both]).double().mean().item() >= 0.999


@pytest.mark.cuda
def test_segment_session_fast_cuda_matches_cpu(cuda_device, tmp_path):
    from fusion3dseg_tpu_torch.io import native
    from fusion3dseg_tpu_torch.pipeline.fast import segment_session_fast

    sess, sd_cpu = _fusion_session("cpu", nframes=16, turns=2.0)
    _, sd_card = _fusion_session("cuda", nframes=16, turns=2.0)
    kw = dict(radius=0.1, angle=25.0, capacity=1 << 14, window=1024, min_pts_per_inst=20)
    cpu = segment_session_fast(sd_cpu, masks=sess.gt_mask, device="cpu", **kw)
    card = [segment_session_fast(sd_card, masks=sess.gt_mask, device="cuda", **kw)
            for _ in range(2)]
    assert card[0].overflow_frames > 0 and card[0].state.points.device.type == "cuda"
    assert abs(card[0].n - cpu.n) <= 0.01 * cpu.n
    assert card[0].n == card[1].n
    assert np.array_equal(card[0].classes, card[1].classes)
    assert np.array_equal(card[0].instance_ids, card[1].instance_ids)
    assert torch.equal(card[0].uv2pt, card[1].uv2pt)
    uc, ug = cpu.uv2pt.numpy(), card[0].uv2pt.cpu().numpy()
    both = (uc >= 0) & (ug >= 0)
    assert (cpu.classes[uc[both]] == card[0].classes[ug[both]]).mean() >= 0.999
    assert {i["category_id"] for i in card[0].instance_info} == \
        {i["category_id"] for i in cpu.instance_info}
    # the native library was built into the port's build directory
    from fusion3dseg_tpu_torch import cuda

    assert native.library_path().parent == cuda.build_dir() and native.library_path().exists()


@pytest.mark.cuda
def test_file_path_cuda_matches_cpu(cuda_device, tmp_path):
    import json
    import pickle

    from fusion3dseg_tpu_torch.io import synthetic
    from fusion3dseg_tpu_torch.pipeline import get3dseg, process3d

    sess = synthetic.make_session(nframes=16, depth_hw=(48, 36), turns=2.0,
                                  room=synthetic.RoomSpec(seed=0), appearance="textured")
    src = synthetic.write_session_dir(sess, tmp_path / "session")
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card0", "cuda"), ("card1", "cuda")):
        out = tmp_path / name
        process3d.process3DSeg(src, out, radius=0.1, device=dev)
        get3dseg.segment(out, src / "masks", verbose=False, device=dev)
        runs[name] = out

    def arrays(out):
        with open(out / "fusion" / "fusion_data.pkl", "rb") as fp:
            data = pickle.load(fp)
        uv = np.stack([np.load(out / "fusion" / "uv2pt" / f"{i}.npy") for i in range(16)])
        return (data, uv, np.load(out / "segmentation" / "classes.npy"),
                np.load(out / "panoptic_segmentation" / "ids.npy"),
                json.loads((out / "panoptic_segmentation" / "final_info.json").read_text()))

    cpu, c0, c1 = (arrays(runs[k]) for k in ("cpu", "card0", "card1"))
    # two card runs: the same bits
    for k, v in c0[0].items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, c1[0][k]) and not isinstance(v, torch.Tensor), k
    for a, b in zip(c0[1:4], c1[1:4]):
        assert np.array_equal(a, b)
    assert c0[4] == c1[4]
    # the card against the CPU: the fusion engine's statistical bars
    n_cpu, n_card = len(cpu[2]), len(c0[2])
    assert abs(n_card - n_cpu) <= 0.01 * n_cpu
    both = (cpu[1] >= 0) & (c0[1] >= 0)
    assert (cpu[2][cpu[1][both]] == c0[2][c0[1][both]]).mean() >= 0.999
    assert {i["category_id"] for i in cpu[4]} == {i["category_id"] for i in c0[4]}
    assert c0[1].dtype == np.int32 and c0[0]["occurences"].dtype == np.uint32


@pytest.mark.cuda
@pytest.mark.parametrize("turns,radius", [(1.0, 0.05), (2.0, 0.1)])
def test_file_path_tree_card_equals_cpu_bit_for_bit(cuda_device, tmp_path, turns, radius):
    # the fusion engine's norms, 3-sums, K @ R and the colour division are
    # spelled out in the CPU's arithmetic: every artifact file is the same
    # bytes on the card (with the loop-closure repair at turns 2)
    import filecmp

    from fusion3dseg_tpu_torch.io import synthetic
    from fusion3dseg_tpu_torch.pipeline import get3dseg, process3d

    sess = synthetic.make_session(nframes=16, depth_hw=(48, 36), turns=turns,
                                  room=synthetic.RoomSpec(seed=0), appearance="textured")
    src = synthetic.write_session_dir(sess, tmp_path / "session")
    for dev in ("cpu", "cuda"):
        process3d.process3DSeg(src, tmp_path / dev, radius=radius, device=dev)
        get3dseg.segment(tmp_path / dev, src / "masks", verbose=False, device=dev)
        get3dseg.remove_classes(tmp_path / dev, src / "masks", verbose=False, device=dev)
    a, b = tmp_path / "cpu", tmp_path / "cuda"
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert [str(f) for f in files if not filecmp.cmp(a / f, b / f, shallow=False)] == []


# ------------------------------------------------------- resizes, training


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((96, 72), (256, 256)), ((480, 640), (256, 256)),
                                     ((200, 300), (199, 301)), ((384, 512), (192, 256))])
def test_linear_resize_cuda_matches_cpu(cuda_device, src, dst):
    # integer arithmetic in int32 on both: the same bits (the CPU's equal cv2)
    from fusion3dseg_tpu_torch.io import image

    g = torch.Generator().manual_seed(sum(src))
    x = torch.randint(0, 256, (2, *src, 3), generator=g, dtype=torch.uint8)
    got = image.resize_linear_uint8(x.to(cuda_device), dst).cpu()
    assert torch.equal(got, image.resize_linear_uint8(x, dst))


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [((384, 512), (192, 256)), ((480, 640), (192, 256)),
                                     ((384, 512), (96, 128)), ((720, 960), (96, 128))])
def test_area_resize_cuda_matches_cpu(cuda_device, src, dst):
    # 2x and 4x are integer sums; 2.5x and 7.5x float32 weights in another
    # summation order (the CPU path equals cv2): within one level, mostly equal
    from fusion3dseg_tpu_torch.io import image

    g = torch.Generator().manual_seed(sum(src))
    x = torch.randint(0, 256, (2, *src, 3), generator=g, dtype=torch.uint8)
    got = image.resize_area_uint8(x.to(cuda_device), dst).cpu().int()
    want = image.resize_area_uint8(x, dst).int()
    if src[0] % dst[0] == 0:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1 and (got == want).float().mean() >= 0.999


@pytest.mark.cuda
def test_device_dataset_on_card(cuda_device):
    from fusion3dseg_tpu_torch.io import synthetic_device as sd
    from fusion3dseg_tpu_torch.io.synthetic import RoomSpec

    it = sd.device_dataset((256, 256), 8, seed=3, augment=True, device="cuda")
    imgs, masks = next(it)
    assert imgs.shape == (8, 256, 256, 3) and imgs.dtype == torch.uint8
    assert masks.shape == (8, 256, 256) and masks.dtype == torch.uint8
    assert imgs.device.type == masks.device.type == "cuda"
    # the card's render against the CPU's (which equals the host renderer):
    # float32 sines and products in other orders move a few pixels a level
    room = RoomSpec(seed=11)
    out = [sd.render_session_device(*sd.session_tables(room, 4, dev), render_hw=(96, 72),
                                    model_hw=(96, 72)) for dev in ("cuda", "cpu")]
    (ig, mg), (ic, mc) = ((i.cpu().int(), m.cpu()) for i, m in out)
    assert (mg == mc).float().mean() >= 0.999
    assert (ig - ic).abs().max().item() <= 1 and (ig == ic).float().mean() >= 0.99


@pytest.mark.cuda
def test_b2_nat_train_step_through_k2(cuda_device):
    # a B2-width train step with a neighbourhood-attention first stage: K2's
    # forward launches counted, loss and gradients against the same step
    # through the plain versions (bfloat16 compute: relative L2 of all
    # gradients within 2e-2)
    import dataclasses

    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.models.segformer import SegFormer
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.parallel import sharding

    cfg = dataclasses.replace(SegFormerConfig.b2(), nat_windows=(7, 0, 0, 0))
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 128, 128, 3), generator=g, dtype=torch.uint8)
    labels = torch.randint(0, 5, (2, 16, 16), generator=g).repeat_interleave(8, 1) \
        .repeat_interleave(8, 2)
    out = []
    for use in (True, False):
        net = SegFormer(cfg, torch.Generator().manual_seed(1), use_cuda_attention=use,
                        param_dtype=torch.float32).to(cuda_device)
        before = attn.neighborhood_attention.launches
        loss = sharding.segmenter_loss(net, images.to(cuda_device), labels.to(cuda_device), 2.0)
        loss.backward()
        torch.cuda.synchronize()
        assert attn.neighborhood_attention.launches - before == (3 if use else 0)
        out.append((loss.item(), torch.cat([p.grad.reshape(-1) for p in net.parameters()])))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    assert ((gk - gp).norm() / gp.norm()).item() <= 2e-2


def _b2_nat(window, dtype):
    """SegFormer-B2 with a neighbourhood-attention first stage of `window`,
    and the shipped B2 weights less that stage's reduction (decisive logits,
    so that masks can be compared)."""
    import dataclasses

    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert

    cfg = dataclasses.replace(SegFormerConfig.b2(), nat_windows=(window, 0, 0, 0), dtype=dtype)
    flat = {k: v for k, v in convert.flatten_params(convert.load_params_npz(
        convert.shipped_checkpoint("b2"))).items()
        if not (k.startswith("stage0_") and ("/sr/" in k or
                                             "EfficientAttention_0/LayerNorm_0" in k))}
    return cfg, convert.from_flax_params(flat, cfg)


@pytest.mark.cuda
def test_b2_nat_window_15_segmenter_cuda_matches_cpu(cuda_device):
    # float32 B2 at 256x256 with window 15 on stage 0 (64 x 64 tokens, D =
    # 64: the kernel streams the halo) against the port on the CPU
    from fusion3dseg_tpu_torch.io.synthetic import make_session
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    cfg, state = _b2_nat(15, torch.float32)
    frames = make_session(nframes=2, depth_hw=(48, 36), appearance="textured").colors
    segs = []
    for dev in ("cuda", "cpu"):
        seg = Segmenter2D(cfg, input_hw=(256, 256), batch_size=2, device=dev)
        seg.model.load_state_dict(state)
        segs.append(seg)
    before = attn.neighborhood_attention.launches
    got = segs[0].predict_batch(frames, 0.0)
    assert attn.neighborhood_attention.launches == before + 3  # B2's three stage-0 blocks
    agree = (got == segs[1].predict_batch(frames, 0.0)).mean()
    assert agree >= 0.999, agree


@pytest.mark.cuda
def test_b2_nat_window_23_train_step_through_k2(cuda_device):
    # the train step of test_b2_nat_train_step_through_k2 at window 23 (a
    # streamed halo) on 256x256 inputs: K2's launches counted, loss and
    # gradients against the step through the plain versions
    import dataclasses

    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.models.segformer import SegFormer
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.parallel import sharding

    cfg = dataclasses.replace(SegFormerConfig.b2(), nat_windows=(23, 0, 0, 0))
    g = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 256, 256, 3), generator=g, dtype=torch.uint8)
    labels = torch.randint(0, 5, (2, 32, 32), generator=g).repeat_interleave(8, 1) \
        .repeat_interleave(8, 2)
    out = []
    for use in (True, False):
        net = SegFormer(cfg, torch.Generator().manual_seed(1), use_cuda_attention=use,
                        param_dtype=torch.float32).to(cuda_device)
        before = attn.neighborhood_attention.launches
        loss = sharding.segmenter_loss(net, images.to(cuda_device), labels.to(cuda_device), 2.0)
        loss.backward()
        torch.cuda.synchronize()
        assert attn.neighborhood_attention.launches - before == (3 if use else 0)
        out.append((loss.item(), torch.cat([p.grad.reshape(-1) for p in net.parameters()])))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    assert ((gk - gp).norm() / gp.norm()).item() <= 2e-2


@pytest.mark.cuda
def test_train_checkpoint_resume_on_card(cuda_device, tmp_path):
    # the trainer on the card: float32 state, a commit, and a resume that
    # restores it bit for bit (the snapshot is what the loop held)
    import dataclasses

    from fusion3dseg_tpu_torch.models import SegFormerConfig, convert
    from fusion3dseg_tpu_torch.models import train as tr

    cfg = tr.TrainConfig(model=SegFormerConfig(num_classes=134, embed_dims=(8, 16, 24, 32),
                                               depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4),
                                               decoder_dim=32),
                         input_hw=(64, 64), batch_size=2, steps=4, checkpoint_every=2,
                         checkpoint_dir=str(tmp_path), ema_decay=0.9, log_every=100)
    params, loss = tr.train(cfg, device="cuda", verbose=False)
    assert np.isfinite(loss) and all(v.device.type == "cuda" and v.dtype == torch.float32
                                     for v in params.values())
    flat, _, it = tr.load_train_state(tmp_path)
    restored = convert.from_flax_params(flat, cfg.model, torch.float32)
    assert it == 4 and all(torch.equal(restored[k], v.cpu()) for k, v in params.items())
    params2, _ = tr.train(dataclasses.replace(cfg, resume=True, steps=6), device="cuda",
                          verbose=False)
    assert tr.committed_step(tmp_path) == 6


def _plane_cloud(n, seed):
    rng = np.random.default_rng(seed)
    a = n // 2
    b = n - a
    pts = np.vstack([np.c_[rng.uniform(0, 4, a), np.zeros(a), rng.uniform(0, 3, a)],
                     np.c_[rng.uniform(0, 4, b), rng.uniform(0, 2.5, b), np.zeros(b)]])
    return np.round(pts, 2).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,k", [(0.05, 16), (0.1, 32)])
def test_radius_graph_card_equals_cpu(cuda_device, radius, k):
    # the graph's ids are exact: the card's equal the CPU port's (which
    # equals JAX's, tests/test_torch_neighbors.py), both lookup paths
    from fusion3dseg_tpu_torch.ops import neighbors as nb

    pts = _plane_cloud(30_000, 1)
    want = nb.radius_graph(pts, radius, k=k, device="cpu")
    got = nb.radius_graph(torch.from_numpy(pts).to(cuda_device), radius, k=k)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    sparse = nb._radius_graph_impl(torch.from_numpy(pts).to(cuda_device), radius, k=k, ncap=None)
    assert torch.equal(sparse.cpu(), want)


@pytest.mark.cuda
def test_propagation_and_fills_card_equal_cpu(cuda_device):
    from fusion3dseg_tpu_torch.ops import components as comp, neighbors as nb
    from fusion3dseg_tpu_torch.pipeline import refinement as ref

    pts = _plane_cloud(20_000, 2)
    classes = np.where(pts[:, 0] < 2, 3, 7).astype(np.int32)
    adj = nb.radius_graph(pts, 0.05, k=12, device="cpu").numpy()
    want, sw = comp.propagate_labels(adj, classes, device="cpu", return_sweeps=True)
    got, sw2 = comp.propagate_labels(adj, classes, return_sweeps=True)
    assert got.is_cuda and torch.equal(got.cpu(), want) and sw == sw2
    t = comp.split_into_instances(classes, adj, backend="device")
    n = comp.split_into_instances(classes, adj, backend="native")
    assert np.array_equal(t[1], n[1]) and t[2] == n[2]
    seeds = np.zeros(len(pts), bool)
    seeds[:5] = True
    assert np.array_equal(comp.floodfill_level(adj, seeds, 6, classes),
                          comp.floodfill_level(adj, seeds, 6, classes, device="cpu"))
    vals = (pts[:, :1] * 0.1 + np.random.default_rng(3).random((len(pts), 3)) * 0.05)
    for v, thr in ((vals[:, 0], 0.04), (vals.astype(np.float32), 0.05)):
        a = ref.gated_floodfill(adj, seeds, v, thr, device="cpu")
        b = ref.gated_floodfill(adj, seeds, v, thr)
        assert b.is_cuda and torch.equal(b.cpu(), a)


# ------------------------------------------------------ the decompositions


@pytest.mark.cuda
def test_one_rank_nccl_group_equals_one_device(cuda_device):
    """A one-rank NCCL group on cuda:0 (real NCCL collectives) through
    voting, the frame-sharded label lifter (K1 on the card) and the
    spatially sharded fusion, each equal to its one-device call."""
    from fusion3dseg_tpu_torch import cuda
    from fusion3dseg_tpu_torch.parallel import launch

    import torch_parallel_ranks

    cuda.build(["histogram", "match_pixels"])  # ranks load what the caller built
    rng = np.random.default_rng(0)
    F, npts, nc = 16, 200, 9
    vote = dict(uv2pt=rng.integers(-1, npts, (F, 64)).astype(np.int32),
                masks=rng.integers(0, nc, (F, 64)).astype(np.uint8), npts=npts, nc=nc)
    label = dict(pts=(rng.normal(size=(800, 3)) + [0, 0, 3.0]).astype(np.float32),
                 K=np.array([[20.0, 0, 12], [0, 20.0, 16], [0, 0, 1]], np.float32),
                 quats=np.tile([1.0, 0, 0, 0], (F, 1)).astype(np.float32),
                 trans=(rng.normal(size=(F, 3)) * 0.1).astype(np.float32),
                 masks=rng.integers(0, 10, (F, 32 * 24)).astype(np.uint8), hw=(32, 24))
    _, sd = _fusion_session("cpu")
    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    args = tuple(np.asarray(x) for x in (sd.Ks, sd.quats_wxyz, sd.translations, sd.points,
                                         sd.normals, sd.colors, valid))
    kw = dict(height=48, width=36, radius=0.1, min_cosine=float(np.cos(np.deg2rad(25.0))),
              max_depth=8.0, capacity=1 << 14)
    (got,) = launch.spawn(torch_parallel_ranks.one_rank_equals_one_device, 1,
                          (dict(vote=vote, label=label, fusion=dict(args=args, kw=kw)),),
                          device_type="cuda", timeout=300.0)
    assert got["backend"] == "nccl" and got["device"] == "cuda:0", got
    assert got["k1_launches"] == 1, got
    assert got["votes"] and got["points"] and got["label"] and got["fusion"], got


# ------------------------------------------------------- fusion frame graph

FRAMES, FHW = 12, (96, 128)
FKW = dict(height=FHW[0], width=FHW[1], radius=0.08, min_cosine=float(np.cos(np.deg2rad(20.0))),
           max_depth=8.0, capacity=1 << 15)


def _fusion_args(device, seed):
    """A synthetic room session's engine arguments, its frames on `device`."""
    from fusion3dseg_tpu_torch.io import rtab, synthetic

    sess = synthetic.make_session(nframes=FRAMES, depth_hw=FHW, appearance="textured",
                                  room=synthetic.RoomSpec(seed=seed))
    sd = rtab.SessionData.from_arrays(sess.colors, sess.depth, sess.K,
                                      sess.quats_wxyz[:, [1, 2, 3, 0]], sess.translations,
                                      device=device)
    valid = (sd.depth > 0.1) & (sd.depth <= 8.0)
    return (sd.Ks.astype(np.float32), sd.quats_wxyz, sd.translations, sd.points, sd.normals,
            sd.colors, valid)


def _tensors(out):
    """The state's fields, uv2pt and (where present) spans of an engine call."""
    return (*out[0], *out[1:])


def _assert_equal_outputs(a, b):
    for x, y in zip(_tensors(a), _tensors(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("window,policy", [(None, "newest"), (1024, "split")],
                         ids=["unwindowed", "split_1024"])
@pytest.mark.parametrize("px", [1, 2], ids=["px1", "px2"])
def test_frame_graph_matches_eager_step(cuda_device, monkeypatch, window, policy, px):
    """The frame loop replayed from a CUDA graph gives the eager step's bits
    on the card; the windowed run overflows its window."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf
    from fusion3dseg_tpu_torch.utils import timing

    args = _fusion_args(cuda_device, 5)
    kw = dict(FKW, window=window, window_policy=policy, candidate_px=px, with_stats=True,
              device=cuda_device)
    with timing.record() as rec:
        graphed = tf.fuse_session(*args, **kw)
    assert rec["fuse_graph.frames"] == FRAMES - 1
    monkeypatch.setattr(tf, "_replay_frames", lambda key, *a: tf._step_frames(*a))
    eager = tf.fuse_session(*args, **kw)
    _assert_equal_outputs(graphed, eager)
    assert 0 < int(graphed[0].n) < FKW["capacity"]
    if window is not None:
        assert int(graphed[2].max()) > window


@pytest.mark.cuda
def test_frame_graphs_cached_per_window(cuda_device):
    """Two windows in one process are two cached graphs; the first replays
    again, uncaptured, with its first bits."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf
    from fusion3dseg_tpu_torch.utils import timing

    tf._GRAPHS.clear()
    args = _fusion_args(cuda_device, 7)
    kw_a = dict(FKW, window=1024, window_policy="split", with_stats=True, device=cuda_device)
    kw_b = dict(FKW, window=2048, window_policy="newest", with_stats=True, device=cuda_device)
    with timing.record() as rec:
        a1 = tf.fuse_session(*args, **kw_a)
        b = tf.fuse_session(*args, **kw_b)
    assert rec["fuse_graph.captures"] == 2 and len(tf._GRAPHS) == 2
    with timing.record() as rec:
        a2 = tf.fuse_session(*args, **kw_a)
    assert rec["fuse_graph.captures"] == 0 and rec["fuse_graph.frames"] == FRAMES - 1
    _assert_equal_outputs(a1, a2)
    assert not torch.equal(a1[1], b[1])


@pytest.mark.cuda
def test_repeated_call_captures_nothing(cuda_device):
    from fusion3dseg_tpu_torch.fusion import fusion as tf
    from fusion3dseg_tpu_torch.utils import timing

    args = _fusion_args(cuda_device, 9)
    kw = dict(FKW, window=4096, window_policy="newest", device=cuda_device)
    counts = []
    for _ in range(2):
        with timing.record() as rec:
            tf.fuse_session(*args, **kw)
        counts.append((rec["fuse_graph.captures"], rec["fuse_graph.frames"]))
    assert counts[1] == (0, FRAMES - 1) and counts[0][1] == FRAMES - 1


@pytest.mark.cuda
def test_fuse_chunk_on_the_card_equals_one_shot(cuda_device):
    """Three chunks from the seed frame give the one-shot session's bits."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf

    args = _fusion_args(cuda_device, 11)
    kw = dict(FKW, window=1024, window_policy="split")
    one = tf.fuse_session(*args, with_stats=True, device=cuda_device, **kw)
    frame_kw = {k: kw[k] for k in ("height", "width", "radius", "min_cosine", "max_depth",
                                   "capacity")}
    state, uv0 = tf._seed_frame(tf._empty_state(kw["capacity"], cuda_device),
                                *(torch.as_tensor(a[0], device=cuda_device) for a in args[3:]),
                                **frame_kw)
    uvs, spans = [uv0[None]], [torch.zeros(1, dtype=torch.int32, device=cuda_device)]
    for rows in (slice(1, 5), slice(5, 9), slice(9, FRAMES)):
        state, uv, sp = tf.fuse_chunk(state, args[0], *(a[rows] for a in args[1:]),
                                      with_stats=True, **kw)
        uvs.append(uv)
        spans.append(sp)
    _assert_equal_outputs(one, (state, torch.cat(uvs), torch.cat(spans)))


@pytest.mark.cuda
def test_returned_state_outlives_the_next_session(cuda_device):
    """A session's returned tensors share no storage with the next
    session's or with any graph's buffers, and the next session's replays
    leave them as they were."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf

    kw = dict(FKW, window=1024, window_policy="split", with_stats=True, device=cuda_device)
    first = tf.fuse_session(*_fusion_args(cuda_device, 13), **kw)
    kept = [t.clone() for t in _tensors(first)]
    second = tf.fuse_session(*_fusion_args(cuda_device, 17), **kw)
    for t, k in zip(_tensors(first), kept):
        assert torch.equal(t, k)
    assert not torch.equal(first[1], second[1])

    def ptrs(tensors):
        return {t.untyped_storage().data_ptr() for t in tensors}

    graph_ptrs = set()
    for g in tf._GRAPHS.values():
        graph_ptrs |= ptrs((*g.buf, g.cam, *g.frames, g.uv2pt, g.span))
    a, b = ptrs(_tensors(first)), ptrs(_tensors(second))
    assert not a & b and not (a | b) & graph_ptrs


# ------------------------------------------------------ fusion match kernel

def _match_on(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _match_both(arrays, device, **kw):
    """(kernel, plain version) on the same card tensors; the kernel's one
    launch counted."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf

    t = _match_on(arrays, device)
    before = tf._match_kernel.launches
    got = tf._match_pixels(*t, **kw)
    assert tf._match_kernel.launches == before + 1
    want = tf._match_pixels_plain(*t, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_ties", "boundaries"])
@pytest.mark.parametrize("half", [1, 2, 3])
@pytest.mark.parametrize("hw", [(23, 31), (97, 130)], ids=["ragged", "blocks"])
def test_match_kernel_equals_plain(cuda_device, case, half, hw):
    """Absent candidates, invalid pixels, equal candidates (the first in
    candidate-major order wins), distances and cosines exactly on float32
    `radius` and `min_cosine`: `match` and `matched` bit for bit."""
    from torch_match_inputs import CASES, MIN_COS, RADIUS

    height, width = hw
    arrays = CASES[case](np.random.default_rng(100 * half + height), height, width, half)
    kw = dict(height=height, width=width, half=half, radius=RADIUS, min_cosine=MIN_COS)
    (match, matched), (want_match, want_matched) = _match_both(arrays, cuda_device, **kw)
    assert match.dtype == torch.int32 and matched.dtype == torch.bool
    assert torch.equal(match, want_match) and torch.equal(matched, want_matched)
    assert 0 < int(matched.sum()) < height * width


@pytest.mark.cuda
@pytest.mark.parametrize("half", [1, 2])
def test_match_kernel_equals_plain_vga(cuda_device, half):
    from torch_match_inputs import MIN_COS, RADIUS, random_case

    arrays = random_case(np.random.default_rng(7 + half), 480, 640, half)
    kw = dict(height=480, width=640, half=half, radius=RADIUS, min_cosine=MIN_COS)
    (match, matched), (want_match, want_matched) = _match_both(arrays, cuda_device, **kw)
    assert torch.equal(match, want_match) and torch.equal(matched, want_matched)
    assert 0.3 < matched.float().mean().item() < 0.95


@pytest.mark.cuda
def test_match_kernel_refuses_what_it_does_not_take(cuda_device):
    from fusion3dseg_tpu_torch.fusion import fusion as tf
    from torch_match_inputs import MIN_COS, RADIUS, random_case

    grid, slotg, fpts, fnrm, fvalid = _match_on(
        random_case(np.random.default_rng(1), 20, 24, 2), cuda_device)
    kw = dict(height=20, width=24, half=2, radius=RADIUS, min_cosine=MIN_COS)
    with pytest.raises(ValueError, match="grid"):
        tf._match_kernel(grid.double(), slotg, fpts, fnrm, fvalid, **kw)
    with pytest.raises(ValueError, match="slotg"):
        tf._match_kernel(grid, slotg.long(), fpts, fnrm, fvalid, **kw)
    with pytest.raises(ValueError, match="fpts"):  # a strided view
        tf._match_kernel(grid, slotg, torch.cat([fpts, fpts], 1)[:, :3], fnrm, fvalid, **kw)
    with pytest.raises(ValueError, match="fvalid"):
        tf._match_kernel(grid, slotg, fpts, fnrm, fvalid.to(torch.uint8), **kw)
    with pytest.raises(ValueError, match="grid"):  # not on the card
        tf._match_kernel(grid.cpu(), slotg, fpts, fnrm, fvalid, **kw)
    with pytest.raises(RuntimeError, match="does not cover"):  # the launcher's -1
        tf._match_kernel(grid[:-1].contiguous(), slotg[:-1].contiguous(), fpts, fnrm, fvalid,
                         **kw)
    # the engine's entry makes the frame's inputs contiguous and launches
    strided = torch.cat([fpts, fpts], 1)[:, :3]
    assert not strided.is_contiguous()
    got = tf._match_pixels(grid, slotg, strided, fnrm, fvalid, **kw)
    want = tf._match_pixels_plain(grid, slotg, fpts, fnrm, fvalid, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_match_kernel_counted_in_replayed_and_eager_frames(cuda_device, monkeypatch):
    """The engine counts every frame stepped on the card as matched by the
    kernel, replayed from its graph or stepped eagerly."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf
    from fusion3dseg_tpu_torch.utils import timing

    args = _fusion_args(cuda_device, 19)
    kw = dict(FKW, window=1024, window_policy="split", device=cuda_device)
    with timing.record() as rec:
        tf.fuse_session(*args, **kw)
    assert rec["fuse_match.kernel_frames"] == rec["fuse_graph.frames"] == FRAMES - 1
    monkeypatch.setattr(tf, "_replay_frames", lambda key, *a: tf._step_frames(*a))
    launches = tf._match_kernel.launches
    with timing.record() as rec:
        tf.fuse_session(*args, **kw)
    assert rec["fuse_match.kernel_frames"] == FRAMES - 1 and rec["fuse_graph.frames"] == 0
    assert tf._match_kernel.launches == launches + FRAMES - 1


@pytest.mark.cuda
def test_match_kernel_counter_reads_zero_on_a_plain_card_step(cuda_device, monkeypatch):
    """The counter follows the dispatch: a card step whose match took the
    plain version counts no frame, replayed (captured anew) or eager."""
    from fusion3dseg_tpu_torch.fusion import fusion as tf
    from fusion3dseg_tpu_torch.utils import timing

    args = _fusion_args(cuda_device, 19)
    kw = dict(FKW, window=1024, window_policy="split", device=cuda_device)
    monkeypatch.setattr(tf, "_match_pixels", tf._match_pixels_plain)
    monkeypatch.setattr(tf, "_GRAPHS", type(tf._GRAPHS)())
    with timing.record() as rec:
        tf.fuse_session(*args, **kw)
    assert rec["fuse_graph.frames"] == FRAMES - 1 and rec["fuse_match.kernel_frames"] == 0
    monkeypatch.setattr(tf, "_replay_frames", lambda key, *a: tf._step_frames(*a))
    with timing.record() as rec:
        tf.fuse_session(*args, **kw)
    assert rec["fuse_match.kernel_frames"] == 0 and rec["fuse_graph.frames"] == 0
