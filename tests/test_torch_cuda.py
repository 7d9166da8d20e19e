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
@pytest.mark.parametrize("B,N,H,D,M,dtype", [
    (8, 4096, 1, 64, 64, torch.bfloat16),  # B2 stage 0 at 256x256
    (8, 1024, 2, 64, 64, torch.bfloat16),  # B2 stage 1
    (1, 1000, 3, 32, 37, torch.float32),  # ragged everything
    (2, 77, 2, 8, 5, torch.float32),  # the smallest lane chunk
    (1, 512, 1, 128, 300, torch.bfloat16),  # the largest head dim, M past 48 KB
    (1, 300, 2, 24, 40, torch.bfloat16),  # D between chunk sizes: zero-padded rows
])
def test_sr_attention_kernel_matches_plain(cuda_device, B, N, H, D, M, dtype):
    from fusion3dseg_tpu_torch.ops import attention as attn

    q, k, v = _qkv((B, N, H, D), (B, M, H, D), dtype, cuda_device)
    before = attn.sr_attention.launches
    got = attn.sr_attention(q, k, v)
    assert attn.sr_attention.launches == before + 1
    want = attn.sr_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    bar = BF16_BAR if dtype == torch.bfloat16 else F32_BAR
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.cuda
def test_sr_attention_kernel_reads_strides_and_refuses(cuda_device):
    from fusion3dseg_tpu_torch.ops import attention as attn

    # q, k, v as slices of one fused projection: token and head strides differ
    qkv = torch.randn((2, 640, 3, 2, 16), device=cuda_device)
    q, k, v = qkv[:, :, 0], qkv[:, :40, 1], qkv[:, :40, 2]
    got = attn.sr_attention(q, k, v)
    want = attn.sr_attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    assert (got - want).abs().max().item() <= F32_BAR
    with pytest.raises(RuntimeError, match="forward only"):
        attn.sr_attention(q.clone().requires_grad_(True), k, v)
    big = torch.zeros((1, 8, 1, 256), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        attn.sr_attention(big, big, big)
    many = torch.zeros((1, 5000, 1, 128), device=cuda_device)
    with pytest.raises(RuntimeError, match="shared memory"):
        attn.sr_attention(many, many, many)


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
    big = torch.zeros((1, 64, 1, 128), device=cuda_device, dtype=dtype)
    with pytest.raises(RuntimeError, match="shared memory"):
        attn.neighborhood_attention(big, big, big, 8, 8, 41)


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
@pytest.mark.parametrize("kw", [{"use_pallas_attention": True}, {"nat_windows": (5, 0, 0, 0)}],
                         ids=["sr_kernel", "nat_kernel"])
def test_segmenter_cuda_matches_cpu(cuda_device, kw):
    # the segmenter on the card (through the kernels) against the port on
    # the CPU (which the CPU tests hold to JAX): float32, a tiny config at
    # 128x128 so that stage 0 has N = 1024 and takes the fused branch
    from fusion3dseg_tpu_torch.io.synthetic import make_session
    from fusion3dseg_tpu_torch.models import SegFormerConfig
    from fusion3dseg_tpu_torch.ops import attention as attn
    from fusion3dseg_tpu_torch.pipeline.get2dseg import Segmenter2D

    cfg = SegFormerConfig(num_classes=134, embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 3, 4), decoder_dim=32, dtype=torch.float32, **kw)
    frames = make_session(nframes=2, depth_hw=(48, 36), appearance="textured").colors
    counter = attn.sr_attention if "use_pallas_attention" in kw else attn.neighborhood_attention
    before = counter.launches
    on_card = Segmenter2D(cfg, input_hw=(128, 128), batch_size=2, seed=0, device="cuda")
    on_cpu = Segmenter2D(cfg, input_hw=(128, 128), batch_size=2, seed=0, device="cpu")
    x = on_cpu._model_input(frames)
    lg = on_card._logits_sem_conf(x.cuda(), 0.0, (48, 36))[0].cpu()
    lc = on_cpu._logits_sem_conf(x, 0.0, (48, 36))[0]
    assert counter.launches == before + 1
    assert (lg - lc).abs().max().item() <= 1e-3
    agree = (on_card.predict_batch(frames, 0.0) == on_cpu.predict_batch(frames, 0.0)).mean()
    assert agree >= 0.98, agree


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
