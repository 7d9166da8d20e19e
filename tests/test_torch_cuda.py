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
