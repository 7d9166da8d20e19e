"""Rank functions for the port's multi-device tests (`parallel/launch.spawn`).

Spawned ranks import this module by name, so it imports torch and the port
only (no JAX): each function runs every case of one test module in one
process group and returns host tensors."""

import numpy as np
import torch

from fusion3dseg_tpu_torch.ops import histogram
from fusion3dseg_tpu_torch.parallel import comm
from fusion3dseg_tpu_torch.parallel import label_fuse as plf
from fusion3dseg_tpu_torch.parallel import sharding
from fusion3dseg_tpu_torch.parallel import voting as pvoting


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def label_cases(rank, inp):
    """Voting and the three label lifters on a (D, 1) mesh."""
    mesh = sharding.make_mesh(rank.world_size, tp=1, device_type=rank.device.type)
    layouts = []
    real = plf.histogram_classify

    def recording(C, nclasses, threshold=0.5):  # K1's wrapper, noting the rows' layout
        layouts.append(histogram.rows_aligned(C.data_ptr(), C.stride(0), C.shape[0]))
        return real(C, nclasses, threshold)

    plf.histogram_classify = recording
    try:
        v = inp["vote"]
        out = {"votes_frames": pvoting.vote_sharded_frames(mesh, v["uv2pt"], v["masks"],
                                                            v["npts"], v["nc"])}
        out["votes_points"], out["classes_points"] = pvoting.vote_sharded_points(
            mesh, v["uv2pt"], v["masks"], v["npts"], v["nc"])
        w = inp["label"]
        args = (w["pts"], w["K"], w["quats"], w["trans"], w["masks"], w["hw"])
        out["label_frames"] = plf.label_fuse_sharded(mesh, *args, nclasses=10)
        out["label_points"] = plf.label_fuse_sharded_points(mesh, *args, nclasses=10)
        c = inp["cells"]
        out["label_cells"] = plf.label_fuse_sharded_cells(
            mesh, c["cells_table"], c["dev_lists"], c["valid"], c["K"], c["quats"], c["trans"],
            c["masks"], c["hw"], npts=c["npts"], nclasses=10)
    finally:
        plf.histogram_classify = real
    out["k1_rows_aligned"] = layouts
    out["collectives"] = dict(comm.STATS)
    return _cpu(out)


def failing(rank, bad_rank):
    """Raises on `bad_rank` after the group has formed."""
    if rank.rank == bad_rank:
        raise ValueError(f"rank {rank.rank} fails on purpose")
    return rank.rank


def hanging(rank, seconds):
    """Rank 0 sleeps past any deadline; the others wait in a collective."""
    import time

    if rank.rank == 0:
        time.sleep(seconds)
    torch.distributed.barrier()
    return rank.rank


def identity(rank):
    return (rank.rank, rank.world_size, str(rank.device), rank.backend,
            np.float32(torch.get_num_threads()))


# the one-rank drift guard's cases (tests/test_model_parallel.py:498-570)
DRIFT_CASES = (dict(capacity=1 << 14), dict(capacity=1 << 13, window=1 << 9),
               dict(capacity=1 << 13, window=1 << 9, window_policy="split"))


def _state(out):
    from fusion3dseg_tpu_torch.fusion import fusion

    state, uv2pt = out
    return {**fusion.state_to_arrays(state), "uv2pt": uv2pt.cpu().numpy()}


def fusion_cases(rank, inp):
    """Both sharded fusion engines on a (D, 1) mesh, and one drift-guard
    case a rank on a (1, D) mesh (a dp axis of one rank) against the
    one-device engine."""
    from fusion3dseg_tpu_torch.fusion import fusion
    from fusion3dseg_tpu_torch.parallel import fusion as pfusion

    dev = rank.device.type
    mesh = sharding.make_mesh(rank.world_size, tp=1, device_type=dev)
    alone = sharding.make_mesh(rank.world_size, tp=rank.world_size, device_type=dev)
    args, short, kw = inp["args"], inp["short"], inp["kw"]
    out = {
        "spatial": _state(pfusion.fuse_session_spatial_sharded(mesh, *args, **kw,
                                                               capacity=inp["cap_spatial"])),
        "split": _state(pfusion.fuse_session_spatial_sharded(mesh, *short, **kw,
                                                             **inp["split"])),
        "frames": _state(pfusion.fuse_session_sharded(mesh, *args, **kw,
                                                      capacity=inp["cap_frames"])),
    }
    if rank.rank < len(DRIFT_CASES):
        case = DRIFT_CASES[rank.rank]
        out["drift"] = (_state(fusion.fuse_session(*short, **kw, **case, device=dev)),
                        _state(pfusion.fuse_session_spatial_sharded(alone, *short, **kw,
                                                                    **case)))
    out["collectives"] = dict(comm.STATS)
    return out


def train_cases(rank, inp):
    """The dp x tp step of the tiny float32 SegFormer from the JAX
    package's weights (two steps, boundary weight and EMA), then `train`
    over the same mesh with a checkpoint, restored on every rank."""
    from fusion3dseg_tpu_torch.models import convert
    from fusion3dseg_tpu_torch.models import train as ttrain
    from fusion3dseg_tpu_torch.models.segformer import SegFormer, SegFormerConfig

    mesh = sharding.make_mesh(rank.world_size, tp=2, device_type=rank.device.type)
    cfg = SegFormerConfig(**inp["tiny"], dtype=torch.float32)
    tcfg = ttrain.TrainConfig(model=cfg, **inp["train_cfg"])
    model = SegFormer(cfg, param_dtype=torch.float32)
    model.load_state_dict(convert.from_flax_params(inp["params"], cfg, torch.float32))
    model, _, _, ema, step = sharding.init_sharded_train(
        model.to(rank.device), mesh, optimizer=lambda ps: ttrain.make_optimizer(tcfg, ps),
        boundary_weight=2.0, ema_decay=0.9)
    names = [n for n, _ in model.named_parameters()]
    rows = sharding.dp_rows(mesh, len(inp["batches"][0][0]))
    out = {"losses": [], "fc1_rows": model.stage0_block0.ffn.fc1.weight.shape[0]}
    comm.reset_stats()
    for images, labels in inp["batches"]:
        out["losses"].append(float(step(torch.from_numpy(images[rows]),
                                        torch.from_numpy(labels[rows]))))
        if "grads" not in out:
            out["collectives_a_step"] = comm.STATS["calls"]
            out["grads"] = sharding.full_state({n: p.grad for n, p in model.named_parameters()},
                                               mesh)
    out["params"] = sharding.full_state({n: p.detach() for n, p in model.named_parameters()},
                                        mesh)
    out["ema"] = sharding.full_state(dict(zip(names, ema.views())), mesh)

    # train() over the mesh: rank 0 writes, every rank restores it
    wrote, last = [], {}
    real_save = ttrain.save_train_state

    def save(*a, **kw):
        wrote.append(rank.rank)
        return real_save(*a, **kw)

    def on_step(it, loss, model, optimizer, ema):
        last.update(params={n: p.detach().clone() for n, p in model.named_parameters()},
                    opt=optimizer.state_dict(), ema=ema.flat.clone())

    ttrain.save_train_state = save
    try:
        ccfg = ttrain.TrainConfig(model=cfg, **inp["ckpt_cfg"])
        full, _ = ttrain.train(ccfg, device=rank.device.type, verbose=False, on_step=on_step,
                               mesh=mesh)
    finally:
        ttrain.save_train_state = real_save
    flat, opt_state, it = ttrain.load_train_state(ccfg.checkpoint_dir)
    restored = sharding.local_state(convert.from_flax_params(flat, cfg, torch.float32), mesh)
    restored_opt = ttrain._opt_state_of(opt_state["optimizer"], names,
                                        lambda d: sharding.local_state(d, mesh))
    ema_local = sharding.local_state(
        convert.from_flax_params(ttrain.load_ema(ccfg.checkpoint_dir), cfg, torch.float32), mesh)
    out["ckpt"] = dict(
        step=it, wrote=wrote,
        params=all(torch.equal(restored[n], last["params"][n]) for n in names),
        whole=all(torch.equal(full[n], v) for n, v in
                  convert.from_flax_params(flat, cfg, torch.float32).items()),
        opt=all(torch.equal(restored_opt["state"][i][k], v)
                for i, st in last["opt"]["state"].items() for k, v in st.items()),
        ema=torch.equal(torch.cat([ema_local[n].reshape(-1) for n in names]), last["ema"]))
    return _cpu(out)


def one_rank_equals_one_device(rank, inp):
    """On one rank (a one-rank NCCL group on the card): voting, the
    frame-sharded label lifter and the spatially sharded fusion, each
    against its one-device call on the same device."""
    from fusion3dseg_tpu_torch.fusion import fusion
    from fusion3dseg_tpu_torch.ops import label_fuse, voting
    from fusion3dseg_tpu_torch.parallel import fusion as pfusion

    dev = rank.device
    mesh = sharding.make_mesh(1, device_type=dev.type)
    v, w, f = inp["vote"], inp["label"], inp["fusion"]
    votes = voting.vote_all_frames(v["uv2pt"], v["masks"], v["npts"], v["nc"], device=dev)
    pv, pc = pvoting.vote_sharded_points(mesh, v["uv2pt"], v["masks"], v["npts"], v["nc"])
    before = histogram.histogram_classify.launches
    classes = plf.label_fuse_sharded(mesh, w["pts"], w["K"], w["quats"], w["trans"],
                                     w["masks"], w["hw"], nclasses=10)
    launches = histogram.histogram_classify.launches - before
    one = label_fuse.tpu_label_fuse(len(w["pts"]), 10, w["hw"], device=dev)(
        w["pts"], w["K"], w["quats"], w["trans"], w["masks"])[1]
    s1, u1 = fusion.fuse_session(*f["args"], **f["kw"], device=dev)
    sS, uS = pfusion.fuse_session_spatial_sharded(mesh, *f["args"], **f["kw"])
    return dict(
        backend=rank.backend, device=str(dev), k1_launches=launches,
        votes=torch.equal(pvoting.vote_sharded_frames(mesh, v["uv2pt"], v["masks"], v["npts"],
                                                      v["nc"]), votes),
        points=torch.equal(pv, votes) and torch.equal(pc, voting.classify(votes, 0.5, v["nc"])),
        label=classes.is_cuda and torch.equal(classes, one),
        fusion=int(s1.n) == int(sS.n) and torch.equal(u1, uS) and all(
            torch.equal(a[:int(s1.n)], b[:int(s1.n)]) for a, b in zip(s1[:5], sS[:5])))
