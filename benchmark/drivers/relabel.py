"""Traffic "relabel": a user relabels a fused cloud with new 2D masks.

Closed loop, one client: `bench.py`'s headline workload. A room cloud
(points on the room's surfaces) and a trajectory through the room are drawn
from the seed on the card; the cell index and the bucket plan are built at
set-up, as `label_fuse_session` does inside. Each call uploads the next of
`mask_sets` mask sets (the ground-truth masks under seeded class
permutations: the same work, different answers), runs
`tpu_label_fuse_cells` and copies the classes to the host.

Traffic parameters: npts, frames, hw [H, W], num_objects, cell_size,
nbuckets, mask_sets, checked (calls compared), limits {configuration:
{number: limit}}.
"""

from __future__ import annotations

import numpy as np
import torch

from f3sbench import room as rooms
from reference import relabel_ref


class State:
    pass


def setup(ctx) -> State:
    from fusion3dseg_tpu_torch.ops import label_fuse as lf

    st = State()
    st.ctx, tr, cfg = ctx, ctx.traffic, ctx.config
    st.dev = dev = ctx.device
    st.hw = hw = tuple(tr["hw"])
    st.npts, st.frames = tr["npts"], tr["frames"]
    st.nclasses, st.threshold = cfg["nclasses"], cfg["threshold"]
    rng = np.random.default_rng(ctx.seed)
    room = rooms.Room(int(rng.integers(0, 2 ** 31)), tr["num_objects"])
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(0, 2 ** 62)))
    st.points = rooms.room_cloud(room, st.npts, gen, dev)
    st.K = rooms.room_camera(hw)
    _, _, gt, quats, eyes = rooms.render(room, st.frames, st.K, hw, dev)
    st.quats = quats.astype(np.float32)
    st.trans = eyes.astype(np.float32)
    gt = gt.reshape(st.frames, -1).long()
    st.mask_sets = [torch.as_tensor(rng.permutation(st.nclasses), device=dev)[gt]
                    .to(torch.uint8) for _ in range(tr["mask_sets"])]
    del gt
    cells_table, cell_lists, counts = lf.build_cell_index(
        st.points.cpu().numpy(), st.K, st.quats, st.trans, hw, cell_size=tr["cell_size"])
    perm, sizes, Ks = lf.plan_window_buckets(counts, nbuckets=tr["nbuckets"], round_to=8,
                                             max_window=cell_lists.shape[1])
    st.run = lf.tpu_label_fuse_cells(st.npts, st.nclasses, hw, Ks, sizes,
                                     threshold=st.threshold, device=dev)
    st.args = (torch.as_tensor(cells_table, device=dev),
               torch.as_tensor(cell_lists[perm], device=dev),
               torch.as_tensor(st.K, dtype=torch.float32, device=dev),
               torch.as_tensor(st.quats[perm], device=dev),
               torch.as_tensor(st.trans[perm], device=dev))
    # the host arrays each call uploads, in the plan's frame order
    st.masks_host = [m[torch.as_tensor(perm, device=dev)].cpu().numpy() for m in st.mask_sets]
    n = tr["mask_sets"]
    st.sample = set(int(x) for x in rng.choice(2 * n, size=tr["checked"], replace=False))
    st.kept = {}
    return st


def warmup(st: State) -> None:
    request(st, 0, keep=False)


def key(st: State, i: int) -> int:
    """The mask set that call i uploads."""
    return i % len(st.masks_host)


def keeps(st: State, i: int) -> bool:
    return i in st.sample


def request(st: State, i: int, keep: bool) -> dict:
    k = key(st, i)
    with torch.profiler.record_function("tpu_label_fuse_cells"):
        (total, _vmax), classes = st.run(*st.args, st.masks_host[k])
    with torch.profiler.record_function("classes_to_host"):
        classes_h = classes.cpu().numpy()
    if keep:
        st.kept[i] = {"total": total.clone(), "classes": classes_h}
    return {"key": k, "frames": st.frames, "npts": st.npts, "work": st.npts * st.frames,
            "stages": {}}


def release(st: State) -> None:
    del st.args
    for got in st.kept.values():
        got["total"] = got["total"].cpu().numpy()


def end_to_end(rec: dict) -> dict:
    work = sum(r["work"] for r in rec["requests"])
    return {"relabel_pt_frames_per_s": work / rec["window_s"]}


def reference(st: State, key: int, control: bool = False) -> dict:
    """The plain reference's answer for mask set `key` (float64); with
    `control`, the control's (float32, the products' operands in TF32)."""
    total, classes = relabel_ref.lift(st.points, st.K, st.quats, st.trans, st.mask_sets[key],
                                      st.hw, st.nclasses, st.threshold,
                                      mode="tf32" if control else "float64")
    return {"total": total.cpu().numpy(), "classes": classes.cpu().numpy()}


def compare(got: dict, ref: dict) -> dict:
    """Shares of the points whose class, or whose vote count (the frames in
    which the point won its pixel), differ from the reference's."""
    return {"class_mismatch": float(np.mean(got["classes"] != ref["classes"])),
            "votes_mismatch": float(np.mean(got["total"] != ref["total"]))}


def check(st: State) -> list:
    limits = st.ctx.traffic["limits"][st.ctx.config["name"]]
    worst, refs = {}, {}
    for i, got in sorted(st.kept.items()):
        k = key(st, i)
        if k not in refs:
            refs[k] = reference(st, k)
        for name, value in compare(got, refs[k]).items():
            worst[name] = max(worst.get(name, value), value)
    return [{"name": n, "value": worst.get(n, float("inf")), "limit": limits[n]}
            for n in limits]
