"""3D segmentation stage: the fused cloud + 2D masks -> labelled artifacts.

Counterpart of `fusion3dseg_tpu/pipeline/get3dseg.py`, with its public
surface: `segment(dirname, mask_dir, threshold, nclasses, filter_classes,
min_pts_per_inst)`, `remove_classes`, `semantic_viz`, `panoptic_viz`,
`load_semantic_segmentation`, `load_csv` and `master_classes`, writing the
same artifact tree: segmentation/{votes.npy, classes.npy, info.json,
pcd.ply, final_pcd.ply, remaining_mask.npy, ...} and
panoptic_segmentation/{ids.npy, info.json, pcd.ply, final_info.json}.

Masks are read and resized (nearest) on the host with the port's codec;
voting and the thresholded classification run on `device`; the instance
split runs on the host over the stored neighbour lists (native
union-find); per-instance boxes come from the host PCA below
`obb.HOST_OBB_MAX_KN` points x instances and from the device above it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from fusion3dseg_tpu_torch import cuda
from fusion3dseg_tpu_torch.io import artifacts, image, ply
from fusion3dseg_tpu_torch.ops import components, neighbors, obb as obb_ops, voting
from fusion3dseg_tpu_torch.pipeline.merge_bb import merge_bb
from fusion3dseg_tpu_torch.utils import palette as pal
from fusion3dseg_tpu_torch.utils import taxonomy as tax
from fusion3dseg_tpu_torch.utils import timing


def _read_masks_resized(mask_files, hw, resize=True) -> np.ndarray:
    """Masks as [len, H*W] uint8: each read as gray and resized (nearest,
    OpenCV's rule) to the depth resolution."""
    h, w = hw
    out = np.zeros((len(mask_files), h * w), np.uint8)
    for i, f in enumerate(mask_files):
        m = image.read(f, gray=True)
        if resize and m.shape != (h, w):
            m = image.resize_nearest(m, (h, w))
        out[i] = m.reshape(-1)
    return out


def vote_session(dirname, mask_dir, npts: int, depth_hw, nclasses: int = 133, votes_file=None,
                 dedup: bool = True, verbose: bool = False, device="cuda") -> np.ndarray:
    """Votes [npts, nclasses+1] int32 of every frame whose mask and uv2pt
    files share a stem. `votes_file`: a votes .npy to start from instead
    (when it exists)."""
    if votes_file is not None and Path(votes_file).is_file():
        return np.load(votes_file)
    dev = cuda.resolve_device(device)
    mask_files, uv2pt_files = artifacts.matched_mask_uv2pt_files(
        mask_dir, Path(dirname) / "fusion" / "uv2pt")
    if not mask_files:
        raise FileNotFoundError(
            f"no mask/uv2pt stem matches between {mask_dir} and "
            f"{Path(dirname) / 'fusion' / 'uv2pt'}: did the fusion stage run, and do the mask "
            "file names match the frame numbers?")
    if verbose:
        print(f"voting over {len(mask_files)} frames ...")
    masks = _read_masks_resized(mask_files, depth_hw)
    uv2pt = np.stack([np.load(f) for f in uv2pt_files]).astype(np.int32)
    return voting.vote_all_frames(uv2pt, masks, npts, nclasses, dedup=dedup,
                                  device=dev).cpu().numpy()


def _classify(votes: np.ndarray, threshold, nclasses, filter_classes, dev) -> np.ndarray:
    return voting.classify(torch.as_tensor(votes, device=dev), threshold, nclasses,
                           filter_classes).cpu().numpy()


def segment(
    dirname,
    mask_dir,
    threshold: float = 0.5,
    nclasses: int = 133,
    filter_classes: Optional[Sequence[int]] = (86, 114, 115),
    min_pts_per_inst: int = 100,
    verbose: bool = True,
    taxonomy: Optional[tax.Taxonomy] = None,
    dedup: bool = True,
    device="cuda",
):
    """Semantic and panoptic segmentation of the fused cloud: votes,
    classes, the instance split over adj.pkl, the viz artifacts, then
    `master_classes` (parent taxonomy, boxes, box merge). Returns (votes,
    classes)."""
    from fusion3dseg_tpu_torch.fusion import Fusion

    dev = cuda.resolve_device(device)
    dirname = Path(dirname)
    points, _, _, _, _, _, depth_hw, adj = Fusion.load_data(dirname)
    npts = len(points)

    with timing.span("segmentation.vote", verbose=verbose):
        votes = vote_session(dirname, mask_dir, npts, depth_hw, nclasses, dedup=dedup,
                             verbose=verbose, device=dev)
        (dirname / "segmentation").mkdir(parents=True, exist_ok=True)
        np.save(dirname / "segmentation" / "votes.npy", votes)
        classes = _classify(votes, threshold, nclasses,
                            tuple(filter_classes) if filter_classes is not None else None, dev)

    if adj is not None:
        with timing.span("segmentation.instances", verbose=verbose):
            _, ids, pan_info, _ = components.split_into_instances(
                classes, neighbors.lists_to_csr(adj), nclasses, filter_classes,
                min_pts_per_inst)
    else:
        print("No adjacency list available, hence skipping instance seperation.")

    with timing.span("segmentation.viz", verbose=verbose):
        semantic_viz(points, classes, nclasses, votes=None, outdir=dirname / "segmentation")
        if adj is None:
            return votes, classes
        panoptic_viz(points, ids, pan_info, dirname / "panoptic_segmentation", alpha=1.0)

    with timing.span("segmentation.master_classes", verbose=verbose):
        master_classes(dirname, taxonomy=taxonomy, device=dev)
    return votes, classes


def remove_classes(
    dirname,
    mask_dir,
    keep_classes: Optional[Sequence[int]] = None,
    threshold: float = 0.75,
    nclasses: int = 133,
    verbose: bool = True,
    taxonomy: Optional[tax.Taxonomy] = None,
    device="cuda",
):
    """Keep-class filtering: classify every point (from
    segmentation/votes.npy when present), drop the points of removable
    classes and the unclassified ones, and write remaining_mask.npy,
    remaining.ply (red remaining, blue removed), cleaned.ply and
    removed_objects_info/. `keep_classes` defaults to the taxonomy's
    building classes. Returns remaining_mask [N] bool."""
    from fusion3dseg_tpu_torch.fusion import Fusion

    dev = cuda.resolve_device(device)
    dirname = Path(dirname)
    taxonomy = taxonomy or tax.Taxonomy()
    if keep_classes is None:
        keep_classes = taxonomy.building_classes

    points, norms, colors, _, _, _, depth_hw, _ = Fusion.load_data(dirname)
    colors = np.array(colors) if colors is not None else np.zeros_like(points)
    colors_org = colors.copy()
    npts = len(points)

    votes_file = dirname / "segmentation" / "votes.npy"
    with timing.span("remove_classes.vote", verbose=verbose):
        votes = vote_session(dirname, mask_dir, npts, depth_hw, nclasses,
                             votes_file=votes_file if votes_file.is_file() else None,
                             verbose=verbose, device=dev)
        if not votes_file.is_file():
            votes_file.parent.mkdir(parents=True, exist_ok=True)
            np.save(votes_file, votes)
        classes = _classify(votes, threshold, nclasses, None, dev)

    remove = np.setdiff1d(np.arange(nclasses), np.asarray(list(keep_classes)))
    remove = np.append(remove, [nclasses, nclasses + 1])  # the unclassified ids
    remaining_mask = ~np.isin(classes, remove)

    (dirname / "segmentation").mkdir(parents=True, exist_ok=True)
    np.save(dirname / "segmentation" / "remaining_mask.npy", remaining_mask)

    viz_colors = colors.copy()
    viz_colors[remaining_mask] = [1, 0, 0]
    viz_colors[~remaining_mask] = [0, 0, 1]
    ply.write_point_cloud(dirname / "segmentation" / "remaining.ply", points, colors=viz_colors)
    ply.write_point_cloud(
        dirname / "segmentation" / "cleaned.ply", points[remaining_mask],
        colors=colors_org[remaining_mask],
        normals=None if norms is None else np.asarray(norms)[remaining_mask])

    removed_point_classes = classes.copy()
    removed_point_classes[remaining_mask] = nclasses
    removed_point_classes[removed_point_classes == nclasses + 1] = nclasses
    semantic_viz(points, removed_point_classes, nclasses, votes=None,
                 outdir=dirname / "segmentation" / "removed_objects_info")
    return remaining_mask


def semantic_viz(points, classes, nclasses, votes=None, coco_data=None, outdir="./"):
    """classes.npy (and votes.npy when given), a class-coloured pcd.ply and
    info.json with css hex colours. Returns (colors, hex colours of the
    present classes, info)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if votes is not None:
        np.save(outdir / "votes.npy", votes)
    np.save(outdir / "classes.npy", classes)

    class_names = tax.stuff_classes_with_unclassified(coco_data, nclasses)
    palette = pal.random_palette(nclasses, seed=0, append_black=True)

    present = np.unique(classes)
    colors = np.zeros((len(points), 3))
    classwise_pts = []
    for cls_ in present:
        mask = classes == cls_
        colors[mask] = palette[cls_]
        classwise_pts.append(int(mask.sum()))

    ply.write_point_cloud(outdir / "pcd.ply", points, colors=colors)

    pal255 = (palette * 255).astype(int)
    info = [
        {
            "category_id": int(c),
            "name": class_names[c] if c < len(class_names) else str(c),
            "area": area,
            "hexcolor": pal.to_css_hex(pal255[c]),
        }
        for c, area in zip(present, classwise_pts)
    ]
    artifacts.write_info_json(outdir / "info.json", info)
    return colors, [pal.to_css_hex(pal255[c]) for c in present], info


def panoptic_viz(points, ids, idinfo, outdir, coco_data=None, colors=None, alpha=1.0):
    """ids.npy, a per-instance coloured pcd.ply (alpha-blended onto
    `colors`) and info.json with names and hex colours. Returns (colors,
    palette, info)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    np.save(outdir / "ids.npy", ids)

    nclasses_guess = max((i["category_id"] for i in idinfo), default=0)
    classnames = tax.stuff_classes_with_unclassified(
        coco_data, 133 if nclasses_guess <= 133 else nclasses_guess)

    allids = np.unique(ids)
    byid = {i["id"]: i for i in idinfo}
    # ids and info stay aligned: ids without an info entry are dropped from both
    present = [i for i in allids if i in byid]
    idinfo = [byid[i] for i in present]

    if colors is None:
        colors = np.zeros((len(points), 3))
    palette = pal.random_palette(len(present), seed=1)
    for id_, info, clr in zip(present, idinfo, palette):
        info["hexcolor"] = pal.to_css_hex((clr * 255).astype(int))
        cid = info["category_id"]
        info["name"] = classnames[cid] if cid < len(classnames) else str(cid)
        mask = ids == id_
        colors[mask] = (1 - alpha) * colors[mask] + alpha * clr

    artifacts.write_info_json(outdir / "info.json", idinfo)
    ply.write_point_cloud(outdir / "pcd.ply", points, colors=colors)
    return colors, palette, idinfo


def load_semantic_segmentation(semantic_dir):
    """(votes, classes, classes, unique classes, info) of a segmentation
    directory."""
    semantic_dir = Path(semantic_dir)
    votes = np.load(semantic_dir / "votes.npy")
    classes = np.load(semantic_dir / "classes.npy")
    info = artifacts.read_info_json(semantic_dir / "info.json")
    return votes, classes, classes, np.unique(classes), info


def load_csv(data_path):
    """The taxonomy CSV as the reference's load_csv tuple."""
    return tax.Taxonomy.from_csv(data_path).as_load_csv_tuple()


def master_classes(dirname, taxonomy: Optional[tax.Taxonomy] = None, verbose: bool = False,
                   device="cuda"):
    """Attach the parent taxonomy and each instance's oriented box to both
    info.json files, repaint segmentation/final_pcd.ply by parent class,
    and merge intersecting same-parent boxes (`merge_bb` writes
    panoptic_segmentation/final_info.json and ids.npy)."""
    dirname = Path(dirname)
    taxonomy = taxonomy or tax.Taxonomy()
    class_id, parent_name, parent_id, flag_infojson, _ = taxonomy.as_load_csv_tuple()

    points, _, _ = ply.read_point_cloud(dirname / "panoptic_segmentation" / "pcd.ply")
    ids = np.load(dirname / "panoptic_segmentation" / "ids.npy")
    classes = np.load(dirname / "segmentation" / "classes.npy")
    parent_classes = classes.copy()
    info_pan = artifacts.read_info_json(dirname / "panoptic_segmentation" / "info.json")
    info_sem = artifacts.read_info_json(dirname / "segmentation" / "info.json")
    palette = np.asarray(taxonomy.classes_meta()["colors"], np.float64) / 255.0

    num_inst = int(ids.max()) + 1 if len(ids) else 0
    with timing.span("master_classes.obbs", verbose=verbose):
        if num_inst * len(points) <= obb_ops.HOST_OBB_MAX_KN:
            corners, counts = obb_ops.instance_obb_corners_np(
                np.asarray(points, np.float32), np.asarray(ids, np.int32), num_inst)
        else:
            dev = cuda.resolve_device(device)
            corners, counts = obb_ops.instance_obb_corners(
                torch.as_tensor(np.asarray(points, np.float32), device=dev),
                torch.as_tensor(np.asarray(ids, np.int32), device=dev), num_inst)
            corners, counts = corners.cpu().numpy(), counts.cpu().numpy()

    final_info = []
    area_unclassified = 0
    unclassified_final_idx = None
    cid_index = {c: i for i, c in enumerate(class_id)}
    for info in info_pan:
        cat = info["category_id"]
        if cat in cid_index:
            k = cid_index[cat]
            info["parent_id"] = int(parent_id[k])
            info["parent_name"] = parent_name[k]
            info["parent_hexcolor"] = pal.to_css_hex((palette[int(parent_id[k])] * 255).astype(int))
            if cat == 133 or counts[info["id"]] < 4:
                info["bbox"] = None
            else:
                info["bbox"] = corners[info["id"]].tolist()
            if flag_infojson[k]:
                if cat == 133:
                    unclassified_final_idx = len(final_info)
                final_info.append(info)
        else:
            area_unclassified += int(np.count_nonzero(ids == info["id"]))
            info["parent_id"] = None
            info["parent_name"] = None
            info["parent_hexcolor"] = None
            info["bbox"] = None
    # the "unclassified" instance absorbs the out-of-taxonomy areas
    if unclassified_final_idx is not None:
        final_info[unclassified_final_idx]["area"] += area_unclassified

    for info in info_sem:
        cat = info["category_id"]
        mask = classes == cat
        if cat in cid_index:
            k = cid_index[cat]
            info["parent_id"] = int(parent_id[k])
            info["parent_name"] = parent_name[k]
            info["parent_hexcolor"] = pal.to_css_hex((palette[int(parent_id[k])] * 255).astype(int))
            parent_classes[mask] = int(parent_id[k])
        else:
            parent_classes[mask] = taxonomy.parent_classes.index("unclassified")

    colors = np.zeros((len(points), 3))
    for cls_ in np.unique(parent_classes):
        colors[parent_classes == cls_] = palette[int(cls_)]
    ply.write_point_cloud(dirname / "segmentation" / "final_pcd.ply", points, colors=colors)

    artifacts.write_info_json(dirname / "segmentation" / "info.json", info_sem)
    artifacts.write_info_json(dirname / "panoptic_segmentation" / "info.json", info_pan)

    merge_bb(dirname, final_info, ids, points, verbose=verbose, device=device)
