"""Stage artifacts on disk: the file contract between the pipeline's stages.

Counterpart of `fusion3dseg_tpu/io/artifacts.py`, with the same names and
dtypes, so either package reads what the other wrote:

  fusion/fusion_data.pkl   dict(points, normals, colors, nmerges, occurences,
                                nframes, depth_hw)
  fusion/adj.pkl           object ndarray of neighbour index arrays
  fusion/uv2pt/<frame>.npy [H*W] int32, -1 = unmapped
  fusion/fusion_<r>_<a>.ply
  segmentation/{votes.npy, classes.npy, info.json, ...}
  panoptic_segmentation/{ids.npy, info.json, final_info.json}

Every array written is a NumPy array: tensors (on any device) are copied
to the host first, since a pickled or `np.save`d tensor would not load
without torch.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import ply


def to_numpy(a):
    """A host NumPy array of `a` (a tensor on any device, or array-like);
    None stays None."""
    if a is None:
        return None
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def dump_fusion_data(
    dirname,
    points,
    normals=None,
    colors=None,
    nmerges=None,
    occurences=None,
    nframes: int = 0,
    depth_hw: Tuple[int, int] = (0, 0),
    adjacency: Optional[np.ndarray] = None,
    ds_radius: Optional[float] = None,
    ds_angle: Optional[float] = None,
) -> None:
    """Write fusion_data.pkl (+ adj.pkl, + fusion_{r}_{a}.ply)."""
    dirname = Path(dirname)
    (dirname / "fusion").mkdir(parents=True, exist_ok=True)
    points, normals, colors = to_numpy(points), to_numpy(normals), to_numpy(colors)
    data = {
        "points": points,
        "normals": normals,
        "colors": colors,
        "nmerges": to_numpy(nmerges),
        "occurences": to_numpy(occurences),
        "nframes": nframes,
        "depth_hw": tuple(depth_hw),
    }
    with open(dirname / "fusion" / "fusion_data.pkl", "wb") as fp:
        pickle.dump(data, fp)
    if adjacency is not None:
        with open(dirname / "fusion" / "adj.pkl", "wb") as fp:
            pickle.dump(adjacency, fp)
    radius = str(ds_radius).replace(".", "_")
    ply.write_point_cloud(
        dirname / "fusion" / f"fusion_{radius}_{ds_angle}.ply",
        points, colors=colors, normals=normals,
    )


def load_fusion_data(dirname):
    """Read fusion_data.pkl + adj.pkl: (points, normals, colors, nmerges,
    occurences, nframes, depth_hw, adj or None)."""
    dirname = Path(dirname)
    with open(dirname / "fusion" / "fusion_data.pkl", "rb") as fp:
        data = pickle.load(fp)
    adjfile = dirname / "fusion" / "adj.pkl"
    adj = None
    if adjfile.is_file():
        with open(adjfile, "rb") as fp:
            adj = pickle.load(fp)
    return (
        data["points"], data["normals"], data["colors"],
        data["nmerges"], data["occurences"],
        data["nframes"], data["depth_hw"], adj,
    )


def save_uv2pt(dirname, frame_name: str, uv2pt) -> None:
    out = Path(dirname) / "fusion" / "uv2pt"
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / f"{frame_name}.npy", to_numpy(uv2pt).astype(np.int32))


def save_uv2pt_batch(dirname, frame_names, uv2pt_batch) -> None:
    """Write the whole session's uv2pt files, clearing the directory's old
    `*.npy` first: a run with other frames or a larger cloud would leave
    rows that index past the new cloud, and the voters read every file."""
    out = Path(dirname) / "fusion" / "uv2pt"
    out.mkdir(parents=True, exist_ok=True)
    for stale in out.glob("*.npy"):
        stale.unlink()
    uv2pt_batch = to_numpy(uv2pt_batch).astype(np.int32)
    for name, uv in zip(frame_names, uv2pt_batch):
        np.save(out / f"{name}.npy", uv)


def matched_mask_uv2pt_files(maskdir, uv2ptdir):
    """Pair mask and uv2pt files by the intersection of their stems."""
    maskdir, uv2ptdir = Path(maskdir), Path(uv2ptdir)
    masks = {p.stem: p for p in maskdir.iterdir() if p.is_file()}
    uvs = {p.stem: p for p in uv2ptdir.iterdir() if p.is_file()}
    names = sorted(masks.keys() & uvs.keys())
    return [masks[n] for n in names], [uvs[n] for n in names]


def _clean(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, dict):
        return {k: _clean(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_clean(v) for v in o]
    return o


def write_info_json(path, info) -> None:
    """Write per-instance info dicts as indented JSON (NumPy scalars and
    arrays as plain numbers and lists), creating the directory."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fp:
        json.dump(_clean(info), fp, indent=4)


def read_info_json(path):
    with open(path) as fp:
        return json.load(fp)
