"""Plane and project-format helpers around the connected-vertex groups.

Counterpart of `fusion3dseg_tpu/pipeline/planes.py` (host): the category
and shape legends, the VIDs CSV that lists connected vertex groups (the
first field of a row is its length), the vertex CSV read, ply path
resolution and small path helpers. `run_connected` computes the groups with
the native grid union-find (`io/native.connected_components`).
"""

from __future__ import annotations

import os
from datetime import datetime
from pathlib import Path
from typing import List, Optional

import numpy as np

from fusion3dseg_tpu_torch.io import native


def obj_legend() -> dict:
    """Category id -> name."""
    return {1: "Walls", 2: "Ceilings", 3: "Floors", 4: "Beams",
            5: "Columns", 6: "Doors", 7: "Windows", 8: "Pipes"}


def shape_legend() -> dict:
    """Shape name -> id."""
    return {"Plane": 1, "Cuboid": 2, "Cylinders": 3, "Sphere": 4,
            "Cone": 5, "Unidentified": 0}


def headers() -> dict:
    """Plane-table column -> index."""
    return {"Shapeinfo": 0, "indicies": 1, "BBoxids": 2, "BBoxpoints": 3,
            "Hide": 4, "Category": 5, "Shape": 6, "Area": 7}


def reveal_shape(category: int) -> int:
    """Category -> shape id: planes for 1-7 but beams and columns
    (cuboids), cylinders otherwise."""
    if category in range(1, 8) and category not in (4, 5):
        return shape_legend()["Plane"]
    if category in (4, 5):
        return shape_legend()["Cuboid"]
    return shape_legend()["Cylinders"]


def col(name: str) -> int:
    return headers()[name]


def obj(name: str) -> Optional[int]:
    for key, val in obj_legend().items():
        if val == name:
            return key
    return None


def run_connected(points, radius: float, labels=None) -> List[np.ndarray]:
    """Vertex-index groups of the radius graph's connected components
    (joined within equal `labels` when given), in order of each group's
    first vertex: the VIDs rows."""
    comp = native.connected_components(np.asarray(points, np.float32), radius, labels)
    groups = {}
    for i, c in enumerate(comp):
        groups.setdefault(int(c), []).append(i)
    return [np.asarray(v, np.int64) for v in groups.values()]


def write_vids_csv(path, groups) -> None:
    """A "VIDs" header, then one row a group: its length, its indices."""
    with open(path, "w") as fp:
        fp.write("VIDs\n")
        for g in groups:
            fp.write(",".join([str(len(g))] + [str(int(i)) for i in g]) + "\n")


def read_vids_csv(path) -> List[List[int]]:
    """The vertex-index lists of a VIDs CSV (each row's count dropped)."""
    out = []
    with open(path) as fp:
        header = fp.readline()
        if not header.strip().startswith("VIDs"):
            raise ValueError(f"{path} is not a VIDs CSV (header {header.strip()!r})")
        for line in fp:
            line = line.strip()
            if line:
                out.append([int(x) for x in line.split(",")[1:]])
    return out


def _read_numeric_csv(path) -> np.ndarray:
    """A comma-separated numeric table with one header row -> float64
    [rows, cols]; empty fields are NaN."""
    rows = []
    with open(path) as fp:
        fp.readline()
        for line in fp:
            line = line.rstrip("\r\n")
            if line.strip():
                rows.append([float(x) if x.strip() else np.nan for x in line.split(",")])
    return np.asarray(rows, np.float64).reshape(len(rows), -1)


def read_vertices_connected_files(file_connected_path, file_vertex_path):
    """(vertex table rounded to 3 decimals with columns [x, y, z, ..., id,
    1], VIDs lists): the vertex CSV's first column is the id."""
    vertex_all = _read_numeric_csv(file_vertex_path)
    vertex_all = np.column_stack((vertex_all[:, 1:], vertex_all[:, 0], np.ones(len(vertex_all))))
    return vertex_all.round(3), read_vids_csv(file_connected_path)


def add_normals_from_cloud(vertex: np.ndarray, points: np.ndarray, normals: np.ndarray):
    """Per-point normals appended as columns."""
    if len(normals) != len(vertex):
        raise IndexError
    return np.hstack((vertex, np.asarray(normals)))


def resolve_ply(input_path, folder: str = "fusion") -> str:
    """The stage's ply inside a session directory: fusion_*.ply under
    fusion/, cleaned*.ply under segmentation/, else an Img_*.ply."""
    prefix = {"fusion": "fusion_", "segmentation": "cleaned"}.get(folder, "Img_")
    folder_path = Path(input_path) / folder
    cands = sorted(p for p in folder_path.glob("*.ply") if prefix in p.name)
    if not cands:
        cands = sorted(p for p in Path(input_path).glob("*.ply") if "Img_" in p.name)
    if not cands:
        raise FileNotFoundError(f"no {prefix}*.ply under {folder_path}")
    return str(cands[0])


def read_plane_txt(inputfile) -> np.ndarray:
    return np.loadtxt(inputfile)


def path_correction(p: str) -> str:
    return p.replace("\\", "/")


def exists(filepath) -> bool:
    return os.path.exists(filepath)


def check_folder_status(folderpath):
    os.makedirs(folderpath, exist_ok=True)
    return folderpath


def current_time(fmt: str = "%Y%m%d_%H-%M") -> str:
    return datetime.now().strftime(fmt)
