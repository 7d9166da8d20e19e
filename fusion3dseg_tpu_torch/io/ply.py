"""PLY point clouds and triangle meshes (binary little-endian; ascii read).

Counterpart of `fusion3dseg_tpu/io/ply.py`, NumPy only: the port keeps its
own copy. For the same arrays the files it writes are byte-identical to
the JAX package's: xyz (+ normals) as little-endian float32, colours as
uchar (float colours in [0, 1] are scaled by 255, clipped and truncated).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def write_point_cloud(
    path,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
) -> None:
    """Write a binary_little_endian PLY point cloud.

    colors: float [0,1] or uint8 [0,255], shape [N,3].
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points, np.float32)
    n = len(points)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {ax}" for ax in "xyz"]
    cols = None
    if normals is not None:
        header += [f"property float n{ax}" for ax in "xyz"]
    if colors is not None:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(np.asarray(cols, np.float64) * 255.0, 0, 255).astype(np.uint8)
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header.append("end_header")

    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if cols is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, dtype=fields)
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        nr = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = nr[:, 0], nr[:, 1], nr[:, 2]
    if cols is not None:
        rec["red"], rec["green"], rec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]

    with open(path, "wb") as fp:
        fp.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(fp)


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_point_cloud(path) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Read a PLY point cloud -> (points, colors01 or None, normals or None).

    Handles binary_little_endian and ascii vertex elements with x/y/z,
    optional nx/ny/nz, optional red/green/blue.
    """
    path = Path(path)
    with open(path, "rb") as fp:
        if fp.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        n = 0
        props = []
        in_vertex = False
        while True:
            line = fp.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                _, typ, pname = line.split()
                props.append((pname, _PLY_TYPES[typ]))
            elif line == "end_header":
                break
        if fmt == "binary_little_endian":
            rec = np.fromfile(fp, dtype=np.dtype(props), count=n)
        elif fmt == "ascii":
            data = np.loadtxt(fp, max_rows=n)
            rec = np.rec.fromarrays(
                [data[:, i] for i in range(len(props))], dtype=np.dtype(props)
            )
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    names = rec.dtype.names
    colors = None
    if "red" in names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
        # integer color properties (uchar/ushort/...) are 0-255; float and
        # double properties (CloudCompare/MeshLab exports) are already 0-1
        scale = 255.0 if np.issubdtype(colors.dtype, np.integer) else 1.0
        colors = colors.astype(np.float32) / scale
    normals = None
    if "nx" in names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]], -1).astype(np.float32)
    return pts, colors, normals


def write_mesh(
    path,
    vertices: np.ndarray,
    triangles: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
) -> None:
    """Write a binary PLY triangle mesh (used by door/window bbox meshes,
    reference segUtils/door_window_bbox.py:140-149)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int32)
    nv, nt = len(vertices), len(triangles)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {nv}"]
    header += [f"property float {ax}" for ax in "xyz"]
    cols = None
    if vertex_colors is not None:
        cols = np.asarray(vertex_colors)
        if cols.dtype != np.uint8:
            cols = np.clip(np.asarray(cols, np.float64) * 255.0, 0, 255).astype(np.uint8)
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += [f"element face {nt}", "property list uchar int vertex_indices", "end_header"]

    vfields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if cols is not None:
        vfields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    vrec = np.empty(nv, dtype=vfields)
    vrec["x"], vrec["y"], vrec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if cols is not None:
        vrec["red"], vrec["green"], vrec["blue"] = cols[:, 0], cols[:, 1], cols[:, 2]

    frec = np.empty(nt, dtype=[("n", "u1"), ("v0", "<i4"), ("v1", "<i4"), ("v2", "<i4")])
    frec["n"] = 3
    frec["v0"], frec["v1"], frec["v2"] = triangles[:, 0], triangles[:, 1], triangles[:, 2]

    with open(path, "wb") as fp:
        fp.write(("\n".join(header) + "\n").encode("ascii"))
        vrec.tofile(fp)
        frec.tofile(fp)


def read_mesh(path) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Read a binary/ascii PLY mesh -> (vertices, triangles, vertex_colors)."""
    path = Path(path)
    with open(path, "rb") as fp:
        if fp.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt, nv, nt = None, 0, 0
        vprops = []
        section = None
        while True:
            line = fp.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                section = name
                if name == "vertex":
                    nv = int(cnt)
                elif name == "face":
                    nt = int(cnt)
            elif line.startswith("property") and section == "vertex" and "list" not in line:
                _, typ, pname = line.split()
                vprops.append((pname, _PLY_TYPES[typ]))
            elif line == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError("only binary_little_endian mesh read supported")
        vrec = np.fromfile(fp, dtype=np.dtype(vprops), count=nv)
        frec = np.fromfile(
            fp, dtype=[("n", "u1"), ("v0", "<i4"), ("v1", "<i4"), ("v2", "<i4")], count=nt
        )
    verts = np.stack([vrec["x"], vrec["y"], vrec["z"]], -1).astype(np.float32)
    tris = np.stack([frec["v0"], frec["v1"], frec["v2"]], -1).astype(np.int32)
    colors = None
    if "red" in vrec.dtype.names:
        colors = np.stack([vrec["red"], vrec["green"], vrec["blue"]], -1)
    return verts, tris, colors


def read_off(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read an OFF mesh (the reference's polyfit/*.off inputs,
    door_window_bbox.py:74). Returns (vertices [V,3], faces [F,3])."""
    with open(path) as fp:
        tokens = fp.read().split()
    assert tokens[0] == "OFF"
    nv, nf = int(tokens[1]), int(tokens[2])
    i = 4
    verts = np.array(tokens[i : i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(tokens[i])
        face = [int(t) for t in tokens[i + 1 : i + 1 + k]]
        for j in range(1, k - 1):  # fan-triangulate
            faces.append([face[0], face[j], face[j + 1]])
        i += 1 + k
    return verts, np.array(faces, np.int32)
