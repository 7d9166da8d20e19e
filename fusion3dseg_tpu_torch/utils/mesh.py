"""Mesh and point-cloud utilities (NumPy, host).

Counterpart of `fusion3dseg_tpu/utils/mesh.py`: geometry constructors,
vertex/triangle maps, face filtering by vertex mask, vertex-connected
triangle clusters (native union-find), per-class triangle colours, OBB
axes, texture sampling and rasterization, batch image reading, vector
angles, and batch queries (nearest point, points in a box) in place of
interactive picking.

`rasterize_triangles_uv` fills each triangle with OpenCV's `fillPoly`
pixel rule, reproduced here (`fill_poly`): the polygon's edges drawn as
8-connected lines, then the scanline fill of the edge table in 16.16 fixed
point, later triangles over earlier ones. `read_images` returns BGR, as
`cv2.imread` does, unlike the rest of the port (`io/image.read` is RGB).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from fusion3dseg_tpu_torch.io import image, native, ply

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# ------------------------------------------------------------ constructors --

def to_pcd(points, colors=None, normals=None, save=None):
    """A point-cloud dict; written as .ply when `save` names a file."""
    pcd = {"points": np.asarray(points), "colors": colors, "normals": normals}
    if save is not None:
        ply.write_point_cloud(save, pcd["points"], colors=colors, normals=normals)
    return pcd


def to_mesh(vertices, triangles, vertex_colors=None, save=None):
    mesh = {"vertices": np.asarray(vertices), "triangles": np.asarray(triangles, np.int32),
            "vertex_colors": vertex_colors}
    if save is not None:
        ply.write_mesh(save, mesh["vertices"], mesh["triangles"], vertex_colors)
    return mesh


def to_lines(points, edges, colors=None):
    """Line-set dict: points [N, 3], edges [E, 2]."""
    return {"points": np.asarray(points), "edges": np.asarray(edges, np.int32), "colors": colors}


def read_camera_json(path):
    """An open3d PinholeCameraParameters (or bare intrinsic) JSON ->
    (K [3, 3], extrinsic [4, 4], width, height); open3d stores the
    matrices column-major."""
    with open(path) as fp:
        data = json.load(fp)
    if "intrinsic" in data:
        intr = data["intrinsic"]
        extr = np.asarray(data.get("extrinsic", np.eye(4).ravel()), float)
    else:
        intr = data
        extr = np.eye(4).ravel()
    K = np.asarray(intr["intrinsic_matrix"], float).reshape(3, 3, order="F")
    return K, extr.reshape(4, 4, order="F"), int(intr["width"]), int(intr["height"])


# ------------------------------------------------- vertex / triangle maps --

def vertex_triangle_maps(triangles: np.ndarray, num_vertices: int):
    """CSR vertex -> triangles: (offsets [V+1], triangle ids [3T] grouped by
    vertex, ascending within a vertex)."""
    triangles = np.asarray(triangles, np.int64)
    t_ids = np.repeat(np.arange(len(triangles)), 3)
    verts = triangles.reshape(-1)
    order = np.argsort(verts, kind="stable")
    offsets = np.searchsorted(verts[order], np.arange(num_vertices + 1))
    return offsets, t_ids[order]


def keep_faces_by_vertex_mask(vertices: np.ndarray, triangles: np.ndarray,
                              keep_vertices: np.ndarray, require_all: bool = True):
    """Keep the faces whose vertices are all (or, without `require_all`,
    any) kept, and reindex. Returns (vertices, triangles, used vertex mask,
    kept face mask); every vertex of a kept face is kept."""
    keep_vertices = np.asarray(keep_vertices, bool)
    fv = keep_vertices[triangles]
    face_keep = fv.all(-1) if require_all else fv.any(-1)
    used = np.zeros(len(vertices), bool)
    used[np.asarray(triangles)[face_keep].reshape(-1)] = True
    remap = np.cumsum(used) - 1
    new_tris = remap[np.asarray(triangles)[face_keep]]
    return vertices[used], new_tris.astype(np.int32), used, face_keep


def connected_triangle_clusters(triangles: np.ndarray, num_vertices: int) -> np.ndarray:
    """[T] int64 cluster of each triangle (its lowest triangle index) over
    shared vertices, by the native union-find: each triangle links to the
    first triangle of each of its vertices."""
    triangles = np.asarray(triangles, np.int64)
    T = len(triangles)
    offsets, tids = vertex_triangle_maps(triangles, num_vertices)
    firsts = np.full(num_vertices, -1, np.int64)
    nz = offsets[:-1] < offsets[1:]
    firsts[nz] = tids[offsets[:-1][nz]]
    edge_dst = firsts[triangles.reshape(-1)].astype(np.int32)
    off3 = np.arange(T + 1, dtype=np.int32) * 3
    return native.components_from_csr(off3, edge_dst).astype(np.int64)


def triangle_colors_by_class(triangles, vertex_classes, palette):
    """Majority class of each triangle's vertices (the first vertex's on a
    three-way tie) and its palette colour: (colours, classes)."""
    vc = np.asarray(vertex_classes)[np.asarray(triangles)]
    maj = np.where(vc[:, 0] == vc[:, 1], vc[:, 0],
                   np.where(vc[:, 1] == vc[:, 2], vc[:, 1], vc[:, 0]))
    return np.asarray(palette)[maj], maj


# ------------------------------------------------------------- OBB helpers --

def obb_axes(points: np.ndarray, device="cuda"):
    """PCA OBB of one point set: (center [3], axes [3, 3] rows, half
    extents [3]), through `ops/obb.instance_obbs` on `device`."""
    from fusion3dseg_tpu_torch import cuda
    from fusion3dseg_tpu_torch.ops import obb as obb_ops

    dev = cuda.resolve_device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    centers, axes, half, _ = obb_ops.instance_obbs(
        pts, torch.zeros(len(pts), dtype=torch.int32, device=dev), 1)
    return centers[0].cpu().numpy(), axes[0].cpu().numpy(), half[0].cpu().numpy()


# ------------------------------------------------------- texture utilities --

def uv_texture_to_vertex_colors(uvs: np.ndarray, texture: np.ndarray) -> np.ndarray:
    """Texture sampled at per-vertex uv (in [0, 1], origin bottom-left), the
    nearest texel; uint8 textures come back as float in [0, 1]."""
    h, w = texture.shape[:2]
    uvs = np.asarray(uvs)
    x = np.clip((uvs[:, 0] * (w - 1)).round().astype(int), 0, w - 1)
    y = np.clip(((1 - uvs[:, 1]) * (h - 1)).round().astype(int), 0, h - 1)
    cols = texture[y, x]
    if cols.dtype == np.uint8:
        cols = cols.astype(np.float64) / 255.0
    return cols


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine on an image of w x h: (whether any of the segment
    lies in the image, the end points as the clipping left them)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's 8-connected `Line` (a LineIterator drawn left to right)."""
    h, w = img.shape[:2]
    x1, y1 = p1
    x2, y2 = p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        step_minor = err < 0
        err += minus_delta + (plus_delta if step_minor else 0)
        if vert:  # y always steps, x on minor
            y += sy
            x += sx if step_minor else 0
        else:
            x += sx
            y += sy if step_minor else 0


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """`cv2.fillPoly(img, [pts], color)` for one polygon of integer vertices
    (shift 0, 8-connected lines): the outline, then the scanline fill of the
    pixel centres between edge pairs. Equal to OpenCV 5's on polygons whose
    vertices lie in the image; where an edge leaves the image, OpenCV 5 also
    paints border columns that this version leaves alone."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []  # [y0, y1, x at y0, dx], x in 16.16 fixed point
    x0, y0 = v[-1]
    for x1, y1 in v:
        _line8(img, (x0, y0), (x1, y1), color)
        c = (x0, y0, x1, y1)
        if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
            _, *clipped = _clip_line(w, h, x0, y0, x1, y1)
            if clipped[1] != clipped[3]:
                c = clipped
        if y0 != y1:
            cx0, cy0, cx1, cy1 = c[0] << XY_SHIFT, c[1], c[2] << XY_SHIFT, c[3]
            dx = _trunc_div(cx1 - cx0, cy1 - cy0)
            if y0 < y1:
                edges.append([y0, y1, cx0 + (y0 - cy0) * dx, dx])
            else:
                edges.append([y1, y0, cx1 + (y1 - cy1) * dx, dx])
        x0, y0 = x1, y1
    _fill_edges(img, edges, color)


def _fill_edges(img: np.ndarray, edges: List[list], color) -> None:
    """The scanline fill of OpenCV's FillEdgeCollection: an active edge list
    sorted by x, spans between consecutive pairs, ceil on the left and floor
    on the right."""
    h, w = img.shape[:2]
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << XY_SHIFT):
        return
    edges = sorted(edges, key=lambda e: (e[0], e[2], e[3]))
    active: List[list] = []
    i, pos = 0, 0
    for y in range(edges[0][0], min(y_max, h)):
        active = [e for e in active if e[1] != y]  # edges ending at this row
        pos = 0
        while i < len(edges) and edges[i][0] == y:  # merge new edges in x order
            while pos < len(active) and active[pos][2] < edges[i][2]:
                pos += 1
            active.insert(pos, edges[i])
            pos += 1
            i += 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                lo, hi = (b, a) if a[2] > b[2] else (a, b)
                x1 = (lo[2] + XY_ONE - 1) >> XY_SHIFT
                x2 = hi[2] >> XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = color
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])  # stable, as OpenCV's bubble sort


def rasterize_triangles_uv(uvs: np.ndarray, triangles: np.ndarray, values,
                           texture_hw: Tuple[int, int]) -> np.ndarray:
    """[h, w, 3] uint8 texture with each triangle filled in its value (3
    channels, in the order given), through its vertices' uv (in [0, 1],
    origin bottom-left, truncated to pixels); later triangles overwrite."""
    h, w = texture_hw
    tex = np.zeros((h, w, 3), np.uint8)
    pix = np.stack([uvs[:, 0] * (w - 1), (1 - uvs[:, 1]) * (h - 1)], axis=-1).astype(np.int32)
    values = np.asarray(values)
    for t, tri in enumerate(np.asarray(triangles)):
        fill_poly(tex, pix[tri], np.asarray([int(c) for c in values[t]], np.uint8))
    return tex


def read_images(dirname, extension="png", grayscale=False):
    """(images, stems) of every `*.<extension>` in `dirname`, sorted: [H, W]
    uint8 with `grayscale`, else [H, W, 3] uint8 in BGR order, as
    `cv2.imread` gives them; an unreadable file gives None."""
    files = sorted(Path(dirname).glob(f"*.{extension}"))
    out = []
    for f in files:
        try:
            img = image.read(f, gray=grayscale)
        except (OSError, image.ImageError):
            img = None
        out.append(img if img is None or grayscale else np.ascontiguousarray(img[:, :, ::-1]))
    return out, [f.stem for f in files]


def vector_angles(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Pairwise angles (radians) between the rows of v1 and of v2."""
    v1 = np.atleast_2d(v1)
    v2 = np.atleast_2d(v2)
    v1 = v1 / np.linalg.norm(v1, axis=-1, keepdims=True)
    v2 = v2 / np.linalg.norm(v2, axis=-1, keepdims=True)
    return np.arccos(np.clip(v1 @ v2.T, -1.0, 1.0))


# --------------------------------------------------- batch picking queries --

def nearest_points(points: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of the cloud point nearest to each query position."""
    from scipy.spatial import cKDTree

    return cKDTree(np.asarray(points)).query(np.atleast_2d(queries))[1]


def select_in_box(points: np.ndarray, box_min, box_max) -> np.ndarray:
    """Indices of the points inside an axis-aligned box (bounds included)."""
    pts = np.asarray(points)
    m = np.all((pts >= np.asarray(box_min)) & (pts <= np.asarray(box_max)), axis=-1)
    return np.nonzero(m)[0]
