"""Door and window rectangle meshes on planes.

Counterpart of `fusion3dseg_tpu/pipeline/door_window.py` (NumPy, host).
For every door/window instance it picks the face of a planar proxy mesh
(`polyfit/*.off`, or a given .off/.ply) that lies closest to the
instance's points, or fits a plane to them when there is no proxy,
projects the points onto it, skips near-horizontal planes, and emits the
in-plane min/max rectangle as two coloured triangles:
`panoptic_segmentation/door_window_mesh.ply` and `triangle_ids.npy`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from fusion3dseg_tpu_torch.io import artifacts, ply
from fusion3dseg_tpu_torch.utils import palette as pal

# door-stuff, window-blind, window-other in the COCO-133 label space
# (utils/taxonomy.py)
DOOR_WINDOW_CATEGORIES = (86, 114, 115)


def points_in_triangles(points: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Barycentric inside test of points [N, 3] lying on the plane of the
    triangle tri [3, 3]. Returns [N] bool (all False when degenerate)."""
    v0 = tri[2] - tri[0]
    v1 = tri[1] - tri[0]
    v2 = points - tri[0]
    d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
    d02 = v2 @ v0
    d12 = v2 @ v1
    denom = d00 * d11 - d01 * d01
    if abs(denom) < 1e-18:
        return np.zeros(len(points), bool)
    u = (d11 * d02 - d01 * d12) / denom
    v = (d00 * d12 - d01 * d02) / denom
    return (u >= 0) & (v >= 0) & (u + v <= 1)


def perpendicular_basis(normal: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two unit vectors spanning the plane of `normal`."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    arbitrary = np.array([0.0, 0.0, 1.0])
    if abs(n @ arbitrary) > 1.0 - 1e-9:
        arbitrary = np.array([0.0, 1.0, 0.0])
    v1 = np.cross(n, arbitrary)
    v2 = np.cross(n, v1)
    return v1 / np.linalg.norm(v1), v2 / np.linalg.norm(v2)


def fit_plane(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares plane through points -> (centroid, unit normal)."""
    c = points.mean(0)
    _, _, vt = np.linalg.svd(points - c, full_matrices=False)
    return c, vt[-1]


def _closest_face_projection(box_pts: np.ndarray, tri_vertices: np.ndarray,
                             tri_normals: np.ndarray, angle_threshold: float):
    """Faces within 5% of the least summed |perpendicular distance| are
    candidates; the one holding the most projected points wins; a
    near-horizontal winner is rejected. Returns (projected points, normal)
    or (None, None)."""
    vecs = box_pts[:, None, :] - tri_vertices[None, :, 0, :]
    perp = np.einsum("ptc,tc->pt", vecs, tri_normals)
    tri_dist = np.abs(perp).sum(0)
    upper = tri_dist[tri_dist.argmin()] * 1.05
    best, best_inside = None, -1
    for t in np.nonzero(tri_dist <= upper)[0]:
        proj = box_pts - perp[:, t:t + 1] * tri_normals[t]
        inside = int(points_in_triangles(proj, tri_vertices[t]).sum())
        if inside > best_inside:
            best, best_inside = t, inside
    n = tri_normals[best]
    if abs(n @ np.array([0.0, 0.0, 1.0])) > angle_threshold:
        return None, None
    return box_pts - perp[:, best:best + 1] * n, n


def generate_mesh(input_dir, proxy_mesh: Optional[str] = None,
                  categories: Sequence[int] = DOOR_WINDOW_CATEGORIES, angle_deg: float = 10.0):
    """Door/window rectangles of a segmented session directory (fusion/ and
    panoptic_segmentation/). `proxy_mesh` (.off or .ply) defaults to the
    first `<input_dir>/polyfit/*.off`; without one each instance gets a
    fitted plane. Instances under 4 points are skipped.

    Returns (triangle ids [2B], vertices [4B, 3], triangles [2B, 3]) and
    writes panoptic_segmentation/{door_window_mesh.ply, triangle_ids.npy}
    (only the ids, empty, when there is no quad)."""
    dirname = Path(input_dir)
    pts, *_ = artifacts.load_fusion_data(dirname)
    ids = np.load(dirname / "panoptic_segmentation" / "ids.npy")
    with open(dirname / "panoptic_segmentation" / "info.json") as fp:
        info = json.load(fp)

    tri_vertices = tri_normals = None
    if proxy_mesh is None:
        offs = sorted((dirname / "polyfit").glob("*.off")) if (dirname / "polyfit").is_dir() else []
        proxy_mesh = str(offs[0]) if offs else None
    if proxy_mesh is not None:
        if str(proxy_mesh).endswith(".off"):
            verts, faces = ply.read_off(proxy_mesh)
        else:
            verts, faces, _ = ply.read_mesh(proxy_mesh)
        tri_vertices = verts[faces]
        n = np.cross(tri_vertices[:, 1] - tri_vertices[:, 0],
                     tri_vertices[:, 2] - tri_vertices[:, 0])
        tri_normals = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    angle_threshold = float(np.cos(np.deg2rad(angle_deg)))
    cat_set = set(int(c) for c in categories)
    quad_tris = np.array([[0, 1, 2], [2, 3, 0]])
    bbox_vertices, bbox_triangles, tri_ids, tri_colors = [], [], [], []
    for idinfo in info:
        if int(idinfo["category_id"]) not in cat_set:
            continue
        box_pts = pts[ids == idinfo["id"]].astype(np.float64)
        if len(box_pts) < 4:
            continue
        if tri_vertices is not None:
            proj, normal = _closest_face_projection(box_pts, tri_vertices, tri_normals,
                                                    angle_threshold)
            if proj is None:
                continue
        else:
            c, normal = fit_plane(box_pts)
            if abs(normal @ np.array([0.0, 0.0, 1.0])) > angle_threshold:
                continue
            proj = box_pts - ((box_pts - c) @ normal)[:, None] * normal
        i, j = perpendicular_basis(normal)
        origin = proj[0]
        x = (proj - origin) @ i
        y = (proj - origin) @ j
        bbox_vertices.append([origin + x.min() * i + y.max() * j,
                              origin + x.min() * i + y.min() * j,
                              origin + x.max() * i + y.min() * j,
                              origin + x.max() * i + y.max() * j])
        bbox_triangles.append(quad_tris + 4 * len(bbox_triangles))
        tri_colors.extend([np.array(pal.from_css_hex(idinfo.get("hexcolor", "#808080")))] * 4)
        tri_ids.extend([idinfo["id"], idinfo["id"]])

    out = dirname / "panoptic_segmentation"
    out.mkdir(parents=True, exist_ok=True)
    if not tri_ids:
        np.save(out / "triangle_ids.npy", np.zeros(0, np.int32))
        return np.zeros(0, np.int32), np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    verts = np.vstack(bbox_vertices)
    tris = np.vstack(bbox_triangles).astype(np.int32)
    tri_ids = np.asarray(tri_ids, np.int32)
    ply.write_mesh(out / "door_window_mesh.ply", verts, tris,
                   np.asarray(tri_colors, np.float64) / 255.0)
    np.save(out / "triangle_ids.npy", tri_ids)
    return tri_ids, verts, tris
