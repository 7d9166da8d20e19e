"""Post-processing against the JAX package on the CPU: the gated flood
fill, the refinement files, the door/wall geometry, the door/window meshes,
the plane/VIDs tools, the mesh utilities and the optional viewer adapter.

The segmented tree is the 6-frame 64x48 room through the JAX package's
`process3DSeg` -> `segment`; each package refines or meshes its own copy,
and the files they write must be byte-identical."""

import filecmp
import json
import shutil

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from fusion3dseg_tpu.io import synthetic as jsyn
from fusion3dseg_tpu.pipeline import door_window as jdw, get3dseg as jget3d, planes as jplanes, \
    process3d as jp3d, refinement as jref
from fusion3dseg_tpu.utils import mesh as jmesh
from fusion3dseg_tpu_torch.io import native, ply
from fusion3dseg_tpu_torch.pipeline import door_window as tdw, planes as tplanes, \
    refinement as tref
from fusion3dseg_tpu_torch.utils import mesh as tmesh, viz as tviz

ULP_BAR = 4  # float32 ulps of the threshold within which a gate decision may flip


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("post")
    sess = jsyn.make_session(nframes=6, depth_hw=(64, 48))
    src = jsyn.write_session_dir(sess, root / "session")
    jp3d.process3DSeg(src, root / "seg")
    jget3d.segment(root / "seg", src / "masks", verbose=False)
    return root


def _copies(tree, name):
    out = {}
    for pkg in ("jax", "port"):
        d = tree / f"{name}_{pkg}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(tree / "seg", d)
        out[pkg] = d
    return out


def _same_files(a, b, sub):
    fa = sorted(p.relative_to(a) for p in (a / sub).rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in (b / sub).rglob("*") if p.is_file())
    assert fa == fb and fa
    assert [str(f) for f in fa if not filecmp.cmp(a / f, b / f, shallow=False)] == []


def _door(tree):
    ids = np.load(tree / "seg" / "panoptic_segmentation" / "ids.npy")
    info = json.loads((tree / "seg" / "panoptic_segmentation" / "info.json").read_text())
    door = [i["id"] for i in info if i["category_id"] in tdw.DOOR_WINDOW_CATEGORIES][0]
    pts, _, _ = ply.read_point_cloud(tree / "seg" / "panoptic_segmentation" / "pcd.ply")
    return ids, door, pts


# ------------------------------------------------------------ gated fill --

def _fill_cloud(nchan):
    rng = np.random.default_rng(7)
    pts = np.round(np.c_[rng.uniform(0, 3, 15_000), rng.uniform(0, 2, 15_000),
                         np.zeros(15_000)], 2).astype(np.float32)
    adj = native.radius_graph(pts, 0.06, k=12)
    base = 0.3 + 0.4 * (pts[:, :1] > 1.5) + 0.02 * rng.standard_normal((len(pts), 1))
    values = np.repeat(base, nchan, 1).astype(np.float32) + 0.01 * rng.random((len(pts), nchan),
                                                                              np.float32)
    seeds = np.zeros(len(pts), bool)
    seeds[np.argsort(np.linalg.norm(pts - [0.5, 1.0, 0], axis=1))[:20]] = True
    return adj, seeds, values[:, 0] if nchan == 1 else values


@pytest.mark.parametrize("nchan,threshold", [(1, 0.05), (3, 0.04)])
def test_gated_floodfill_membership(nchan, threshold):
    adj, seeds, values = _fill_cloud(nchan)
    want = np.asarray(jref.gated_floodfill(jnp.asarray(adj), jnp.asarray(seeds),
                                           jnp.asarray(values), jnp.float32(threshold)))
    got, rounds = tref.gated_floodfill(adj, seeds, values, np.float32(threshold), device="cpu",
                                       return_rounds=True)
    got = got.numpy()
    assert 5 < want.sum() < len(want) and rounds > 2
    if not np.array_equal(got, want):
        # the stated bar: the first round where the two differ may flip only
        # points whose distance to the common cluster mean lies within
        # ULP_BAR float32 ulps of the threshold
        for r in range(1, rounds + 1):
            a = np.asarray(jref.gated_floodfill(jnp.asarray(adj), jnp.asarray(seeds),
                                                jnp.asarray(values), jnp.float32(threshold),
                                                max_level=r))
            b = tref.gated_floodfill(adj, seeds, values, threshold, r, device="cpu").numpy()
            if not np.array_equal(a, b):
                break
            prev = a
        v = values.reshape(len(values), -1).astype(np.float64)
        mean = v[prev].mean(0)
        flipped = np.nonzero(a != b)[0]
        gap = np.abs(np.abs(v[flipped] - mean) - threshold).min(axis=1)
        assert (gap <= ULP_BAR * np.spacing(np.float32(threshold))).all(), gap


def test_refinement_files_and_resume(tree):
    ids, door, pts = _door(tree)
    seed = int(np.nonzero(ids == door)[0][0])
    adj = native.radius_graph(pts, 0.1, k=16)
    c = pts[ids == door].mean(0)
    n = tdw.fit_plane(pts[ids == door].astype(np.float64))[1]
    colors = ply.read_point_cloud(tree / "seg" / "fusion" / "fusion_0_05_10.0.ply")[1]
    d = _copies(tree, "refine")
    runs = {}
    for mod, key in ((jref, "jax"), (tref, "port")):
        kw = {} if mod is jref else {"device": "cpu"}
        runs[key] = []
        for grow in (False, True):  # the second round resumes from cv_segmentation/
            runs[key].append(mod.depth_floodfill(d[key], adj, seed, c, n, depth_threshold=0.04,
                                                 grow_from_instance=grow, **kw))
            runs[key].append(mod.color_floodfill(d[key], adj, seed, colors,
                                                 color_threshold=0.15, grow_from_instance=grow,
                                                 **kw))
    for (a_ids, a_grown), (b_ids, b_grown) in zip(runs["port"], runs["jax"]):
        np.testing.assert_array_equal(a_ids, b_ids)
        np.testing.assert_array_equal(a_grown, b_grown)
    assert runs["jax"][0][1].sum() > 0  # the single seed grew
    _same_files(d["jax"], d["port"], "cv_segmentation")


def test_door_updation_and_floor_align():
    rng = np.random.default_rng(8)
    outer = np.array([[0, 0, 0], [4, 0, 0], [4, 0, 2.5], [0, 0, 2.5]], np.float64)
    for _ in range(20):
        inner = outer * rng.uniform(0.1, 0.9) + rng.normal(0, 0.15, (4, 3)) + [0.5, 0, 0.1]
        normal = np.array([0, 1, 0]) + rng.normal(0, 0.05, 3)
        np.testing.assert_array_equal(tref.door_updation(outer, inner, normal, 0.3),
                                      jref.door_updation(outer, inner, normal, 0.3))
        door = rng.normal(0, 1, (8, 3))
        wall = rng.normal(0, 1, (8, 3))
        for flip in (True, False):
            np.testing.assert_allclose(tref.door_floor_align(door, wall, flip),
                                       jref.door_floor_align(door, wall, flip), rtol=1e-6,
                                       atol=1e-6)
    flat = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1.0]])
    np.testing.assert_array_equal(tref.door_floor_align(flat, flat), flat)
    d, q = tref.closest_point_on_segment([0, 0, 0], [2, 0, 0], [1, 1, 0])
    assert d == 1.0 and np.array_equal(q, [1.0, 0, 0])


# -------------------------------------------------------- door / window --

def _room_off(path, size=(6.0, 2.8, 8.0)):
    sx, sy, sz = size
    v = np.array([[x, y, z] for x in (0, sx) for y in (0, sy) for z in (0, sz)])
    quads = [[0, 1, 3, 2], [4, 6, 7, 5], [0, 4, 5, 1], [2, 3, 7, 6], [0, 2, 6, 4], [1, 5, 7, 3]]
    lines = ["OFF", f"{len(v)} {len(quads)} 0"] + [" ".join(map(str, r)) for r in v]
    lines += [" ".join(map(str, [4] + q)) for q in quads]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("proxy", [None, "polyfit", "ply"])
def test_generate_mesh_byte_identical(tree, proxy):
    d = _copies(tree, f"dw_{proxy}")
    for key in d:
        if proxy == "polyfit":
            _room_off(d[key] / "polyfit" / "room.off")
        elif proxy == "ply":
            _room_off(tree / "room.off")
            verts, faces = ply.read_off(tree / "room.off")
            ply.write_mesh(d[key] / "room.ply", verts, faces)
    kw = {"proxy_mesh": str(d["jax"] / "room.ply")} if proxy == "ply" else {}
    want = jdw.generate_mesh(d["jax"], **kw)
    kw = {"proxy_mesh": str(d["port"] / "room.ply")} if proxy == "ply" else {}
    got = tdw.generate_mesh(d["port"], **kw)
    assert len(want[0]) >= 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _same_files(d["jax"], d["port"], "panoptic_segmentation")
    box = np.random.default_rng(9).random((50, 3))
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]])
    proj = box * [1, 1, 0]
    np.testing.assert_array_equal(tdw.points_in_triangles(proj, tri),
                                  jdw.points_in_triangles(proj, tri))
    for n in ([0, 0, 1.0], [1, 2, 0.5]):
        np.testing.assert_array_equal(tdw.perpendicular_basis(n), jdw.perpendicular_basis(n))


# ------------------------------------------------------------- planes --

def test_planes_vids_and_vertex_files(tmp_path):
    rng = np.random.default_rng(10)
    pts = rng.random((2000, 3)).astype(np.float32) * [3, 3, 0.2]
    labels = (pts[:, 0] > 1.5).astype(np.int32)
    for lab in (None, labels):
        t = tplanes.run_connected(pts, 0.08, lab)
        j = jplanes.run_connected(pts, 0.08, lab)
        assert len(t) == len(j) > 1 and all(np.array_equal(a, b) for a, b in zip(t, j))
    tplanes.write_vids_csv(tmp_path / "t.csv", t)
    jplanes.write_vids_csv(tmp_path / "j.csv", t)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert tplanes.read_vids_csv(tmp_path / "t.csv") == [list(g) for g in t]
    rows = ["id,x,y,z,nx"] + [f"{i},{x:.7f},{y:.6f},{z:.9g},{i % 3}"
                              for i, (x, y, z) in enumerate(rng.normal(0, 3, (300, 3)))]
    (tmp_path / "v.csv").write_text("\n".join(rows) + "\n")
    gv, gl = tplanes.read_vertices_connected_files(tmp_path / "t.csv", tmp_path / "v.csv")
    wv, wl = jplanes.read_vertices_connected_files(tmp_path / "t.csv", tmp_path / "v.csv")
    assert gv.dtype == wv.dtype == np.float64 and gl == wl
    np.testing.assert_array_equal(gv, wv)
    for c in range(10):
        assert tplanes.reveal_shape(c) == jplanes.reveal_shape(c)
    assert tplanes.obj("Doors") == jplanes.obj("Doors") == 6
    assert tplanes.col("Area") == 7 and tplanes.path_correction("a\\b") == "a/b"
    (tmp_path / "fusion").mkdir()
    (tmp_path / "fusion" / "fusion_0_05_10.0.ply").write_bytes(b"")
    assert tplanes.resolve_ply(tmp_path) == jplanes.resolve_ply(tmp_path)
    with pytest.raises(FileNotFoundError):
        tplanes.resolve_ply(tmp_path, "segmentation")


# --------------------------------------------------------------- mesh --

def test_mesh_utilities(tmp_path):
    rng = np.random.default_rng(11)
    verts = rng.random((60, 3))
    tris = rng.integers(0, 60, (80, 3))
    tris[40:] = rng.integers(30, 60, (40, 3))  # a second group of vertices
    for a, b in zip(tmesh.vertex_triangle_maps(tris, 60), jmesh.vertex_triangle_maps(tris, 60)):
        np.testing.assert_array_equal(a, b)
    keep = rng.random(60) > 0.3
    for req in (True, False):
        for a, b in zip(tmesh.keep_faces_by_vertex_mask(verts, tris, keep, req),
                        jmesh.keep_faces_by_vertex_mask(verts, tris, keep, req)):
            np.testing.assert_array_equal(a, b)
    sep = np.vstack([tris[:5], tris[:5] + 60])  # two disjoint copies
    np.testing.assert_array_equal(tmesh.connected_triangle_clusters(sep, 120),
                                  jmesh.connected_triangle_clusters(sep, 120))
    vc = rng.integers(0, 5, 60)
    pal = rng.random((5, 3))
    for a, b in zip(tmesh.triangle_colors_by_class(tris, vc, pal),
                    jmesh.triangle_colors_by_class(tris, vc, pal)):
        np.testing.assert_array_equal(a, b)
    box = (rng.random((500, 3)) * [3, 1, 0.4]).astype(np.float32)
    (tc, ta, th), (jc, ja, jh) = tmesh.obb_axes(box, device="cpu"), jmesh.obb_axes(box)
    np.testing.assert_allclose(tc, jc, atol=1e-4)
    np.testing.assert_allclose(np.sort(th), np.sort(jh), atol=1e-4)
    assert (np.abs(ta @ np.asarray(ja).T).max(axis=1) > 1 - 1e-4).all()
    uvs = rng.random((60, 2))
    tex = rng.integers(0, 256, (32, 24, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tmesh.uv_texture_to_vertex_colors(uvs, tex),
                                  jmesh.uv_texture_to_vertex_colors(uvs, tex))
    np.testing.assert_array_equal(tmesh.vector_angles(verts[:7], verts[7:20]),
                                  jmesh.vector_angles(verts[:7], verts[7:20]))
    np.testing.assert_array_equal(tmesh.nearest_points(verts, verts[:9] + 0.01),
                                  jmesh.nearest_points(verts, verts[:9] + 0.01))
    np.testing.assert_array_equal(tmesh.select_in_box(verts, [0.2] * 3, [0.7] * 3),
                                  jmesh.select_in_box(verts, [0.2] * 3, [0.7] * 3))
    cam = {"intrinsic": {"width": 64, "height": 48,
                         "intrinsic_matrix": [60, 0, 0, 0, 61, 0, 32, 24, 1]},
           "extrinsic": list(np.eye(4).ravel() + np.arange(16) * 0.01)}
    (tmp_path / "cam.json").write_text(json.dumps(cam))
    for a, b in zip(tmesh.read_camera_json(tmp_path / "cam.json"),
                    jmesh.read_camera_json(tmp_path / "cam.json")):
        np.testing.assert_array_equal(a, b)
    cols = rng.random((60, 3))
    tmesh.to_mesh(verts, tris, cols, save=tmp_path / "m_t.ply")
    jmesh.to_mesh(verts, tris, cols, save=tmp_path / "m_j.ply")
    tmesh.to_pcd(verts, cols, save=tmp_path / "p_t.ply")
    jmesh.to_pcd(verts, cols, save=tmp_path / "p_j.ply")
    for kind in ("m", "p"):
        assert (tmp_path / f"{kind}_t.ply").read_bytes() == \
            (tmp_path / f"{kind}_j.ply").read_bytes()
    assert tmesh.to_lines(verts, tris[:, :2])["edges"].dtype == np.int32


@pytest.mark.parametrize("case", ["random", "degenerate", "overlapping"])
def test_rasterize_equals_fillpoly(case):
    rng = np.random.default_rng({"random": 12, "degenerate": 13, "overlapping": 14}[case])
    for h, w in ((48, 64), (97, 31), (5, 5)):
        uvs = rng.random((50, 2))
        uvs[::6] = np.round(uvs[::6])  # vertices on the border
        tris = rng.integers(0, 50, (40, 3))
        if case == "degenerate":
            tris[::2, 2] = tris[::2, 1]  # repeated vertex
            mid = np.arange(1, 49, 3)
            uvs[mid] = 0.5 * (uvs[mid - 1] + uvs[mid + 1])  # collinear vertices
        if case == "overlapping":
            uvs = 0.3 + 0.4 * uvs  # every triangle over the same patch
        vals = rng.integers(0, 256, (40, 3))
        want = jmesh.rasterize_triangles_uv(uvs, tris, vals, (h, w))  # cv2.fillPoly
        got = tmesh.rasterize_triangles_uv(uvs, tris, vals, (h, w))
        assert got.dtype == np.uint8 and want.any()
        np.testing.assert_array_equal(got, want)


def test_fill_poly_polygons():
    rng = np.random.default_rng(15)
    for _ in range(200):
        h, w = rng.integers(5, 40, 2)
        p = np.c_[rng.integers(0, w, 5), rng.integers(0, h, 5)].astype(np.int32)
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [p], (9, 99, 199))
        tmesh.fill_poly(b, p, np.array([9, 99, 199], np.uint8))
        np.testing.assert_array_equal(b, a)


def test_read_images_is_bgr_as_imread(tmp_path):
    rng = np.random.default_rng(16)
    for i in range(3):
        img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"{i}.png"), img)
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), img)
    (tmp_path / "9.png").write_bytes(b"not an image")
    for ext in ("png", "jpg"):
        for gray in (False, True):
            got, gs = tmesh.read_images(tmp_path, ext, gray)
            want, ws = jmesh.read_images(tmp_path, ext, gray)
            assert gs == ws and len(got) == len(want)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


def test_viz_imports_and_raises_its_hint():
    assert not tviz.have_open3d()
    for call in (lambda: tviz.show_cloud(np.zeros((3, 3))),
                 lambda: tviz.pick_points(np.zeros((3, 3)))):
        with pytest.raises(RuntimeError, match="fusion3dseg_tpu_torch.utils.mesh"):
            call()
