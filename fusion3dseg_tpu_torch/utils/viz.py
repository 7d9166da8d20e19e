"""Optional interactive viewers (open3d, imported only when called).

Counterpart of `fusion3dseg_tpu/utils/viz.py`. The pipeline is headless:
every stage writes .ply/.npy artifacts, and picking is a batch query
(`utils/mesh.nearest_points`, `select_in_box`). Where open3d is installed,
these functions open windows on clouds and artifacts and pick points;
`get_roi` drag-selects image rectangles with OpenCV's GUI. Without the
package each raises RuntimeError naming the headless alternative.
Importing this module imports neither.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

_HEADLESS_HINT = (
    "open3d is not installed (it is deliberately not a dependency). "
    "Headless alternatives: the stage .ply artifacts under the output "
    "directory view in any point-cloud tool; programmatic selection via "
    "fusion3dseg_tpu_torch.utils.mesh.nearest_points / select_in_box."
)


def have_open3d() -> bool:
    """True when the optional open3d package is importable."""
    try:
        import open3d  # noqa: F401
    except Exception:
        return False
    return True


def _o3d():
    try:
        import open3d
    except Exception as e:  # ImportError or a broken GUI build
        raise RuntimeError(_HEADLESS_HINT) from e
    return open3d


def _to_o3d_cloud(points, colors=None):
    o3d = _o3d()
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(points, np.float64))
    if colors is not None:
        c = np.asarray(colors, np.float64)
        if c.max() > 1.0:
            c = c / 255.0
        pcd.colors = o3d.utility.Vector3dVector(c)
    return pcd


def show_cloud(points, colors=None, window_name: str = "fusion3dseg"):
    """Open an interactive window on an in-memory cloud (the reference's
    o3d.visualization.draw_geometries calls, get3DSeg.py:105,114)."""
    o3d = _o3d()
    o3d.visualization.draw_geometries(
        [_to_o3d_cloud(points, colors)], window_name=window_name
    )


def show_ply(path):
    """View one of the pipeline's ply artifacts (dependency-free reader,
    io/ply.py — open3d is only used for the window)."""
    from fusion3dseg_tpu_torch.io import ply

    points, colors, _ = ply.read_point_cloud(path)
    show_cloud(points, colors, window_name=str(path))


def show_stage(dirname, stage: str = "segmentation"):
    """View a stage's main artifact: segmentation/pcd.ply,
    panoptic_segmentation/pcd.ply, segmentation/final_pcd.ply ... — pass
    the session output dir and the stage subdirectory name."""
    d = Path(dirname) / stage
    for name in ("final_pcd.ply", "pcd.ply", "cleaned.ply", "remaining.ply"):
        p = d / name
        if p.is_file():
            return show_ply(p)
    raise FileNotFoundError(f"no ply artifact found under {d}")


def pick_points(points, colors=None) -> list:
    """Interactive point picking (reference meshUtils.pick_points:470-486):
    shift+left-click to select, shift+right-click to deselect, q to close.
    Returns the picked point INDICES. Headless equivalent:
    utils.mesh.nearest_points(points, queries)."""
    o3d = _o3d()
    print("-" * 72)
    print("Press [shift + left click] to select a point")
    print("Press [shift + right click] to deselect")
    print("Press q to close the window")
    print("-" * 72)
    vis = o3d.visualization.VisualizerWithEditing()
    vis.create_window()
    vis.add_geometry(_to_o3d_cloud(points, colors))
    vis.run()
    vis.destroy_window()
    picked = list(vis.get_picked_points())
    print("Selected points:", picked)
    return picked


def get_roi(img) -> Optional[np.ndarray]:
    """Drag-select pixel ROIs on an image (reference meshUtils.get_roi:
    489-551): left-drag rectangles, Esc to finish. Returns [2, K] pixel
    (x, y) coordinates covering the union of rectangles, or None if nothing
    was selected. Requires a GUI-capable cv2 build; headless equivalent:
    utils.mesh.select_in_box on back-projected points."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("get_roi needs OpenCV with GUI support. " + _HEADLESS_HINT) from e

    img = np.asarray(img).copy()
    h, w = img.shape[:2]
    state = {"drawing": False, "ix": -1, "iy": -1, "roi": []}

    def on_mouse(event, x, y, flags, param):
        x = int(np.clip(x, 0, w - 1))
        y = int(np.clip(y, 0, h - 1))
        if event == cv2.EVENT_LBUTTONDOWN:
            state["drawing"] = True
            state["ix"], state["iy"] = x, y
            state["roi"].append([[x, y]])
        elif event == cv2.EVENT_MOUSEMOVE and state["drawing"]:
            cv2.rectangle(img, (state["ix"], state["iy"]), (x, y),
                          (0, 255, 255), -1)
        elif event == cv2.EVENT_LBUTTONUP and state["drawing"]:
            state["drawing"] = False
            cv2.rectangle(img, (state["ix"], state["iy"]), (x, y),
                          (0, 255, 255), -1)
            state["roi"][-1].append([x, y])

    win = "Drag to select ROI"
    try:
        cv2.namedWindow(winname=win)
    except cv2.error as e:  # headless build
        raise RuntimeError(
            "cv2 has no GUI support here. " + _HEADLESS_HINT
        ) from e
    cv2.setMouseCallback(win, on_mouse)
    while True:
        cv2.imshow(win, img)
        if cv2.waitKey(10) == 27:
            break
    cv2.destroyAllWindows()

    coords = []
    for rect in state["roi"]:
        if len(rect) != 2:
            continue
        (x1, y1), (x2, y2) = rect
        x1, x2 = sorted((x1, x2))
        y1, y2 = sorted((y1, y2))
        xs, ys = np.meshgrid(np.arange(x1, x2 + 1), np.arange(y1, y2 + 1))
        coords.append(np.vstack((xs.ravel(), ys.ravel())))
    return np.hstack(coords) if coords else None
