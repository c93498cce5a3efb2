"""Headless sparse-model renderer: the headless replacement for the Qt GUI.

The reference ships a Qt5/OpenGL model viewer (``/root/reference/src/ui/
model_viewer_widget.cc``, point/line painters + colormaps in
``/root/reference/src/ui/colormaps.cc``).  A production GPU server is
headless, so the equivalent surface here is offscreen rendering: the
reconstruction (3D points colored by the same quantities the reference's
colormaps expose — track length, reprojection error, depth — plus camera
frusta wireframes) is rasterized to PNG with matplotlib's Agg backend.
Single views and turntable sequences are supported; interactive
inspection uses the also-provided PLY / reference-format text exports in
any external viewer.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

import matplotlib

matplotlib.use("Agg")  # headless; never require a display
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d.art3d import Line3DCollection  # noqa: E402


def _frustum_segments(rec, image_id: int, scale: float) -> np.ndarray:
    """(8, 2, 3) wireframe segments of one camera frustum in world space.

    Matches the viewer's camera glyph (``model_viewer_widget.cc``: image
    plane rectangle + apex rays), sized relative to the scene.
    """
    img = rec.images[image_id]
    cam = rec.cameras[img.camera_id]
    R = img.rotation_matrix()
    c = img.projection_center()
    f = cam.mean_focal_length()
    # Image-plane corners in normalized camera coordinates at depth=scale.
    hw = 0.5 * cam.width / f
    hh = 0.5 * cam.height / f
    corners_cam = np.array([
        [-hw, -hh, 1.0], [hw, -hh, 1.0], [hw, hh, 1.0], [-hw, hh, 1.0],
    ]) * scale
    corners = corners_cam @ R + c  # R^T @ x per row
    segs = []
    for i in range(4):
        segs.append([c, corners[i]])                     # apex rays
        segs.append([corners[i], corners[(i + 1) % 4]])  # plane rectangle
    return np.asarray(segs)


def _point_colors(rec, pids: Sequence[int], color_by: str) -> np.ndarray:
    """Per-point scalar for the colormap (reference ``colormaps.cc``)."""
    if color_by == "track":
        vals = np.array([len(rec.points3d[p].track) for p in pids], float)
    elif color_by == "error":
        vals = np.array([max(rec.points3d[p].error, 0.0) for p in pids])
    else:  # depth: distance along the mean viewing direction
        xyz = np.stack([rec.points3d[p].xyz for p in pids])
        vals = xyz[:, 2].astype(float)
    lo, hi = np.percentile(vals, [2, 98]) if len(vals) else (0.0, 1.0)
    if hi - lo < 1e-12:
        hi = lo + 1.0
    return np.clip((vals - lo) / (hi - lo), 0.0, 1.0)


def render_model(rec, out_path: str,
                 elev: float = -60.0, azim: float = -90.0,
                 color_by: str = "track",
                 image_size: Tuple[int, int] = (1280, 960),
                 max_points: int = 200_000,
                 draw_cameras: bool = True,
                 title: Optional[str] = None) -> str:
    """Render one view of the sparse model to ``out_path`` (PNG).

    color_by: "track" (track length), "error" (mean reproj error px) or
    "depth" — the quantities of the reference viewer's point colormaps.
    """
    pids = sorted(rec.points3d.keys())
    if len(pids) > max_points:
        step = len(pids) // max_points + 1
        pids = pids[::step]
    xyz = (np.stack([rec.points3d[p].xyz for p in pids])
           if pids else np.zeros((0, 3)))

    dpi = 100
    fig = plt.figure(figsize=(image_size[0] / dpi, image_size[1] / dpi),
                     dpi=dpi)
    ax = fig.add_subplot(111, projection="3d")
    ax.set_proj_type("persp")

    if len(xyz):
        ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=1.0,
                   c=_point_colors(rec, pids, color_by),
                   cmap="viridis", linewidths=0, depthshade=False)

    centers = []
    if draw_cameras and rec.reg_image_ids:
        extent = (np.ptp(xyz, axis=0).max() if len(xyz) else 1.0) or 1.0
        scale = 0.03 * extent
        segs = np.concatenate([
            _frustum_segments(rec, iid, scale) for iid in rec.reg_image_ids])
        ax.add_collection3d(
            Line3DCollection(segs, colors=(0.85, 0.1, 0.1, 0.9),
                             linewidths=0.7))
        centers = np.stack([rec.images[iid].projection_center()
                            for iid in rec.reg_image_ids])

    allp = np.concatenate([xyz] + ([centers] if len(centers) else []))
    if len(allp):
        mid = (allp.min(0) + allp.max(0)) / 2
        half = max(float(np.ptp(allp, axis=0).max()) / 2, 1e-6)
        ax.set_xlim(mid[0] - half, mid[0] + half)
        ax.set_ylim(mid[1] - half, mid[1] + half)
        ax.set_zlim(mid[2] - half, mid[2] + half)
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    if title is None:
        title = (f"{rec.num_registered()} images · "
                 f"{len(rec.points3d)} points · "
                 f"mean reproj {rec.compute_mean_reprojection_error():.2f}px")
    ax.set_title(title, fontsize=9)
    fig.tight_layout(pad=0.1)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def render_turntable(rec, out_dir: str, num_frames: int = 12,
                     elev: float = -60.0, **kwargs) -> list:
    """Render ``num_frames`` azimuth steps (360/n apart) to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k in range(num_frames):
        azim = -90.0 + 360.0 * k / num_frames
        path = os.path.join(out_dir, f"frame{k:03d}.png")
        paths.append(render_model(rec, path, elev=elev, azim=azim, **kwargs))
    return paths
