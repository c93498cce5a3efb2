"""Generate a synthetic multi-view image dataset with gravity + calibration.

Two scene kinds:

* ``plane`` — a richly-textured tilted plane rendered through per-view
  homographies (inverse-mapped bilinear sampling).
* ``box``   — a true 3D scene: several independently-textured planar
  facets at different depths/orientations, composited per pixel by
  nearest depth (analytic plane depth under the inverse homography).
  NOT renderable by any single homography, so the e2e run exercises real
  parallax/occlusion rather than a degenerate planar geometry.

Writes ``<img>.png``, ``<img>.png.gravity.txt`` and
``<img>.png.camera_model.txt`` in the reference's dataset layout
(``image_reader.cc:206-247``), plus ``gt_poses.txt`` for evaluation.

The facet tilts keep the horizontal-plane 2D reduction of the initializer
non-degenerate (a fronto-parallel plane would project to a line in the 2D
sub-problem).

Usage: python tools/synth_dataset.py OUTDIR [num_images] [plane|box]
       [SIMPLE_PINHOLE|OPENCV]

With ``OPENCV`` the box scene is rendered through real barrel+tangential
lens distortion (inverse mapping computed with the framework's own
Newton undistortion), and the sidecar declares the OPENCV model — the
e2e pipeline must then undistort during line lifting and distort inside
every BA/projection residual.

Rendering uses numpy and scipy only (``map_coordinates`` for warps,
``gaussian_filter`` for blur, ``zoom`` for the cubic texture resize) and
writes PNGs through ``privacy_preserving_sfm_tpu.utils.png``; the output
is a deterministic function of the seed.
"""

import os
import sys

import numpy as np
from scipy import ndimage

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from privacy_preserving_sfm_tpu.ops import lie_np  # noqa: E402
from privacy_preserving_sfm_tpu.utils import png  # noqa: E402


def _resize_cubic(img, size):
    """Cubic-spline upsampling of a square float image to (size, size)."""
    return ndimage.zoom(img, size / img.shape[0], order=3,
                        mode="nearest", grid_mode=True)


def _make_texture(rng, tex_size):
    tex = _resize_cubic(
        rng.uniform(0, 1, (tex_size // 8, tex_size // 8)), tex_size)
    tex += 0.5 * _resize_cubic(
        rng.uniform(0, 1, (tex_size // 32, tex_size // 32)), tex_size)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 255).astype(np.uint8)


def _sample_bilinear(tex, x, y):
    """Bilinear texture lookup at float pixel coords, edge-replicated."""
    out = ndimage.map_coordinates(tex.astype(np.float32), [y, x], order=1,
                                  mode="nearest")
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


# Facets of the "box" scene: (origin O, edge A, edge B) with world points
# X(u, v) = O + u A + v B, (u, v) in [-1, 1]^2.  A back wall, a tilted
# floor, a slanted side wall and a floating billboard — different depths
# and normals, so no single homography explains any image pair.
BOX_FACETS = (
    (np.array([0.0, 0.0, 6.5]),            # back wall, gently tilted
     np.array([3.2, 0.0, 0.7]), np.array([0.0, 2.4, 0.5])),
    (np.array([0.0, 1.6, 4.6]),            # floor, sloped
     np.array([2.8, 0.12, 0.0]), np.array([0.0, 0.55, 2.2])),
    (np.array([-2.4, 0.0, 4.8]),           # left wall, slanted inward
     np.array([0.9, 0.05, 1.6]), np.array([0.1, 1.9, 0.0])),
    (np.array([1.5, -0.5, 4.1]),           # floating billboard
     np.array([0.9, 0.0, 0.35]), np.array([0.0, 0.8, 0.2])),
)


def _undistorted_pix_map(width, height, model, params):
    """Per-pixel map: distorted output pixel -> undistorted pinhole pixel.

    Uses the framework's own ``image_to_world`` (Newton undistortion), so
    the rendered distortion is exactly what the pipeline will invert.
    View-independent (intrinsics only): compute once per dataset.
    """
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.ops import cameras as cam_ops

    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel()], 1)
    xn = np.asarray(cam_ops.image_to_world(model, jnp.asarray(params),
                                           jnp.asarray(pts)))
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    pu = np.stack([xn[:, 0] * fx + cx, xn[:, 1] * fy + cy,
                   np.ones(len(xn))], 1)
    return np.ascontiguousarray(pu.T.reshape(3, height, width))


def _render_box_view(K, R, t, textures, width, height, pix=None):
    """Composite the BOX_FACETS by nearest positive depth.

    ``pix``: optional (3, H, W) per-output-pixel homogeneous PINHOLE pixel
    coordinates (identity for a pinhole camera; the undistorted map for a
    distorted camera — rendering through it bakes real lens distortion
    into the image)."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    if pix is None:
        pix = np.stack([xs, ys, np.ones_like(xs)])  # (3, H, W)
    img = np.full((height, width), 96, np.uint8)  # featureless background
    zbuf = np.full((height, width), np.inf)
    for (O, A, B), tex in zip(BOX_FACETS, textures):
        ts = tex.shape[0]
        # Homography [u, v, 1] -> image pixel for this facet.
        Hm = K @ np.column_stack([R @ A, R @ B, R @ O + t])
        Hinv = np.linalg.inv(Hm)
        uvw = np.einsum("ij,jhw->ihw", Hinv, pix)
        w = uvw[2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = uvw[0] / w
            v = uvw[1] / w
        # Depth of the facet point along the camera z axis.
        depth = (R[2] @ O + t[2]) + u * (R[2] @ A) + v * (R[2] @ B)
        valid = (np.abs(u) <= 1) & (np.abs(v) <= 1) & (depth > 0.1)
        valid &= np.isfinite(u) & np.isfinite(v)
        win = valid & (depth < zbuf)
        img[win] = _sample_bilinear(tex, (u[win] + 1) * 0.5 * (ts - 1),
                                    (v[win] + 1) * 0.5 * (ts - 1))
        zbuf[win] = depth[win]
    return img


def _warp_perspective(tex, H, width, height):
    """Image of ``tex`` under the homography H (texture px -> image px),
    sampled by inverse mapping with edge replication."""
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float64)
    src = np.einsum("ij,jhw->ihw", np.linalg.inv(H),
                    np.stack([xs, ys, np.ones_like(xs)]))
    return _sample_bilinear(tex, src[0] / src[2], src[1] / src[2])


def _degrade(img, rng, level: float):
    """Photometric degradation: blur + exposure/gamma jitter + sensor noise.

    The closest available proxy for the reference's real-image protocol
    (ETH example / Strecha, ``scripts/matlab/ppsfm/evaluation/strecha/
    run_evaluations.m:35-44``) in an environment with no real dataset:
    per-image defocus blur (sigma ~ U[0, 0.8*level] px), exposure gain
    ~ U[1/(1+0.5*level), 1+0.5*level] with gamma ~ U[1/(1+0.3*level),
    1+0.3*level], additive Gaussian sensor noise (sigma = 4*level gray
    levels) and a vignetting falloff.  level=1 is a plausible consumer
    camera; the pipeline must survive it without threshold changes.
    """
    h, w = img.shape[:2]
    out = img.astype(np.float32) / 255.0
    sig = rng.uniform(0.0, 0.8 * level)
    if sig > 0.05:
        out = ndimage.gaussian_filter(out, sig, mode="mirror")
    # Vignetting: cos^4-like radial falloff up to 25% * level at corners.
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = (((xx - w / 2) / (w / 2)) ** 2 + ((yy - h / 2) / (h / 2)) ** 2) / 2
    out = out * (1.0 - 0.25 * level * r2)
    gain = rng.uniform(1.0 / (1 + 0.5 * level), 1 + 0.5 * level)
    gamma = rng.uniform(1.0 / (1 + 0.3 * level), 1 + 0.3 * level)
    out = np.clip(gain * np.clip(out, 0, 1) ** gamma, 0, 1)
    out = out + rng.standard_normal(out.shape).astype(np.float32) \
        * (4.0 * level / 255.0)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


def make_dataset(outdir: str, num_images: int = 8, width=640, height=480,
                 f=400.0, seed=0, scene: str = "plane",
                 camera: str = "SIMPLE_PINHOLE", degrade: float = 0.0):
    if camera == "SIMPLE_PINHOLE":
        cam_params = [f, width / 2, height / 2]
    elif camera == "OPENCV":
        # Moderate barrel distortion + slight tangential (max displacement
        # ~10 px at the image corners at these values).
        cam_params = [f, f, width / 2, height / 2,
                      -0.16, 0.035, 1e-3, -5e-4]
        if scene != "box":
            raise SystemExit("OPENCV rendering implemented for scene=box")
    else:
        raise SystemExit(f"unsupported camera {camera}")
    dist_pix = _undistorted_pix_map(width, height, camera, cam_params) \
        if camera != "SIMPLE_PINHOLE" else None

    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)

    # High-contrast smooth texture(s).
    tex_size = 1600
    tex = _make_texture(rng, tex_size)
    box_textures = [_make_texture(rng, 800) for _ in BOX_FACETS] \
        if scene == "box" else None

    # Plane: X(u, v) = (u, v, z0 + ax u + ay v), (u, v) in [-S, S]^2.
    S, z0, ax_c, ay_c = 3.0, 5.0, 0.5, 0.35
    M = np.array([[1.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0],
                  [ax_c, ay_c, z0]])
    # Texture px -> (u, v): u = (x/tex) * 2S - S.
    T = np.array([[2 * S / tex_size, 0, -S],
                  [0, 2 * S / tex_size, -S],
                  [0, 0, 1.0]])
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])

    # Camera arc: centers spread wide relative to scene depth, AIMED at the
    # plane center so every view keeps it in frame.  The spread matters:
    # the initializer's mean-min-tri-angle gate (2 deg) needs adjacent-view
    # baselines of >= ~3.5% of depth (atan(spread/(n-1)/z0)), which a
    # narrow arc of 50 views fails.
    spread = 10.0
    gt_lines = []
    for i in range(num_images):
        frac = i / max(1, num_images - 1)
        C = np.array([spread * (frac - 0.5),
                      rng.uniform(-0.15, 0.15), rng.uniform(-0.3, 0.3)])
        yaw = np.arctan2(C[0], z0)  # aim the optical axis at (0, 0, z0)
        q_yaw = np.array([np.cos(yaw / 2), 0, np.sin(yaw / 2), 0])
        ax = rng.standard_normal(3) * 0.03
        ang = np.linalg.norm(ax) + 1e-12
        q_tilt = np.concatenate([[np.cos(ang / 2)],
                                 np.sin(ang / 2) * ax / ang])
        R = lie_np.quat_to_rotmat(q_tilt) @ lie_np.quat_to_rotmat(q_yaw)
        q = lie_np.rotmat_to_quat(R)
        t = -R @ C
        if scene == "box":
            img = _render_box_view(K, R, t, box_textures, width, height,
                                   pix=dist_pix)
        else:
            # Homography texture -> image: world point X = M [u, v, 1]^T,
            # so x ~ K (R X + t) = K (R M + t [0,0,1]) [u,v,1]^T.
            H = K @ (R @ M + t[:, None]
                     @ np.array([[0.0, 0.0, 1.0]])) @ T
            img = _warp_perspective(tex, H, width, height)
        if degrade > 0:
            img = _degrade(img, rng, degrade)
        name = f"img{i:03d}.png"
        png.write_png(os.path.join(outdir, name), img)
        g = R @ np.array([0.0, 1.0, 0.0])
        with open(os.path.join(outdir, name + ".gravity.txt"), "w") as fo:
            fo.write(f"{g[0]} {g[1]} {g[2]}\n")
        with open(os.path.join(outdir, name + ".camera_model.txt"), "w") as fo:
            fo.write(camera + ", "
                     + ", ".join(str(p) for p in cam_params) + "\n")
        gt_lines.append(
            f"{name} " + " ".join(repr(float(v)) for v in q) + " "
            + " ".join(repr(float(v)) for v in t))

    with open(os.path.join(outdir, "gt_poses.txt"), "w") as fo:
        fo.write("# name qw qx qy qz tx ty tz\n")
        fo.write("\n".join(gt_lines) + "\n")
    # Scene metadata: lets evaluation tools rebuild the exact per-view
    # homographies (H_i = K (R_i M + t_i e3^T) T).
    import json
    with open(os.path.join(outdir, "meta.json"), "w") as fo:
        json.dump({"f": f, "width": width, "height": height,
                   "scene": scene, "camera": camera,
                   "camera_params": list(map(float, cam_params)),
                   "plane_S": S, "plane_z0": z0,
                   "plane_ax": ax_c, "plane_ay": ay_c,
                   "degrade": degrade,
                   "tex_size": tex_size}, fo)
    return outdir


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/ppsfm_synth"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    kind = sys.argv[3] if len(sys.argv) > 3 else "plane"
    cam = sys.argv[4] if len(sys.argv) > 4 else "SIMPLE_PINHOLE"
    deg = float(sys.argv[5]) if len(sys.argv) > 5 else 0.0
    make_dataset(out, n, scene=kind, camera=cam, degrade=deg)
    print(f"wrote {n} {kind}/{cam} images to {out}")
