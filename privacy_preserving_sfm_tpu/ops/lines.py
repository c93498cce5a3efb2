"""Feature-line lifting and point-to-line residual kernels.

The privacy-preserving representation stores, per keypoint, a random 2D line
through the *normalized* image point instead of the point itself:

  * aligned line:  ``l = g_rot x x_hat`` where ``g_rot`` is the projection of
    the per-image gravity direction used as the line direction,
  * random line:   ``l = r x x_hat`` for a random direction ``r``,
  * normalization: ``l /= ||l[:2]||`` so that ``l . p_hom`` is a signed
    point-to-line distance in the normalized image plane.

Reference: line lifting ``src/feature/extraction.cc:437-504``; residuals
``src/base/projection.cc:162-260``; BA cost ``src/base/cost_functions.h:62-100``.

All kernels are batched over observations and purely elementwise,
with optional masking in place of the reference's early-return MAX sentinels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import cameras as cam_ops

# Sentinel matching the reference's numeric_limits<double>::max() gating.
BIG = 1e30


def normalize_lines(lines: jax.Array) -> jax.Array:
    """Normalize homogeneous 2D lines so ||(a, b)|| = 1. (..., 3)->(..., 3).

    Mirrors the renormalization at ``extraction.cc:499-503`` and the DB read
    path ``database.cc:55-74``.
    """
    n = jnp.linalg.norm(lines[..., :2], axis=-1, keepdims=True)
    return lines / jnp.maximum(n, 1e-12)


def lift_keypoints_to_lines(
    key: jax.Array,
    normalized_points: jax.Array,
    gravity: jax.Array,
    aligned_mask: jax.Array,
) -> jax.Array:
    """Lift normalized image points to privacy-preserving 2D lines.

    Args:
      key: PRNG key for the random line directions.
      normalized_points: (N, 2) keypoints in the normalized image plane
        (output of ``cameras.image_to_world``).
      gravity: (3,) per-image gravity direction (camera frame).
      aligned_mask: (N,) bool; True -> gravity-aligned line.

    Returns:
      (N, 3) lines with ||l[:2]|| = 1.

    Semantics of ``LineFeatureWriterThread`` (``extraction.cc:476-504``):
    aligned lines use ``l = g x x_hom``; the rest use ``l = r x x_hom`` with
    ``r`` a random unit direction.
    """
    n = normalized_points.shape[0]
    x_hom = jnp.concatenate(
        [normalized_points, jnp.ones_like(normalized_points[..., :1])], axis=-1)
    rnd = jax.random.normal(key, (n, 3), dtype=normalized_points.dtype)
    rnd = rnd / jnp.linalg.norm(rnd, axis=-1, keepdims=True)
    g = jnp.broadcast_to(gravity, (n, 3)).astype(normalized_points.dtype)
    direction = jnp.where(aligned_mask[:, None], g, rnd)
    lines = jnp.cross(direction, x_hom)
    return normalize_lines(lines)


def project_points(proj: jax.Array, points3d: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Apply 3x4 projection(s): returns (normalized_xy, depth z).

    proj: (..., 3, 4), points3d: (..., 3) -> ((..., 2), (...,)).
    """
    xyz = jnp.einsum("...ij,...j->...i", proj[..., :, :3], points3d) + proj[..., :, 3]
    z = xyz[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-30, 1e-30, z)
    return xyz[..., :2] / z_safe[..., None], z


def closest_point_on_line(lines: jax.Array, pts: jax.Array) -> jax.Array:
    """Closest point to ``pts`` on normalized line(s). (...,3),(...,2)->(...,2).

    ``p - (l . p_hom) * (a, b)`` — valid because ||(a,b)|| = 1
    (``cost_functions.h:77-82``).
    """
    alpha = lines[..., 0] * pts[..., 0] + lines[..., 1] * pts[..., 1] + lines[..., 2]
    return pts - alpha[..., None] * lines[..., :2]


def squared_line_reprojection_error(
    lines: jax.Array,
    points3d: jax.Array,
    proj: jax.Array,
    camera_model: str,
    camera_params: jax.Array,
    width,
    height,
) -> jax.Array:
    """Squared *pixel* point-to-line reprojection error.

    Exact semantics of ``CalculateSquaredLineReprojectionError``
    (``projection.cc:162-203``) including the distort-both-points trick:
    project X to the normalized plane, find the closest point on the line
    there, push BOTH points through WorldToImage, and return their squared
    pixel distance.  Returns BIG when the point is behind the camera or
    projects outside the image.
    """
    xy, z = project_points(proj, points3d)
    line_pt = closest_point_on_line(lines, xy)
    im_proj = cam_ops.world_to_image(camera_model, camera_params, xy)
    im_line = cam_ops.world_to_image(camera_model, camera_params, line_pt)
    err = jnp.sum((im_proj - im_line) ** 2, axis=-1)

    in_image = (
        (im_proj[..., 0] >= 0)
        & (im_proj[..., 0] < width)
        & (im_proj[..., 1] >= 0)
        & (im_proj[..., 1] < height)
    )
    valid = (z >= jnp.finfo(points3d.dtype).eps) & in_image
    return jnp.where(valid, err, BIG)


def line_angular_error(
    lines: jax.Array,
    points3d: jax.Array,
    proj: jax.Array,
    camera_model: str,
    camera_params: jax.Array,
    width,
    height,
) -> jax.Array:
    """|pi/2 - angle(line_normal, viewing ray)| with cheirality+image gating.

    Semantics of ``CalculateNormalizedLineAngularError``
    (``projection.cc:241-260``).
    """
    line_n = lines / jnp.linalg.norm(lines, axis=-1, keepdims=True)
    ray = jnp.einsum("...ij,...j->...i", proj[..., :, :3], points3d) + proj[..., :, 3]
    ray_n = ray / jnp.maximum(jnp.linalg.norm(ray, axis=-1, keepdims=True), 1e-30)
    cosang = jnp.abs(jnp.sum(line_n * ray_n, axis=-1))
    err = jnp.abs(jnp.pi / 2 - jnp.arccos(jnp.clip(cosang, 0.0, 1.0)))

    z = ray[..., 2]
    xy = ray[..., :2] / jnp.where(jnp.abs(z) < 1e-30, 1e-30, z)[..., None]
    im = cam_ops.world_to_image(camera_model, camera_params, xy)
    in_image = (
        (im[..., 0] >= 0) & (im[..., 0] < width)
        & (im[..., 1] >= 0) & (im[..., 1] < height)
    )
    valid = (z >= 0) & in_image
    return jnp.where(valid, err, BIG)


def line_ba_residual(
    lines: jax.Array,
    points3d: jax.Array,
    qvec: jax.Array,
    tvec: jax.Array,
    camera_model: str,
    camera_params: jax.Array,
) -> jax.Array:
    """2-vector pixel residual of the line BA cost (differentiable).

    Twin of ``BundleAdjustmentLineCostFunction`` (``cost_functions.h:62-100``):
    rotate+translate, project, find closest point on the line in the
    normalized plane, distort both points, residual = pixel difference.
    No gating — gating/masking is the caller's job (as in Ceres, where only
    valid observations become residual blocks).
    """
    from privacy_preserving_sfm_tpu.ops import lie

    xyz = lie.quat_rotate(qvec, points3d) + tvec
    z = xyz[..., 2]
    xy = xyz[..., :2] / jnp.where(jnp.abs(z) < 1e-30, 1e-30, z)[..., None]
    line_pt = closest_point_on_line(lines, xy)
    im_proj = cam_ops.world_to_image(camera_model, camera_params, xy)
    im_line = cam_ops.world_to_image(camera_model, camera_params, line_pt)
    return im_proj - im_line
