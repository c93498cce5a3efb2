"""Camera model zoo (batched, jit/vmap-friendly).

Re-implements the reference's 11 compile-time camera models
(``src/base/camera_models.h:117-129``) as pure JAX functions.  Parameter
layouts are byte-identical to the reference so that databases and text models
interoperate:

  SIMPLE_PINHOLE        f, cx, cy
  PINHOLE               fx, fy, cx, cy
  SIMPLE_RADIAL         f, cx, cy, k
  RADIAL                f, cx, cy, k1, k2
  OPENCV                fx, fy, cx, cy, k1, k2, p1, p2
  OPENCV_FISHEYE        fx, fy, cx, cy, k1, k2, k3, k4
  FULL_OPENCV           fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
  FOV                   fx, fy, cx, cy, omega
  SIMPLE_RADIAL_FISHEYE f, cx, cy, k
  RADIAL_FISHEYE        f, cx, cy, k1, k2
  THIN_PRISM_FISHEYE    fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1

Design differences from the reference (accelerator-first):
  * every op broadcasts over a leading batch of points; the camera model is a
    *static* (trace-time) choice, so XLA sees straight-line code per model;
  * iterative undistortion uses a fixed-iteration Newton solve with an
    *autodiff* Jacobian (``jax.jacfwd``) instead of central differences
    (reference ``camera_models.h:545-588``) — same fixed point, better
    accuracy, and fully fused by XLA.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Distortion functions: extra_params, (u, v) -> (du, dv), all elementwise.
# ---------------------------------------------------------------------------


def _distort_none(p, u, v, xp=jnp):
    return xp.zeros_like(u), xp.zeros_like(v)


def _distort_simple_radial(p, u, v, xp=jnp):
    k = p[..., 0]
    r2 = u * u + v * v
    radial = k * r2
    return u * radial, v * radial


def _distort_radial(p, u, v, xp=jnp):
    k1, k2 = p[..., 0], p[..., 1]
    r2 = u * u + v * v
    radial = k1 * r2 + k2 * r2 * r2
    return u * radial, v * radial


def _distort_opencv(p, u, v, xp=jnp):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    return du, dv


def _distort_full_opencv(p, u, v, xp=jnp):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    k3, k4, k5, k6 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2) - u
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2) - v
    return du, dv


def _fisheye_thetad(p_terms, u, v, xp=jnp):
    """Common fisheye mapping: theta-polynomial radial distortion.

    p_terms is a tuple of odd-power theta coefficients (k1, k2, ...) applied
    as thetad = theta * (1 + k1 th^2 + k2 th^4 + ...).
    """
    eps = xp.asarray(xp.finfo(u.dtype).eps, u.dtype)
    r = xp.sqrt(u * u + v * v)
    r_safe = xp.maximum(r, eps)
    theta = xp.arctan(r_safe)
    th2 = theta * theta
    poly = xp.ones_like(theta)
    acc = xp.ones_like(theta)
    for k in p_terms:
        acc = acc * th2
        poly = poly + k * acc
    thetad = theta * poly
    scale = xp.where(r > eps, thetad / r_safe, xp.ones_like(r))
    return u * scale - u, v * scale - v


def _distort_opencv_fisheye(p, u, v, xp=jnp):
    return _fisheye_thetad((p[..., 0], p[..., 1], p[..., 2], p[..., 3]), u, v, xp)


def _distort_simple_radial_fisheye(p, u, v, xp=jnp):
    return _fisheye_thetad((p[..., 0],), u, v, xp)


def _distort_radial_fisheye(p, u, v, xp=jnp):
    return _fisheye_thetad((p[..., 0], p[..., 1]), u, v, xp)


def _distort_fov(p, u, v, xp=jnp):
    # FOV model (reference camera_models.h:1136-1173), Taylor fallbacks for
    # small omega / small radius included for the same numerical behavior.
    omega = p[..., 0]
    eps = 1e-4
    radius2 = u * u + v * v
    omega2 = omega * omega
    tan_half = xp.tan(omega / 2)
    radius = xp.sqrt(xp.maximum(radius2, xp.finfo(u.dtype).tiny))

    factor_generic = xp.arctan(radius * 2 * tan_half) / (radius * omega)
    factor_small_omega = omega2 * radius2 / 3 - omega2 / 12 + 1
    factor_small_radius = (-2 * tan_half * (4 * radius2 * tan_half * tan_half - 3)) / (3 * omega)

    factor = xp.where(
        omega2 < eps,
        factor_small_omega,
        xp.where(radius2 < eps, factor_small_radius, factor_generic),
    )
    # NOTE: FOV "distortion" returns the distorted point directly (u*factor),
    # not a delta — mirrored in world_to_image below.
    return u * factor, v * factor


def _undistort_fov(p, u, v, xp=jnp):
    omega = p[..., 0]
    eps = 1e-4
    radius2 = u * u + v * v
    omega2 = omega * omega
    tan_half = xp.tan(omega / 2)
    radius = xp.sqrt(xp.maximum(radius2, xp.finfo(u.dtype).tiny))

    factor_generic = xp.tan(radius * omega) / (radius * 2 * tan_half)
    factor_small_omega = omega2 * radius2 / 3 - omega2 / 12 + 1
    factor_small_radius = omega * (omega * omega * radius2 + 3) / (6 * tan_half)

    factor = xp.where(
        omega2 < eps,
        factor_small_omega,
        xp.where(radius2 < eps, factor_small_radius, factor_generic),
    )
    return u * factor, v * factor


def _distort_thin_prism_fisheye(p, u, v, xp=jnp):
    k1, k2, p1, p2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    k3, k4, sx1, sy1 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    r8 = r4 * r4
    radial = k1 * r2 + k2 * r4 + k3 * r6 + k4 * r8
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2) + sx1 * r2
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2) + sy1 * r2
    return du, dv


# ---------------------------------------------------------------------------
# Model registry
# ---------------------------------------------------------------------------


class CameraModelSpec(NamedTuple):
    model_id: int
    name: str
    num_params: int
    focal_idxs: Tuple[int, ...]
    principal_idxs: Tuple[int, ...]
    extra_idxs: Tuple[int, ...]
    distort: Callable  # (extra_params, u, v) -> (du, dv)
    fisheye_pre: bool  # THIN_PRISM: atan(r)/r pre-warp before distortion
    fov_style: bool  # FOV: distort returns the mapped point, closed-form undistort


MODELS: Dict[str, CameraModelSpec] = {}
MODEL_BY_ID: Dict[int, CameraModelSpec] = {}


def _register(model_id, name, num_params, focal, principal, extra, distort,
              fisheye_pre=False, fov_style=False):
    spec = CameraModelSpec(model_id, name, num_params, tuple(focal),
                           tuple(principal), tuple(extra), distort,
                           fisheye_pre, fov_style)
    MODELS[name] = spec
    MODEL_BY_ID[model_id] = spec


_register(0, "SIMPLE_PINHOLE", 3, (0,), (1, 2), (), _distort_none)
_register(1, "PINHOLE", 4, (0, 1), (2, 3), (), _distort_none)
_register(2, "SIMPLE_RADIAL", 4, (0,), (1, 2), (3,), _distort_simple_radial)
_register(3, "RADIAL", 5, (0,), (1, 2), (3, 4), _distort_radial)
_register(4, "OPENCV", 8, (0, 1), (2, 3), (4, 5, 6, 7), _distort_opencv)
_register(5, "OPENCV_FISHEYE", 8, (0, 1), (2, 3), (4, 5, 6, 7), _distort_opencv_fisheye)
_register(6, "FULL_OPENCV", 12, (0, 1), (2, 3), tuple(range(4, 12)), _distort_full_opencv)
_register(7, "FOV", 5, (0, 1), (2, 3), (4,), _distort_fov, fov_style=True)
_register(8, "SIMPLE_RADIAL_FISHEYE", 4, (0,), (1, 2), (3,), _distort_simple_radial_fisheye)
_register(9, "RADIAL_FISHEYE", 5, (0,), (1, 2), (3, 4), _distort_radial_fisheye)
_register(10, "THIN_PRISM_FISHEYE", 12, (0, 1), (2, 3), tuple(range(4, 12)),
          _distort_thin_prism_fisheye, fisheye_pre=True)


def _split_params(spec: CameraModelSpec, params, xp=jnp):
    f = xp.stack([params[..., i] for i in spec.focal_idxs], axis=-1)
    if len(spec.focal_idxs) == 1:
        fx = fy = f[..., 0]
    else:
        fx, fy = f[..., 0], f[..., 1]
    cx = params[..., spec.principal_idxs[0]]
    cy = params[..., spec.principal_idxs[1]]
    if spec.extra_idxs:
        lo, hi = spec.extra_idxs[0], spec.extra_idxs[-1] + 1
        extra = params[..., lo:hi]
    else:
        extra = params[..., :0]
    return fx, fy, cx, cy, extra


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_NEWTON_ITERS = 20


def world_to_image_uv(model: str, params, u, v, xp=jnp):
    """Component-wise ``WorldToImage``: (u, v) arrays -> (x_pix, y_pix).

    Structure-of-arrays variant of :func:`world_to_image` for
    accelerator-friendly layouts: no trailing size-2 axis is ever
    materialized, so callers can keep big batch axes (tracks, combos) in
    the tiled minor dimensions.
    ``params`` must broadcast against ``u``/``v`` after its last axis is
    consumed by the parameter split (e.g. params (T, N, 1, P) with
    u, v (T, N, C)).
    """
    spec = MODELS[model]
    fx, fy, cx, cy, extra = _split_params(spec, params, xp)

    if spec.fisheye_pre:  # THIN_PRISM_FISHEYE: pre-warp to theta coords
        eps = xp.asarray(xp.finfo(u.dtype).eps, u.dtype)
        r = xp.sqrt(u * u + v * v)
        r_safe = xp.maximum(r, eps)
        theta = xp.arctan(r_safe)
        scale = xp.where(r > eps, theta / r_safe, xp.ones_like(r))
        u, v = u * scale, v * scale

    if spec.fov_style:
        x, y = spec.distort(extra, u, v, xp)
    else:
        du, dv = spec.distort(extra, u, v, xp)
        x, y = u + du, v + dv
    return fx * x + cx, fy * y + cy


def world_to_image(model: str, params, uv, xp=jnp):
    """Normalized camera coords (..., 2) -> pixel coords (..., 2).

    Semantics of ``CameraModel::WorldToImage`` for every model in the zoo.
    ``model`` must be a static Python string.  Pass ``xp=numpy`` for a
    device-free host evaluation (used by the orchestration fast paths).
    """
    x, y = world_to_image_uv(model, params, uv[..., 0], uv[..., 1], xp)
    return xp.stack([x, y], axis=-1)


def _newton_undistort(distort_fn, extra: jax.Array, xy: jax.Array) -> jax.Array:
    """Invert p -> p + distort(p) with fixed-iteration Newton (autodiff J).

    Replaces the reference's 100-iteration central-difference Newton
    (``camera_models.h:545-588``) with a fixed ``_NEWTON_ITERS`` loop whose
    2x2 Jacobian comes from forward-mode autodiff; branch-free and compiled
    to straight-line code by XLA.
    """

    def residual(p, x0):
        du, dv = distort_fn(extra, p[..., 0], p[..., 1])
        return p + jnp.stack([du, dv], axis=-1) - x0

    def body(_, p):
        r = residual(p, xy)
        # Elementwise 2x2 Jacobian via two jvp evaluations (forward mode).
        e0 = jnp.stack([jnp.ones_like(p[..., 0]), jnp.zeros_like(p[..., 0])], -1)
        e1 = jnp.stack([jnp.zeros_like(p[..., 0]), jnp.ones_like(p[..., 0])], -1)
        _, j0 = jax.jvp(lambda q: residual(q, xy), (p,), (e0,))
        _, j1 = jax.jvp(lambda q: residual(q, xy), (p,), (e1,))
        a, c = j0[..., 0], j0[..., 1]  # d r / d p0
        b, d = j1[..., 0], j1[..., 1]  # d r / d p1
        det = a * d - b * c
        det = jnp.where(jnp.abs(det) < 1e-20, jnp.ones_like(det), det)
        step0 = (d * r[..., 0] - b * r[..., 1]) / det
        step1 = (-c * r[..., 0] + a * r[..., 1]) / det
        return p - jnp.stack([step0, step1], axis=-1)

    return jax.lax.fori_loop(0, _NEWTON_ITERS, body, xy)


def image_to_world(model: str, params: jax.Array, xy: jax.Array) -> jax.Array:
    """Pixel coords (..., 2) -> normalized camera coords (..., 2).

    Semantics of ``CameraModel::ImageToWorld`` for every model in the zoo.
    """
    spec = MODELS[model]
    fx, fy, cx, cy, extra = _split_params(spec, params)
    u = (xy[..., 0] - cx) / fx
    v = (xy[..., 1] - cy) / fy

    if spec.fov_style:
        u, v = _undistort_fov(extra, u, v)
        return jnp.stack([u, v], axis=-1)

    if spec.extra_idxs:
        uv = _newton_undistort(spec.distort, extra, jnp.stack([u, v], axis=-1))
        u, v = uv[..., 0], uv[..., 1]

    if spec.fisheye_pre:  # THIN_PRISM_FISHEYE: undo theta pre-warp
        eps = jnp.asarray(jnp.finfo(xy.dtype).eps, xy.dtype)
        theta = jnp.sqrt(u * u + v * v)
        tct = theta * jnp.cos(theta)
        scale = jnp.where(tct > eps, jnp.sin(theta) / jnp.maximum(tct, eps),
                          jnp.ones_like(theta))
        u, v = u * scale, v * scale

    return jnp.stack([u, v], axis=-1)


def mean_focal_length(model: str, params: jax.Array) -> jax.Array:
    spec = MODELS[model]
    f = jnp.stack([params[..., i] for i in spec.focal_idxs], axis=-1)
    return jnp.mean(f, axis=-1)


def image_to_world_threshold(model: str, params: jax.Array,
                             threshold) -> jax.Array:
    """Pixel-space threshold -> normalized-plane threshold.

    Mirrors ``BaseCameraModel::ImageToWorldThreshold``
    (``camera_models.h:533-543``): divide by the mean focal length.
    """
    return threshold / mean_focal_length(model, params)


def has_bogus_params(model: str, params, width, height,
                     min_focal_ratio: float, max_focal_ratio: float,
                     max_extra_param: float) -> bool:
    """Host-side sanity check on camera parameters.

    Combines ``HasBogusFocalLength`` / ``HasBogusPrincipalPoint`` /
    ``HasBogusExtraParams`` (``camera_models.h:478-531``).
    """
    import numpy as np

    spec = MODELS[model]
    p = np.asarray(params)
    max_dim = max(width, height)
    for i in spec.focal_idxs:
        ratio = p[i] / max_dim
        if ratio < min_focal_ratio or ratio > max_focal_ratio:
            return True
    cx, cy = p[spec.principal_idxs[0]], p[spec.principal_idxs[1]]
    if not (0 <= cx <= width and 0 <= cy <= height):
        return True
    for i in spec.extra_idxs:
        if abs(p[i]) > max_extra_param:
            return True
    return False
