"""SoA batched robust line triangulation (many tracks per device call).

Same LORANSAC semantics as ``solvers/triangulation.estimate_triangulation``
(reference ``src/estimators/triangulation.{h,cc}``), re-laid-out for accelerator
memory.  The naive formulation vmapped over tracks materializes
tensors like ``(tracks, combos, 3, 4)`` whose tiny trailing (3, 4) dims make poor device-memory layouts (tiled
layouts pad them many times over, at ``(4096, 2024, 3, 4)`` tens of GB for
982 MB of payload).  Here every
large intermediate keeps the two BIG axes (tracks, combos) or
(tracks, observations, combos) in the tiled minor positions and splits
3-/4-vectors into separate component arrays (structure of arrays), so
padding waste is bounded by lane rounding of the combo axis alone.

Secondary win: combination counts are per-pool-size buckets chosen by the
caller, so a 4-observation pool pays C(4,3)=4 hypotheses instead of the
fixed C(24,3)=2024 the padded-to-MAX_POOL layout forced.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.ops import cameras as cam_ops
from privacy_preserving_sfm_tpu.ops import triangulation as tri_ops
from privacy_preserving_sfm_tpu.solvers.triangulation import (
    BIG, TriangulationResult, _combinations3)


@lru_cache(maxsize=None)
def _capped_combinations(n: int, cap: int) -> np.ndarray:
    """C(n,3) triples, exhaustive up to ``cap`` else a deterministic sample.

    Mirrors the reference's CombinationSampler-with-trial-budget behavior
    (``triangulation.cc:128-140``): exhaustive for small pools, uniform
    random triples over the FULL pool beyond.
    """
    total = n * (n - 1) * (n - 2) // 6
    if total <= cap:
        return _combinations3(n)
    rng = np.random.default_rng(104729 * n + 11)
    combos = np.stack(
        [rng.choice(n, size=3, replace=False) for _ in range(cap)], axis=0)
    return np.ascontiguousarray(np.sort(combos, axis=1).astype(np.int32))


def _solve3_soa(g, rhs, reg_scale: float):
    """Componentwise regularized symmetric 3x3 solve with one refinement.

    g: 6-tuple (g00,g01,g02,g11,g12,g22) of (...,) arrays; rhs: 3-tuple.
    Twin of ``ops/linalg.lstsq_normal3`` for SoA layouts.
    """
    g00, g01, g02, g11, g12, g22 = g
    reg = reg_scale * (g00 + g11 + g22) + 1e-30
    r00, r11, r22 = g00 + reg, g11 + reg, g22 + reg

    def solve(b0, b1, b2):
        c00 = r11 * r22 - g12 * g12
        c01 = g02 * g12 - g01 * r22
        c02 = g01 * g12 - g02 * r11
        c11 = r00 * r22 - g02 * g02
        c12 = g01 * g02 - r00 * g12
        c22 = r00 * r11 - g01 * g01
        det = r00 * c00 + g01 * c01 + g02 * c02
        det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
        x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
        x1 = (c01 * b0 + c11 * b1 + c12 * b2) / det
        x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
        return x0, x1, x2

    x0, x1, x2 = solve(*rhs)
    # One iterative-refinement pass against the UNregularized system.
    e0 = rhs[0] - (g00 * x0 + g01 * x1 + g02 * x2)
    e1 = rhs[1] - (g01 * x0 + g11 * x1 + g12 * x2)
    e2 = rhs[2] - (g02 * x0 + g12 * x1 + g22 * x2)
    d0, d1, d2 = solve(e0, e1, e2)
    return x0 + d0, x1 + d1, x2 + d2


def _minimal_dlt_soa(rowc: Tuple[jax.Array, ...], c0, c1, c2, dtype):
    """Triangulate every combo: 4D cross product + 3x3 rescue, SoA.

    rowc: 4 arrays (T, N) — normalized DLT row components l^T P.
    c0/c1/c2: (C,) int32 combo member indices.
    Returns (xw, yw, zw) each (T, C).
    """
    a = [jnp.take(rowc[k], c0, axis=1) for k in range(4)]
    b = [jnp.take(rowc[k], c1, axis=1) for k in range(4)]
    c = [jnp.take(rowc[k], c2, axis=1) for k in range(4)]

    def det3(i, j, k):
        return (a[i] * (b[j] * c[k] - b[k] * c[j])
                - a[j] * (b[i] * c[k] - b[k] * c[i])
                + a[k] * (b[i] * c[j] - b[j] * c[i]))

    n0 = det3(1, 2, 3)
    n1 = -det3(0, 2, 3)
    n2 = det3(0, 1, 3)
    n3 = -det3(0, 1, 2)
    w_safe = jnp.where(jnp.abs(n3) < 1e-12,
                       jnp.where(n3 < 0, -1e-12, 1e-12), n3)
    xh, yh, zh = n0 / w_safe, n1 / w_safe, n2 / w_safe

    # Inhomogeneous 3x3 rescue (same as triangulate_three_lines).
    g = (a[0] * a[0] + b[0] * b[0] + c[0] * c[0],
         a[0] * a[1] + b[0] * b[1] + c[0] * c[1],
         a[0] * a[2] + b[0] * b[2] + c[0] * c[2],
         a[1] * a[1] + b[1] * b[1] + c[1] * c[1],
         a[1] * a[2] + b[1] * b[2] + c[1] * c[2],
         a[2] * a[2] + b[2] * b[2] + c[2] * c[2])
    rhs = (-(a[0] * a[3] + b[0] * b[3] + c[0] * c[3]),
           -(a[1] * a[3] + b[1] * b[3] + c[1] * c[3]),
           -(a[2] * a[3] + b[2] * b[3] + c[2] * c[3]))
    reg = 1e-12 if dtype == jnp.float64 else 1e-8
    xl, yl, zl = _solve3_soa(g, rhs, reg)

    def resid(x, y, z):
        ra = a[0] * x + a[1] * y + a[2] * z + a[3]
        rb = b[0] * x + b[1] * y + b[2] * z + b[3]
        rc = c[0] * x + c[1] * y + c[2] * z + c[3]
        return ra * ra + rb * rb + rc * rc

    fin_h = jnp.isfinite(xh) & jnp.isfinite(yh) & jnp.isfinite(zh)
    xh = jnp.where(fin_h, xh, 0.0)
    yh = jnp.where(fin_h, yh, 0.0)
    zh = jnp.where(fin_h, zh, 0.0)
    fin_l = jnp.isfinite(xl) & jnp.isfinite(yl) & jnp.isfinite(zl)
    xl = jnp.where(fin_l, xl, 0.0)
    yl = jnp.where(fin_l, yl, 0.0)
    zl = jnp.where(fin_l, zl, 0.0)
    use_h = resid(xh, yh, zh) < resid(xl, yl, zl)
    return (jnp.where(use_h, xh, xl), jnp.where(use_h, yh, yl),
            jnp.where(use_h, zh, zl))


def _residuals_soa(xw, yw, zw, lines, proj, params, camera_model: str,
                   width, height, residual: str):
    """Squared residuals of C candidate points vs N observations, (T, N, C).

    xw/yw/zw: (T, C) candidate point components.
    lines/proj/params: (T, N, 3) / (T, N, 3, 4) / (T, N, P).
    residual: "angular" (``projection.cc:241-260``) or "pixel"
    (``projection.cc:162-203``, distort-both-points).
    """
    ones = jnp.ones_like(xw)
    Xh = jnp.stack([xw, yw, zw, ones], axis=1)  # (T, 4, C)
    ray0 = jnp.einsum("tnj,tjc->tnc", proj[..., 0, :], Xh)
    ray1 = jnp.einsum("tnj,tjc->tnc", proj[..., 1, :], Xh)
    ray2 = jnp.einsum("tnj,tjc->tnc", proj[..., 2, :], Xh)

    z = ray2
    eps = jnp.finfo(xw.dtype).eps
    z_safe = jnp.where(jnp.abs(z) < 1e-30, 1e-30, z)
    u = ray0 / z_safe
    v = ray1 / z_safe
    params_b = params[:, :, None, :]  # broadcast over combos

    if residual == "angular":
        lnorm = jnp.linalg.norm(lines, axis=-1)[..., None]  # (T, N, 1)
        l0 = (lines[..., 0] / lnorm[..., 0])[..., None]
        l1 = (lines[..., 1] / lnorm[..., 0])[..., None]
        l2 = (lines[..., 2] / lnorm[..., 0])[..., None]
        rnorm = jnp.sqrt(ray0 * ray0 + ray1 * ray1 + ray2 * ray2)
        cos = jnp.abs(l0 * ray0 + l1 * ray1 + l2 * ray2) \
            / jnp.maximum(rnorm, 1e-30)
        err = jnp.abs(jnp.pi / 2 - jnp.arccos(jnp.clip(cos, 0.0, 1.0)))
        px, py = cam_ops.world_to_image_uv(camera_model, params_b, u, v)
        in_image = (px >= 0) & (px < width) & (py >= 0) & (py < height)
        ok = (z >= 0) & in_image
        return jnp.where(ok, err * err, BIG)

    # pixel: closest point on the line in the normalized plane, distort both.
    l0 = lines[..., 0][..., None]
    l1 = lines[..., 1][..., None]
    l2 = lines[..., 2][..., None]
    alpha = l0 * u + l1 * v + l2
    lu = u - alpha * l0
    lv = v - alpha * l1
    px, py = cam_ops.world_to_image_uv(camera_model, params_b, u, v)
    qx, qy = cam_ops.world_to_image_uv(camera_model, params_b, lu, lv)
    err2 = (px - qx) ** 2 + (py - qy) ** 2
    in_image = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    ok = (z >= eps) & in_image
    return jnp.where(ok, err2, BIG)


def _score(sq, valid, thresh):
    """Inlier-count + residual-sum-tiebreak support over axis 1 (obs).

    sq: (T, N, C); valid: (T, N).  Returns (score, num, inlier) with
    score/num (T, C) and inlier (T, N, C).
    """
    inl = (sq < thresh) & valid[:, :, None]
    num = jnp.sum(inl, axis=1)
    rs = jnp.sum(jnp.where(inl, sq, 0.0), axis=1)
    score = num.astype(sq.dtype) - rs / (1.0 + rs)
    return score, num, inl


def estimate_triangulation_batch(
    lines: jax.Array,
    proj: jax.Array,
    centers: jax.Array,
    camera_params: jax.Array,
    valid: jax.Array,
    camera_model: str,
    width,
    height,
    max_err,
    min_tri_angle_rad,
    residual: str = "angular",
    max_combos: int = 512,
) -> TriangulationResult:
    """Robust triangulation of T tracks in one device call.

    Args:
      lines: (T, N, 3); proj: (T, N, 3, 4); centers: (T, N, 3);
      camera_params: (T, N, P); valid: (T, N) observation mask.
      max_err: inlier threshold — radians (angular) or pixels (pixel).
      residual: "angular" (Create path) or "pixel" (CompleteImage path).

    Returns a TriangulationResult of batched arrays: point3d (T, 3),
    num_inliers (T,), inlier_mask (T, N), success (T,).
    """
    tt, n = valid.shape
    dtype = lines.dtype
    combos = _capped_combinations(n, max_combos)
    c0 = jnp.asarray(combos[:, 0])
    c1 = jnp.asarray(combos[:, 1])
    c2 = jnp.asarray(combos[:, 2])

    rows = jnp.einsum("tni,tnij->tnj", lines, proj)  # (T, N, 4)
    rows = rows / jnp.maximum(
        jnp.linalg.norm(rows, axis=-1, keepdims=True), 1e-12)
    rowc = tuple(rows[..., k] for k in range(4))

    xw, yw, zw = _minimal_dlt_soa(rowc, c0, c1, c2, dtype)
    fin = jnp.isfinite(xw) & jnp.isfinite(yw) & jnp.isfinite(zw)

    # Sample validity: all members valid (+ distinct by construction).
    s_valid = (jnp.take(valid, c0, axis=1) & jnp.take(valid, c1, axis=1)
               & jnp.take(valid, c2, axis=1))

    # Cheirality in each sampled view: third projection row dot [X; 1] > 0.
    p2 = tuple(proj[..., 2, k] for k in range(4))  # (T, N) x4

    def depth(ci):
        return (jnp.take(p2[0], ci, axis=1) * xw
                + jnp.take(p2[1], ci, axis=1) * yw
                + jnp.take(p2[2], ci, axis=1) * zw
                + jnp.take(p2[3], ci, axis=1))

    cheiral = (depth(c0) > 0) & (depth(c1) > 0) & (depth(c2) > 0)

    # Pairwise triangulation angles (law of cosines, min(angle, pi-angle)).
    cx = tuple(centers[..., k] for k in range(3))

    def gath(ci):
        return tuple(jnp.take(cx[k], ci, axis=1) for k in range(3))

    g0, g1, g2 = gath(c0), gath(c1), gath(c2)

    def tri_angle(ca, cb):
        bl2 = ((ca[0] - cb[0]) ** 2 + (ca[1] - cb[1]) ** 2
               + (ca[2] - cb[2]) ** 2)
        ra2 = (xw - ca[0]) ** 2 + (yw - ca[1]) ** 2 + (zw - ca[2]) ** 2
        rb2 = (xw - cb[0]) ** 2 + (yw - cb[1]) ** 2 + (zw - cb[2]) ** 2
        denom = 2.0 * jnp.sqrt(ra2 * rb2)
        cos = jnp.clip((ra2 + rb2 - bl2) / jnp.maximum(denom, 1e-30),
                       -1.0, 1.0)
        ang = jnp.abs(jnp.arccos(cos))
        ang = jnp.where(denom <= 0.0, jnp.zeros_like(ang), ang)
        return jnp.minimum(ang, jnp.pi - ang)

    max_ang = jnp.maximum(jnp.maximum(tri_angle(g0, g1), tri_angle(g0, g2)),
                          tri_angle(g1, g2))
    s_valid = s_valid & cheiral & (max_ang >= min_tri_angle_rad) & fin

    sq = _residuals_soa(xw, yw, zw, lines, proj, camera_params,
                        camera_model, width, height, residual)  # (T, N, C)
    sq = jnp.where(s_valid[:, None, :], sq, BIG)
    thresh = jnp.asarray(max_err, dtype) ** 2
    score, num, inl = _score(sq, valid, thresh)

    best = jnp.argmax(score, axis=1)  # (T,)

    def pick(x):  # (T, C) -> (T,)
        return jnp.take_along_axis(x, best[:, None], axis=1)[:, 0]

    xb, yb, zb = pick(xw), pick(yw), pick(zw)
    score_b = pick(score)
    num_b = pick(num)
    inl_b = jnp.take_along_axis(inl, best[:, None, None], axis=2)[..., 0]

    # LO refit on the winning sample's inliers (single refit, LORANSAC
    # loransac.h:149-192); keep whichever support is better.
    X_lo = tri_ops.triangulate_multiview_lines(proj, lines, mask=inl_b)
    ok_lo = jnp.all(jnp.isfinite(X_lo), axis=-1)
    sq_lo = _residuals_soa(X_lo[..., 0:1], X_lo[..., 1:2], X_lo[..., 2:3],
                           lines, proj, camera_params, camera_model,
                           width, height, residual)  # (T, N, 1)
    sq_lo = jnp.where(ok_lo[:, None, None], sq_lo, BIG)
    score_lo, num_lo, inl_lo = _score(sq_lo, valid, thresh)
    score_lo = score_lo[:, 0]
    num_lo = num_lo[:, 0]
    inl_lo = inl_lo[..., 0]

    use_lo = score_lo > score_b
    point = jnp.where(use_lo[:, None],
                      X_lo, jnp.stack([xb, yb, zb], axis=-1))
    num_f = jnp.where(use_lo, num_lo, num_b)
    inl_f = jnp.where(use_lo[:, None], inl_lo, inl_b)
    return TriangulationResult(point3d=point, num_inliers=num_f,
                               inlier_mask=inl_f, success=num_f >= 3)
