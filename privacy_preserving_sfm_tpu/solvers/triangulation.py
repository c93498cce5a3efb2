"""Robust multi-view line triangulation (LORANSAC semantics).

Twin of ``TriangulationEstimator`` / ``EstimateTriangulation``
(``src/estimators/triangulation.{h,cc}``):

  * minimal sample: 3 observations (enforced at ``triangulation.cc:61``),
  * model: DLT on stacked ``l_i^T P_i`` rows (``base/triangulation.cc:41``),
  * per-sample gating: cheirality in every sampled view and pairwise
    triangulation angle >= min_tri_angle (``triangulation.cc:75-93``),
  * residual: squared angular error (``projection.cc:241-260``) — the
    estimator's ANGULAR_ERROR mode, which is what the incremental
    triangulator uses (``incremental_triangulator.cc:516-531``),
  * sampling: exhaustive C(n,3) combinations for tracks <= 15 observations
    (CombinationSampler, ``triangulation.cc:128-140``), uniform random
    beyond,
  * LO step: refit DLT on the inliers of the best sample (LORANSAC's
    single local-optimization refit).

Accelerator-first: all combinations are evaluated as one batch; invalid/padded
observations and invalid combinations are masked, not branched.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.ops import cameras as cam_ops
from privacy_preserving_sfm_tpu.ops import lie, lines as line_ops
from privacy_preserving_sfm_tpu.ops import triangulation as tri_ops
from privacy_preserving_sfm_tpu.solvers import ransac

BIG = 1e30
MAX_EXHAUSTIVE_TRACK = 15  # C(15,3) = 455 combinations (reference's cap)
# Without a PRNG key we still enumerate exhaustively as long as the
# combination count stays cheap on device; C(30,3) = 4060.
MAX_EXHAUSTIVE_COMBOS = 4096


@lru_cache(maxsize=None)
def _combinations3(n: int) -> np.ndarray:
    """All C(n, 3) index triples, shape (C, 3)."""
    return np.asarray(list(itertools.combinations(range(n), 3)), dtype=np.int32)


@lru_cache(maxsize=None)
def _keyless_combinations(n: int, m: int) -> np.ndarray:
    """Deterministic triples covering the FULL index pool [0, n).

    Exhaustive when C(n,3) <= MAX_EXHAUSTIVE_COMBOS; otherwise a
    deterministic (seeded by n) uniform sample of m distinct triples over
    the whole pool.  This replaces the old behavior of truncating to the
    first MAX_EXHAUSTIVE_TRACK observations, which made later observations
    unreachable as minimal-sample members.
    """
    total = n * (n - 1) * (n - 2) // 6
    if total <= MAX_EXHAUSTIVE_COMBOS:
        return _combinations3(n)
    rng = np.random.default_rng(7919 * n + 3)
    combos = np.stack(
        [rng.choice(n, size=3, replace=False) for _ in range(m)], axis=0)
    return combos.astype(np.int32)


class TriangulationResult(NamedTuple):
    point3d: jax.Array  # (3,) or (..., 3)
    num_inliers: jax.Array
    inlier_mask: jax.Array  # (N,)
    success: jax.Array


def angular_residuals(point3d, proj, lines, camera_params, camera_model: str,
                      width, height):
    """Squared angular error per observation; BIG when gated out.

    point3d (..., 3); proj (..., N, 3, 4); lines (..., N, 3);
    camera_params (..., N, P).
    """
    err = line_ops.line_angular_error(
        lines, point3d[..., None, :], proj, camera_model, camera_params,
        width, height)
    return jnp.where(err >= BIG, BIG, err * err)


def estimate_triangulation(
    lines: jax.Array,
    proj: jax.Array,
    centers: jax.Array,
    camera_params: jax.Array,
    valid: jax.Array,
    camera_model: str,
    width,
    height,
    max_angle_error_rad,
    min_tri_angle_rad,
    key: Optional[jax.Array] = None,
    num_random_samples: int = 512,
) -> TriangulationResult:
    """Robust triangulation of one track from point-to-line observations.

    Args:
      lines: (N, 3) normalized lines (one per observation).
      proj: (N, 3, 4) projection matrices of the observing images.
      centers: (N, 3) camera centers in world coordinates.
      camera_params: (N, P) camera parameters per observation.
      valid: (N,) bool observation mask (padding).
      camera_model: static camera model name (shared across observations).
      max_angle_error_rad: inlier threshold on the angular error.
      min_tri_angle_rad: minimal pairwise triangulation angle within a
        sample (``triangulation.cc:86-92``).
      key: optional PRNG key; when given and N > MAX_EXHAUSTIVE_TRACK,
        random sampling replaces the exhaustive combination set.

    Shapes are static in N; vmap over tracks for batched use.
    """
    n = lines.shape[0]
    dtype = lines.dtype

    if n <= MAX_EXHAUSTIVE_TRACK:
        combos = jnp.asarray(_combinations3(n))
    elif key is None:
        combos = jnp.asarray(_keyless_combinations(n, num_random_samples))
    else:
        combos = jax.random.randint(key, (num_random_samples, 3), 0, n)

    s_valid = jnp.all(valid[combos], axis=-1)
    # Distinctness (random sampling can repeat an index).
    distinct = ((combos[:, 0] != combos[:, 1])
                & (combos[:, 0] != combos[:, 2])
                & (combos[:, 1] != combos[:, 2]))
    s_valid = s_valid & distinct

    s_lines = lines[combos]      # (C, 3, 3)
    s_proj = proj[combos]        # (C, 3, 3, 4)
    s_centers = centers[combos]  # (C, 3, 3)

    X = tri_ops.triangulate_three_lines(s_proj, s_lines)  # (C, 3)

    # Per-sample gates: cheirality in each sampled view + pairwise angles.
    xyz = jnp.einsum("cnij,cj->cni", s_proj[..., :3], X) + s_proj[..., 3]
    cheiral = jnp.all(xyz[..., 2] > 0, axis=-1)
    ang01 = tri_ops.triangulation_angle(s_centers[:, 0], s_centers[:, 1], X)
    ang02 = tri_ops.triangulation_angle(s_centers[:, 0], s_centers[:, 2], X)
    ang12 = tri_ops.triangulation_angle(s_centers[:, 1], s_centers[:, 2], X)
    good_angle = (jnp.maximum(jnp.maximum(ang01, ang02), ang12)
                  >= min_tri_angle_rad)
    s_valid = s_valid & cheiral & good_angle & jnp.all(jnp.isfinite(X), axis=-1)

    # Score every sample against every observation.
    res = angular_residuals(X, proj[None], lines[None], camera_params[None],
                            camera_model, width, height)  # (C, N)
    res = jnp.where(s_valid[:, None], res, BIG)
    thresh = jnp.asarray(max_angle_error_rad, dtype) ** 2
    score, num, inl = ransac.inlier_score(res, thresh, valid[None])
    best = ransac.select_best(X, score, num, inl)

    # LO refit on the best sample's inliers (LORANSAC.loransac.h:149-192,
    # one refit), keep whichever support is better.
    X_lo = tri_ops.triangulate_multiview_lines(proj, lines, mask=best.inlier_mask)
    res_lo = angular_residuals(X_lo, proj, lines, camera_params,
                               camera_model, width, height)
    ok_lo = jnp.all(jnp.isfinite(X_lo))
    res_lo = jnp.where(ok_lo, res_lo, BIG)
    score_lo, num_lo, inl_lo = ransac.inlier_score(res_lo, thresh, valid)

    use_lo = score_lo > best.score
    point = jnp.where(use_lo, X_lo, best.model)
    num_fin = jnp.where(use_lo, num_lo, best.num_inliers)
    inl_fin = jnp.where(use_lo, inl_lo, best.inlier_mask)

    # Reference requires >= 3 residuals within threshold for success
    # (EstimateTriangulation returns false on < 3 inliers implicitly via
    # min sample size; IncrementalTriangulator::Create checks >= 3).
    success = num_fin >= 3
    return TriangulationResult(point3d=point, num_inliers=num_fin,
                               inlier_mask=inl_fin, success=success)
