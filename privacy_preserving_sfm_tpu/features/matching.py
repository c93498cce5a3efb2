"""Descriptor matching: exact batched top-2 with ratio/distance/cross checks.

Semantics of the reference CPU brute-force matcher (``src/feature/sift.cc:
54-143, 251-351``): descriptors are uint8 quantizations of 512 * L1-root
normalized SIFT vectors; similarity is the dot product scaled by 1/512^2 and
mapped through acos to an angular distance; a match survives if

  * best_dist < max_distance            (0.7 rad default)
  * best_dist < max_ratio * second_dist (0.8 default)
  * cross check: mutual nearest neighbors (cross_check=true)

The FLANN path (4 kd-trees, 128 checks) is an *approximation* of exactly
this; here the exact (N1, 128) @ (128, N2) product runs as one dense
matmul per pair and needs no trees.  Pairs with < min_num_matches matches
are zeroed by the caller (``matching.cc:414-416``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

DIST_NORM = 1.0 / (512.0 * 512.0)
BIG = 1e9


class MatchResult(NamedTuple):
    matches: jax.Array  # (N1,) int32 index into image 2, -1 = no match
    num_matches: jax.Array  # () int32
    best_dist: jax.Array  # (N1,) angular distance of the best candidate


def descriptor_dots(desc1: jax.Array, desc2: jax.Array) -> jax.Array:
    """Raw dot-product matrix d1 . d2, (N1, N2) f32 (LARGER = closer).

    Inputs are uint8 descriptors upcast to f32.  The default precision is
    exact here, TF32 tensor cores included: every uint8 value fits TF32's
    11-bit significand, each product is accumulated in f32, and a sum of
    128 products is at most 128 * 255^2 < 2^24, so every partial sum is an
    integer f32 represents exactly.
    """
    d1 = desc1.astype(jnp.float32)
    d2 = desc2.astype(jnp.float32)
    return jax.lax.dot_general(
        d1, d2, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)


def descriptor_distances(desc1: jax.Array, desc2: jax.Array) -> jax.Array:
    """Angular distance matrix acos(clip(d1 . d2 / 512^2)). (N1,N2) f32."""
    return _to_angle(descriptor_dots(desc1, desc2))


def _to_angle(dots: jax.Array) -> jax.Array:
    return jnp.arccos(jnp.clip(dots * DIST_NORM, -1.0, 1.0))


def _top2_max(dots: jax.Array, axis: int):
    """Largest and second-largest along axis, with argmax of the largest.

    acos is monotonically decreasing, so the top-2 dots ARE the top-2
    nearest neighbors; the transcendental is applied to 2N scalars
    afterwards instead of the full N^2 matrix (which dominated CPU
    matching time).
    """
    best_idx = jnp.argmax(dots, axis=axis)
    best = jnp.max(dots, axis=axis)
    iota = jax.lax.broadcasted_iota(jnp.int32, dots.shape, axis)
    masked = jnp.where(iota == jnp.expand_dims(best_idx, axis), -BIG, dots)
    second = jnp.max(masked, axis=axis)
    return best, second, best_idx


def _top2_both_batched(d1s, d2s, valid1, valid2):
    """Top-2 dots + argmax in both directions for B pairs.

    d1s (B, N1, 128) u8, d2s (B, N2, 128) u8, valid (B, N).  Returns
    (bd12, sd12, idx12, bd21, sd21, idx21) raw-dot f32 / int32 arrays.
    Each pair's (N1, N2) f32 dot matrix is materialized in device memory
    (``features/schedulers.pairs_per_dispatch`` sizes batches for it).
    """
    def one(d1, d2, v1, v2):
        dots = descriptor_dots(d1, d2)
        dots = jnp.where(v1[:, None], dots, -BIG)
        dots = jnp.where(v2[None, :], dots, -BIG)
        bd12, sd12, idx12 = _top2_max(dots, axis=1)
        bd21, sd21, idx21 = _top2_max(dots, axis=0)
        return bd12, sd12, idx12, bd21, sd21, idx21

    return jax.vmap(one)(d1s, d2s, valid1, valid2)


def _gate_and_cross(valid1, bd12, sd12, idx12, bd21, sd21, idx21,
                    max_ratio, max_distance, cross_check):
    """Ratio/distance gates + mutual-NN cross check on (B, N) tables."""
    best12, second12 = _to_angle(bd12), _to_angle(sd12)
    ok = valid1 & (best12 < max_distance) & (best12 < max_ratio * second12)
    if cross_check:
        best21, second21 = _to_angle(bd21), _to_angle(sd21)
        ok21 = (best21 < max_distance) & (best21 < max_ratio * second21)
        back = jnp.take_along_axis(idx21, idx12, axis=1)
        okb = jnp.take_along_axis(ok21, idx12, axis=1)
        mutual = (back == jnp.arange(idx12.shape[1])[None, :]) & okb
        ok = ok & mutual
    matches = jnp.where(ok, idx12, -1)
    return MatchResult(matches=matches.astype(jnp.int32),
                       num_matches=jnp.sum(ok, axis=1).astype(jnp.int32),
                       best_dist=best12)


def match_descriptors(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: Optional[jax.Array] = None,
    valid2: Optional[jax.Array] = None,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
) -> MatchResult:
    """Match uint8 SIFT descriptors (fixed shapes, padding masked).

    Defaults are ``SiftMatchingOptions`` (``sift.h:117-144``).
    """
    if valid1 is None:
        valid1 = jnp.ones(desc1.shape[0], bool)
    if valid2 is None:
        valid2 = jnp.ones(desc2.shape[0], bool)
    res = _gate_and_cross(
        valid1[None],
        *_top2_both_batched(desc1[None], desc2[None], valid1[None],
                            valid2[None]),
        max_ratio, max_distance, cross_check)
    return MatchResult(matches=res.matches[0],
                       num_matches=res.num_matches[0],
                       best_dist=res.best_dist[0])


def match_many_pairs(desc: jax.Array, valid: jax.Array,
                     pairs: jax.Array, max_ratio: float = 0.8,
                     max_distance: float = 0.7,
                     cross_check: bool = True) -> MatchResult:
    """Batched matcher over a (B, 2) array of image-index pairs.

    desc: (I, N, 128) stacked per-image descriptor tables (padded);
    valid: (I, N).  Used by the exhaustive/sequential schedulers to batch
    whole blocks of pairs into one device call
    (block structure: ``matching.cc:436-498``).
    """
    d1s, d2s = desc[pairs[:, 0]], desc[pairs[:, 1]]
    v1s, v2s = valid[pairs[:, 0]], valid[pairs[:, 1]]
    return _gate_and_cross(v1s, *_top2_both_batched(d1s, d2s, v1s, v2s),
                           max_ratio, max_distance, cross_check)
