"""Device-resident vectorized RANSAC.

Semantics follow the reference framework (``src/optim/ransac.h:78-249``,
``loransac.h:54-238``, ``support_measurement.h:43-77``) but the execution
model is batched: B hypotheses are generated and scored in parallel instead
of a sequential loop.

Support comparison (reference `InlierSupportMeasurer::Compare`): more
inliers wins; equal inliers -> smaller inlier-residual sum wins.  We encode
this lexicographic order in a single float score
``num_inliers - rs / (1 + rs)`` (the second term is in [0, 1)).  MSAC
scoring (RansacLib, used by the init module) is ``-sum(min(r, thresh))``.

Data is fixed-shape and padded; a validity mask excludes padding from both
sampling and scoring.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class RansacResult(NamedTuple):
    model: object  # best model pytree (leading batch dims stripped)
    score: jax.Array  # combined support score (higher better)
    num_inliers: jax.Array  # ()
    inlier_mask: jax.Array  # (N,)
    best_index: jax.Array  # hypothesis index, for debugging


def draw_samples(key: jax.Array, num_data: int, valid: jax.Array,
                 sample_size: int, num_hypotheses: int) -> jax.Array:
    """(B, k) index samples, distinct within a sample, valid-only.

    Gumbel top-k over masked logits: equivalent to uniform sampling of k
    distinct valid indices, fully batched (no per-hypothesis loop).
    """
    g = jax.random.gumbel(key, (num_hypotheses, num_data))
    logits = jnp.where(valid[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(logits, sample_size)
    return idx


def inlier_score(residuals: jax.Array, threshold, valid: jax.Array):
    """Reference inlier-count support with residual-sum tiebreak.

    residuals: (..., N) squared residuals; valid: (N,) or (..., N).
    Returns (score, num_inliers, inlier_mask).
    """
    inlier = (residuals < threshold) & valid
    num = jnp.sum(inlier, axis=-1)
    rs = jnp.sum(jnp.where(inlier, residuals, 0.0), axis=-1)
    score = num.astype(residuals.dtype) - rs / (1.0 + rs)
    return score, num, inlier


def msac_score(residuals: jax.Array, threshold, valid: jax.Array):
    """RansacLib LO-MSAC truncated score (negated: higher is better)."""
    r = jnp.where(valid, jnp.minimum(residuals, threshold), 0.0)
    inlier = (residuals < threshold) & valid
    num = jnp.sum(inlier, axis=-1)
    return -jnp.sum(r, axis=-1), num, inlier


def select_best(models, score: jax.Array, num_inliers: jax.Array,
                inlier_mask: jax.Array) -> RansacResult:
    """Argmax over flattened hypothesis axes of a scored model batch.

    models: pytree with leading shape matching ``score``.
    """
    flat_score = score.reshape(-1)
    best = jnp.argmax(flat_score)

    def take(x):
        return x.reshape((-1,) + x.shape[score.ndim:])[best]

    return RansacResult(
        model=jax.tree_util.tree_map(take, models),
        score=flat_score[best],
        num_inliers=num_inliers.reshape(-1)[best],
        inlier_mask=inlier_mask.reshape((-1,) + inlier_mask.shape[score.ndim:])[best],
        best_index=best,
    )


def num_trials_needed(num_inliers, num_valid, sample_size: int,
                      confidence: float = 0.99999,
                      multiplier: float = 3.0,
                      max_trials: int = 1_000_000):
    """Adaptive trial bound ``log(1-conf)/log(1-ratio^m) * multiplier``.

    Mirror of ``ransac.h:158-176``; used by callers for between-batch
    early exit (host-side), not inside the jitted kernel.
    """
    ratio = jnp.clip(num_inliers / jnp.maximum(num_valid, 1), 1e-9, 1.0)
    nom = jnp.log(jnp.maximum(1.0 - confidence, 1e-300))
    denom = jnp.log1p(-jnp.clip(ratio ** sample_size, None, 1.0 - 1e-12))
    trials = multiplier * nom / jnp.minimum(denom, -1e-300)
    return jnp.minimum(trials, max_trials)


def prosac_prefix_sizes(num_data: int, sample_size: int,
                        num_hypotheses: int,
                        num_progressive: int = 200_000):
    """Static PROSAC prefix-size schedule n_t for t = 1..B.

    Host-side port of the growth function of
    ``src/optim/progressive_sampler.cc:49-82`` (Chum & Matas eq. 3): the
    t-th hypothesis samples from the top n_t quality-ranked
    correspondences, growing towards plain RANSAC.  Returns a numpy int
    array usable as a trace-time constant.
    """
    import numpy as np

    m = sample_size
    T_n = float(num_progressive)
    for i in range(m):
        T_n *= (m - i) / (num_data - i)
    T_n_p = 1.0
    n = m
    out = np.zeros(num_hypotheses, np.int32)
    for t in range(1, num_hypotheses + 1):
        if t == int(T_n_p) and n < num_data:
            T_n_plus_1 = T_n * (n + 1.0) / (n + 1.0 - m)
            T_n_p += np.ceil(T_n_plus_1 - T_n)
            T_n = T_n_plus_1
            n += 1
        out[t - 1] = n
    return out


def draw_samples_progressive(key: jax.Array, num_data: int,
                             valid: jax.Array, sample_size: int,
                             num_hypotheses: int,
                             quality_rank: jax.Array) -> jax.Array:
    """PROSAC sampling, batched: hypothesis t draws its sample from the
    top-n_t entries of the quality ordering (best-ranked correspondences
    first), degenerating to uniform RANSAC as t grows.

    quality_rank: (N,) lower = better (e.g. descriptor match distance).
    Distinctness within a sample via Gumbel top-k over prefix-masked
    logits (same trick as ``draw_samples``).
    """
    order = jnp.argsort(jnp.where(valid, quality_rank, jnp.inf))  # (N,)
    num_valid = jnp.sum(valid)
    prefix = jnp.asarray(
        prosac_prefix_sizes(num_data, sample_size, num_hypotheses))
    prefix = jnp.minimum(prefix, num_valid)  # never sample padding
    pos = jnp.arange(num_data)[None, :]  # position in the quality order
    in_prefix = pos < prefix[:, None]  # (B, N)
    g = jax.random.gumbel(key, (num_hypotheses, num_data))
    logits = jnp.where(in_prefix, g, -jnp.inf)
    _, pos_idx = jax.lax.top_k(logits, sample_size)  # positions in order
    return order[pos_idx]  # (B, k) original indices


def subset_prescreen(res_subset: jax.Array, threshold,
                     valid_subset: jax.Array, keep: int) -> jax.Array:
    """Batched SPRT analogue: rank hypotheses by inlier support on a
    random residual SUBSET, return the indices of the ``keep`` best.

    The reference's SPRT (``sprt.h:45-80``) aborts per-hypothesis residual
    loops early via a likelihood-ratio test; on the device the sequential test
    becomes a two-stage batch: cheap subset scoring over all B hypotheses,
    full scoring only for the shortlisted ``keep``.

    res_subset: (B, n_sub) squared residuals on the probe subset.
    """
    score, _, _ = inlier_score(res_subset, threshold, valid_subset)
    _, idx = jax.lax.top_k(score, keep)
    return idx
