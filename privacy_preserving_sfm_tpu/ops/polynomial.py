"""Batched univariate polynomial arithmetic and root finding.

The reference extracts polynomial roots with a nonsymmetric 8x8 companion
matrix eigensolve (``lib/re3q3/re3q3/re3q3.h:152-165``), which batches poorly on
an accelerator.  We instead run a *fixed-iteration Aberth–Ehrlich* simultaneous
root finder in complex arithmetic (pairs of reals), which vectorizes over
both the batch and the root dimension — a few dozen elementwise iterations
instead of a sequential QR eigensolve — followed by Newton polishing of the
real roots.

Coefficient convention: ascending order, ``p(x) = sum_k c[..., k] x^k``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

ABERTH_ITERS = 48
POLISH_ITERS = 3


def polymul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Product of polynomials, ascending coefficients, batched on leading dims.

    a: (..., Na), b: (..., Nb) -> (..., Na+Nb-1).  Implemented as an explicit
    outer-product scatter (small fixed N) so it fuses under jit.
    """
    na, nb = a.shape[-1], b.shape[-1]
    out = jnp.zeros(jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (na + nb - 1,),
                    dtype=jnp.result_type(a, b))
    for i in range(na):
        out = out.at[..., i:i + nb].add(a[..., i:i + 1] * b)
    return out


def polyadd(a: jax.Array, b: jax.Array) -> jax.Array:
    """Sum of polynomials with possibly different lengths (ascending)."""
    n = max(a.shape[-1], b.shape[-1])
    pad_a = [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])]
    pad_b = [(0, 0)] * (b.ndim - 1) + [(0, n - b.shape[-1])]
    return jnp.pad(a, pad_a) + jnp.pad(b, pad_b)


def polyval(c: jax.Array, x: jax.Array) -> jax.Array:
    """Evaluate ascending-coefficient polynomial at x (Horner).

    c: (..., N), x: (...) -> (...).  Supports complex x.
    """
    out = jnp.zeros_like(x) + c[..., -1]
    for k in range(c.shape[-1] - 2, -1, -1):
        out = out * x + c[..., k]
    return out


def polyder(c: jax.Array) -> jax.Array:
    """Derivative, ascending coefficients."""
    n = c.shape[-1]
    k = jnp.arange(1, n, dtype=c.dtype)
    return c[..., 1:] * k


def _initial_roots(c: jax.Array, degree: int) -> jax.Array:
    """Initial Aberth guesses on a circle scaled by the root-magnitude bound.

    Uses the Cauchy-style bound r = 1 + max|c_k / c_n| and spreads the guesses
    at fixed non-symmetric angles (a deterministic offset avoids the symmetric
    stagnation case).
    """
    cn = c[..., -1:]
    cn_safe = jnp.where(jnp.abs(cn) < 1e-30, 1e-30, cn)
    ratios = jnp.abs(c[..., :-1] / cn_safe)
    r = 1.0 + jnp.max(ratios, axis=-1, keepdims=True)
    r = jnp.minimum(r, 1e8)
    k = jnp.arange(degree, dtype=c.dtype)
    theta = 2.0 * jnp.pi * k / degree + 0.4
    return (r * jnp.exp(1j * theta.astype(jnp.complex64 if c.dtype == jnp.float32
                                          else jnp.complex128)))


def aberth_roots(c: jax.Array, iters: int = ABERTH_ITERS) -> jax.Array:
    """All complex roots of p(x) = sum c[..., k] x^k, degree = N-1.

    c: (..., N) real, leading coefficient c[..., -1] must be nonzero
    (caller normalizes / guards degenerate batches).  Returns (..., N-1)
    complex roots.  Fixed iteration count -> static control flow.
    """
    degree = c.shape[-1] - 1
    cdtype = jnp.complex64 if c.dtype == jnp.float32 else jnp.complex128
    # Normalize to monic for numerical sanity.
    cn = c[..., -1:]
    cn_safe = jnp.where(jnp.abs(cn) < 1e-30, 1e-30, cn)
    cm = c / cn_safe

    # Root-magnitude scaling: substitute x = s * u with s ~ the geometric
    # mean root magnitude |c0 / cN|^(1/N), so Aberth's initial circle sits
    # near the roots even when coefficients span many orders of magnitude
    # (otherwise convergence from a 1e8 radius needs hundreds of steps).
    c0 = jnp.abs(cm[..., :1])
    s = jnp.power(jnp.maximum(c0, 1e-30), 1.0 / degree)
    s = jnp.clip(s, 1e-6, 1e6)
    k = jnp.arange(degree + 1, dtype=c.dtype)
    cm = cm * jnp.power(s, k)  # coefficients of p(s u) (up to overall scale)
    cm = cm / jnp.maximum(jnp.max(jnp.abs(cm), axis=-1, keepdims=True), 1e-30)
    cm = cm.astype(cdtype)

    z = _initial_roots(jnp.real(cm).astype(c.dtype), degree)  # (..., degree)
    cmb = cm[..., None, :]  # broadcast coefficients over the root axis
    dcmb = polyder(cm)[..., None, :]

    def body(_, z):
        p = polyval(cmb, z)
        dp = polyval(dcmb, z)
        dp = jnp.where(jnp.abs(dp) < 1e-30, 1e-30 + 0j, dp)
        newton = p / dp
        # Pairwise repulsion sum_{j != i} 1 / (z_i - z_j).
        diff = z[..., :, None] - z[..., None, :]
        eye = jnp.eye(degree, dtype=bool)
        diff = jnp.where(eye, 1.0 + 0j, diff)
        inv = jnp.where(eye, 0.0 + 0j, 1.0 / diff)
        rep = jnp.sum(inv, axis=-1)
        denom = 1.0 - newton * rep
        denom = jnp.where(jnp.abs(denom) < 1e-30, 1e-30 + 0j, denom)
        step = newton / denom
        # Guard NaN/Inf explosions (degenerate coefficient rows).
        step = jnp.where(jnp.isfinite(step), step, 0.0 + 0j)
        return z - step

    u = jax.lax.fori_loop(0, iters, body, z)
    return u * s.astype(cdtype)  # undo the x = s * u substitution


def real_roots(c: jax.Array, imag_tol: float = 1e-6,
               polish_iters: int = POLISH_ITERS) -> Tuple[jax.Array, jax.Array]:
    """Real roots of a real polynomial with validity mask.

    Returns (roots, is_real) both shaped (..., degree).  Real-part estimates
    are Newton-polished on the real polynomial, mirroring the reference's
    post-eigensolve real-root extraction (``re3q3.h:169-191``) but keeping a
    fixed shape (masked) instead of compacting.
    """
    z = aberth_roots(c)
    x = jnp.real(z)

    cn = c[..., -1:]
    cn_safe = jnp.where(jnp.abs(cn) < 1e-30, 1e-30, cn)
    cm = c / cn_safe
    dcm = polyder(cm)

    # Broadcast coefficient row over the root axis for polyval.
    cmb = jnp.broadcast_to(cm[..., None, :], x.shape + (cm.shape[-1],))
    dcmb = jnp.broadcast_to(dcm[..., None, :], x.shape + (dcm.shape[-1],))

    def polish_b(_, x):
        p = polyval(cmb, x)
        dp = polyval(dcmb, x)
        dp = jnp.where(jnp.abs(dp) < 1e-30, 1e-30, dp)
        step = p / dp
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        return x - step

    x = jax.lax.fori_loop(0, polish_iters, polish_b, x)

    # Realness test: small imaginary part relative to root magnitude.
    scale = jnp.maximum(jnp.abs(z), 1.0)
    is_real = jnp.abs(jnp.imag(z)) <= imag_tol * scale
    return x, is_real
