"""Closed-form small-matrix kernels (batched, accelerator-friendly).

``jnp.linalg.*`` routes tiny dense problems through generic LAPACK-style
lowerings (one library call per tiny matrix) that are slow on an
accelerator; every solver in this framework
needs only 2x2/3x3/4x4 systems, so we provide explicit cofactor/Cramer
kernels that fuse into surrounding elementwise code.  All functions
broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def det2(A: jax.Array) -> jax.Array:
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def det3(A: jax.Array) -> jax.Array:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: jax.Array) -> jax.Array:
    """Adjugate (transposed cofactor matrix) of 3x3 A."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = jnp.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        axis=-1,
    )
    return adj.reshape(A.shape)


def solve2(A: jax.Array, b: jax.Array, eps: float = 1e-30) -> jax.Array:
    """Solve 2x2 systems A x = b by Cramer's rule. (..., 2, 2), (..., 2)."""
    det = det2(A)
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    x0 = (A[..., 1, 1] * b[..., 0] - A[..., 0, 1] * b[..., 1]) / det
    x1 = (A[..., 0, 0] * b[..., 1] - A[..., 1, 0] * b[..., 0]) / det
    return jnp.stack([x0, x1], axis=-1)


def solve3(A: jax.Array, b: jax.Array, eps: float = 1e-30) -> jax.Array:
    """Solve 3x3 systems A x = b via the adjugate. (..., 3, 3), (..., 3)."""
    det = det3(A)
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    return jnp.einsum("...ij,...j->...i", adjugate3(A), b) / det[..., None]


def inv3(A: jax.Array, eps: float = 1e-30) -> jax.Array:
    det = det3(A)
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    return adjugate3(A) / det[..., None, None]


def chol3(A: jax.Array, eps: float = 1e-30) -> jax.Array:
    """Closed-form Cholesky of batched SPD 3x3: A = L L^T, L lower.

    Batched over leading dims; clamps pivots at ``eps`` so padded/singular
    blocks yield finite (garbage) factors instead of NaNs — callers mask.
    """
    a00 = jnp.maximum(A[..., 0, 0], eps)
    l00 = jnp.sqrt(a00)
    l10 = A[..., 1, 0] / l00
    l20 = A[..., 2, 0] / l00
    l11 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l10 * l10, eps))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l20 * l20 - l21 * l21, eps))
    z = jnp.zeros_like(l00)
    return jnp.stack([
        jnp.stack([l00, z, z], -1),
        jnp.stack([l10, l11, z], -1),
        jnp.stack([l20, l21, l22], -1)], -2)


def solve_spd(A: jax.Array, b: jax.Array, damping: float = 0.0) -> jax.Array:
    """Solve small SPD systems via Cholesky-free normal-equation Cramer.

    For n <= 3 uses the closed forms above; larger systems should use the
    blocked solvers in ``optim/``.
    """
    n = A.shape[-1]
    if damping:
        A = A + damping * jnp.eye(n, dtype=A.dtype)
    if n == 2:
        return solve2(A, b)
    if n == 3:
        return solve3(A, b)
    raise ValueError(f"solve_spd only supports n<=3, got {n}")


_JACOBI_SWEEPS = 10


def symmetric_eig_smallest(G: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n) G.

    Fixed-sweep cyclic Jacobi, unrolled over the static pair list — no
    data-dependent control flow, so it vectorizes and compiles to
    straight-line code.  Intended for small n (<= 10-ish).
    """
    n = G.shape[-1]
    V0 = jnp.broadcast_to(jnp.eye(n, dtype=G.dtype), G.shape)
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]

    def sweep(_, AV):
        A, V = AV
        for p, q in pairs:
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            theta = 0.5 * jnp.arctan2(2.0 * apq, aqq - app)
            c = jnp.cos(theta)
            s = jnp.sin(theta)
            J = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
            J = J.at[..., p, p].set(c)
            J = J.at[..., q, q].set(c)
            J = J.at[..., p, q].set(s)
            J = J.at[..., q, p].set(-s)
            A = jnp.einsum("...ji,...jk,...kl->...il", J, A, J)
            V = jnp.einsum("...ij,...jk->...ik", V, J)
        return A, V

    # fori_loop over sweeps: 10x smaller jaxpr than full unrolling (the
    # round-1 unrolled version dominated mapper trace time).
    A, V = jax.lax.fori_loop(0, _JACOBI_SWEEPS, sweep, (G, V0))
    idx = jnp.argmin(jnp.diagonal(A, axis1=-2, axis2=-1), axis=-1)
    v = jnp.take_along_axis(V, idx[..., None, None].repeat(n, -2), axis=-1)
    v = v[..., 0]
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)


def gram_null_vector(A: jax.Array) -> jax.Array:
    """Unit null-space vector of a tall (..., m, n) stack via A^T A Jacobi.

    Replacement for `JacobiSVD(...).matrixV().rightCols(1)` on small n.
    Rows are norm-balanced first to tame the squared conditioning.
    """
    norm = jnp.linalg.norm(A, axis=-1, keepdims=True)
    An = A / jnp.maximum(norm, 1e-30)
    G = jnp.einsum("...mi,...mj->...ij", An, An)
    return symmetric_eig_smallest(G)


def solve_gauss(A: jax.Array, b: jax.Array) -> jax.Array:
    """Dense solve with partial pivoting, unrolled for small static n.

    Branch-free: pivot selection uses argmax + one-hot permutation matmuls.
    A: (..., n, n), b: (..., n).  Intended for n <= ~16 (e.g. the 8x8
    camera system of the 2D init bundle).
    """
    n = A.shape[-1]
    M = jnp.concatenate([A, b[..., :, None]], axis=-1)  # (..., n, n+1)
    for k in range(n):
        col = jnp.abs(M[..., :, k])
        if k > 0:
            mask = jnp.arange(n) < k
            col = jnp.where(mask, -jnp.inf, col)
        piv = jnp.argmax(col, axis=-1)  # (...,)
        # Swap rows k and piv via a gather permutation.
        ar = jnp.arange(n)
        idx = jnp.broadcast_to(ar, M.shape[:-2] + (n,))
        idx = idx.at[..., k].set(piv)
        is_piv_row = (ar == piv[..., None]) & (ar != k)
        idx = jnp.where(is_piv_row, k, idx)
        M = jnp.take_along_axis(M, idx[..., None], axis=-2)
        pivot_val = M[..., k, k]
        pivot_val = jnp.where(jnp.abs(pivot_val) < 1e-30,
                              jnp.where(pivot_val < 0, -1e-30, 1e-30),
                              pivot_val)
        row_k = M[..., k, :] / pivot_val[..., None]
        M = M.at[..., k, :].set(row_k)
        factors = M[..., :, k]
        factors = factors.at[..., k].set(0.0)
        M = M - factors[..., :, None] * row_k[..., None, :]
    return M[..., :, n]


def lstsq_normal3(A: jax.Array, b: jax.Array, reg_scale: float = 1e-12,
                  refine: int = 1) -> jax.Array:
    """Least-squares solve of tall (..., N, 3) systems via normal equations.

    A trace-scaled Levenberg floor keeps rank-deficient stacks finite, and
    ``refine`` rounds of iterative refinement recover fp32 accuracy.
    """
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    Atb = jnp.einsum("...ni,...n->...i", A, b)
    reg = reg_scale * jnp.trace(AtA, axis1=-2, axis2=-1)
    eye = jnp.eye(3, dtype=A.dtype)
    AtA_r = AtA + (reg[..., None, None] + 1e-30) * eye
    x = solve3(AtA_r, Atb)
    for _ in range(refine):
        r = Atb - jnp.einsum("...ij,...j->...i", AtA, x)
        x = x + solve3(AtA_r, r)
    return x
