"""Batched 3Q3 solver: three quadrics in three unknowns (up to 8 solutions).

Behavioral equivalent of the reference's re3q3 (``lib/re3q3/re3q3/re3q3.h``,
itself a re-implementation of E3Q3 with the stability tricks of Zhou et al.
ACCV 2018), but derived and implemented differently, accelerator-first:

  * elimination: treat the three quadrics as linear in (y^2, z^2, yz) given
    x, solve for them, and rewrite as three relations E1: y^2 = a0 y + b0 z
    + g0, E2: z^2 = ..., E3: yz = ... with a,b linear and g quadratic in x.
    Cross-multiplying (y*E3 vs z*E1, z*E3 vs y*E2, E1*E2 vs E3^2) and
    re-substituting yields a 3x3 polynomial matrix M(x) with
    M(x) [y, z, 1]^T = 0, so det M(x) = 0 — a degree-8 polynomial.
    (The reference reaches the same determinant through hand-expanded
    coefficient formulas; we build it with small polynomial convolutions.)
  * roots: Aberth–Ehrlich simultaneous iteration (``ops/polynomial.py``)
    instead of a companion-matrix eigensolve (a sequential, branchy QR
    iteration that batches poorly on an accelerator).
  * back-substitution: least-squares solve of M(x) [y, z]^T = -M(x)[:, 2]
    over all three rows (the reference uses a 2x2 subsystem).
  * stability: the same best-pivot variable permutation as the reference
    (choose which variable remains univariate by the largest |det| of the
    quadratic-block matrix) plus a random affine change of variables for
    degenerate instances, here applied branch-free via masking; and a final
    damped-Newton polish on the original quadrics, which also rescues the
    fp32 path.

Monomial order of the input coefficients (matching the reference):
``x^2, xy, xz, y^2, yz, z^2, x, y, z, 1``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import linalg
from privacy_preserving_sfm_tpu.ops import polynomial as poly

# Monomial indices.
_X2, _XY, _XZ, _Y2, _YZ, _Z2, _X, _Y, _Z, _1 = range(10)

NEWTON_POLISH_ITERS = 8

# Variable permutations: for pivot k, (sigma) maps new vars (x', y', z') to
# original positions: original_var[perm[k][i]] = new_var i.
#   pivot 0 (x stays):      (x, y, z)
#   pivot 1 (y stays):      x' = y, y' = x, z' = z
#   pivot 2 (z stays):      x' = z, y' = y, z' = x
_PERMS = ((0, 1, 2), (1, 0, 2), (2, 1, 0))


def _permute_coeffs(coeffs: jax.Array, perm) -> jax.Array:
    """Reorder monomial coefficients under a permutation of (x, y, z)."""
    p = perm
    # monomial index as function of variable pair
    pair_idx = {(0, 0): _X2, (0, 1): _XY, (1, 0): _XY, (0, 2): _XZ,
                (2, 0): _XZ, (1, 1): _Y2, (1, 2): _YZ, (2, 1): _YZ,
                (2, 2): _Z2}
    lin_idx = {0: _X, 1: _Y, 2: _Z}
    order = []
    # new monomial m'(x', y', z') = m(original vars) with var i' = var p[i]
    for (i, j), tgt in (((0, 0), _X2), ((0, 1), _XY), ((0, 2), _XZ),
                        ((1, 1), _Y2), ((1, 2), _YZ), ((2, 2), _Z2)):
        order.append((tgt, pair_idx[(p[i], p[j])]))
    for i, tgt in ((0, _X), (1, _Y), (2, _Z)):
        order.append((tgt, lin_idx[p[i]]))
    order.append((_1, _1))
    out = [None] * 10
    for tgt, src in order:
        out[tgt] = coeffs[..., src]
    return jnp.stack(out, axis=-1)


def _quad_block_det(coeffs: jax.Array, perm) -> jax.Array:
    """|det| of the 3x3 block of (y'^2, z'^2, y'z') coefficients."""
    c = _permute_coeffs(coeffs, perm)
    A = jnp.stack([c[..., _Y2], c[..., _Z2], c[..., _YZ]], axis=-1)  # (...,3,3)
    return jnp.abs(linalg.det3(A))


def _affine_change_matrix(A: jax.Array, a: jax.Array, dtype) -> jax.Array:
    """Build B (10, 10) with mu(A w + a) = B mu(w) for the monomial vector mu.

    Used for the random change of variables on degenerate instances
    (counterpart of ``re3q3.h:39-64``), but constructed programmatically
    from the substitution rather than hand-expanded.
    """
    rows_quad = [(_X2, 0, 0), (_XY, 0, 1), (_XZ, 0, 2),
                 (_Y2, 1, 1), (_YZ, 1, 2), (_Z2, 2, 2)]
    pair_of = {(0, 0): _X2, (0, 1): _XY, (1, 0): _XY, (0, 2): _XZ,
               (2, 0): _XZ, (1, 1): _Y2, (1, 2): _YZ, (2, 1): _YZ,
               (2, 2): _Z2}
    lin_of = {0: _X, 1: _Y, 2: _Z}
    B = jnp.zeros((10, 10), dtype=dtype)
    for row, i, j in rows_quad:
        # v_i v_j = sum_kl A_ik A_jl w_k w_l + sum_k (A_ik a_j + A_jk a_i) w_k
        #           + a_i a_j
        for k in range(3):
            for l in range(3):
                B = B.at[row, pair_of[(k, l)]].add(A[i, k] * A[j, l])
            B = B.at[row, lin_of[k]].add(A[i, k] * a[j] + A[j, k] * a[i])
        B = B.at[row, _1].add(a[i] * a[j])
    for i in range(3):
        row = lin_of[i]
        for k in range(3):
            B = B.at[row, lin_of[k]].add(A[i, k])
        B = B.at[row, _1].add(a[i])
    B = B.at[_1, _1].set(1.0)
    return B


def _build_M_polys(P: jax.Array):
    """From the elimination matrix P build the 3x3 polynomial matrix M(x).

    P: (..., 3, 7) with [y^2; z^2; yz] = P @ [x^2, xy, xz, x, y, z, 1]^T.
    Returns the 9 coefficient vectors (ascending in x) of M(x), with row
    degrees (2, 2, 3), (2, 2, 3), (3, 3, 4).
    """
    def lin(i, col_x, col_1):  # linear-in-x coefficient pair (ascending)
        return jnp.stack([P[..., i, col_1], P[..., i, col_x]], axis=-1)

    # alpha_i(x) = P[i,1] x + P[i,4]; beta_i = P[i,2] x + P[i,5];
    # gamma_i(x) = P[i,0] x^2 + P[i,3] x + P[i,6]
    al = [lin(i, 1, 4) for i in range(3)]
    be = [lin(i, 2, 5) for i in range(3)]
    ga = [jnp.stack([P[..., i, 6], P[..., i, 3], P[..., i, 0]], axis=-1)
          for i in range(3)]

    pm, pa = poly.polymul, poly.polyadd

    def neg(c):
        return -c

    # Row 1: y*(E3) == z*(E1) re-substituted.
    f1y = pa(pa(pm(al[2], be[2]), ga[2]), neg(pm(al[1], be[0])))
    f1z = pa(pa(pm(al[2], be[0]), pm(be[2], be[2])),
             pa(neg(pm(al[0], be[2])), pa(neg(pm(be[0], be[1])), neg(ga[0]))))
    f1c = pa(pa(pm(al[2], ga[0]), pm(be[2], ga[2])),
             pa(neg(pm(al[0], ga[2])), neg(pm(be[0], ga[1]))))

    # Row 2: z*(E3) == y*(E2) re-substituted.
    f2y = pa(pa(pm(al[0], al[1]), pm(be[1], al[2])),
             pa(ga[1], pa(neg(pm(al[2], al[2])), neg(pm(be[2], al[1])))))
    f2z = pa(pm(al[1], be[0]), pa(neg(pm(al[2], be[2])), neg(ga[2])))
    f2c = pa(pa(pm(al[1], ga[0]), pm(be[1], ga[2])),
             pa(neg(pm(al[2], ga[2])), neg(pm(be[2], ga[1]))))

    # Row 3: E1 * E2 == E3^2 re-substituted.
    u = pa(pm(al[0], al[1]), neg(pm(al[2], al[2])))
    v = pa(pa(pm(al[0], be[1]), pm(be[0], al[1])),
           neg(2.0 * pm(al[2], be[2])))
    w = pa(pm(be[0], be[1]), neg(pm(be[2], be[2])))
    f3y = pa(pa(pm(u, al[0]), pm(v, al[2])),
             pa(pm(w, al[1]),
                pa(pm(al[0], ga[1]), pa(pm(ga[0], al[1]),
                                        neg(2.0 * pm(al[2], ga[2]))))))
    f3z = pa(pa(pm(u, be[0]), pm(v, be[2])),
             pa(pm(w, be[1]),
                pa(pm(be[0], ga[1]), pa(pm(ga[0], be[1]),
                                        neg(2.0 * pm(be[2], ga[2]))))))
    f3c = pa(pa(pm(u, ga[0]), pm(v, ga[2])),
             pa(pm(w, ga[1]), pa(pm(ga[0], ga[1]), neg(pm(ga[2], ga[2])))))

    return (f1y, f1z, f1c), (f2y, f2z, f2c), (f3y, f3z, f3c)


def _det_poly(row1, row2, row3) -> jax.Array:
    """Degree-8 coefficient vector of det M(x) via cofactor expansion."""
    f1y, f1z, f1c = row1
    f2y, f2z, f2c = row2
    f3y, f3z, f3c = row3
    pm, pa = poly.polymul, poly.polyadd
    c = pa(pm(f1y, pa(pm(f2z, f3c), -pm(f2c, f3z))),
           pa(-pm(f1z, pa(pm(f2y, f3c), -pm(f2c, f3y))),
              pm(f1c, pa(pm(f2y, f3z), -pm(f2z, f3y)))))
    # Pad/truncate to exactly 9 coefficients (degree 8).
    n = c.shape[-1]
    if n < 9:
        c = jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, 9 - n)])
    return c[..., :9]


def _eval_rows(rows, x: jax.Array):
    """Evaluate the 3x3 polynomial matrix at root candidates x (..., R)."""
    out = []
    for r in rows:
        row = []
        for c in r:
            cb = jnp.broadcast_to(c[..., None, :], x.shape + (c.shape[-1],))
            row.append(poly.polyval(cb, x))
        out.append(row)
    return out  # 3x3 nested list of (..., R)


def _backsub_yz(rows_at_x):
    """Least-squares solve of M [y, z]^T = -M[:, 2] over the three rows."""
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = rows_at_x
    a11 = m00 * m00 + m10 * m10 + m20 * m20
    a12 = m00 * m01 + m10 * m11 + m20 * m21
    a22 = m01 * m01 + m11 * m11 + m21 * m21
    b1 = -(m00 * m02 + m10 * m12 + m20 * m22)
    b2 = -(m01 * m02 + m11 * m12 + m21 * m22)
    det = a11 * a22 - a12 * a12
    det = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    y = (a22 * b1 - a12 * b2) / det
    z = (a11 * b2 - a12 * b1) / det
    return y, z


def quadric_residuals(coeffs: jax.Array, sols: jax.Array) -> jax.Array:
    """Evaluate the three quadrics at solutions. (...,3,10),(...,R,3)->(...,R,3)."""
    x, y, z = sols[..., 0], sols[..., 1], sols[..., 2]
    mono = jnp.stack([x * x, x * y, x * z, y * y, y * z, z * z,
                      x, y, z, jnp.ones_like(x)], axis=-1)  # (..., R, 10)
    return jnp.einsum("...km,...rm->...rk", coeffs, mono)


def _newton_polish(coeffs: jax.Array, sols: jax.Array,
                   iters: int = NEWTON_POLISH_ITERS) -> jax.Array:
    """Damped Newton on the original quadrics; rescues fp32 root accuracy."""

    def body(_, s):
        x, y, z = s[..., 0], s[..., 1], s[..., 2]
        r = quadric_residuals(coeffs, s)  # (..., R, 3)
        c = coeffs[..., None, :, :]  # (..., 1, 3, 10)
        J = jnp.stack([
            2 * c[..., _X2] * x[..., None] + c[..., _XY] * y[..., None]
            + c[..., _XZ] * z[..., None] + c[..., _X],
            c[..., _XY] * x[..., None] + 2 * c[..., _Y2] * y[..., None]
            + c[..., _YZ] * z[..., None] + c[..., _Y],
            c[..., _XZ] * x[..., None] + c[..., _YZ] * y[..., None]
            + 2 * c[..., _Z2] * z[..., None] + c[..., _Z],
        ], axis=-1)  # (..., R, 3 eq, 3 var)
        # Damped solve: (J^T J + lambda I) step = J^T r
        JtJ = jnp.einsum("...ki,...kj->...ij", J, J)
        Jtr = jnp.einsum("...ki,...k->...i", J, r)
        lam = 1e-12 * jnp.trace(JtJ, axis1=-2, axis2=-1)[..., None, None]
        eye = jnp.eye(3, dtype=s.dtype)
        step = linalg.solve3(JtJ + lam * eye, Jtr)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        return s - step

    return jax.lax.fori_loop(0, iters, body, sols)


def solve_e3q3(
    coeffs: jax.Array,
    key: Optional[jax.Array] = None,
    imag_tol: float = 1e-4,
) -> Tuple[jax.Array, jax.Array]:
    """Solve a batch of 3Q3 systems.

    Args:
      coeffs: (..., 3, 10) quadric coefficients in the monomial order
        ``x^2, xy, xz, y^2, yz, z^2, x, y, z, 1``.
      key: optional PRNG key; enables the random affine change of variables
        for degenerate instances (mirrors ``re3q3.h:39-64``).
      imag_tol: relative imaginary-part tolerance for accepting a root as
        real.

    Returns:
      sols: (..., 8, 3) real solutions (garbage where ``valid`` is False).
      valid: (..., 8) bool mask.
    """
    dtype = coeffs.dtype
    batch_shape = coeffs.shape[:-2]

    # --- Degeneracy guard: random affine change of variables where all three
    # quadratic-block pivots are singular. -------------------------------
    dets = jnp.stack([_quad_block_det(coeffs, p) for p in _PERMS], axis=-1)
    degenerate = jnp.max(dets, axis=-1) < 1e-10

    if key is not None:
        from privacy_preserving_sfm_tpu.ops import lie

        kq, kt = jax.random.split(key)
        q = jax.random.normal(kq, (4,), dtype=dtype)
        q = q / jnp.linalg.norm(q)
        Arot = lie.quat_to_rotmat(q)
        avec = jax.random.normal(kt, (3,), dtype=dtype)
        avec = avec / jnp.linalg.norm(avec)
        B = _affine_change_matrix(Arot, avec, dtype)
        # mu(v) with v = A w + a equals B mu(w); coeffs.mu(v) = (coeffs B) mu(w)
        coeffs_tf = jnp.einsum("...km,mn->...kn", coeffs, B)
        coeffs = jnp.where(degenerate[..., None, None], coeffs_tf, coeffs)
        dets = jnp.stack([_quad_block_det(coeffs, p) for p in _PERMS], axis=-1)
    else:
        Arot = None
        avec = None

    pivot = jnp.argmax(dets, axis=-1)  # (...,)

    # --- Solve all three permutations, select by pivot (branch-free). ----
    all_sols = []
    all_valid = []
    for k, perm in enumerate(_PERMS):
        c = _permute_coeffs(coeffs, perm)
        A = jnp.stack([c[..., _Y2], c[..., _Z2], c[..., _YZ]], axis=-1)
        rhs = jnp.stack([c[..., _X2], c[..., _XY], c[..., _XZ],
                         c[..., _X], c[..., _Y], c[..., _Z], c[..., _1]],
                        axis=-1)  # (..., 3, 7)
        # Singular pivots produce garbage here but are masked out by
        # `pivot`; inv3's determinant floor keeps them finite.
        P = -jnp.einsum("...ij,...jk->...ik", linalg.inv3(A), rhs)

        rows = _build_M_polys(P)
        detp = _det_poly(*rows)
        # Scale-normalize the polynomial for root finding.
        scale = jnp.max(jnp.abs(detp), axis=-1, keepdims=True)
        detp_n = detp / jnp.maximum(scale, 1e-30)
        x, is_real = poly.real_roots(detp_n, imag_tol=imag_tol)

        rows_at_x = _eval_rows(rows, x)
        y, z = _backsub_yz(rows_at_x)
        sol = jnp.stack([x, y, z], axis=-1)  # (..., 8, 3) in permuted vars

        # Un-permute: original var perm[i] = new var i.
        inv = [0, 0, 0]
        for i, pi in enumerate(perm):
            inv[pi] = i
        sol = sol[..., jnp.asarray(inv)]
        all_sols.append(sol)
        all_valid.append(is_real)

    sols = jnp.stack(all_sols, axis=0)  # (3, ..., 8, 3)
    valids = jnp.stack(all_valid, axis=0)
    pivot_b = jnp.broadcast_to(pivot, batch_shape)
    take = pivot_b[None, ..., None, None]
    sols = jnp.take_along_axis(
        sols, jnp.broadcast_to(take, (1,) + batch_shape + (8, 3)), axis=0)[0]
    valid = jnp.take_along_axis(
        valids, jnp.broadcast_to(take[..., 0], (1,) + batch_shape + (8,)),
        axis=0)[0]

    # --- Newton polish on the (possibly transformed) quadrics. -----------
    sols = _newton_polish(coeffs, sols)

    # --- Undo the affine change of variables for degenerate instances. ---
    if key is not None:
        sols_tf = jnp.einsum("ij,...rj->...ri", Arot, sols) + avec
        sols = jnp.where(degenerate[..., None, None], sols_tf, sols)

    # Final validity: small residual on the *original* system is checked by
    # callers via quadric_residuals; here keep realness + finiteness.
    valid = valid & jnp.all(jnp.isfinite(sols), axis=-1)
    return sols, valid
