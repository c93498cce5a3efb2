"""Point-to-line bundle adjustment: implicit-Schur Levenberg-Marquardt.

Problem layout (SoA, fixed shapes, padded):

  cameras  C:  qvecs (C, 4), tvecs (C, 3), camera params (C, P) [constant],
               dof mask (C, 6) — 3 rotation-tangent + 3 translation dofs;
               gauge fixing = zeroed mask entries (reference holds pose 0
               fully constant and tvec[0] of pose 1,
               ``incremental_mapper.cc:921-926``).
  points   P:  points3d (P, 3), point mask (P,) (variable vs constant,
               ``bundle_adjustment.h:103-167`` semantics).
  obs      O:  camera index, point index, line (O, 3), weight (O,) — weight
               0 masks padding; the 2-vector pixel residual is the
               distort-both-points line cost (``cost_functions.h:62-100``).

Algorithm per LM iteration (all inside one jit, ``lax.while_loop``):

  1. residuals + Jacobians for every observation (forward-mode JVPs on the
     6-dof camera tangent and the 3-dof point),
  2. robust IRLS weights (Trivial / SoftL1 / Cauchy — the three losses of
     ``bundle_adjustment.h:51``),
  3. normal-equation blocks via ``segment_sum`` scatter: Hcc (C,6,6),
     Hpp (P,3,3), per-observation Hcp (O,6,3),
  4. eliminate points: implicit Schur matvec
     ``S v = (Hcc + lam D) v - E Hpp^{-1} E^T v`` evaluated with gathers +
     segment sums — S is never materialized,
  5. Schur-Jacobi preconditioned CG on the camera system, back-substitute
     point updates,
  6. accept/reject with trust-region-style lambda control.

This one kernel covers the reference's DENSE_SCHUR / SPARSE_SCHUR /
ITERATIVE_SCHUR(+SCHUR_JACOBI) regimes (``bundle_adjustment.cc:276-286``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import cameras as cam_ops
from privacy_preserving_sfm_tpu.ops import lie, linalg, lines as line_ops


class BAProblem(NamedTuple):
    qvecs: jax.Array  # (C, 4)
    tvecs: jax.Array  # (C, 3)
    cam_params: jax.Array  # (C, P) intrinsics, constant
    points3d: jax.Array  # (P, 3)
    obs_cam: jax.Array  # (O,) int32
    obs_point: jax.Array  # (O,) int32
    obs_line: jax.Array  # (O, 3) normalized lines
    obs_weight: jax.Array  # (O,) float, 0 = padding
    cam_dof_mask: jax.Array  # (C, 6) float, 0 = frozen dof
    point_mask: jax.Array  # (P,) float, 0 = constant point


class BAOptions(NamedTuple):
    max_iterations: int = 50  # ba_global_max_num_iterations default
    loss: str = "trivial"  # trivial | soft_l1 | cauchy
    loss_scale: float = 1.0
    cg_iterations: int = 30
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e10
    function_tolerance: float = 1e-8
    # Ceres-style termination on the max-abs gradient entry (the reference
    # runs its mapper BAs with function_tolerance=0 and gradient_tolerance
    # 10 (local) / 1 (global), controllers/incremental_mapper.cc:199-226 —
    # local bundles exit after a handful of LM iterations).  0 disables.
    gradient_tolerance: float = 0.0
    # Give up after this many consecutive rejected steps: each rejection
    # grows lambda 4x, so 8 rejections = damping x65k with no cost
    # decrease — the solve is at a (numerical) local minimum.  Without
    # this, an already-converged problem burns ~29 iterations waiting for
    # lambda to hit max_lambda (measured on the box-scene global BA).
    max_consecutive_rejections: int = 8
    # Dense-block solver only: camera-bin reduction strategy.  "onehot"
    # contracts (C, P*K) @ (P*K, n) (wastes a factor C of FLOPs in one
    # dense matmul); "gather" is the per-camera gather + masked sum;
    # "twolayout" rebuilds camera-sorted copies once per LM iteration.
    cam_reduce: str = "onehot"
    # Dense-block solver only: how to solve the reduced camera system.
    #   "implicit" — matrix-free CG (S never materialized); the scalable
    #     path, mirrors Ceres ITERATIVE_SCHUR.
    #   "explicit" — materialize S (6C, 6C) with one Gram matmul and run
    #     the PCG as dense matvecs (``optim/schur_pcg.py``); the
    #     DENSE_SCHUR regime, a handful of kernel launches per CG step
    #     instead of ~15.
    #   "auto" — explicit on the GPU when ``schur_pcg.explicit_fits``,
    #     else implicit (the reference's size-based solver switch,
    #     ``bundle_adjustment.cc:276-286``).
    schur_mode: str = "auto"
    # Explicit mode only: operand precision of the S_corr Gram matmul
    # (the dominant one, (3P, 6C)^T @ (3P, 6C)).
    #   "f32"  — full f32 (``Precision.HIGHEST``, no TF32 rounding).
    #   "bf16" — bfloat16 operands with f32 accumulation.  S keeps ~3
    #     significant digits per entry; inside a damped LM trust region
    #     the resulting step is a descent direction long before it is an
    #     exact Newton step (tests/test_schur_explicit.py).
    schur_precision: str = "f32"
    # Intrinsics refinement (reference BundleAdjustmentOptions.refine_*,
    # bundle_adjustment.cc:490-528; all default OFF — known calibration).
    # When any is set the mapper routes the solve through
    # optim/ba_intrinsics.py (projectively corrected lifted lines) and
    # bakes the converged correction back into the stored lines.
    refine_focal_length: bool = False
    refine_principal_point: bool = False
    refine_extra_params: bool = False


class DynamicBAOptions(NamedTuple):
    """The per-solve knobs the mapper varies between BA calls, as TRACED
    scalars: strict-small-model tolerances, local/global iteration caps
    and the soft_l1->trivial loss schedule all ride ONE compiled LM
    kernel per problem shape instead of one per option set (each new
    (shape, options) key costs a trace plus a compile or compile-cache
    load).  Structural knobs (cg_iterations, cam_reduce, schur_mode) stay
    static in BAOptions."""

    loss_code: jax.Array  # i32: 0 trivial / 1 soft_l1 / 2 cauchy
    loss_scale: jax.Array
    gradient_tolerance: jax.Array  # <= 0 disables
    function_tolerance: jax.Array
    initial_lambda: jax.Array
    max_iterations: jax.Array  # i32

    @staticmethod
    def from_options(options: "BAOptions") -> "DynamicBAOptions":
        code = {"trivial": 0, "soft_l1": 1, "cauchy": 2}[options.loss]
        return DynamicBAOptions(
            loss_code=jnp.asarray(code, jnp.int32),
            loss_scale=jnp.asarray(options.loss_scale, jnp.float32),
            gradient_tolerance=jnp.asarray(options.gradient_tolerance,
                                           jnp.float32),
            function_tolerance=jnp.asarray(options.function_tolerance,
                                           jnp.float32),
            initial_lambda=jnp.asarray(options.initial_lambda, jnp.float32),
            max_iterations=jnp.asarray(options.max_iterations, jnp.int32))

    @staticmethod
    def strip(options: "BAOptions") -> "BAOptions":
        """The static residue used as the compile key: every field that
        moved into DynamicBAOptions is canonicalized away."""
        return options._replace(
            loss="trivial", loss_scale=1.0, gradient_tolerance=0.0,
            function_tolerance=0.0, initial_lambda=1e-4, max_iterations=0)


class BASummary(NamedTuple):
    initial_cost: jax.Array
    final_cost: jax.Array
    num_iterations: jax.Array
    lam: jax.Array


def _robust_weight(sq_norm: jax.Array, loss: str, scale: float) -> jax.Array:
    """IRLS weight rho'(s) for squared residual norm s."""
    if loss == "trivial":
        return jnp.ones_like(sq_norm)
    s = sq_norm / (scale * scale)
    if loss == "soft_l1":
        return 1.0 / jnp.sqrt(1.0 + s)
    if loss == "cauchy":
        return 1.0 / (1.0 + s)
    raise ValueError(f"unknown loss {loss}")


def _robust_weight_dyn(sq_norm: jax.Array, code: jax.Array,
                       scale: jax.Array) -> jax.Array:
    """IRLS weight with a TRACED loss selector (0 trivial / 1 soft_l1 /
    2 cauchy): computing all three branches is elementwise-cheap and one
    compiled kernel then serves every loss variant (the mapper alternates
    soft_l1/trivial between refinement rounds — a static loss string
    would double the compile-key count)."""
    s = sq_norm / (scale * scale)
    w_soft = 1.0 / jnp.sqrt(1.0 + s)
    w_cauchy = 1.0 / (1.0 + s)
    return jnp.where(code == 0, jnp.ones_like(sq_norm),
                     jnp.where(code == 1, w_soft, w_cauchy))


def _robust_cost_dyn(sq_norm: jax.Array, code: jax.Array,
                     scale: jax.Array) -> jax.Array:
    b = scale * scale
    s = sq_norm / b
    c_soft = 2.0 * b * (jnp.sqrt(1.0 + s) - 1.0)
    c_cauchy = b * jnp.log1p(s)
    return jnp.where(code == 0, sq_norm,
                     jnp.where(code == 1, c_soft, c_cauchy))


def _robust_cost(sq_norm: jax.Array, loss: str, scale: float) -> jax.Array:
    """rho(s): the robustified cost of a squared residual norm."""
    if loss == "trivial":
        return sq_norm
    b = scale * scale
    s = sq_norm / b
    if loss == "soft_l1":
        return 2.0 * b * (jnp.sqrt(1.0 + s) - 1.0)
    if loss == "cauchy":
        return b * jnp.log1p(s)
    raise ValueError(f"unknown loss {loss}")


def _quat_delta(dq: jax.Array) -> jax.Array:
    """Smooth quaternion increment (1, dq/2)/sqrt(1+|dq/2|^2), batched."""
    half = dq / 2.0
    w = jnp.ones(dq.shape[:-1] + (1,), dq.dtype)
    q = jnp.concatenate([w, half], axis=-1)
    return q / jnp.sqrt(1.0 + jnp.sum(half * half, axis=-1, keepdims=True))


def _apply_step(qvecs, tvecs, points, dc, dp):
    """Apply camera tangent steps (C, 6) and point steps (P, 3)."""
    q_new = lie.quat_normalize(
        lie.quat_multiply(qvecs, _quat_delta(dc[:, :3])))
    return q_new, tvecs + dc[:, 3:], points + dp


def _residuals_and_jacobians(problem: BAProblem, qvecs, tvecs, points,
                             camera_model: str):
    """Per-observation residual (O, 2), J_cam (O, 2, 6), J_pt (O, 2, 3)."""
    oc, op = problem.obs_cam, problem.obs_point
    q_o = qvecs[oc]
    t_o = tvecs[oc]
    X_o = points[op]
    par_o = problem.cam_params[oc]
    lines_o = problem.obs_line

    def res_fn(dc, dX, q, t, X, par, line):
        qq = lie.quat_multiply(q, _quat_delta(dc[:3]))
        tt = t + dc[3:]
        return line_ops.line_ba_residual(line, X + dX, qq, tt, camera_model,
                                         par)

    zero6 = jnp.zeros(q_o.shape[:-1] + (6,), qvecs.dtype)
    zero3 = jnp.zeros(X_o.shape, qvecs.dtype)

    def one(dc, dX, q, t, X, par, line):
        r = res_fn(dc, dX, q, t, X, par, line)
        Jc = jax.jacfwd(res_fn, argnums=0)(dc, dX, q, t, X, par, line)
        Jp = jax.jacfwd(res_fn, argnums=1)(dc, dX, q, t, X, par, line)
        return r, Jc, Jp

    r, Jc, Jp = jax.vmap(one)(zero6, zero3, q_o, t_o, X_o, par_o, lines_o)
    # Freeze masked dofs.
    Jc = Jc * problem.cam_dof_mask[oc][:, None, :]
    Jp = Jp * problem.point_mask[op][:, None, None]
    return r, Jc, Jp


def _cost(problem: BAProblem, qvecs, tvecs, points, camera_model: str,
          loss: str, loss_scale: float) -> jax.Array:
    oc, op = problem.obs_cam, problem.obs_point
    r = line_ops.line_ba_residual(
        problem.obs_line, points[op], qvecs[oc], tvecs[oc], camera_model,
        problem.cam_params[oc])
    sq = jnp.sum(r * r, axis=-1)
    return 0.5 * jnp.sum(_robust_cost(sq, loss, loss_scale)
                         * problem.obs_weight)


def bundle_adjust(problem: BAProblem, camera_model: str,
                  options: BAOptions = BAOptions()):
    """Run LM bundle adjustment; returns (qvecs, tvecs, points3d, summary)."""
    C = problem.qvecs.shape[0]
    P = problem.points3d.shape[0]
    dtype = problem.points3d.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)

    def build_normal(qvecs, tvecs, points):
        r, Jc, Jp = _residuals_and_jacobians(problem, qvecs, tvecs, points,
                                             camera_model)
        sq = jnp.sum(r * r, axis=-1)
        w = (_robust_weight(sq, options.loss, options.loss_scale)
             * problem.obs_weight)  # (O,)
        Hcc_o = jnp.einsum("ori,orj,o->oij", Jc, Jc, w)
        Hpp_o = jnp.einsum("ori,orj,o->oij", Jp, Jp, w)
        Hcp_o = jnp.einsum("ori,orj,o->oij", Jc, Jp, w)  # (O, 6, 3)
        gc_o = jnp.einsum("ori,or,o->oi", Jc, r, w)
        gp_o = jnp.einsum("ori,or,o->oi", Jp, r, w)
        Hcc = jax.ops.segment_sum(Hcc_o, problem.obs_cam, C)
        Hpp = jax.ops.segment_sum(Hpp_o, problem.obs_point, P)
        gc = jax.ops.segment_sum(gc_o, problem.obs_cam, C)
        gp = jax.ops.segment_sum(gp_o, problem.obs_point, P)
        return Hcc, Hpp, Hcp_o, gc, gp

    def solve_step(Hcc, Hpp, Hcp_o, gc, gp, lam):
        """One damped Schur/CG solve; returns (dc, dp) DESCENT steps."""
        # LM damping: lambda * diag(H) (Ceres-style scaling), floored.
        dHcc = Hcc + lam * _diag_embed6(jnp.diagonal(Hcc, axis1=-2, axis2=-1)) \
            + 1e-12 * eye6
        dHpp = Hpp + lam * _diag_embed3(jnp.diagonal(Hpp, axis1=-2, axis2=-1)) \
            + 1e-12 * eye3
        Hpp_inv = linalg.inv3(dHpp)  # (P, 3, 3)

        oc, op = problem.obs_cam, problem.obs_point

        def S_matvec(v):  # v: (C, 6)
            Bv = jnp.einsum("cij,cj->ci", dHcc, v)
            Etv_o = jnp.einsum("oji,oj->oi", Hcp_o, v[oc])  # (O, 3)
            Etv = jax.ops.segment_sum(Etv_o, op, P)  # (P, 3)
            y = jnp.einsum("pij,pj->pi", Hpp_inv, Etv)  # (P, 3)
            Ey_o = jnp.einsum("oij,oj->oi", Hcp_o, y[op])  # (O, 6)
            Ey = jax.ops.segment_sum(Ey_o, oc, C)
            return Bv - Ey

        # RHS: g_c - E Hpp^{-1} g_p.
        y0 = jnp.einsum("pij,pj->pi", Hpp_inv, gp)
        rhs = gc - jax.ops.segment_sum(
            jnp.einsum("oij,oj->oi", Hcp_o, y0[op]), oc, C)

        # Schur-Jacobi preconditioner: block-diagonal of S.
        SJ_o = jnp.einsum("oij,ojk,olk->oil", Hcp_o, Hpp_inv[op], Hcp_o)
        SJ = dHcc - jax.ops.segment_sum(SJ_o, oc, C)  # (C, 6, 6)
        SJ_inv = _inv6(SJ + 1e-12 * eye6)

        def precond(v):
            return jnp.einsum("cij,cj->ci", SJ_inv, v)

        # Preconditioned CG on S dc = rhs.
        def cg_body(i, state):
            x, rr, p, rz = state
            Ap = S_matvec(p)
            pAp = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
            p = z + beta * p
            return x, rr, p, rz_new

        x0 = jnp.zeros((C, 6), dtype)
        z0 = precond(rhs)
        state = (x0, rhs, z0, jnp.sum(rhs * z0))
        dc, _, _, _ = jax.lax.fori_loop(0, options.cg_iterations, cg_body,
                                        state)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)

        # Back-substitute points: dp = Hpp^{-1} (gp - E^T dc).
        Etdc = jax.ops.segment_sum(
            jnp.einsum("oji,oj->oi", Hcp_o, dc[oc]), op, P)
        dp = jnp.einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
        return dc, dp

    cost0 = _cost(problem, problem.qvecs, problem.tvecs, problem.points3d,
                  camera_model, options.loss, options.loss_scale)

    def lm_body(state):
        (qvecs, tvecs, points, lam, cost, it, stall, rebuild, rej,
         normal) = state
        # Re-linearize only after an accepted step; a rejected step reuses
        # the cached normal equations with a larger lambda (Ceres keeps the
        # Jacobian across unsuccessful trust-region iterations).
        normal = jax.lax.cond(
            rebuild,
            lambda args: build_normal(*args),
            lambda args: normal,
            (qvecs, tvecs, points))
        Hcc, Hpp, Hcp_o, gc, gp = normal
        if options.gradient_tolerance > 0:
            g_max = jnp.maximum(
                jnp.max(jnp.abs(gc * problem.cam_dof_mask)),
                jnp.max(jnp.abs(gp * problem.point_mask[:, None])))
            grad_done = g_max <= options.gradient_tolerance
        else:
            grad_done = jnp.asarray(False)
        dc, dp = solve_step(Hcc, Hpp, Hcp_o, gc, gp, lam)
        # Descent direction: parameters move by -d.
        dc_m = dc * problem.cam_dof_mask
        dp_m = dp * problem.point_mask[:, None]
        q_new, t_new, X_new = _apply_step(qvecs, tvecs, points, -dc_m, -dp_m)
        cost_new = _cost(problem, q_new, t_new, X_new, camera_model,
                         options.loss, options.loss_scale)
        accept = cost_new < cost
        rel_decrease = (cost - cost_new) / jnp.maximum(cost, 1e-30)
        qvecs = jnp.where(accept, q_new, qvecs)
        tvecs = jnp.where(accept, t_new, tvecs)
        points = jnp.where(accept, X_new, points)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, options.min_lambda),
                        jnp.minimum(lam * 4.0, options.max_lambda))
        converged = accept & (rel_decrease < options.function_tolerance)
        stall = jnp.where(converged, stall + 1, jnp.where(accept, 0, stall))
        stall = jnp.where(grad_done, 2, stall)
        rej = jnp.where(accept, 0, rej + 1)
        stall = jnp.where(rej >= options.max_consecutive_rejections, 2,
                          stall)
        return (qvecs, tvecs, points, lam, cost, it + 1, stall, accept,
                rej, normal)

    def lm_cond(state):
        lam, cost, it, stall = state[3], state[4], state[5], state[6]
        return (it < options.max_iterations) & (stall < 2) & (
            lam < options.max_lambda * 0.99)

    normal0 = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(build_normal, problem.qvecs, problem.tvecs,
                       problem.points3d))
    init = (problem.qvecs, problem.tvecs, problem.points3d,
            jnp.asarray(options.initial_lambda, dtype), cost0,
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(True), jnp.asarray(0, jnp.int32), normal0)
    qvecs, tvecs, points, lam, cost, it = jax.lax.while_loop(
        lm_cond, lm_body, init)[:6]

    summary = BASummary(initial_cost=cost0, final_cost=cost,
                        num_iterations=it, lam=lam)
    return qvecs, tvecs, points, summary


def _diag_embed3(d: jax.Array) -> jax.Array:
    out = jnp.zeros(d.shape[:-1] + (3, 3), d.dtype)
    for i in range(3):
        out = out.at[..., i, i].set(d[..., i])
    return out


def _diag_embed6(d: jax.Array) -> jax.Array:
    out = jnp.zeros(d.shape[:-1] + (6, 6), d.dtype)
    for i in range(6):
        out = out.at[..., i, i].set(d[..., i])
    return out


def _inv6(A: jax.Array) -> jax.Array:
    """Blockwise 6x6 inverse via 3x3 Schur complement (closed forms only)."""
    A11 = A[..., :3, :3]
    A12 = A[..., :3, 3:]
    A21 = A[..., 3:, :3]
    A22 = A[..., 3:, 3:]
    A11i = linalg.inv3(A11)
    S = A22 - jnp.einsum("...ij,...jk,...kl->...il", A21, A11i, A12)
    Si = linalg.inv3(S)
    B11 = A11i + jnp.einsum("...ij,...jk,...kl,...lm,...mn->...in",
                            A11i, A12, Si, A21, A11i)
    B12 = -jnp.einsum("...ij,...jk,...kl->...il", A11i, A12, Si)
    B21 = -jnp.einsum("...ij,...jk,...kl->...il", Si, A21, A11i)
    top = jnp.concatenate([B11, B12], axis=-1)
    bot = jnp.concatenate([B21, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
