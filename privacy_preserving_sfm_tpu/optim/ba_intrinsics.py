"""Bundle adjustment with variable intrinsics (focal / principal / extra).

Replaces the reference's camera-subset parametrization
(``/root/reference/src/optim/bundle_adjustment.cc:490-528``): when any of
``refine_focal_length`` / ``refine_principal_point`` /
``refine_extra_params`` is enabled, the shared camera parameter vectors
join the Schur "camera side" of the reduced system.  Off by default, like
the reference (known calibration).

**Lifted-line subtlety** (why the reference fork hard-disables this): the
privacy lift bakes the calibration into the stored lines — they live in
the normalized plane of the LIFT-TIME intrinsics, and the point-to-line
constraint itself never touches camera parameters (only the
distort-both-points error metric does).  Naively refining focal in this
representation is degenerate: shrinking f scales every pixel residual
down without changing the constraint.  The well-posed formulation used
here: a focal / principal-point change is an affinity of the normalized
plane, under which lifted lines transform projectively,

    l' ∝ (a fx'/f0x,  b fy'/f0y,
          c - a (cx0 - cx')/f0x - b (cy0 - cy')/f0y),

so the residual differentiates through the CORRECTED line (the geometric
constraint moves with the intrinsics) while the metric uses the updated
parameters.  Distortion (extra) parameters are NOT an affinity of the
normalized plane and cannot be corrected post-lift; ``refine_extra``
only adjusts the error metric and is near-degenerate — kept for parity
but discouraged.  On convergence the caller bakes the correction into
the stored lines (``correct_lines``) so the model stays consistent.

Design: intrinsics live per UNIQUE camera (U of them; many image slots can
share one camera, reference semantics where Ceres shares the params block).
The camera-side variable of the Schur system becomes

    v = (vc (C, 6) pose tangents, vu (U, Pr) intrinsics tangents)

and the implicit-Schur CG of ``optim/ba.py`` extends with the
pose-intrinsics / intrinsics-point coupling blocks; all reductions stay
``segment_sum`` over observation tables.  This path is the rare
uncalibrated regime, so it reuses the flat SoA layout (the dense-block and
SoA explicit-Schur solvers keep the constant-intrinsics fast path).

The per-parameter mask (U, Pr) is built from the model's
focal/principal/extra index groups (``ops/cameras.MODELS``), mirroring
``Camera::FocalLengthIdxs``-based subset parametrization.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.ops import cameras as cam_ops
from privacy_preserving_sfm_tpu.ops import lie, linalg, lines as line_ops
from privacy_preserving_sfm_tpu.optim import ba as ba_mod


class IntrBAProblem(NamedTuple):
    base: ba_mod.BAProblem  # cam_params field is ignored (see intr_params)
    cam_of_slot: jax.Array  # (C,) int32 image slot -> unique camera index
    intr_params: jax.Array  # (U, Pr) current estimate (starting point)
    intr_mask: jax.Array  # (U, Pr) float, 0 = frozen parameter
    lift_params: jax.Array  # (U, Pr) intrinsics the lines were lifted with


def corrected_line(line, lift_par, par, model: str, xp=jnp):
    """Transform a lifted line to the normalized plane of ``par``.

    line (..., 3) with ||(a, b)|| = 1, lifted under ``lift_par``; returns
    the line of the same pixel measurement under intrinsics ``par``,
    renormalized.  Only focal/principal changes are representable (see
    module docstring).
    """
    spec = cam_ops.MODELS[model]
    f0x, f0y, c0x, c0y, _ = cam_ops._split_params(spec, lift_par, xp)
    fx, fy, cx, cy, _ = cam_ops._split_params(spec, par, xp)
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    a2 = a * fx / f0x
    b2 = b * fy / f0y
    c2 = c - a * (c0x - cx) / f0x - b * (c0y - cy) / f0y
    norm = xp.sqrt(a2 * a2 + b2 * b2)
    norm = xp.maximum(norm, 1e-12)
    return xp.stack([a2 / norm, b2 / norm, c2 / norm], axis=-1)


def correct_lines(lines: np.ndarray, lift_par: np.ndarray, par: np.ndarray,
                  model: str) -> np.ndarray:
    """Bake a converged intrinsics correction into stored lines (host)."""
    return np.asarray(corrected_line(np.asarray(lines), lift_par, par,
                                     model, xp=np))


def intr_mask_for_model(model: str, refine_focal: bool, refine_principal: bool,
                        refine_extra: bool) -> np.ndarray:
    """(Pr,) 0/1 mask of variable parameters for one camera.

    Mirrors ``BundleAdjuster::ParameterizeCameras``'s subset selection.
    """
    spec = cam_ops.MODELS[model]
    mask = np.zeros(spec.num_params)
    if refine_focal:
        mask[list(spec.focal_idxs)] = 1.0
    if refine_principal:
        mask[list(spec.principal_idxs)] = 1.0
    if refine_extra:
        mask[list(spec.extra_idxs)] = 1.0
    return mask


def _inv_small(A: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Batched (..., n, n) inverse for small static n via pivoted solves."""
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    Ad = A + eps * eye
    cols = jax.vmap(lambda b: linalg.solve_gauss(Ad, b),
                    in_axes=-1, out_axes=-1)(
        jnp.broadcast_to(eye, A.shape))
    return cols


def _residuals_and_jacobians(problem: IntrBAProblem, qvecs, tvecs, points,
                             intr, camera_model: str):
    """r (O, 2), J_cam (O, 2, 6), J_pt (O, 2, 3), J_intr (O, 2, Pr)."""
    base = problem.base
    oc, op = base.obs_cam, base.obs_point
    ou = problem.cam_of_slot[oc]  # (O,) unique-camera index
    q_o = qvecs[oc]
    t_o = tvecs[oc]
    X_o = points[op]
    par_o = intr[ou]
    par0_o = problem.lift_params[ou]
    lines_o = base.obs_line

    def res_fn(dc, dX, dpar, q, t, X, par, par0, line):
        qq = lie.quat_multiply(q, ba_mod._quat_delta(dc[:3]))
        tt = t + dc[3:]
        pnew = par + dpar
        lcorr = corrected_line(line, par0, pnew, camera_model)
        return line_ops.line_ba_residual(lcorr, X + dX, qq, tt,
                                         camera_model, pnew)

    def one(q, t, X, par, par0, line):
        zero6 = jnp.zeros(6, qvecs.dtype)
        zero3 = jnp.zeros(3, qvecs.dtype)
        zerop = jnp.zeros(par.shape, qvecs.dtype)
        r = res_fn(zero6, zero3, zerop, q, t, X, par, par0, line)
        Jc = jax.jacfwd(res_fn, argnums=0)(zero6, zero3, zerop, q, t, X,
                                           par, par0, line)
        Jp = jax.jacfwd(res_fn, argnums=1)(zero6, zero3, zerop, q, t, X,
                                           par, par0, line)
        Ji = jax.jacfwd(res_fn, argnums=2)(zero6, zero3, zerop, q, t, X,
                                           par, par0, line)
        return r, Jc, Jp, Ji

    r, Jc, Jp, Ji = jax.vmap(one)(q_o, t_o, X_o, par_o, par0_o, lines_o)
    Jc = Jc * base.cam_dof_mask[oc][:, None, :]
    Jp = Jp * base.point_mask[op][:, None, None]
    Ji = Ji * problem.intr_mask[ou][:, None, :]
    return r, Jc, Jp, Ji


def _cost(problem: IntrBAProblem, qvecs, tvecs, points, intr,
          camera_model: str, loss: str, loss_scale: float) -> jax.Array:
    base = problem.base
    oc, op = base.obs_cam, base.obs_point
    ou = problem.cam_of_slot[oc]
    lcorr = corrected_line(base.obs_line, problem.lift_params[ou],
                           intr[ou], camera_model)
    r = line_ops.line_ba_residual(
        lcorr, points[op], qvecs[oc], tvecs[oc], camera_model, intr[ou])
    sq = jnp.sum(r * r, axis=-1)
    return 0.5 * jnp.sum(ba_mod._robust_cost(sq, loss, loss_scale)
                         * base.obs_weight)


def bundle_adjust_intrinsics(problem: IntrBAProblem, camera_model: str,
                             options: ba_mod.BAOptions = ba_mod.BAOptions()):
    """LM with variable intrinsics; returns (q, t, X, intr, summary)."""
    base = problem.base
    C = base.qvecs.shape[0]
    P = base.points3d.shape[0]
    U, Pr = problem.intr_params.shape
    dtype = base.points3d.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    eyep = jnp.eye(Pr, dtype=dtype)
    oc, op = base.obs_cam, base.obs_point
    ou = problem.cam_of_slot[oc]

    def build_normal(qvecs, tvecs, points, intr):
        r, Jc, Jp, Ji = _residuals_and_jacobians(
            problem, qvecs, tvecs, points, intr, camera_model)
        sq = jnp.sum(r * r, axis=-1)
        w = (ba_mod._robust_weight(sq, options.loss, options.loss_scale)
             * base.obs_weight)
        Hcc = jax.ops.segment_sum(
            jnp.einsum("ori,orj,o->oij", Jc, Jc, w), oc, C)
        Hii = jax.ops.segment_sum(
            jnp.einsum("ori,orj,o->oij", Ji, Ji, w), ou, U)
        Hpp = jax.ops.segment_sum(
            jnp.einsum("ori,orj,o->oij", Jp, Jp, w), op, P)
        Hci_o = jnp.einsum("ori,orj,o->oij", Jc, Ji, w)  # (O, 6, Pr)
        Hcp_o = jnp.einsum("ori,orj,o->oij", Jc, Jp, w)  # (O, 6, 3)
        Hip_o = jnp.einsum("ori,orj,o->oij", Ji, Jp, w)  # (O, Pr, 3)
        gc = jax.ops.segment_sum(jnp.einsum("ori,or,o->oi", Jc, r, w), oc, C)
        gi = jax.ops.segment_sum(jnp.einsum("ori,or,o->oi", Ji, r, w), ou, U)
        gp = jax.ops.segment_sum(jnp.einsum("ori,or,o->oi", Jp, r, w), op, P)
        return Hcc, Hii, Hpp, Hci_o, Hcp_o, Hip_o, gc, gi, gp

    def solve_step(normal, lam):
        Hcc, Hii, Hpp, Hci_o, Hcp_o, Hip_o, gc, gi, gp = normal
        dHcc = Hcc + lam * ba_mod._diag_embed6(
            jnp.diagonal(Hcc, axis1=-2, axis2=-1)) + 1e-12 * eye6
        dHii = Hii + lam * jnp.einsum(
            "ij,uj->uij", eyep, jnp.diagonal(Hii, axis1=-2, axis2=-1)) \
            + 1e-12 * eyep
        dHpp = Hpp + lam * ba_mod._diag_embed3(
            jnp.diagonal(Hpp, axis1=-2, axis2=-1)) + 1e-12 * eye3
        Hpp_inv = linalg.inv3(dHpp)

        def S_matvec(v):
            vc, vu = v
            # Camera-side block product (pose & intrinsics coupling).
            Bc = jnp.einsum("cij,cj->ci", dHcc, vc) \
                + jax.ops.segment_sum(
                    jnp.einsum("oij,oj->oi", Hci_o, vu[ou]), oc, C)
            Bu = jnp.einsum("uij,uj->ui", dHii, vu) \
                + jax.ops.segment_sum(
                    jnp.einsum("oji,oj->oi", Hci_o, vc[oc]), ou, U)
            # Point elimination: E^T v, y = Hpp^-1 E^T v, E y.
            Etv = jax.ops.segment_sum(
                jnp.einsum("oji,oj->oi", Hcp_o, vc[oc])
                + jnp.einsum("oji,oj->oi", Hip_o, vu[ou]), op, P)
            y = jnp.einsum("pij,pj->pi", Hpp_inv, Etv)
            Eyc = jax.ops.segment_sum(
                jnp.einsum("oij,oj->oi", Hcp_o, y[op]), oc, C)
            Eyu = jax.ops.segment_sum(
                jnp.einsum("oij,oj->oi", Hip_o, y[op]), ou, U)
            return Bc - Eyc, Bu - Eyu

        y0 = jnp.einsum("pij,pj->pi", Hpp_inv, gp)
        rhs_c = gc - jax.ops.segment_sum(
            jnp.einsum("oij,oj->oi", Hcp_o, y0[op]), oc, C)
        rhs_u = gi - jax.ops.segment_sum(
            jnp.einsum("oij,oj->oi", Hip_o, y0[op]), ou, U)

        # Block-Jacobi preconditioner on both camera-side block types.
        SJc = dHcc - jax.ops.segment_sum(
            jnp.einsum("oij,ojk,olk->oil", Hcp_o, Hpp_inv[op], Hcp_o),
            oc, C)
        SJu = dHii - jax.ops.segment_sum(
            jnp.einsum("oij,ojk,olk->oil", Hip_o, Hpp_inv[op], Hip_o),
            ou, U)
        SJc_inv = ba_mod._inv6(SJc + 1e-12 * eye6)
        SJu_inv = _inv_small(SJu + 1e-12 * eyep)

        def precond(v):
            vc, vu = v
            return (jnp.einsum("cij,cj->ci", SJc_inv, vc),
                    jnp.einsum("uij,uj->ui", SJu_inv, vu))

        def dot(a, b):
            return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

        def cg_body(i, state):
            x, rr, p, rz = state
            Ap = S_matvec(p)
            pAp = dot(p, Ap)
            alpha = rz / jnp.where(jnp.abs(pAp) < 1e-30, 1e-30, pAp)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
            z = precond(rr)
            rz_new = dot(rr, z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
            return x, rr, (z[0] + beta * p[0], z[1] + beta * p[1]), rz_new

        x0 = (jnp.zeros((C, 6), dtype), jnp.zeros((U, Pr), dtype))
        rhs = (rhs_c, rhs_u)
        z0 = precond(rhs)
        (dc, du), _, _, _ = jax.lax.fori_loop(
            0, options.cg_iterations, cg_body, (x0, rhs, z0, dot(rhs, z0)))
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        du = jnp.where(jnp.isfinite(du), du, 0.0)

        Etdc = jax.ops.segment_sum(
            jnp.einsum("oji,oj->oi", Hcp_o, dc[oc])
            + jnp.einsum("oji,oj->oi", Hip_o, du[ou]), op, P)
        dp = jnp.einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
        return dc, du, dp

    cost0 = _cost(problem, base.qvecs, base.tvecs, base.points3d,
                  problem.intr_params, camera_model, options.loss,
                  options.loss_scale)

    def lm_body(state):
        (qvecs, tvecs, points, intr, lam, cost, it, stall, rebuild, rej,
         normal) = state
        normal = jax.lax.cond(
            rebuild,
            lambda args: build_normal(*args),
            lambda args: normal,
            (qvecs, tvecs, points, intr))
        gc, gi, gp = normal[6], normal[7], normal[8]
        if options.gradient_tolerance > 0:
            g_max = jnp.maximum(
                jnp.max(jnp.abs(gc * base.cam_dof_mask)),
                jnp.max(jnp.abs(gp * base.point_mask[:, None])))
            g_max = jnp.maximum(
                g_max, jnp.max(jnp.abs(gi * problem.intr_mask)))
            grad_done = g_max <= options.gradient_tolerance
        else:
            grad_done = jnp.asarray(False)
        dc, du, dp = solve_step(normal, lam)
        dc_m = dc * base.cam_dof_mask
        du_m = du * problem.intr_mask
        dp_m = dp * base.point_mask[:, None]
        q_new, t_new, X_new = ba_mod._apply_step(qvecs, tvecs, points,
                                                 -dc_m, -dp_m)
        i_new = intr - du_m
        cost_new = _cost(problem, q_new, t_new, X_new, i_new, camera_model,
                         options.loss, options.loss_scale)
        accept = cost_new < cost
        rel = (cost - cost_new) / jnp.maximum(cost, 1e-30)
        qvecs = jnp.where(accept, q_new, qvecs)
        tvecs = jnp.where(accept, t_new, tvecs)
        points = jnp.where(accept, X_new, points)
        intr = jnp.where(accept, i_new, intr)
        cost = jnp.where(accept, cost_new, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, options.min_lambda),
                        jnp.minimum(lam * 4.0, options.max_lambda))
        conv = accept & (rel < options.function_tolerance)
        stall = jnp.where(conv, stall + 1, jnp.where(accept, 0, stall))
        stall = jnp.where(grad_done, 2, stall)
        rej = jnp.where(accept, 0, rej + 1)
        stall = jnp.where(rej >= options.max_consecutive_rejections, 2,
                          stall)
        return (qvecs, tvecs, points, intr, lam, cost, it + 1, stall,
                accept, rej, normal)

    def lm_cond(state):
        lam, cost, it, stall = state[4], state[5], state[6], state[7]
        return (it < options.max_iterations) & (stall < 2) & (
            lam < options.max_lambda * 0.99)

    normal0 = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(build_normal, base.qvecs, base.tvecs, base.points3d,
                       problem.intr_params))
    init = (base.qvecs, base.tvecs, base.points3d, problem.intr_params,
            jnp.asarray(options.initial_lambda, dtype), cost0,
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(True), jnp.asarray(0, jnp.int32), normal0)
    q, t, X, intr, lam, cost, it = jax.lax.while_loop(
        lm_cond, lm_body, init)[:7]
    summary = ba_mod.BASummary(initial_cost=cost0, final_cost=cost,
                               num_iterations=it, lam=lam)
    return q, t, X, intr, summary
