"""Dense-block bundle adjustment: observations laid out per point.

The flat-SoA solver (``optim/ba.py``) reduces point blocks with
``segment_sum`` scatters into P bins (atomic scatter-adds on the GPU).
Here observations are laid out **densely per point**:

  cam_idx (P, K), lines (P, K, 3), weight (P, K)   with K = max track len

so every point-side reduction (Hpp, E^T v, back-substitution) becomes an
einsum over the K axis — dense work, no scatter.  The only
remaining scatters reduce into the C camera bins (C is small).  This is
the CSR-of-blocks design of SURVEY.md §7.6.

Every contraction runs at ``Precision.HIGHEST`` (``_einsum``): the GPU's
default f32 matmul may round operands to TF32, which would cap the
normal equations at about three decimal digits.

Semantically identical to ``ba.bundle_adjust`` (same damping, CG,
accept/reject); tested for agreement.  ``from_flat_problem`` converts a
``ba.BAProblem``; tracks longer than K keep their K strongest... no —
tracks are padded to K and K must cover the longest track (the caller
buckets K).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.ops import lie, linalg, lines as line_ops
from privacy_preserving_sfm_tpu.optim import ba as ba_mod
from privacy_preserving_sfm_tpu.optim import schur_pcg
from privacy_preserving_sfm_tpu.utils.jax_setup import accelerator

HIGHEST = jax.lax.Precision.HIGHEST


def _einsum(*args):
    return jnp.einsum(*args, precision=HIGHEST)


class DenseBAProblem(NamedTuple):
    qvecs: jax.Array  # (C, 4)
    tvecs: jax.Array  # (C, 3)
    cam_params: jax.Array  # (C, Pr)
    points3d: jax.Array  # (P, 3)
    obs_cam: jax.Array  # (P, K) int32
    obs_line: jax.Array  # (P, K, 3)
    obs_weight: jax.Array  # (P, K) float, 0 = padding
    cam_dof_mask: jax.Array  # (C, 6)
    point_mask: jax.Array  # (P,)
    cam_gather: jax.Array  # (C, M) int32: flat (P*K) indices per camera
    cam_gather_mask: jax.Array  # (C, M) float, 0 = padding


def from_flat_problem(problem: ba_mod.BAProblem,
                      k_bucket: int = 8,
                      m_bucket: int = 64,
                      k_growth: int = 4,
                      gather_tables: bool = True) -> DenseBAProblem:
    """Convert a flat BAProblem to dense per-point blocks (host-side).

    Builds BOTH layouts of the observation set: per-point (P, K) blocks for
    scatter-free point elimination, and a per-camera gather table (C, M)
    over the flattened (P*K) axis so camera-bin reductions are dense
    gather+sum instead of one-hot matmuls (which waste a factor C of
    FLOPs) or scatters.  Fully vectorized numpy.

    ``k_growth != 2`` selects the coarse K ladder (16, 128, 512):
    K enters the jit retrace key, and every new key costs a trace plus a
    compile or compile-cache load, seconds each time the max track length
    crosses a rung.  Padded-slot compute is cheap by comparison.  ``gather_tables=False`` skips the (C, M) tables and
    returns (C, 1) dummies: the SoA solver never reads them, and M (max
    observations per camera) is the most volatile shape in the problem.
    """
    obs_point = np.asarray(problem.obs_point)
    obs_cam = np.asarray(problem.obs_cam)
    obs_line = np.asarray(problem.obs_line)
    obs_weight = np.asarray(problem.obs_weight)
    P = problem.points3d.shape[0]
    C = problem.qvecs.shape[0]

    valid = obs_weight > 0
    counts = np.bincount(obs_point[valid], minlength=P)
    K = int(max(1, counts.max()))
    if k_growth == 2:
        K = max(K, k_bucket)
        while k_bucket < K:
            k_bucket *= 2
        K = k_bucket
    else:
        # Coarse ladder: 16, then straight to the long-track classes.  Local bundles live in the 8/16 rungs (K is bounded
        # by the bundle's camera count), global BAs in 32/128/512.
        for rung in (16, 128, 256, 512, 2048):
            if K <= rung:
                K = rung
                break

    # Per-point slots: stable sort by point, position within group.
    vidx = np.nonzero(valid)[0]
    vp = obs_point[vidx]
    order = np.argsort(vp, kind="stable")
    vidx, vp = vidx[order], vp[order]
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    kslot = np.arange(len(vidx)) - start[vp]

    cam_idx = np.zeros((P, K), np.int32)
    lines = np.zeros((P, K, 3))
    lines[..., 0] = 1.0
    weight = np.zeros((P, K))
    cam_idx[vp, kslot] = obs_cam[vidx]
    lines[vp, kslot] = obs_line[vidx]
    weight[vp, kslot] = obs_weight[vidx]

    if gather_tables:
        # Per-camera gather over the flat (P*K) axis.
        flat_idx = vp * K + kslot
        vc = obs_cam[vidx]
        ccounts = np.bincount(vc, minlength=C)
        M = int(max(1, ccounts.max()))
        m = m_bucket
        while m < M:
            m *= k_growth
        M = m
        corder = np.argsort(vc, kind="stable")
        cstart = np.concatenate([[0], np.cumsum(ccounts)[:-1]])
        mslot = np.arange(len(vidx)) - cstart[vc[corder]]
        cam_gather = np.zeros((C, M), np.int32)
        cam_gather_mask = np.zeros((C, M))
        cam_gather[vc[corder], mslot] = flat_idx[corder]
        cam_gather_mask[vc[corder], mslot] = 1.0
    else:
        cam_gather = np.zeros((C, 1), np.int32)
        cam_gather_mask = np.zeros((C, 1))

    return DenseBAProblem(
        qvecs=problem.qvecs, tvecs=problem.tvecs,
        cam_params=problem.cam_params, points3d=problem.points3d,
        obs_cam=jnp.asarray(cam_idx),
        obs_line=jnp.asarray(lines, problem.obs_line.dtype),
        obs_weight=jnp.asarray(weight, problem.obs_weight.dtype),
        cam_dof_mask=problem.cam_dof_mask, point_mask=problem.point_mask,
        cam_gather=jnp.asarray(cam_gather),
        cam_gather_mask=jnp.asarray(cam_gather_mask,
                                    problem.obs_weight.dtype))


def _residuals_and_jacobians(problem: DenseBAProblem, qvecs, tvecs, points,
                             camera_model: str):
    """(P, K, 2) residuals; J_cam (P, K, 2, 6); J_pt (P, K, 2, 3)."""
    oc = problem.obs_cam  # (P, K)
    q_o = qvecs[oc]
    t_o = tvecs[oc]
    par_o = problem.cam_params[oc]
    lines_o = problem.obs_line
    X = points  # (P, 3)

    def res_fn(dc, dX, q, t, Xp, par, line):
        qq = lie.quat_multiply(q, ba_mod._quat_delta(dc[:3]))
        tt = t + dc[3:]
        return line_ops.line_ba_residual(line, Xp + dX, qq, tt, camera_model,
                                         par)

    def one(dc, dX, q, t, Xp, par, line):
        r = res_fn(dc, dX, q, t, Xp, par, line)
        Jc = jax.jacfwd(res_fn, argnums=0)(dc, dX, q, t, Xp, par, line)
        Jp = jax.jacfwd(res_fn, argnums=1)(dc, dX, q, t, Xp, par, line)
        return r, Jc, Jp

    P_, K = oc.shape
    zero6 = jnp.zeros((P_, K, 6), qvecs.dtype)
    zero3 = jnp.zeros((P_, K, 3), qvecs.dtype)
    Xb = jnp.broadcast_to(X[:, None, :], (P_, K, 3))
    r, Jc, Jp = jax.vmap(jax.vmap(one))(zero6, zero3, q_o, t_o, Xb, par_o,
                                        lines_o)
    Jc = Jc * problem.cam_dof_mask[oc][:, :, None, :]
    Jp = Jp * problem.point_mask[:, None, None, None]
    return r, Jc, Jp


def _cost(problem: DenseBAProblem, qvecs, tvecs, points, camera_model,
          loss, loss_scale):
    oc = problem.obs_cam
    P_, K = oc.shape
    Xb = jnp.broadcast_to(points[:, None, :], (P_, K, 3))
    r = line_ops.line_ba_residual(
        problem.obs_line, Xb, qvecs[oc], tvecs[oc], camera_model,
        problem.cam_params[oc])
    sq = jnp.sum(r * r, axis=-1)
    return 0.5 * jnp.sum(ba_mod._robust_cost(sq, loss, loss_scale)
                         * problem.obs_weight)


def bundle_adjust_dense(problem: DenseBAProblem, camera_model: str,
                        options: ba_mod.BAOptions = ba_mod.BAOptions()):
    """LM with per-point dense blocks; semantics of ``ba.bundle_adjust``."""
    C = problem.qvecs.shape[0]
    P_, K = problem.obs_cam.shape
    dtype = problem.points3d.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    # Camera-bin reduction strategy (options.cam_reduce):
    #   twolayout — the big per-observation tensors are REBUILT in
    #     camera-sorted layout once per LM iteration (one big sequential
    #     gather), so every per-CG-step reduction streams device memory
    #     sequentially and only gathers tiny (C,6)/(P,3) tables.
    #   onehot — (C, P*K) @ (P*K, n) contraction.  Wastes a factor C of
    #     FLOPs (one-hot density 1/C) and its N=6 payload is a skinny
    #     matmul.
    #   gather — per-camera gather + masked sum per reduction (random
    #     device-memory access per CG step).
    if options.cam_reduce == "gather":
        def cam_reduce(blocks_flat):
            """(P*K, ...) -> (C, ...) per-camera gather + masked sum."""
            g = blocks_flat[problem.cam_gather]  # (C, M, ...)
            mask = problem.cam_gather_mask.reshape(
                problem.cam_gather.shape + (1,) * (blocks_flat.ndim - 1))
            return jnp.sum(g * mask, axis=1)
    elif options.cam_reduce == "twolayout":
        cam_reduce = None  # camera reductions handled in-layout below
    else:
        oc_flat = problem.obs_cam.reshape(-1)  # (P*K,)
        onehot = jax.nn.one_hot(oc_flat, C, dtype=dtype)  # (P*K, C)

        def cam_reduce(blocks_flat):
            """(P*K, ...) -> (C, ...) via one-hot contraction."""
            flat2 = blocks_flat.reshape(blocks_flat.shape[0], -1)
            out = jax.lax.dot_general(
                onehot, flat2, (((0,), (0,)), ((), ())), precision=HIGHEST,
                preferred_element_type=dtype)
            return out.reshape((C,) + blocks_flat.shape[1:])

    twolayout = options.cam_reduce == "twolayout"
    cam_gather = problem.cam_gather  # (C, M)
    cam_mask = problem.cam_gather_mask  # (C, M)
    point_of_cam = cam_gather // K  # (C, M): point index per cam slot

    # Reduced-camera-system solve strategy (resolved at trace time).
    if options.schur_mode == "explicit":
        use_explicit = True
    elif options.schur_mode == "auto":
        # Kernel-launch count dominates on the GPU, so the dense system
        # wins whenever it fits; on the CPU the implicit matvecs are
        # cheaper than materializing S.
        use_explicit = (accelerator() == "gpu"
                        and schur_pcg.explicit_fits(C))
    else:
        use_explicit = False
    n_pad = schur_pcg.padded_dim(C)

    def build_normal(qvecs, tvecs, points):
        r, Jc, Jp = _residuals_and_jacobians(problem, qvecs, tvecs, points,
                                             camera_model)
        sq = jnp.sum(r * r, axis=-1)
        w = (ba_mod._robust_weight(sq, options.loss, options.loss_scale)
             * problem.obs_weight)  # (P, K)
        Hpp = _einsum("pkri,pkrj,pk->pij", Jp, Jp, w)  # no scatter!
        Hcp_o = _einsum("pkri,pkrj,pk->pkij", Jc, Jp, w)  # (P, K, 6, 3)
        gp = _einsum("pkri,pkr,pk->pi", Jp, r, w)  # no scatter!
        if twolayout:
            # Rebuild the camera-side tensors in camera-sorted layout once
            # per LM iteration; all camera reductions below are then plain
            # sequential einsums over the M axis.
            Jc_cam = Jc.reshape(-1, 2, 6)[cam_gather]  # (C, M, 2, 6)
            r_cam = r.reshape(-1, 2)[cam_gather]
            w_cam = w.reshape(-1)[cam_gather] * cam_mask
            Hcc = _einsum("cmri,cmrj,cm->cij", Jc_cam, Jc_cam, w_cam)
            gc = _einsum("cmri,cmr,cm->ci", Jc_cam, r_cam, w_cam)
            Hcp_cam = Hcp_o.reshape(-1, 6, 3)[cam_gather] \
                * cam_mask[..., None, None]  # (C, M, 6, 3)
        else:
            Hcc_o = _einsum("pkri,pkrj,pk->pkij", Jc, Jc, w)
            gc_o = _einsum("pkri,pkr,pk->pki", Jc, r, w)
            Hcc = cam_reduce(Hcc_o.reshape(-1, 6, 6))
            gc = cam_reduce(gc_o.reshape(-1, 6))
            Hcp_cam = Hcp_o[:0]  # unused placeholder
        return Hcc, Hpp, Hcp_o, Hcp_cam, gc, gp

    def solve_explicit(dHcc, Hpp_inv, Hcp_o, gc, gp):
        """Materialize S (6C, 6C) and run the PCG on it.

        Single-Gram formulation: with Hpp_inv = L L^T (closed-form 3x3
        Cholesky) and V = L^T U, the Schur correction
        S_corr = U^T Hpp_inv U = V^T V  AND the rhs correction
        U^T Hpp_inv gp = V^T (L^T gp)  come out of ONE Gram matmul —
        the L^T gp vector rides as an extra column of V, so no second
        U-sized tensor and no transposed-matvec rhs pass are needed.
        """
        n = 6 * C
        L = linalg.chol3(Hpp_inv)  # (P, 3, 3) lower
        gL = _einsum("pba,pb->pa", L, gp)  # L^T gp
        U = schur_pcg.build_u_matrix(Hcp_o, problem.obs_cam, C)
        V = _einsum("pba,pbn->pan", L, U)  # L^T U, (P, 3, n)
        Vx = jnp.concatenate([V.reshape(-1, n), gL.reshape(-1, 1)], axis=1)
        G = schur_pcg.gram(Vx, options.schur_precision)  # (n+1, n+1)
        S_corr = G[:n, :n]
        rhs = gc.reshape(n) - G[:n, n]
        SJ = dHcc - schur_pcg.diag_blocks(S_corr, C)
        SJ_inv = ba_mod._inv6(SJ + 1e-12 * eye6)
        S = schur_pcg.embed_block_diag(dHcc, n_pad, pad_value=1.0)
        S = S - jnp.pad(S_corr, ((0, n_pad - n), (0, n_pad - n)))
        Minv = schur_pcg.embed_block_diag(SJ_inv, n_pad, pad_value=1.0)
        rhs_p = jnp.pad(rhs, (0, n_pad - n))
        dcf = schur_pcg.pcg_xla(S, Minv, rhs_p, options.cg_iterations)
        return dcf[:n].reshape(C, 6)

    def solve_step(Hcc, Hpp, Hcp_o, Hcp_cam, gc, gp, lam):
        dHcc = Hcc + lam * ba_mod._diag_embed6(
            jnp.diagonal(Hcc, axis1=-2, axis2=-1)) + 1e-12 * eye6
        dHpp = Hpp + lam * ba_mod._diag_embed3(
            jnp.diagonal(Hpp, axis1=-2, axis2=-1)) + 1e-12 * eye3
        Hpp_inv = linalg.inv3(dHpp)  # (P, 3, 3)

        if use_explicit:
            dc = solve_explicit(dHcc, Hpp_inv, Hcp_o, gc, gp)
            dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
            Etdc = _einsum("pkji,pkj->pi", Hcp_o, dc[problem.obs_cam])
            dp = _einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
            dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
            return dc, dp

        def cam_side_reduce(y):
            """E y: (P, 3) point vectors -> (C, 6) camera bins."""
            if twolayout:
                y_cam = y[point_of_cam]  # (C, M, 3): small-table gather
                return _einsum("cmij,cmj->ci", Hcp_cam, y_cam)
            Ey_o = _einsum("pkij,pj->pki", Hcp_o, y)
            return cam_reduce(Ey_o.reshape(-1, 6))

        def S_matvec(v):  # v (C, 6)
            Bv = _einsum("cij,cj->ci", dHcc, v)
            v_o = v[problem.obs_cam]  # (P, K, 6)
            Etv = _einsum("pkji,pkj->pi", Hcp_o, v_o)  # dense reduce
            y = _einsum("pij,pj->pi", Hpp_inv, Etv)
            return Bv - cam_side_reduce(y)

        y0 = _einsum("pij,pj->pi", Hpp_inv, gp)
        rhs = gc - cam_side_reduce(y0)

        if twolayout:
            Hpp_inv_cam = Hpp_inv[point_of_cam]  # (C, M, 3, 3)
            SJ = dHcc - _einsum("cmij,cmjl,cmkl->cik", Hcp_cam,
                                   Hpp_inv_cam, Hcp_cam)
        else:
            SJ_o = _einsum("pkij,pjl,pkml->pkim", Hcp_o, Hpp_inv, Hcp_o)
            SJ = dHcc - cam_reduce(SJ_o.reshape(-1, 6, 6))
        SJ_inv = ba_mod._inv6(SJ + 1e-12 * eye6)

        def precond(v):
            return _einsum("cij,cj->ci", SJ_inv, v)

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
            return x, rr, z + beta * p, rz_new

        x0 = jnp.zeros((C, 6), dtype)
        z0 = precond(rhs)
        dc, _, _, _ = jax.lax.fori_loop(
            0, options.cg_iterations, cg_body, (x0, rhs, z0,
                                               jnp.sum(rhs * z0)))
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        Etdc = _einsum("pkji,pkj->pi", Hcp_o, dc[problem.obs_cam])
        dp = _einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
        return dc, dp

    cost0 = _cost(problem, problem.qvecs, problem.tvecs, problem.points3d,
                  camera_model, options.loss, options.loss_scale)

    def lm_body(state):
        q, t, X, lam, c, it, stall, rebuild, rej, normal = state
        # Re-linearize only after an accepted step (Ceres keeps the
        # Jacobian across unsuccessful trust-region iterations).
        normal = jax.lax.cond(
            rebuild,
            lambda args: build_normal(*args),
            lambda args: normal,
            (q, t, X))
        Hcc, Hpp, Hcp_o, Hcp_cam, gc, gp = normal
        if options.gradient_tolerance > 0:
            g_max = jnp.maximum(
                jnp.max(jnp.abs(gc * problem.cam_dof_mask)),
                jnp.max(jnp.abs(gp * problem.point_mask[:, None])))
            grad_done = g_max <= options.gradient_tolerance
        else:
            grad_done = jnp.asarray(False)
        dc, dp = solve_step(Hcc, Hpp, Hcp_o, Hcp_cam, gc, gp, lam)
        dc_m = dc * problem.cam_dof_mask
        dp_m = dp * problem.point_mask[:, None]
        q_new, t_new, X_new = ba_mod._apply_step(q, t, X, -dc_m, -dp_m)
        c_new = _cost(problem, q_new, t_new, X_new, camera_model,
                      options.loss, options.loss_scale)
        accept = c_new < c
        rel = (c - c_new) / jnp.maximum(c, 1e-30)
        q = jnp.where(accept, q_new, q)
        t = jnp.where(accept, t_new, t)
        X = jnp.where(accept, X_new, X)
        c = jnp.where(accept, c_new, c)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, options.min_lambda),
                        jnp.minimum(lam * 4.0, options.max_lambda))
        conv = accept & (rel < options.function_tolerance)
        stall = jnp.where(conv, stall + 1, jnp.where(accept, 0, stall))
        stall = jnp.where(grad_done, 2, stall)
        rej = jnp.where(accept, 0, rej + 1)
        stall = jnp.where(rej >= options.max_consecutive_rejections, 2,
                          stall)
        return q, t, X, lam, c, it + 1, stall, accept, rej, normal

    def lm_cond(state):
        lam, c, it, stall = state[3], state[4], state[5], state[6]
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
    q, t, X, lam, c, it = jax.lax.while_loop(lm_cond, lm_body, init)[:6]
    summary = ba_mod.BASummary(initial_cost=cost0, final_cost=c,
                               num_iterations=it, lam=lam)
    return q, t, X, summary
