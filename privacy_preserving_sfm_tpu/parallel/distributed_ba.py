"""Distributed implicit-Schur bundle adjustment over a device mesh.

Partitioning strategy (a multi-device SPARSE_SCHUR):

  * **points + their observations are sharded** over the mesh axis with
    track-contiguous assignment: every observation of a point lives on the
    same device, so point-block elimination (Hpp^-1, back-substitution) is
    entirely local;
  * **cameras are replicated**: every device computes its partial camera
    gradient / Schur matvec from its observation shard, and one ``psum``
    per CG step reduces the camera-space vectors over NVLink (NCCL);
  * the (small) preconditioned CG on the reduced camera system then runs
    identically on all devices — no further communication.

Per LM iteration the only collectives are psums of (C, 6)-shaped camera
vectors and scalars — O(C) bytes over the interconnect, independent of the number of
points/observations, which is what makes images-registered/s scale with
devices.

The kernel is ``shard_map``-ped over a 1-D mesh; the host-side
``shard_problem`` partitions a ``ba.BAProblem`` accordingly.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from privacy_preserving_sfm_tpu.optim import ba as ba_mod
from privacy_preserving_sfm_tpu.ops import linalg


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_problem(problem: ba_mod.BAProblem, n_shards: int):
    """Partition points (and their observations) into n_shards groups.

    Greedy balanced assignment by observation count; returns a new
    BAProblem whose obs/point arrays are concatenations of equal-size
    padded shards, plus the shard sizes (for array reshaping).
    """
    obs_point = np.asarray(problem.obs_point)
    obs_weight = np.asarray(problem.obs_weight)
    points_np = np.asarray(problem.points3d)
    pmask_np = np.asarray(problem.point_mask)
    P_total = problem.points3d.shape[0]

    # Count observations per point (valid only) and balance by "snake"
    # assignment in descending-count order: fully vectorized and within
    # one max-track-length of the greedy optimum.
    counts = np.bincount(obs_point[obs_weight > 0], minlength=P_total)
    order = np.argsort(-counts, kind="stable")
    ranks = np.empty(P_total, np.int64)
    ranks[order] = np.arange(P_total)
    period = ranks % (2 * n_shards)
    snake = np.where(period < n_shards, period, 2 * n_shards - 1 - period)
    point_shard = snake.astype(np.int32)

    # Per-shard point slots: stable sort by shard, positions within group.
    shard_counts = np.bincount(point_shard, minlength=n_shards)
    points_per_shard = max(1, int(shard_counts.max()))
    by_shard = np.argsort(point_shard, kind="stable")
    group_start = np.concatenate([[0], np.cumsum(shard_counts)[:-1]])
    point_slot = np.empty(P_total, np.int32)
    point_slot[by_shard] = (np.arange(P_total)
                            - group_start[point_shard[by_shard]])
    new_points = np.zeros((n_shards, points_per_shard, 3))
    new_point_mask = np.zeros((n_shards, points_per_shard))
    new_points[point_shard, point_slot] = points_np
    new_point_mask[point_shard, point_slot] = pmask_np

    # Observations per shard (padded to the max), vectorized scatter.
    valid = obs_weight > 0
    obs_shard = point_shard[obs_point]
    obs_shard_counts = np.bincount(obs_shard[valid], minlength=n_shards)
    O = max(1, int(obs_shard_counts.max()))
    vidx = np.nonzero(valid)[0]
    vs = obs_shard[vidx]
    vorder = np.argsort(vs, kind="stable")
    vidx = vidx[vorder]
    vs = vs[vorder]
    ostart = np.concatenate([[0], np.cumsum(obs_shard_counts)[:-1]])
    oslot = np.arange(len(vidx)) - ostart[vs]
    new_obs_cam = np.zeros((n_shards, O), np.int32)
    new_obs_point = np.zeros((n_shards, O), np.int32)
    new_obs_line = np.zeros((n_shards, O, 3))
    new_obs_line[..., 0] = 1.0
    new_obs_weight = np.zeros((n_shards, O))
    new_obs_cam[vs, oslot] = np.asarray(problem.obs_cam)[vidx]
    new_obs_point[vs, oslot] = point_slot[obs_point[vidx]]
    new_obs_line[vs, oslot] = np.asarray(problem.obs_line)[vidx]
    new_obs_weight[vs, oslot] = obs_weight[vidx]

    sharded = ba_mod.BAProblem(
        qvecs=problem.qvecs, tvecs=problem.tvecs,
        cam_params=problem.cam_params,
        points3d=jnp.asarray(new_points.reshape(-1, 3)),
        obs_cam=jnp.asarray(new_obs_cam.reshape(-1)),
        obs_point=jnp.asarray(new_obs_point.reshape(-1)),
        obs_line=jnp.asarray(new_obs_line.reshape(-1, 3)),
        obs_weight=jnp.asarray(new_obs_weight.reshape(-1)),
        cam_dof_mask=problem.cam_dof_mask,
        point_mask=jnp.asarray(new_point_mask.reshape(-1)),
    )
    meta = {"points_per_shard": points_per_shard, "obs_per_shard": O,
            "point_shard": point_shard, "point_slot": point_slot}
    return sharded, meta


def bundle_adjust_sharded(problem: ba_mod.BAProblem, mesh: Mesh,
                          camera_model: str,
                          options: ba_mod.BAOptions = ba_mod.BAOptions(),
                          axis: str = "shard"):
    """Run distributed LM-BA; ``problem`` must come from ``shard_problem``.

    Returns (qvecs, tvecs, points3d, summary) like ``ba.bundle_adjust``;
    ``points3d`` stays in sharded slot order.
    """
    n = mesh.shape[axis]
    dtype = problem.points3d.dtype
    C = problem.qvecs.shape[0]
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)

    # Local (per-shard) views keep the BAProblem structure: cameras
    # replicated, points/observations sharded on the leading axis.
    spec_rep = P()
    spec_shard = P(axis)

    def kernel(qvecs, tvecs, cam_params, dof_mask, points, point_mask,
               obs_cam, obs_point, obs_line, obs_weight):
        Pl = points.shape[0]

        def lp(q, t, X):
            return ba_mod.BAProblem(
                qvecs=q, tvecs=t, cam_params=cam_params, points3d=X,
                obs_cam=obs_cam, obs_point=obs_point, obs_line=obs_line,
                obs_weight=obs_weight, cam_dof_mask=dof_mask,
                point_mask=point_mask)

        def cost(q, t, X):
            local = ba_mod._cost(lp(q, t, X), q, t, X, camera_model,
                                 options.loss, options.loss_scale)
            return jax.lax.psum(local, axis)

        def build(q, t, X):
            prob = lp(q, t, X)
            r, Jc, Jp = ba_mod._residuals_and_jacobians(
                prob, q, t, X, camera_model)
            sq = jnp.sum(r * r, axis=-1)
            w = (ba_mod._robust_weight(sq, options.loss, options.loss_scale)
                 * obs_weight)
            Hcc_o = jnp.einsum("ori,orj,o->oij", Jc, Jc, w)
            Hpp_o = jnp.einsum("ori,orj,o->oij", Jp, Jp, w)
            Hcp_o = jnp.einsum("ori,orj,o->oij", Jc, Jp, w)
            gc_o = jnp.einsum("ori,or,o->oi", Jc, r, w)
            gp_o = jnp.einsum("ori,or,o->oi", Jp, r, w)
            # Camera blocks: psum over shards (the cross-device reduction).
            Hcc = jax.lax.psum(jax.ops.segment_sum(Hcc_o, obs_cam, C), axis)
            gc = jax.lax.psum(jax.ops.segment_sum(gc_o, obs_cam, C), axis)
            # Point blocks stay local.
            Hpp = jax.ops.segment_sum(Hpp_o, obs_point, Pl)
            gp = jax.ops.segment_sum(gp_o, obs_point, Pl)
            return Hcc, Hpp, Hcp_o, gc, gp

        def solve_step(Hcc, Hpp, Hcp_o, gc, gp, lam):
            dHcc = Hcc + lam * ba_mod._diag_embed6(
                jnp.diagonal(Hcc, axis1=-2, axis2=-1)) + 1e-12 * eye6
            dHpp = Hpp + lam * ba_mod._diag_embed3(
                jnp.diagonal(Hpp, axis1=-2, axis2=-1)) + 1e-12 * eye3
            Hpp_inv = linalg.inv3(dHpp)

            def S_matvec(v):
                Bv = jnp.einsum("cij,cj->ci", dHcc, v)
                Etv = jax.ops.segment_sum(
                    jnp.einsum("oji,oj->oi", Hcp_o, v[obs_cam]),
                    obs_point, Pl)
                y = jnp.einsum("pij,pj->pi", Hpp_inv, Etv)
                Ey = jax.ops.segment_sum(
                    jnp.einsum("oij,oj->oi", Hcp_o, y[obs_point]),
                    obs_cam, C)
                return Bv - jax.lax.psum(Ey, axis)

            y0 = jnp.einsum("pij,pj->pi", Hpp_inv, gp)
            rhs = gc - jax.lax.psum(jax.ops.segment_sum(
                jnp.einsum("oij,oj->oi", Hcp_o, y0[obs_point]),
                obs_cam, C), axis)

            SJ_o = jnp.einsum("oij,ojk,olk->oil", Hcp_o,
                              Hpp_inv[obs_point], Hcp_o)
            SJ = dHcc - jax.lax.psum(
                jax.ops.segment_sum(SJ_o, obs_cam, C), axis)
            SJ_inv = ba_mod._inv6(SJ + 1e-12 * eye6)

            def precond(v):
                return jnp.einsum("cij,cj->ci", SJ_inv, v)

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
            Etdc = jax.ops.segment_sum(
                jnp.einsum("oji,oj->oi", Hcp_o, dc[obs_cam]), obs_point, Pl)
            dp = jnp.einsum("pij,pj->pi", Hpp_inv, gp - Etdc)
            dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
            return dc, dp

        cost0 = cost(qvecs, tvecs, points)

        def lm_body(state):
            q, t, X, lam, c, it, stall, rebuild, rej, normal = state
            # Re-linearize only after an accepted step (mirrors optim/ba).
            normal = jax.lax.cond(
                rebuild,
                lambda args: build(*args),
                lambda args: normal,
                (q, t, X))
            Hcc, Hpp, Hcp_o, gc, gp = normal
            if options.gradient_tolerance > 0:
                g_max = jnp.maximum(
                    jnp.max(jnp.abs(gc * dof_mask)),
                    jnp.max(jnp.abs(gp * point_mask[:, None])))
                # Camera gradients are replicated post-psum; the point-max
                # must still be reduced across shards.
                g_max = jax.lax.pmax(g_max, axis)
                grad_done = g_max <= options.gradient_tolerance
            else:
                grad_done = jnp.asarray(False)
            dc, dp = solve_step(Hcc, Hpp, Hcp_o, gc, gp, lam)
            dc_m = dc * dof_mask
            dp_m = dp * point_mask[:, None]
            q_new, t_new, X_new = ba_mod._apply_step(q, t, X, -dc_m, -dp_m)
            c_new = cost(q_new, t_new, X_new)
            accept = c_new < c
            rel = (c - c_new) / jnp.maximum(c, 1e-30)
            q = jnp.where(accept, q_new, q)
            t = jnp.where(accept, t_new, t)
            X = jnp.where(accept, X_new, X)
            c = jnp.where(accept, c_new, c)
            lam = jnp.where(accept,
                            jnp.maximum(lam / 3.0, options.min_lambda),
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
            jax.eval_shape(build, qvecs, tvecs, points))
        # Hcc/gc come out of build() psum'd (replicated); Hpp/Hcp_o/gp are
        # shard-varying.  The zero seeds must carry the same varying axes
        # for the lax.cond branches to type-check under shard_map.
        Hcc0, Hpp0, Hcp0, gc0, gp0 = normal0
        normal0 = (Hcc0, jax.lax.pcast(Hpp0, axis, to="varying"),
                   jax.lax.pcast(Hcp0, axis, to="varying"), gc0,
                   jax.lax.pcast(gp0, axis, to="varying"))
        init = (qvecs, tvecs, points,
                jnp.asarray(options.initial_lambda, dtype), cost0,
                jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(True), jnp.asarray(0, jnp.int32), normal0)
        q, t, X, lam, c, it = jax.lax.while_loop(lm_cond, lm_body,
                                                 init)[:6]
        summary = ba_mod.BASummary(initial_cost=cost0, final_cost=c,
                                   num_iterations=it, lam=lam)
        return q, t, X, summary

    f = shard_map(
        kernel, mesh=mesh,
        in_specs=(spec_rep, spec_rep, spec_rep, spec_rep, spec_shard,
                  spec_shard, spec_shard, spec_shard, spec_shard, spec_shard),
        out_specs=(spec_rep, spec_rep, spec_shard,
                   ba_mod.BASummary(spec_rep, spec_rep, spec_rep, spec_rep)))

    return f(problem.qvecs, problem.tvecs, problem.cam_params,
             problem.cam_dof_mask, problem.points3d, problem.point_mask,
             problem.obs_cam, problem.obs_point, problem.obs_line,
             problem.obs_weight)
