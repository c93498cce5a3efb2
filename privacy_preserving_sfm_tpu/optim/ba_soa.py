"""SoA explicit-Schur bundle adjustment: component-array layout.

The dense-block solver (``optim/ba_dense.py``) materializes per-observation
tensors with tiny trailing dims — Jc (P, K, 2, 6), Jp (P, K, 2, 3),
Hcp (P, K, 6, 3) — whose minor dimensions waste most of every memory
transaction and vector lane.

Here every per-observation quantity is a tuple of **(K, P) scalar
component arrays** (big axis minor, zero padding waste):

  residual   r1, r2                            2  x (K, P)
  J_camera   jc[row][dof]                      12 x (K, P)
  J_point    jp[row][axis]                     6  x (K, P)
  Hcp        hcp[i][a] = sum_r Jc_ri Jp_ra     18 x (K, P)

Point-side reductions (Hpp, gp, back-substitution) collapse over K into
(P,) components; the camera side reduces all 27 unique Hcc/gc components
with ONE (27, K*P) @ (K*P, C) contraction; the Schur correction
S_corr = V^T V is one Gram matmul (``schur_pcg.gram_soa_xla``) over the
(18*K, P) component stack.  The damped 3x3 point-block inverse and its
Cholesky factor are closed-form scalar expressions on the six Hpp
components.

Semantics are identical to ``ba_dense.bundle_adjust_dense`` with
``schur_mode="explicit"`` (same LM damping/accept/reject, same CG);
tested for agreement in tests/test_ba_soa.py.

Replaces the role of Ceres' DENSE_SCHUR/SPARSE_SCHUR assembly
(reference ``src/optim/bundle_adjustment.cc:276-488``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import lie, lines as line_ops
from privacy_preserving_sfm_tpu.optim import ba as ba_mod
from privacy_preserving_sfm_tpu.optim import ba_dense, schur_pcg

# Element-count ceiling for the resident (K*P, C) camera one-hot: 2^28 f32
# elements is 1 GiB of device memory held for the whole solve.  Above it
# gather_obs scans transient chunks instead (tests lower it to exercise
# the chunked path at toy sizes).
_ONEHOT_CHUNK_LIMIT = 1 << 28
HIGHEST = jax.lax.Precision.HIGHEST


def _res_scalar(dc, dX, q, t, Xp, par, l0, l1, l2, camera_model):
    """Per-observation residual (r1, r2) from scalar components."""
    qq = lie.quat_multiply(q, ba_mod._quat_delta(dc[:3]))
    tt = t + dc[3:]
    line = jnp.stack([l0, l1, l2])
    r = line_ops.line_ba_residual(line, Xp + dX, qq, tt, camera_model, par)
    return r[0], r[1]


def _soa_residuals_and_jacobians(cam_comps, X_comps, l_comps,
                                 camera_model):
    """r + J component arrays from (K, P) scalar component inputs.

    ``cam_comps`` is a tuple of 4 + 3 + Pr per-observation (K, P) arrays
    (quaternion, tvec, intrinsics components) — the minor axis is always
    P, so every device-memory pass is sequential and coalesced (a
    (K, P, 4) gathered tensor would read 4-wide rows, and XLA would
    rematerialize the random gather into every consumer fusion).
    ``X_comps``: 3 x (K, P) broadcast point coordinates.

    Returns (r1, r2, jc, jp): jc 12 components (rows r1 then r2, 6 dofs
    each), jp 6 components (rows r1 then r2, 3 axes each).
    """
    dtype = cam_comps[0].dtype
    n_cc = len(cam_comps)

    def one(*args):
        cc = args[:n_cc]
        X0, X1, X2, l0, l1, l2 = args[n_cc:]
        q = jnp.stack(cc[:4])
        t = jnp.stack(cc[4:7])
        par = jnp.stack(cc[7:])
        Xp = jnp.stack([X0, X1, X2])
        zero6 = jnp.zeros(6, dtype)
        zero3 = jnp.zeros(3, dtype)
        r1, r2 = _res_scalar(zero6, zero3, q, t, Xp, par, l0, l1, l2,
                             camera_model)
        Jc = jax.jacfwd(_res_scalar, argnums=0)(
            zero6, zero3, q, t, Xp, par, l0, l1, l2, camera_model)
        Jp = jax.jacfwd(_res_scalar, argnums=1)(
            zero6, zero3, q, t, Xp, par, l0, l1, l2, camera_model)
        out = (r1, r2)
        out += tuple(Jc[0][i] for i in range(6))
        out += tuple(Jc[1][i] for i in range(6))
        out += tuple(Jp[0][i] for i in range(3))
        out += tuple(Jp[1][i] for i in range(3))
        return out

    outs = jax.vmap(jax.vmap(one))(*cam_comps, *X_comps, *l_comps)
    return outs[0], outs[1], outs[2:14], outs[14:20]


def _chol3_comps(a11, a21, a31, a22, a32, a33):
    """Closed-form lower Cholesky of symmetric 3x3 from components."""
    l11 = jnp.sqrt(jnp.maximum(a11, 1e-30))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = jnp.sqrt(jnp.maximum(a22 - l21 * l21, 1e-30))
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a33 - l31 * l31 - l32 * l32, 1e-30))
    return l11, l21, l31, l22, l32, l33


def _inv3_comps(a11, a21, a31, a22, a32, a33):
    """Closed-form inverse of symmetric 3x3 from components (adjugate)."""
    c11 = a22 * a33 - a32 * a32
    c21 = a32 * a31 - a21 * a33
    c31 = a21 * a32 - a22 * a31
    c22 = a11 * a33 - a31 * a31
    c32 = a21 * a31 - a11 * a32
    c33 = a11 * a22 - a21 * a21
    det = a11 * c11 + a21 * c21 + a31 * c31
    d = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return c11 * d, c21 * d, c31 * d, c22 * d, c32 * d, c33 * d


def _sym3_matvec(m, x0, x1, x2):
    """(m11,m21,m31,m22,m32,m33) @ (x0,x1,x2) componentwise."""
    m11, m21, m31, m22, m32, m33 = m
    return (m11 * x0 + m21 * x1 + m31 * x2,
            m21 * x0 + m22 * x1 + m32 * x2,
            m31 * x0 + m32 * x1 + m33 * x2)


def bundle_adjust_soa(problem: ba_dense.DenseBAProblem, camera_model: str,
                      options: ba_mod.BAOptions = ba_mod.BAOptions(),
                      dynamic: ba_mod.DynamicBAOptions | None = None):
    """Explicit-Schur LM in SoA component layout.

    Requires ``schur_pcg.explicit_fits(C)``; the caller (``_run_ba`` /
    bench) falls back to ``bundle_adjust_dense`` beyond that.

    Structural differences from ``bundle_adjust_dense`` (same LM
    semantics):

    * **One residual pass per iteration.**  The trial point's robust cost
      and its normal equations come out of the same fused build; on
      accept the normal is kept for the next solve, on reject it is
      discarded.  ``ba_dense`` pays a separate cost pass every iteration
      plus a rebuild inside a ``lax.cond`` (whose passthrough branch
      copies the big carried tensors).
    * **Select-based carry** of the normal as a handful of stacked
      (K, P)-minor component arrays — no (…, 6, 3) trailing dims, no
      cond-boundary copies.
    * The Schur Gram is one matmul over the (18*K, P) component stack
      (``schur_pcg.gram_soa_xla``) — no (P, K, 3, 6) repack.
    """
    C = problem.qvecs.shape[0]
    P, K = problem.obs_cam.shape
    dtype = problem.points3d.dtype
    # Per-solve knobs: traced scalars when a DynamicBAOptions is supplied
    # (the production mapper path — one compiled kernel serves every
    # loss/tolerance/iteration-cap variant), static otherwise.
    dyn = dynamic if dynamic is not None \
        else ba_mod.DynamicBAOptions.from_options(options)
    eye6 = jnp.eye(6, dtype=dtype)
    n = 6 * C
    n_pad = schur_pcg.padded_dim(C)

    # ---- static observation-side tensors (computed once per solve) ----
    oc_kp = problem.obs_cam.T  # (K, P)
    w_kp = problem.obs_weight.T.astype(dtype)  # (K, P)
    l_comps = tuple(problem.obs_line[..., i].T for i in range(3))
    # The static one-hot that backs the camera gather is (K*P, C)
    # resident; past ~1 GiB (the >512-camera regime) it is rebuilt in
    # transient chunks inside gather_obs instead.
    chunked_onehot = K * P * C > _ONEHOT_CHUNK_LIMIT
    onehot_n = None if chunked_onehot else \
        jax.nn.one_hot(oc_kp.reshape(-1), C, dtype=dtype)  # (K*P, C)
    _OC_CH = 1 << 15
    if chunked_onehot:
        kp_pad = -(-(K * P) // _OC_CH) * _OC_CH
        oc_chunks = jnp.pad(oc_kp.reshape(-1), (0, kp_pad - K * P),
                            constant_values=-1).reshape(-1, _OC_CH)
    dof_kp = tuple(problem.cam_dof_mask[:, i][oc_kp] for i in range(6))
    pmask = problem.point_mask.astype(dtype)  # (P,)

    n_par = problem.cam_params.shape[1]

    def _onehot_gather(mat_rc):
        """(R, C) camera-indexed rows -> (R, K*P) per-observation values.

        One contraction against the one-hot does ALL the camera gathers
        at once (XLA would otherwise rematerialize a random gather into
        every consumer fusion).  HIGHEST precision: a default-precision
        f32 matmul may round to TF32 (or bf16) and perturb the gathered
        quaternions; at HIGHEST the one-hot selection is f32-exact.  In
        the chunked (>512-camera) regime transient (CH, C) one-hots are
        scanned instead (id -1 padding rows select nothing -> zero
        columns, sliced off).
        """
        if chunked_onehot:
            def chunk(_, oc_c):
                oh = jax.nn.one_hot(oc_c, C, dtype=dtype)
                return None, jax.lax.dot_general(
                    mat_rc, oh, (((1,), (1,)), ((), ())),
                    preferred_element_type=dtype, precision=HIGHEST)
            _, gs = jax.lax.scan(chunk, None, oc_chunks)
            g = jnp.transpose(gs, (1, 0, 2)).reshape(mat_rc.shape[0], -1)
            return g[:, :K * P]
        return jax.lax.dot_general(
            mat_rc, onehot_n, (((1,), (1,)), ((), ())),
            preferred_element_type=dtype, precision=HIGHEST)

    def gather_obs(q, t, X):
        """Per-observation camera quantities as (K, P) component arrays.

        The optimization barrier pins the gathered block so downstream
        fusions re-READ it instead of re-gathering (see _onehot_gather).
        """
        qt = jnp.concatenate([q, t, problem.cam_params], axis=1).T  # (R, C)
        g = jax.lax.optimization_barrier(_onehot_gather(qt))
        cam_comps = tuple(g[i].reshape(K, P) for i in range(7 + n_par))
        X_comps = tuple(jnp.broadcast_to(X[:, i][None], (K, P))
                        for i in range(3))
        return cam_comps, X_comps

    def build_normal(q, t, X):
        """Fused robust cost + SoA normal equations at (q, t, X).

        Returns (cost, hpp (6, P), gp (3, P), hcp (18, K, P) i-major,
        cam_sums (27, C) = 21 Hcc upper-tri + 6 gc components).
        """
        cam_comps, X_comps = gather_obs(q, t, X)
        r1, r2, jc, jp = _soa_residuals_and_jacobians(
            cam_comps, X_comps, l_comps, camera_model)
        # Freeze masked dofs / constant points.
        jc = tuple(jc[row * 6 + i] * dof_kp[i]
                   for row in range(2) for i in range(6))
        jp = tuple(c * pmask[None, :] for c in jp)
        sq = r1 * r1 + r2 * r2
        cost = 0.5 * jnp.sum(
            ba_mod._robust_cost_dyn(sq, dyn.loss_code, dyn.loss_scale)
            * w_kp)
        w = ba_mod._robust_weight_dyn(sq, dyn.loss_code, dyn.loss_scale) \
            * w_kp

        # Point side: 6 Hpp + 3 gp components, reduced over K.
        hpp = jnp.stack([
            jnp.sum((jp[i] * jp[j] + jp[3 + i] * jp[3 + j]) * w, axis=0)
            for i in range(3) for j in range(i, 3)])  # 11,12,13,22,23,33
        gp = jnp.stack([jnp.sum((jp[i] * r1 + jp[3 + i] * r2) * w, axis=0)
                        for i in range(3)])
        # Cross blocks: (18, K, P) components, i (cam dof) major.
        hcp = jnp.stack([(jc[i] * jp[a] + jc[6 + i] * jp[3 + a]) * w
                         for i in range(6) for a in range(3)])
        # Camera side: 21 Hcc upper-tri + 6 gc -> one contraction (HIGHEST:
        # exact per-camera sums of the f32 components).
        cam_rows = [(jc[i] * jc[j] + jc[6 + i] * jc[6 + j]) * w
                    for i in range(6) for j in range(i, 6)]
        cam_rows += [(jc[i] * r1 + jc[6 + i] * r2) * w for i in range(6)]
        stackc = jnp.stack([c.reshape(-1) for c in cam_rows])  # (27, K*P)
        if chunked_onehot:
            kp_pad = oc_chunks.size
            stackp = jnp.pad(stackc, ((0, 0), (0, kp_pad - K * P))) \
                .reshape(27, -1, _OC_CH).transpose(1, 0, 2)

            def csum(acc, xs):
                st_c, oc_c = xs
                oh = jax.nn.one_hot(oc_c, C, dtype=dtype)
                return acc + jax.lax.dot_general(
                    st_c, oh, (((1,), (0,)), ((), ())), precision=HIGHEST,
                    preferred_element_type=dtype), None

            cam_sums, _ = jax.lax.scan(
                csum, jnp.zeros((27, C), dtype), (stackp, oc_chunks))
        else:
            cam_sums = jax.lax.dot_general(
                stackc, onehot_n, (((1,), (0,)), ((), ())),
                precision=HIGHEST, preferred_element_type=dtype)  # (27, C)
        return cost, hpp, gp, hcp, cam_sums

    # Static row permutation expanding the 21 upper-tri components to the
    # full symmetric 6x6 (one gather, no scatters).
    _HCC_IDX = {(i, j): k for k, (i, j) in enumerate(
        (i, j) for i in range(6) for j in range(i, 6))}
    _SYM36 = jnp.asarray([_HCC_IDX[(min(i, j), max(i, j))]
                          for i in range(6) for j in range(6)], jnp.int32)

    def cam_blocks(cam_sums):
        """(27, C) component rows -> Hcc (C, 6, 6), gc (C, 6)."""
        Hcc = jnp.transpose(cam_sums[_SYM36].reshape(6, 6, C), (2, 0, 1))
        gc = cam_sums[21:27].T  # (C, 6)
        return Hcc, gc

    def solve_step(hpp, gp, hcp, cam_sums, lam):
        Hcc, gc = cam_blocks(cam_sums)
        dHcc = Hcc + lam * ba_mod._diag_embed6(
            jnp.diagonal(Hcc, axis1=-2, axis2=-1)) + 1e-12 * eye6
        h11, h12, h13, h22, h23, h33 = hpp
        d11 = h11 * (1.0 + lam) + 1e-12
        d22 = h22 * (1.0 + lam) + 1e-12
        d33 = h33 * (1.0 + lam) + 1e-12
        hinv = _inv3_comps(d11, h12, h13, d22, h23, d33)  # (P,) x 6
        L = _chol3_comps(*hinv)  # lower chol of Hpp_inv, (P,) x 6
        l11, l21, l31, l22, l32, l33 = L

        # LH[a][i] = (L^T Hcp)[a, i] = sum_b L[b, a] hcp[i][b]; L lower.
        def lh(a, i):
            if a == 0:
                return (l11 * hcp[i * 3] + l21 * hcp[i * 3 + 1]
                        + l31 * hcp[i * 3 + 2])
            if a == 1:
                return l22 * hcp[i * 3 + 1] + l32 * hcp[i * 3 + 2]
            return l33 * hcp[i * 3 + 2]

        # gL = L^T gp, (3, P).
        gL = jnp.stack([l11 * gp[0] + l21 * gp[1] + l31 * gp[2],
                        l22 * gp[1] + l32 * gp[2],
                        l33 * gp[2]])

        # (18, K, P) a-major stack -> (18K, P) rows (a*6+i)*K + k: the
        # native input of gram_soa_xla — no (P, K, 3, 6) repack.
        lh_stack = jnp.stack([lh(a, i) for a in range(3)
                              for i in range(6)]).reshape(18 * K, P)
        S_corr, rhs_corr = schur_pcg.gram_soa_xla(
            lh_stack, gL, oc_kp, C, precision=options.schur_precision)
        rhs = gc.reshape(n) - rhs_corr

        SJ = dHcc - schur_pcg.diag_blocks(S_corr, C)
        SJ_inv = ba_mod._inv6(SJ + 1e-12 * eye6)
        S = schur_pcg.embed_block_diag(dHcc, n_pad, pad_value=1.0)
        S = S - jnp.pad(S_corr, ((0, n_pad - n), (0, n_pad - n)))
        Minv = schur_pcg.embed_block_diag(SJ_inv, n_pad, pad_value=1.0)
        rhs_p = jnp.pad(rhs, (0, n_pad - n))
        dcf = schur_pcg.pcg_xla(S, Minv, rhs_p, options.cg_iterations)
        dc = dcf[:n].reshape(C, 6)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)

        # Back-substitution: dp = Hpp_inv (gp - E^T dc), all components.
        dcg_flat = _onehot_gather(dc.T)  # (6, K*P)
        dcg = tuple(dcg_flat[i].reshape(K, P) for i in range(6))
        et = tuple(
            jnp.sum(sum(hcp[i * 3 + a] * dcg[i] for i in range(6)), axis=0)
            for a in range(3))  # 3 x (P,)
        dp0, dp1, dp2 = _sym3_matvec(hinv, gp[0] - et[0], gp[1] - et[1],
                                     gp[2] - et[2])
        dp = jnp.stack([dp0, dp1, dp2], axis=-1)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
        return dc, dp

    cost0, *normal0 = build_normal(problem.qvecs, problem.tvecs,
                                   problem.points3d)
    normal0 = tuple(normal0)

    def lm_body(state):
        q, t, X, lam, c, it, stall, rej, normal = state
        hpp, gp, hcp, cam_sums = normal
        gc_m = cam_sums[21:27].T * problem.cam_dof_mask
        gp_m = gp.T * pmask[:, None]
        g_max = jnp.maximum(jnp.max(jnp.abs(gc_m)),
                            jnp.max(jnp.abs(gp_m)))
        grad_done = (dyn.gradient_tolerance > 0) & \
            (g_max <= dyn.gradient_tolerance)
        dc, dp = solve_step(hpp, gp, hcp, cam_sums, lam)
        dc_m = dc * problem.cam_dof_mask
        dp_m = dp * pmask[:, None]
        q_new, t_new, X_new = ba_mod._apply_step(q, t, X, -dc_m, -dp_m)
        # Fused trial evaluation: cost AND normal equations at the trial
        # point from one residual/Jacobian pass.  On accept the normal is
        # exactly the next iteration's linearization (ba_dense's
        # rebuild-on-accept cond); on reject it is discarded by the
        # selects below (Ceres keeps the old Jacobian across rejected
        # trust-region steps).
        c_new, *normal_new = build_normal(q_new, t_new, X_new)
        accept = c_new < c
        rel = (c - c_new) / jnp.maximum(c, 1e-30)
        q = jnp.where(accept, q_new, q)
        t = jnp.where(accept, t_new, t)
        X = jnp.where(accept, X_new, X)
        c = jnp.where(accept, c_new, c)
        normal = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old),
            tuple(normal_new), normal)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, options.min_lambda),
                        jnp.minimum(lam * 4.0, options.max_lambda))
        conv = accept & (rel < dyn.function_tolerance)
        stall = jnp.where(conv, stall + 1, jnp.where(accept, 0, stall))
        stall = jnp.where(grad_done, 2, stall)
        rej = jnp.where(accept, 0, rej + 1)
        stall = jnp.where(rej >= options.max_consecutive_rejections, 2,
                          stall)
        return q, t, X, lam, c, it + 1, stall, rej, normal

    def lm_cond(state):
        lam, c, it, stall = state[3], state[4], state[5], state[6]
        return (it < dyn.max_iterations) & (stall < 2) & (
            lam < options.max_lambda * 0.99)

    init = (problem.qvecs, problem.tvecs, problem.points3d,
            dyn.initial_lambda.astype(dtype), cost0,
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32), normal0)
    q, t, X, lam, c, it = jax.lax.while_loop(lm_cond, lm_body, init)[:6]
    summary = ba_mod.BASummary(initial_cost=cost0, final_cost=c,
                               num_iterations=it, lam=lam)
    return q, t, X, summary
