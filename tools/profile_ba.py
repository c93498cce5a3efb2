"""Stage-level profile of the dense-block LM BA on the bench problem.

Times each constituent of one LM iteration as its own jitted call
(compile excluded) so the dominant stage is visible, on the GPU:

  normal   residuals + jacfwd Jacobians + Hpp/Hcp/gc/gp (+Hcc) assembly
  schur    U-matrix + S_corr materialization + preconditioner build
  pcg      the explicit-system PCG camera solve
  cost     one robust cost evaluation
  full     one complete jitted LM solve (LM_ITERS iterations) for scale

Usage: python tools/profile_ba.py [--cg_iters 30]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def timeit(fn, *args, reps=5):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def make_looped(stage, n_loop):
    """Wrap ``stage(q, t, X) -> pytree`` in an in-jit repeat loop so the
    per-call launch and dispatch overhead amortizes away.  The
    carry feeds back a data-dependent epsilon so XLA cannot CSE the
    iterations, and every leaf is reduced into the carry so nothing is
    dead-code-eliminated."""
    import jax
    import jax.numpy as jnp

    def run(first, *rest):
        def body(i, acc):
            out = stage(first * (1 + 1e-30 * acc), *rest)
            leaves = jax.tree_util.tree_leaves(out)
            return sum(jnp.sum(l.astype(jnp.float32)) for l in leaves) * 0.0
        return jax.lax.fori_loop(0, n_loop, body, jnp.float32(0.0))

    return jax.jit(run)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cg_iters", type=int, default=30)
    args = ap.parse_args()

    import bench

    _, kind, _ = bench.require_gpu()
    import jax
    import jax.numpy as jnp
    import numpy as np
    from privacy_preserving_sfm_tpu.optim import ba as ba_mod
    from privacy_preserving_sfm_tpu.optim import ba_dense, schur_pcg

    print(f"device: {kind}", flush=True)
    rng = np.random.default_rng(0)
    problem = bench.build_problem(rng, jnp.float32)
    dense = ba_dense.from_flat_problem(problem, k_bucket=8, k_growth=2)
    C = dense.qvecs.shape[0]
    P, K = dense.obs_cam.shape
    n = 6 * C
    n_pad = schur_pcg.padded_dim(C)
    num_obs = int(jnp.sum(dense.obs_weight > 0))
    print(f"P={P} K={K} C={C} obs={num_obs} n={n} pad={n_pad}", flush=True)

    opts = ba_mod.BAOptions(max_iterations=bench.LM_ITERS,
                            cg_iterations=args.cg_iters,
                            function_tolerance=0.0,
                            cam_reduce="onehot", schur_mode="explicit")
    dtype = jnp.float32
    eye6 = jnp.eye(6, dtype=dtype)

    # ---- stage: normal equations (residuals + jacobians + assembly) ----
    LOOP = 16  # in-jit repeats: amortize per-call overhead

    def stage_normal(q, t, X):
        r, Jc, Jp = ba_dense._residuals_and_jacobians(
            dense, q, t, X, "SIMPLE_PINHOLE")
        sq = jnp.sum(r * r, axis=-1)
        w = (ba_mod._robust_weight(sq, opts.loss, opts.loss_scale)
             * dense.obs_weight)
        Hpp = jnp.einsum("pkri,pkrj,pk->pij", Jp, Jp, w)
        Hcp_o = jnp.einsum("pkri,pkrj,pk->pkij", Jc, Jp, w)
        gp = jnp.einsum("pkri,pkr,pk->pi", Jp, r, w)
        oc_flat = dense.obs_cam.reshape(-1)
        onehot = jax.nn.one_hot(oc_flat, C, dtype=dtype)
        Hcc_o = jnp.einsum("pkri,pkrj,pk->pkij", Jc, Jc, w)
        gc_o = jnp.einsum("pkri,pkr,pk->pki", Jc, r, w)
        Hcc = jax.lax.dot_general(
            onehot, Hcc_o.reshape(-1, 36), (((0,), (0,)), ((), ())),
            preferred_element_type=dtype).reshape(C, 6, 6)
        gc = jax.lax.dot_general(
            onehot, gc_o.reshape(-1, 6), (((0,), (0,)), ((), ())),
            preferred_element_type=dtype).reshape(C, 6)
        return Hcc, Hpp, Hcp_o, gc, gp

    q0, t0, X0 = dense.qvecs, dense.tvecs, dense.points3d
    t_normal = timeit(make_looped(stage_normal, LOOP), q0, t0, X0) / LOOP
    Hcc, Hpp, Hcp_o, gc, gp = jax.jit(stage_normal)(q0, t0, X0)

    # ---- stage: jacobians only (no assembly) ----
    def stage_jac(q, t, X):
        return ba_dense._residuals_and_jacobians(
            dense, q, t, X, "SIMPLE_PINHOLE")

    t_jac = timeit(make_looped(stage_jac, LOOP), q0, t0, X0) / LOOP

    # ---- stage: explicit Schur build (Hcp_o first: it feeds the
    # anti-CSE perturbation so the U build cannot be hoisted) ----
    from privacy_preserving_sfm_tpu.ops import linalg

    def stage_schur(Hcp_o, Hcc, Hpp, gc, gp):
        lam = jnp.asarray(1e-4, dtype)
        dHcc = Hcc + lam * ba_mod._diag_embed6(
            jnp.diagonal(Hcc, axis1=-2, axis2=-1)) + 1e-12 * eye6
        dHpp = Hpp + lam * ba_mod._diag_embed3(
            jnp.diagonal(Hpp, axis1=-2, axis2=-1)) \
            + 1e-12 * jnp.eye(3, dtype=dtype)
        Hpp_inv = linalg.inv3(dHpp)
        U = schur_pcg.build_u_matrix(Hcp_o, dense.obs_cam, C)
        L = linalg.chol3(Hpp_inv)
        V = ba_dense._einsum("pba,pbn->pan", L, U)
        gL = ba_dense._einsum("pba,pb->pa", L, gp)
        Vx = jnp.concatenate([V.reshape(-1, n), gL.reshape(-1, 1)], axis=1)
        G = schur_pcg.gram(Vx, opts.schur_precision)
        S_corr = G[:n, :n]
        rhs = gc.reshape(n) - G[:n, n]
        SJ = dHcc - schur_pcg.diag_blocks(S_corr, C)
        SJ_inv = ba_mod._inv6(SJ + 1e-12 * eye6)
        S = schur_pcg.embed_block_diag(dHcc, n_pad, 1.0)
        S = S - jnp.pad(S_corr, ((0, n_pad - n), (0, n_pad - n)))
        Minv = schur_pcg.embed_block_diag(SJ_inv, n_pad, 1.0)
        return S, Minv, jnp.pad(rhs, (0, n_pad - n))

    t_schur = timeit(make_looped(stage_schur, LOOP),
                     Hcp_o, Hcc, Hpp, gc, gp) / LOOP
    S, Minv, rhs_p = jax.jit(stage_schur)(Hcp_o, Hcc, Hpp, gc, gp)

    # ---- sub-stage: S_corr matmul alone ----
    U_probe = schur_pcg.build_u_matrix(Hcp_o, dense.obs_cam, C)

    def stage_scorr(U):
        return schur_pcg.gram(U.reshape(-1, n), opts.schur_precision)

    t_scorr = timeit(make_looped(stage_scorr, LOOP), U_probe) / LOOP

    def stage_ubuild(Hcp_o):
        return schur_pcg.build_u_matrix(Hcp_o, dense.obs_cam, C)

    t_ubuild = timeit(make_looped(stage_ubuild, LOOP), Hcp_o) / LOOP

    # ---- stage: PCG on the explicit system ----
    def stage_pcg(S, Minv, rhs):
        return schur_pcg.pcg_xla(S, Minv, rhs, args.cg_iters)

    t_pcg = timeit(make_looped(stage_pcg, LOOP), S, Minv, rhs_p) / LOOP

    # ---- stage: cost eval ----
    def stage_cost(q, t, X):
        return ba_dense._cost(dense, q, t, X, "SIMPLE_PINHOLE",
                              opts.loss, opts.loss_scale)

    t_cost = timeit(make_looped(stage_cost, LOOP), q0, t0, X0) / LOOP

    # ---- full solve ----
    @jax.jit
    def full():
        return ba_dense.bundle_adjust_dense(dense, "SIMPLE_PINHOLE", opts)

    out = full()
    jax.block_until_ready(out)
    iters = int(out[3].num_iterations)
    t_full = timeit(full, reps=3)

    per_iter = t_full / max(iters, 1)
    print(f"\n--- per call (ms), min of 5, {LOOP}x in-jit loop ---")
    print(f"jacobians only        {t_jac*1e3:9.2f}")
    print(f"normal build (incl J) {t_normal*1e3:9.2f}")
    print(f"schur explicit build  {t_schur*1e3:9.2f}")
    print(f"  U build only        {t_ubuild*1e3:9.2f}")
    print(f"  S_corr matmul only  {t_scorr*1e3:9.2f}")
    print(f"PCG x{args.cg_iters:3d}             {t_pcg*1e3:9.2f}")
    print(f"cost eval             {t_cost*1e3:9.2f}")
    print(f"--- full solve: {t_full*1e3:.1f} ms / {iters} iters "
          f"= {per_iter*1e3:.2f} ms/iter "
          f"({num_obs*iters/t_full/1e6:.2f}M obs*iter/s)")
    acct = t_normal + t_schur + t_pcg + 2 * t_cost
    print(f"accounted per-iter: {acct*1e3:.2f} ms "
          f"(normal+schur+pcg+2*cost); gap = "
          f"{(per_iter-acct)*1e3:.2f} ms")


if __name__ == "__main__":
    main()
