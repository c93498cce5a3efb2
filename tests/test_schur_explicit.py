"""Explicit-Schur PCG (optim/schur_pcg.py) vs the implicit solver.

The explicit path materializes the reduced camera system and solves it
with a fused PCG; it must agree with the matrix-free implicit CG of
``ba_dense.bundle_adjust_dense`` (same damping, preconditioner, iteration
budget) and recover the same synthetic scene.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from privacy_preserving_sfm_tpu.ops import lie
from privacy_preserving_sfm_tpu.optim import ba, ba_dense, schur_pcg


def _random_spd(n, rng, dtype=jnp.float64):
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    return jnp.asarray(S, dtype)


def test_pcg_xla_solves_spd():
    rng = np.random.default_rng(0)
    n = 64
    S = _random_spd(n, rng)
    rhs = jnp.asarray(rng.standard_normal(n))
    Minv = jnp.diag(1.0 / jnp.diag(S))
    x = schur_pcg.pcg_xla(S, Minv, rhs, iters=200)
    np.testing.assert_allclose(np.asarray(S @ x), np.asarray(rhs),
                               rtol=0, atol=1e-8)


def test_embed_and_diag_blocks_roundtrip():
    rng = np.random.default_rng(2)
    blocks = jnp.asarray(rng.standard_normal((5, 6, 6)))
    dense = schur_pcg.embed_block_diag(blocks, schur_pcg.padded_dim(5))
    assert dense.shape == (128, 128)
    back = schur_pcg.diag_blocks(dense, 5)
    np.testing.assert_allclose(np.asarray(back), np.asarray(blocks))
    # Off-diagonal blocks are zero; padding diagonal is 1.
    np.testing.assert_allclose(float(dense[30, 30]), 1.0)
    np.testing.assert_allclose(float(dense[0, 7]), 0.0)


def _synthetic_problem(rng, num_cams=12, num_points=400, obs_per_point=5):
    pts = rng.uniform(-4, 4, (num_points, 3))
    pts[:, 2] += 10.0
    qs = np.zeros((num_cams, 4))
    ts = np.zeros((num_cams, 3))
    for c in range(num_cams):
        yaw = rng.uniform(-0.4, 0.4)
        qs[c] = [np.cos(yaw / 2), 0, np.sin(yaw / 2), 0]
        ts[c] = [rng.uniform(-3, 3), rng.uniform(-0.4, 0.4),
                 rng.uniform(-1, 1)]
    obs_cam = np.stack([rng.permutation(num_cams)[:obs_per_point]
                        for _ in range(num_points)]).reshape(-1)
    obs_point = np.repeat(np.arange(num_points), obs_per_point)
    Rm = np.asarray(lie.quat_to_rotmat(jnp.asarray(qs)))
    Xc = np.einsum("oij,oj->oi", Rm[obs_cam], pts[obs_point]) + ts[obs_cam]
    z = np.maximum(Xc[:, 2], 0.5)
    uv = Xc[:, :2] / z[:, None]
    hom = np.concatenate([uv, np.ones((len(uv), 1))], 1)
    lns = np.cross(rng.standard_normal((len(uv), 3)), hom)
    lns /= np.linalg.norm(lns[:, :2], axis=-1, keepdims=True)
    mask = np.ones((num_cams, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    dtype = jnp.float64
    return ba.BAProblem(
        qvecs=jnp.asarray(qs + rng.normal(0, 2e-3, qs.shape), dtype),
        tvecs=jnp.asarray(ts + rng.normal(0, 2e-2, ts.shape), dtype),
        cam_params=jnp.broadcast_to(
            jnp.asarray([500.0, 320.0, 240.0], dtype), (num_cams, 3)),
        points3d=jnp.asarray(pts + rng.normal(0, 2e-2, pts.shape), dtype),
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_point=jnp.asarray(obs_point, jnp.int32),
        obs_line=jnp.asarray(lns, dtype),
        obs_weight=jnp.ones(len(obs_cam), dtype),
        cam_dof_mask=jnp.asarray(mask, dtype),
        point_mask=jnp.ones(num_points, dtype))


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_explicit_matches_implicit_ba(loss):
    rng = np.random.default_rng(3)
    problem = _synthetic_problem(rng)
    dense = ba_dense.from_flat_problem(problem)
    kw = dict(max_iterations=12, cg_iterations=25, loss=loss,
              function_tolerance=0.0)
    q_i, t_i, X_i, s_i = ba_dense.bundle_adjust_dense(
        dense, "SIMPLE_PINHOLE", ba.BAOptions(schur_mode="implicit", **kw))
    q_e, t_e, X_e, s_e = ba_dense.bundle_adjust_dense(
        dense, "SIMPLE_PINHOLE", ba.BAOptions(schur_mode="explicit", **kw))
    # Same math modulo CG round-off: both drive the cost to ~zero on the
    # noise-free scene and land on the same parameters.
    assert float(s_e.final_cost) < 1e-10 * float(s_e.initial_cost)
    assert float(s_i.final_cost) < 1e-10 * float(s_i.initial_cost)
    np.testing.assert_allclose(np.asarray(t_e), np.asarray(t_i), atol=1e-5)
    np.testing.assert_allclose(np.asarray(X_e), np.asarray(X_i), atol=1e-4)


def test_build_u_matrix_matches_scatter():
    rng = np.random.default_rng(4)
    P, K, C = 17, 4, 6
    Hcp = rng.standard_normal((P, K, 6, 3))
    cams = rng.integers(0, C, (P, K)).astype(np.int32)
    U = np.asarray(schur_pcg.build_u_matrix(
        jnp.asarray(Hcp), jnp.asarray(cams), C))
    expect = np.zeros((P, 3, 6 * C))
    for p in range(P):
        for k in range(K):
            c = cams[p, k]
            expect[p, :, 6 * c:6 * c + 6] += Hcp[p, k].T
    np.testing.assert_allclose(U, expect, atol=1e-12)


def test_explicit_bf16_schur_converges():
    """bf16-compute/f32-accumulate S_corr still solves the scene: the LM
    accept/reject runs on the exact f32 cost, so a low-precision S only
    perturbs step directions."""
    rng = np.random.default_rng(5)
    problem = _synthetic_problem(rng)
    # bf16 path operates on f32 tensors (the production dtype).
    problem = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if a.dtype == jnp.float64 else a, problem)
    dense = ba_dense.from_flat_problem(problem)
    kw = dict(max_iterations=20, cg_iterations=25, function_tolerance=0.0)
    q_f, t_f, X_f, s_f = ba_dense.bundle_adjust_dense(
        dense, "SIMPLE_PINHOLE",
        ba.BAOptions(schur_mode="explicit", schur_precision="f32", **kw))
    q_b, t_b, X_b, s_b = ba_dense.bundle_adjust_dense(
        dense, "SIMPLE_PINHOLE",
        ba.BAOptions(schur_mode="explicit", schur_precision="bf16", **kw))
    assert float(s_f.final_cost) < 1e-6 * float(s_f.initial_cost)
    # Measured trade-off (recorded here as the spec): a ~3-digit S still
    # yields descent directions — cost drops ~5 orders of magnitude — but
    # stalls earlier than f32 (CG steps become noise-dominated near the
    # optimum).  bf16 is therefore an early-iteration accelerator, not a
    # drop-in: keep f32 the default for parity.
    assert float(s_b.final_cost) < 1e-4 * float(s_b.initial_cost)
    assert float(s_b.final_cost) > float(s_f.final_cost)
