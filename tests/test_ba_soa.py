"""SoA explicit-Schur BA agrees with the dense-block solver."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from privacy_preserving_sfm_tpu.ops import lie
from privacy_preserving_sfm_tpu.optim import ba, ba_dense, ba_soa


def _make_problem(rng, num_cams=6, num_points=80, obs_per_point=4,
                  noise=1e-2, meas_noise=0.0):
    pts = rng.uniform(-2, 2, (num_points, 3))
    pts[:, 2] += 8.0
    qs = np.zeros((num_cams, 4))
    ts = np.zeros((num_cams, 3))
    for c in range(num_cams):
        yaw = rng.uniform(-0.4, 0.4)
        qs[c] = [np.cos(yaw / 2), 0, np.sin(yaw / 2), 0]
        ts[c] = [rng.uniform(-2, 2), rng.uniform(-0.3, 0.3),
                 rng.uniform(-0.5, 0.5)]
    obs_cam = rng.integers(0, num_cams, (num_points, obs_per_point))
    obs_point = np.repeat(np.arange(num_points), obs_per_point)
    obs_cam = obs_cam.reshape(-1)
    Rm = np.asarray(lie.quat_to_rotmat(jnp.asarray(qs)))
    Xc = np.einsum("oij,oj->oi", Rm[obs_cam], pts[obs_point]) + ts[obs_cam]
    z = np.maximum(Xc[:, 2], 0.5)
    uv = Xc[:, :2] / z[:, None]
    # meas_noise > 0 shifts each observed point in the normalized plane
    # before the line is drawn through it: the optimum then has a real
    # nonzero cost (instead of the f32 noise floor), which mode-agreement
    # tests need for a meaningful relative comparison.
    uv = uv + rng.normal(0, meas_noise, uv.shape)
    hom = np.concatenate([uv, np.ones((len(uv), 1))], 1)
    lines = np.cross(rng.standard_normal((len(uv), 3)), hom)
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)
    mask = np.ones((num_cams, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0
    dtype = jnp.float32
    return ba.BAProblem(
        qvecs=jnp.asarray(qs + rng.normal(0, noise * 0.1, qs.shape), dtype),
        tvecs=jnp.asarray(ts + rng.normal(0, noise, ts.shape), dtype),
        cam_params=jnp.broadcast_to(
            jnp.asarray([500.0, 320.0, 240.0], dtype), (num_cams, 3)),
        points3d=jnp.asarray(pts + rng.normal(0, noise, pts.shape), dtype),
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_point=jnp.asarray(obs_point, jnp.int32),
        obs_line=jnp.asarray(lines, dtype),
        obs_weight=jnp.ones(len(obs_cam), dtype),
        cam_dof_mask=jnp.asarray(mask, dtype),
        point_mask=jnp.ones(num_points, dtype))


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_soa_matches_dense_one_step(loss):
    """One LM iteration: the SoA build/solve IS the dense build/solve.

    (Beyond one iteration the accept/reject + lambda sequences bifurcate
    on f32 accumulation-order differences — both trajectories converge,
    see test_soa_converges_like_dense.)
    """
    rng = np.random.default_rng(3)
    problem = _make_problem(rng)
    dense = ba_dense.from_flat_problem(problem, k_bucket=4)
    opts = ba.BAOptions(max_iterations=1, cg_iterations=20, loss=loss,
                        function_tolerance=0.0, schur_mode="explicit")
    qd, td, Xd, sd = jax.jit(
        lambda p: ba_dense.bundle_adjust_dense(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    qs, ts_, Xs, ss = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    assert int(sd.num_iterations) == int(ss.num_iterations)
    np.testing.assert_allclose(float(ss.initial_cost),
                               float(sd.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(ss.final_cost), float(sd.final_cost),
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(qs), np.asarray(qd), atol=5e-4)
    np.testing.assert_allclose(np.asarray(ts_), np.asarray(td), atol=5e-3)
    np.testing.assert_allclose(np.asarray(Xs), np.asarray(Xd), atol=2e-2)


def test_soa_converges_like_dense():
    """Multi-iteration runs land in the same convergence class."""
    rng = np.random.default_rng(3)
    problem = _make_problem(rng)
    dense = ba_dense.from_flat_problem(problem, k_bucket=4)
    opts = ba.BAOptions(max_iterations=12, cg_iterations=20,
                        function_tolerance=0.0, schur_mode="explicit")
    _, _, _, sd = jax.jit(
        lambda p: ba_dense.bundle_adjust_dense(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    _, _, _, ss = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    assert float(ss.final_cost) < 1e-3 * float(ss.initial_cost)
    assert float(sd.final_cost) < 1e-3 * float(sd.initial_cost)


def test_soa_reduces_cost_to_near_zero():
    """On an outlier-free perturbed problem the solver must converge."""
    rng = np.random.default_rng(4)
    problem = _make_problem(rng, noise=5e-3)
    dense = ba_dense.from_flat_problem(problem, k_bucket=4)
    opts = ba.BAOptions(max_iterations=30, cg_iterations=25)
    q, t, X, s = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    assert float(s.final_cost) < 1e-6 * float(s.initial_cost)


def test_mode_agreement_at_scale():
    """soa / explicit / implicit converge to the SAME optimum at scale.

    Timing the three solver modes on fixed iteration counts compares
    different optimization trajectories (they diverge on f32
    accumulation order), so agreement is checked at convergence: this
    runs one C=100 camera,
    100k-observation problem to convergence in every mode and requires
    the final costs to agree to 1e-3 relative — the property the
    mapper's automatic mode choice (``_run_ba``) silently relies on.
    """
    rng = np.random.default_rng(42)
    problem = _make_problem(rng, num_cams=100, num_points=6250,
                            obs_per_point=16, noise=5e-3, meas_noise=1e-3)
    dense = ba_dense.from_flat_problem(problem, k_bucket=16)
    finals = {}
    for mode in ("soa", "explicit", "implicit"):
        opts = ba.BAOptions(max_iterations=40, cg_iterations=40,
                            function_tolerance=1e-10,
                            schur_mode="explicit" if mode == "soa" else mode)
        if mode == "soa":
            _, _, _, s = jax.jit(
                lambda p, o=opts: ba_soa.bundle_adjust_soa(
                    p, "SIMPLE_PINHOLE", o))(dense)
        else:
            _, _, _, s = jax.jit(
                lambda p, o=opts: ba_dense.bundle_adjust_dense(
                    p, "SIMPLE_PINHOLE", o))(dense)
        finals[mode] = float(s.final_cost)
        # Every mode must actually descend; the floor is the measurement
        # noise (~f^2 sigma^2 N/2 ~ 1e4 here), not zero, so the real
        # assertion is the cross-mode agreement below.
        assert finals[mode] < 0.5 * float(s.initial_cost), (mode, finals)
    ref = finals["soa"]
    for mode, c in finals.items():
        np.testing.assert_allclose(c, ref, rtol=1e-3,
                                   err_msg=f"{mode} vs soa: {finals}")


def test_soa_chunked_onehot_gather(monkeypatch):
    """The chunked camera gather (>512-camera regime) solves identically.

    Forces the chunk path at toy size by lowering the residency limit;
    the solve must match the resident-one-hot trajectory exactly (the
    chunked contraction computes the same f32 dot products).
    """
    from privacy_preserving_sfm_tpu.optim import ba_soa as soa_mod

    rng = np.random.default_rng(6)
    problem = _make_problem(rng)
    dense = ba_dense.from_flat_problem(problem, k_bucket=4)
    opts = ba.BAOptions(max_iterations=8, cg_iterations=20,
                        function_tolerance=0.0, schur_mode="explicit")
    q0, t0, X0, s0 = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    monkeypatch.setattr(soa_mod, "_ONEHOT_CHUNK_LIMIT", 0)
    q1, t1, X1, s1 = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    np.testing.assert_allclose(float(s1.final_cost), float(s0.final_cost),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(q1), np.asarray(q0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(X1), np.asarray(X0), atol=1e-5)


def test_soa_respects_gauge_mask():
    rng = np.random.default_rng(5)
    problem = _make_problem(rng)
    dense = ba_dense.from_flat_problem(problem, k_bucket=4)
    opts = ba.BAOptions(max_iterations=5)
    q, t, X, s = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    # _apply_step renormalizes every quaternion (dense solver does too);
    # the held camera's ROTATION must be unchanged.
    q0_in = np.asarray(dense.qvecs[0])
    np.testing.assert_allclose(np.asarray(q[0]),
                               q0_in / np.linalg.norm(q0_in), atol=1e-6)
    np.testing.assert_allclose(np.asarray(t[0]), np.asarray(dense.tvecs[0]),
                               atol=1e-7)
    np.testing.assert_allclose(float(t[1, 0]), float(dense.tvecs[1, 0]),
                               atol=1e-7)
