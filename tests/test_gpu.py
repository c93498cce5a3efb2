"""Device paths on an NVIDIA GPU, against plain references.

Marked ``gpu``: they skip on the CPU and run on the card through
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu`` (``chip_smoke.py``'s
tests phase).  Each checks what only the card can show: that the path
compiles for it and that f32 stays f32 where the code asks for HIGHEST.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_accelerator_is_gpu():
    from privacy_preserving_sfm_tpu.sfm.incremental_mapper import (
        choose_ba_solver,
    )
    from privacy_preserving_sfm_tpu.utils.jax_setup import accelerator

    assert accelerator() == "gpu"
    assert choose_ba_solver(128) == "soa"
    assert choose_ba_solver(2048) == "dense"


def test_matcher_exact_on_gpu():
    from test_matching_xla import _check_pairs, _rand_desc

    rng = np.random.default_rng(0)
    b, n1, n2 = 3, 1024, 2048
    d1 = np.stack([_rand_desc(rng, n1) for _ in range(b)])
    d2 = np.stack([_rand_desc(rng, n2) for _ in range(b)])
    d2[0, 5] = d2[0, 9] = d1[0, 3]  # ties
    v1 = np.ones((b, n1), bool)
    v2 = np.ones((b, n2), bool)
    v1[1, 700:] = False
    v2[2] = False
    _check_pairs(d1, d2, v1, v2)


def test_gram_is_full_f32_on_gpu():
    from privacy_preserving_sfm_tpu.optim import schur_pcg
    from test_matching_xla import _schur_reference

    rng = np.random.default_rng(1)
    C, K, P = 48, 8, 600
    lh = rng.standard_normal((18 * K, P)).astype(np.float32)
    gL = rng.standard_normal((3, P)).astype(np.float32)
    cam = rng.integers(0, C, (K, P)).astype(np.int32)
    S, r = schur_pcg.gram_soa_xla(jnp.asarray(lh), jnp.asarray(gL),
                                  jnp.asarray(cam), C)
    S_ref, r_ref = _schur_reference(lh, gL, cam, C)
    # TF32 operands (2^-11 relative) would miss this by ~100x.
    np.testing.assert_allclose(np.asarray(S), S_ref, rtol=0,
                               atol=1e-5 * np.abs(S_ref).max())
    np.testing.assert_allclose(np.asarray(r), r_ref, rtol=0,
                               atol=1e-5 * np.abs(r_ref).max())


def test_line_residual_precision_on_gpu():
    """Pixel residuals in f32 on the card match float64 to f32 rounding."""
    from privacy_preserving_sfm_tpu.ops import lines as line_ops

    rng = np.random.default_rng(2)
    n = 4096
    q = np.concatenate([np.ones((n, 1)), 0.1 * rng.standard_normal((n, 3))],
                       axis=1)  # cameras facing the points (z > 0)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.uniform(-1, 1, (n, 3))
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0.0, 0.0, 8.0])
    from privacy_preserving_sfm_tpu.ops import lie_np

    Xc = np.einsum("nij,nj->ni", np.stack([lie_np.quat_to_rotmat(qq)
                                           for qq in q]), X) + t
    uv = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 0.01, (n, 2))
    lines = np.cross(rng.standard_normal((n, 3)),
                     np.concatenate([uv, np.ones((n, 1))], 1))
    lines /= np.linalg.norm(lines[:, :2], axis=1, keepdims=True)
    par = np.array([500.0, 320.0, 240.0])

    def res(lines, X, q, t, par):
        return jax.vmap(lambda l, x, qq, tt: line_ops.line_ba_residual(
            l, x, qq, tt, "SIMPLE_PINHOLE", par))(lines, X, q, t)

    f32 = [jnp.asarray(a, jnp.float32) for a in (lines, X, q, t, par)]
    got = np.asarray(jax.jit(res)(*f32), np.float64)
    cpu = jax.devices("cpu")[0]
    ref = np.asarray(jax.jit(res)(*[jax.device_put(
        jnp.asarray(a, jnp.float64), cpu) for a in (lines, X, q, t, par)]))
    # f32 rounding of ~500 px projections is ~1e-4 px; TF32 products
    # (2^-11 relative) would be ~0.1 px off.
    err = np.abs(got - ref)
    assert err.max() < 2e-3, err.max()


def test_soa_ba_converges_on_gpu():
    from privacy_preserving_sfm_tpu.optim import ba, ba_dense, ba_soa
    from test_ba_soa import _make_problem

    problem = _make_problem(np.random.default_rng(4), noise=5e-3)
    dense = ba_dense.from_flat_problem(problem, k_bucket=4)
    opts = ba.BAOptions(max_iterations=30, cg_iterations=25)
    _, _, _, s = jax.jit(
        lambda p: ba_soa.bundle_adjust_soa(p, "SIMPLE_PINHOLE", opts)
    )(dense)
    assert float(s.final_cost) < 1e-6 * float(s.initial_cost)
