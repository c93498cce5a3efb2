"""The XLA matcher and Schur Gram against plain numpy references.

The matcher must agree with an integer brute force EXACTLY (uint8
descriptor dots are integers below 2^24, exact in f32 and in TF32 with f32
accumulation); the Gram against a float64 Schur correction.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from privacy_preserving_sfm_tpu.features import matching, schedulers
from privacy_preserving_sfm_tpu.optim import schur_pcg


def _brute_top2(d1, d2, v1, v2):
    """Integer top-2 + argmax in both directions, invalid rows at -1e9."""
    big = -10 ** 9
    dots = d1.astype(np.int64) @ d2.astype(np.int64).T
    dots[~v1, :] = big
    dots[:, ~v2] = big
    out = []
    for m in (dots, dots.T.copy()):
        idx = np.argmax(m, axis=1)  # first occurrence on ties
        rows = np.arange(len(m))
        best = m[rows, idx]
        m[rows, idx] = np.iinfo(np.int64).min
        out += [best, m.max(axis=1), idx]
    return out


def _rand_desc(rng, n):
    return rng.integers(0, 256, (n, 128)).astype(np.uint8)


def _sift_like(rng, n):
    """512 * L1-root normalized, uint8-quantized (the extractor's format)."""
    v = rng.gamma(0.5, size=(n, 128))
    v = np.sqrt(v / v.sum(1, keepdims=True)) * 512
    return np.clip(np.round(v), 0, 255).astype(np.uint8)


def _check_pairs(d1s, d2s, v1s, v2s):
    got = [np.asarray(a) for a in matching._top2_both_batched(
        jnp.asarray(d1s), jnp.asarray(d2s), jnp.asarray(v1s),
        jnp.asarray(v2s))]
    for b in range(d1s.shape[0]):
        ref = _brute_top2(d1s[b], d2s[b], v1s[b], v2s[b])
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].astype(np.int64), r)
    return got


@pytest.mark.parametrize("case", ["random", "ties", "padded_rows",
                                  "no_valid_candidates"])
def test_top2_matches_integer_brute_force(case):
    rng = np.random.default_rng(["random", "ties", "padded_rows",
                                 "no_valid_candidates"].index(case))
    b, n1, n2 = 2, 384, 512
    d1 = np.stack([_rand_desc(rng, n1) for _ in range(b)])
    d2 = np.stack([_rand_desc(rng, n2) for _ in range(b)])
    v1 = np.ones((b, n1), bool)
    v2 = np.ones((b, n2), bool)
    if case == "ties":
        d2[0, 40] = d1[0, 7]   # exact duplicate across images
        d2[0, 300] = d1[0, 7]  # second duplicate: tie in both directions
    elif case == "padded_rows":
        v1[1, 250:] = False
        v2[1, 400:] = False
    elif case == "no_valid_candidates":
        v2[0] = False
    got = _check_pairs(d1, d2, v1, v2)
    if case == "ties":
        assert int(got[2][0, 7]) == 40  # first occurrence wins
        assert float(got[0][0, 7]) == float(got[1][0, 7])  # ratio 1
    if case == "no_valid_candidates":
        ang = np.arccos(np.clip(got[0][0] * matching.DIST_NORM, -1, 1))
        assert (ang > 3.0).all()  # every gate rejects


def test_match_descriptors_gates_on_brute_force_top2():
    """Ratio/distance/cross-check gates applied to the brute-force top-2
    reproduce match_descriptors."""
    rng = np.random.default_rng(3)
    d1 = _sift_like(rng, 256)
    d2 = np.concatenate([d1[:100], _sift_like(rng, 156)])
    res = matching.match_descriptors(jnp.asarray(d1), jnp.asarray(d2))
    bd12, sd12, i12, bd21, sd21, i21 = _brute_top2(
        d1, d2, np.ones(256, bool), np.ones(256, bool))

    def ang(x):
        x = x.astype(np.float32) * np.float32(matching.DIST_NORM)
        return np.arccos(np.clip(x, -1.0, 1.0))

    ok = (ang(bd12) < 0.7) & (ang(bd12) < 0.8 * ang(sd12))
    ok21 = (ang(bd21) < 0.7) & (ang(bd21) < 0.8 * ang(sd21))
    ok &= (i21[i12] == np.arange(256)) & ok21[i12]
    np.testing.assert_array_equal(np.asarray(res.matches),
                                  np.where(ok, i12, -1))
    assert int(res.num_matches) == int(ok.sum()) >= 100


def test_pairs_per_dispatch_fits_the_budget():
    assert schedulers.pairs_per_dispatch(1024) == \
        schedulers.MAX_PAIRS_PER_DISPATCH
    for n in (4096, 8192, 16384):
        k = schedulers.pairs_per_dispatch(n)
        per_pair = schedulers._TEMP_BYTES_PER_DOT * n * n
        assert 1 <= k <= schedulers.MAX_PAIRS_PER_DISPATCH
        assert k * per_pair <= schedulers.MATCH_TEMP_BYTES
        assert k == schedulers.MAX_PAIRS_PER_DISPATCH or \
            (k + 1) * per_pair > schedulers.MATCH_TEMP_BYTES
    assert schedulers.pairs_per_dispatch(1 << 20) == 1


def _schur_reference(lh, gL, cam, C):
    """Dense float64 V (3P, 6C) from the component stack, then V^T V."""
    K, P = cam.shape
    lh4 = lh.reshape(3, 6, K, P).astype(np.float64)
    V = np.zeros((P, 3, C, 6))
    for k in range(K):
        for p in range(P):
            V[p, :, cam[k, p], :] += lh4[:, :, k, p]
    V = V.reshape(3 * P, 6 * C)
    return V.T @ V, V.T @ gL.T.astype(np.float64).reshape(-1)


@pytest.mark.parametrize("C,K,P", [(9, 4, 37), (23, 8, 150), (64, 16, 90)])
def test_gram_soa_xla_matches_float64_schur(C, K, P):
    rng = np.random.default_rng(C)
    lh = rng.standard_normal((18 * K, P)).astype(np.float32)
    gL = rng.standard_normal((3, P)).astype(np.float32)
    cam = rng.integers(0, C, (K, P)).astype(np.int32)
    S, r = schur_pcg.gram_soa_xla(jnp.asarray(lh), jnp.asarray(gL),
                                  jnp.asarray(cam), C)
    S_ref, r_ref = _schur_reference(lh, gL, cam, C)
    scale = np.abs(S_ref).max()
    np.testing.assert_allclose(np.asarray(S), S_ref, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(r), r_ref, rtol=0,
                               atol=1e-5 * np.abs(r_ref).max())
    np.testing.assert_allclose(np.asarray(S), np.asarray(S).T, rtol=0,
                               atol=1e-6 * scale)


def test_gram_precision_modes():
    rng = np.random.default_rng(0)
    V = jnp.asarray(rng.standard_normal((300, 40)), jnp.float32)
    ref = np.asarray(V, np.float64).T @ np.asarray(V, np.float64)
    g32 = np.asarray(schur_pcg.gram(V, "f32"))
    g16 = np.asarray(schur_pcg.gram(V, "bf16"))
    assert schur_pcg.gram(V, "bf16").dtype == jnp.float32
    err32 = np.abs(g32 - ref).max() / np.abs(ref).max()
    err16 = np.abs(g16 - ref).max() / np.abs(ref).max()
    assert err32 < 1e-6 < err16 < 2e-2
    with pytest.raises(ValueError):
        schur_pcg.gram(V, "tf32")
