"""Benchmark: line-BA throughput on the flagship problem, on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.

The hot loop of the privacy-preserving SfM pipeline is point-to-line bundle
adjustment (SURVEY.md §3.3: global/local Ceres BA dominates the reference's
runtime).  This bench measures steady-state residual-evaluations per second
of the LM kernel on a production-shaped problem (100 cameras, 20k points,
~120k observations, f32), i.e. observations x LM-iterations / wall second,
for every BA solver mode, plus SIFT images/s and matcher pairs/s.

It runs on an NVIDIA GPU only: with any other device it exits non-zero
before measuring anything, because a number from another device is not a
measurement of this system.
"""

import json
import sys
import time

import numpy as np

# Published dense peaks per device, keyed by ``jax.devices()[0].device_kind``
# (source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, without
# sparsity; rates assume the card's full 700 W power limit).  A device
# missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,     # FP32 outside the tensor cores
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The peak table row for ``device_kind``; unknown devices raise."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind]


def require_gpu():
    """(platform, device_kind, count) of the GPU, or exit non-zero."""
    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        sys.exit(f"no GPU found: {e}")
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU found: JAX reports platform "
                 f"{devs[0].platform!r}; this benchmark measures only on "
                 "an NVIDIA GPU")
    return devs[0].platform, devs[0].device_kind, len(devs)


NUM_CAMS = 100
NUM_POINTS = 20_000
OBS_PER_POINT = 6
LM_ITERS = 20
CG_ITERS = 30


def build_problem(rng, dtype, meas_noise: float = 0.0):
    """The bench problem; ``meas_noise`` > 0 shifts each observed point in
    the normalized plane before its line is drawn, so the optimum has a
    real nonzero cost that solvers can be compared on."""
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.optim import ba

    pts = rng.uniform(-5, 5, (NUM_POINTS, 3))
    pts[:, 2] += 12.0
    qs = np.zeros((NUM_CAMS, 4))
    ts = np.zeros((NUM_CAMS, 3))
    for c in range(NUM_CAMS):
        yaw = rng.uniform(-0.5, 0.5)
        qs[c] = [np.cos(yaw / 2), 0, np.sin(yaw / 2), 0]
        ts[c] = [rng.uniform(-4, 4), rng.uniform(-0.5, 0.5),
                 rng.uniform(-1, 1)]

    # Each point observed by OBS_PER_POINT random cameras.
    obs_cam = rng.integers(0, NUM_CAMS, (NUM_POINTS, OBS_PER_POINT))
    obs_point = np.repeat(np.arange(NUM_POINTS), OBS_PER_POINT)
    obs_cam = obs_cam.reshape(-1)

    from privacy_preserving_sfm_tpu.ops import lie_np

    Rm = np.stack([lie_np.quat_to_rotmat(q) for q in qs])
    Xc = np.einsum("oij,oj->oi", Rm[obs_cam], pts[obs_point]) + ts[obs_cam]
    z = np.maximum(Xc[:, 2], 0.5)
    uv = Xc[:, :2] / z[:, None]
    if meas_noise > 0:
        uv = uv + rng.normal(0, meas_noise, uv.shape)
    hom = np.concatenate([uv, np.ones((len(uv), 1))], 1)
    lines = np.cross(rng.standard_normal((len(uv), 3)), hom)
    lines /= np.linalg.norm(lines[:, :2], axis=-1, keepdims=True)

    mask = np.ones((NUM_CAMS, 6))
    mask[0] = 0.0
    mask[1, 3] = 0.0

    return ba.BAProblem(
        qvecs=jnp.asarray(qs + rng.normal(0, 1e-3, qs.shape), dtype),
        tvecs=jnp.asarray(ts + rng.normal(0, 1e-2, ts.shape), dtype),
        cam_params=jnp.broadcast_to(
            jnp.asarray([500.0, 320.0, 240.0], dtype), (NUM_CAMS, 3)),
        points3d=jnp.asarray(pts + rng.normal(0, 1e-2, pts.shape), dtype),
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_point=jnp.asarray(obs_point, jnp.int32),
        obs_line=jnp.asarray(lines, dtype),
        obs_weight=jnp.ones(len(obs_cam), dtype),
        cam_dof_mask=jnp.asarray(mask, dtype),
        point_mask=jnp.ones(NUM_POINTS, dtype))


# Useful (algorithmically necessary) FLOPs per observation per LM
# iteration, counting the dense linear algebra of the implicit-Schur LM:
# residual+jacfwd (~1000), normal-equation blocks Hcc/Hpp/Hcp/gc/gp
# (~290), 2 cost evaluations (~200), Schur-Jacobi block build (~324), and
# 2x(6x3) contractions per CG step (72 each).  One-hot padding waste and
# layout copies are NOT counted — this is useful-work utilization.
USEFUL_FLOPS_PER_OBS_ITER = 1000 + 290 + 200 + 324 + 72 * CG_ITERS


def _bench_frontend(jnp, rng):
    """Secondary metrics: SIFT+lift steady-state img/s and matcher pair/s.

    The north-star unit is images-registered/s (``chip_smoke.py`` runs the
    full pipeline); these two micro-benches pin the front-end kernels
    feeding it so the bench is not BA-only.
    """
    import jax
    import time as _time

    from privacy_preserving_sfm_tpu.features import extraction, matching
    from privacy_preserving_sfm_tpu.features import sift as sift_mod

    out = {}
    B = 8  # the extractor's production batch (extract_and_lift_batch_jit)
    imgs = jnp.asarray(rng.random((B, 480, 640)), jnp.float32)
    params = jnp.broadcast_to(
        jnp.asarray([500.0, 320.0, 240.0], jnp.float32), (B, 3))
    gravity = jnp.broadcast_to(
        jnp.asarray([0.0, 1.0, 0.0], jnp.float32), (B, 3))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    opts = sift_mod.SiftOptions(max_num_features=2048)
    feats = extraction.extract_and_lift_batch_jit(
        keys, imgs, "SIMPLE_PINHOLE", params, gravity, opts)
    jax.block_until_ready(feats.lines)
    ts = []
    for _ in range(5):
        t0 = _time.perf_counter()
        feats = extraction.extract_and_lift_batch_jit(
            keys, imgs, "SIMPLE_PINHOLE", params, gravity, opts)
        jax.block_until_ready(feats.lines)
        ts.append(_time.perf_counter() - t0)
    out["sift_lift_images_per_s_640x480"] = B / min(ts)

    # Matcher: the production path is blocks of pairs per dispatch, sized
    # by schedulers.pairs_per_dispatch; one pair per call would measure
    # launch latency, not the kernel.
    from privacy_preserving_sfm_tpu.features import schedulers

    n = 8192
    n_imgs, n_pairs = 8, schedulers.pairs_per_dispatch(n)
    desc = jnp.asarray(rng.integers(0, 256, (n_imgs, n, 128)), jnp.uint8)
    valid = jnp.ones((n_imgs, n), bool)
    pairs = jnp.asarray(rng.integers(0, n_imgs, (n_pairs, 2)), jnp.int32)
    match = jax.jit(lambda d, v, p: matching.match_many_pairs(d, v, p))
    res = match(desc, valid, pairs)
    jax.block_until_ready(res.matches)
    ts = []
    for _ in range(5):
        t0 = _time.perf_counter()
        res = match(desc, valid, pairs)
        jax.block_until_ready(res.matches)
        ts.append(_time.perf_counter() - t0)
    out["match_pairs_per_s_8192x8192"] = n_pairs / min(ts)
    out["match_tflops"] = n_pairs * 2 * n * n * 128 / min(ts) / 1e12
    return out


def main():
    platform, kind, count = require_gpu()
    peaks = device_peaks(kind)

    import jax
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.utils.jax_setup import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    from privacy_preserving_sfm_tpu.optim import ba, ba_dense, ba_soa

    rng = np.random.default_rng(0)
    problem = build_problem(rng, jnp.float32)

    # Every BA solver mode: SoA explicit Schur, dense-block explicit,
    # dense-block implicit with one-hot or camera-sorted reductions —
    # measure all, report the best.
    # k_growth=2: the bench measures kernel speed at the exact K=8 shape
    # (the mapper's coarse production ladder starts at 16 to bound its
    # compile-key count — that padding policy is not the kernel's speed).
    dense = ba_dense.from_flat_problem(problem, k_bucket=8, k_growth=2)
    num_obs = int(problem.obs_cam.shape[0])

    # (label, solver, cam_reduce, schur_mode) — "explicit" materializes
    # the 6Cx6C Schur system; "soa" is the component-array rewrite.
    configs = [
        ("soa", "soa", "onehot", "explicit"),
        ("explicit", "dense", "onehot", "explicit"),
        ("onehot", "dense", "onehot", "implicit"),
        ("twolayout", "dense", "twolayout", "implicit"),
    ]
    results = {}
    for label, solver, cam_reduce, schur_mode in configs:
        opts = ba.BAOptions(max_iterations=LM_ITERS, cg_iterations=CG_ITERS,
                            function_tolerance=0.0,  # fixed work per solve
                            cam_reduce=cam_reduce, schur_mode=schur_mode)
        fn = (ba_soa.bundle_adjust_soa if solver == "soa"
              else ba_dense.bundle_adjust_dense)
        step = jax.jit(lambda p, o=opts, f=fn: f(p, "SIMPLE_PINHOLE", o))
        out = step(dense)  # warmup / compile
        jax.block_until_ready(out)
        iters_run = int(out[3].num_iterations)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = step(dense)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        results[label] = num_obs * iters_run / min(times)

    frontend = _bench_frontend(jnp, rng)

    mode = max(results, key=results.get)
    value = results[mode]
    print(json.dumps({
        "metric": "line_ba_obs_iters_per_s",
        "value": value,
        "unit": "obs*iter/s",
        "device": {"platform": platform, "kind": kind, "count": count},
        "cam_reduce": mode,
        "all_modes": results,
        "useful_flops_per_obs_iter": USEFUL_FLOPS_PER_OBS_ITER,
        "useful_tflops": value * USEFUL_FLOPS_PER_OBS_ITER / 1e12,
        # NOT a utilization claim: useful-FLOPs basis over the published
        # f32 peak, a trend metric only (the LM is memory/launch-bound).
        "useful_flops_over_f32_peak": (
            value * USEFUL_FLOPS_PER_OBS_ITER / peaks["f32_flops"]),
        "ms_per_lm_iter_120k_obs": 120_000 / value * 1e3,
        **frontend,
    }))


if __name__ == "__main__":
    main()
