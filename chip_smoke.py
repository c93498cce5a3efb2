"""Smoke run of the whole system on one NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the multi-device paths only

Phases (each in a child process, one after another, so that exactly one
process holds the card at a time; this parent never imports JAX):

  device   platform must be "gpu"; prints device_kind, the device count
           and nvidia-smi's name and power limit.
  render   box50: box scene, 50 images of 640x480, SIMPLE_PINHOLE, from a
           seed (tools/synth_dataset.py; numpy/scipy, no device).
  tests    the tests marked ``gpu`` (tests/conftest.py), on the card.
  kernels  each device path at its real width, compiled for the card and
           compared with a plain reference: the SoA BA solve against the
           CPU float64 flat solver, the Schur Gram against a numpy float64
           Schur correction, the XLA matcher against a brute-force integer
           top-2, SIFT+lift against the same jitted function on the CPU.
  e2e      ``automatic_reconstructor`` (exhaustive matcher) on box50,
           evaluated against gt_poses.txt with tools/evaluate.py.

With ``--four``: ``bundle_adjust_sharded`` over a 4-GPU mesh against the
single-device solve, and ``hierarchical_mapper --num_workers 4`` on box50
(one worker per card) against the same ground-truth bounds.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only
when every phase passed.  Without a GPU, or outside a checkout of this
repository, the script exits non-zero and prints no result.  Long logs go
to ``chiprun_out/smoke/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
RESULT = "SMOKE_RESULT "

# Acceptance bounds of the end-to-end phase (box50).
MIN_REGISTERED = 48
MAX_ATE = 0.01          # scene units
MAX_ROT_DEG = 0.5
# Kernel comparisons.
BA_RTOL = 1e-3          # tests/test_ba_soa.py::test_mode_agreement_at_scale
# Gram: |S - S_ref| <= GRAM_RTOL * sum|products| entrywise.  Full-f32
# (HIGHEST) sums of <= ~1200 products stay within a few dozen f32 ulps
# (2^-24 ~ 6e-8) of that scale; TF32 operand rounding (2^-11) would miss
# it by two orders of magnitude.
GRAM_RTOL = 1e-5
# SIFT GPU vs CPU: the f32/bf16 sums run in another order on each backend,
# which flips detections whose response sits at the peak or edge
# threshold, so a few keypoints exist on one side only.
SIFT_MIN_MATCHED = 0.90     # share of keypoints found on both backends
SIFT_MIN_MEDIAN_COS = 0.99  # descriptor cosine of matched keypoints
SIFT_MIN_COS95 = 0.90       # share of matched keypoints with cos >= 0.95
# (The matcher's distance gate is acos(cos) < 0.7 rad, i.e. cos > 0.76;
# cos 0.99 is 0.14 rad, a fifth of that gate.)


# --------------------------------------------------------------------------
# parent side: no JAX here
# --------------------------------------------------------------------------

def _run_child(phase: str, extra=(), env=None, timeout=1200):
    """Run ``chip_smoke.py --child phase``; return its result dict.

    The child's output goes to chiprun_out/smoke/<phase>.log; lines it
    marks with "|" are echoed here.
    """
    os.makedirs(OUT, exist_ok=True)
    log_path = os.path.join(OUT, f"{phase}.log")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", phase,
           *extra]
    t0 = time.perf_counter()
    result = None
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=ROOT, env={**os.environ, **(env or {})})
        try:
            for line in proc.stdout:
                log.write(line)
                if line.startswith(RESULT):
                    result = json.loads(line[len(RESULT):])
                elif line.startswith("|"):
                    print(f"  [{phase}] {line[1:].rstrip()}", flush=True)
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or result is None:
        tail = open(log_path).read()[-3000:]
        print(f"phase {phase} FAILED (rc {proc.returncode}, {secs:.1f} s); "
              f"log tail:\n{tail}", file=sys.stderr, flush=True)
        return None
    print(f"phase {phase}: ok in {secs:.1f} s", flush=True)
    result["_seconds"] = secs
    return result


def _nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def parent(four: bool):
    if not os.path.isdir(os.path.join(ROOT, "privacy_preserving_sfm_tpu")):
        _fail("run from a checkout of the repository (package not found)")
    t_start = time.perf_counter()
    dev = _run_child("device", timeout=300)
    if dev is None:
        _fail("no GPU found")
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    for line in _nvidia_smi().splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    # Never trust a native library copied from another machine.
    subprocess.run(["sh", os.path.join(ROOT, "native", "build.sh")],
                   check=True, capture_output=True)

    data = os.path.join(OUT, "box50")
    shutil.rmtree(data, ignore_errors=True)
    if _run_child("render", [data], env={"JAX_PLATFORMS": "cpu"},
                  timeout=600) is None:
        _fail("rendering box50 failed")

    if four:
        if dev["count"] < 4:
            _fail(f"--four needs 4 GPUs, found {dev['count']}")
        phases = [("dist_ba", [], 600), ("hier", [data], 1500)]
    else:
        phases = [("tests", [], 600), ("kernels", [data], 900),
                  ("e2e", [data], 1200)]
    for name, extra, timeout in phases:
        if _run_child(name, extra, timeout=timeout) is None:
            _fail(f"phase {name} failed")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)


# --------------------------------------------------------------------------
# children
# --------------------------------------------------------------------------

def _emit(result: dict):
    print(RESULT + json.dumps(result), flush=True)


def _say(msg: str):
    print("|" + msg, flush=True)


def _timed(fn, *args, reps=5):
    """(min seconds, last output) over ``reps`` calls after one warm-up."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis unavailable"
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {m.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB")


def child_device():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"JAX platform is {devs[0].platform!r}, not gpu")
    _emit({"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)})


def child_render(data: str):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from synth_dataset import make_dataset

    make_dataset(data, 50, width=640, height=480, seed=0, scene="box",
                 camera="SIMPLE_PINHOLE")
    _say(f"rendered box50 to {data}")
    _emit({"images": 50})


def child_tests():
    import xml.etree.ElementTree as ET

    xml = os.path.join(OUT, "gpu_tests.xml")
    env = {**os.environ, "JAX_PLATFORMS": "cuda,cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         f"--junitxml={xml}"],
        cwd=ROOT, env=env, capture_output=True, text=True)
    print(r.stdout[-6000:], r.stderr[-3000:])
    cases = ET.parse(xml).getroot().iter("testcase")
    passed, bad = 0, []
    for case in cases:
        name = f"{case.get('classname')}::{case.get('name')}"
        if case.find("failure") is not None or \
                case.find("error") is not None:
            bad.append(name)
        elif case.find("skipped") is not None:
            # Modules skipped for an optional package (matplotlib, PIL,
            # cv2) are fine; a gpu test skipped for want of a GPU is not.
            if "NVIDIA GPU" in (case.find("skipped").get("message") or ""):
                bad.append(name)
        else:
            passed += 1
    _say(f"gpu tests: {passed} passed, {len(bad)} failed or skipped "
         f"for want of a GPU (pytest rc {r.returncode})")
    if bad or passed == 0 or r.returncode not in (0,):
        raise SystemExit(f"gpu tests failed: {bad}")
    _emit({"passed": passed})


def _peaks():
    sys.path.insert(0, ROOT)
    import bench
    import jax

    return bench.device_peaks(jax.devices()[0].device_kind)


def _roofline(seconds, flops, bytes_, peak_flops, peak_bw):
    """Least time over measured time, and which bound sets it."""
    t_f, t_b = flops / peak_flops, bytes_ / peak_bw
    return max(t_f, t_b) / seconds, ("compute" if t_f >= t_b else "memory")


def check_ba(peaks) -> dict:
    """SoA BA at the bench problem vs the CPU float64 flat solver."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from privacy_preserving_sfm_tpu.optim import ba, ba_dense, ba_soa

    opts = ba.BAOptions(max_iterations=40, cg_iterations=40,
                        function_tolerance=1e-10, schur_mode="explicit")
    # CPU float64 reference in its own process (x64 is process-wide).
    ref = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", "ba_ref"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})

    problem = bench.build_problem(np.random.default_rng(0), jnp.float32,
                                  meas_noise=1e-3)
    dense = ba_dense.from_flat_problem(problem, gather_tables=False)
    solve = jax.jit(lambda p: ba_soa.bundle_adjust_soa(
        p, "SIMPLE_PINHOLE", opts))
    t0 = time.perf_counter()
    compiled = solve.lower(dense).compile()
    t_compile = time.perf_counter() - t0
    _say(f"ba soa C={dense.qvecs.shape[0]} P={dense.obs_cam.shape[0]} "
         f"K={dense.obs_cam.shape[1]}: compile {t_compile:.1f} s, "
         f"{_mem(compiled)}")
    secs, (_, _, _, s) = _timed(compiled, dense, reps=3)
    gpu_cost = float(s.final_cost)
    iters = int(s.num_iterations)
    out, _ = ref.communicate(timeout=900)
    line = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
    if ref.returncode != 0 or not line:
        raise SystemExit(f"CPU float64 reference failed:\n{out[-3000:]}")
    cpu_cost = json.loads(line[-1][len(RESULT):])["final_cost"]
    rel = abs(gpu_cost - cpu_cost) / abs(cpu_cost)
    num_obs = int(problem.obs_cam.shape[0])
    _say(f"ba soa: final cost {gpu_cost:.6e} vs CPU f64 flat "
         f"{cpu_cost:.6e} (rel {rel:.2e}, limit {BA_RTOL}); {iters} LM "
         f"iters in {secs * 1e3:.1f} ms = {secs / iters * 1e3:.2f} ms/iter, "
         f"{num_obs * iters / secs:.3e} obs*iter/s")
    if not rel <= BA_RTOL:
        raise SystemExit("BA cost disagrees with the CPU float64 solver")
    return {"final_cost": gpu_cost, "cpu_f64_cost": cpu_cost, "rel": rel,
            "ms_per_iter": secs / iters * 1e3, "compile_s": t_compile}


def child_ba_ref():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    import bench
    from privacy_preserving_sfm_tpu.optim import ba

    opts = ba.BAOptions(max_iterations=40, cg_iterations=40,
                        function_tolerance=1e-10)
    problem = bench.build_problem(np.random.default_rng(0), jnp.float32,
                                  meas_noise=1e-3)
    problem = jax.tree.map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        problem)
    _, _, _, s = jax.jit(lambda p: ba.bundle_adjust(
        p, "SIMPLE_PINHOLE", opts))(problem)
    _emit({"final_cost": float(s.final_cost),
           "iters": int(s.num_iterations)})


def _gram_reference(lh, gL, cam, C):
    """numpy float64 S_corr, rhs_corr and sum|products| (sparse build)."""
    import numpy as np

    K = cam.shape[0]
    lh4 = lh.reshape(3, 6, K, -1).astype(np.float64)
    g = gL.astype(np.float64)
    S = np.zeros((C, C, 6, 6))
    S_abs = np.zeros((C, C, 6, 6))
    for k1 in range(K):
        for k2 in range(K):
            blk = np.einsum("aip,ajp->pij", lh4[:, :, k1], lh4[:, :, k2])
            ablk = np.einsum("aip,ajp->pij", np.abs(lh4[:, :, k1]),
                             np.abs(lh4[:, :, k2]))
            np.add.at(S, (cam[k1], cam[k2]), blk)
            np.add.at(S_abs, (cam[k1], cam[k2]), ablk)
    rhs = np.zeros((C, 6))
    for k in range(K):
        np.add.at(rhs, cam[k], np.einsum("aip,ap->pi", lh4[:, :, k], g))
    n = 6 * C
    S = S.transpose(0, 2, 1, 3).reshape(n, n)
    S_abs = S_abs.transpose(0, 2, 1, 3).reshape(n, n)
    return S, S_abs, rhs.reshape(n)


def check_gram(peaks, P=20_000, cams=(100, 600, 1000)) -> dict:
    """gram_soa_xla at C in {100, 600, 1000} vs numpy float64."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from privacy_preserving_sfm_tpu.optim import schur_pcg

    K, K_obs = 8, 6
    out = {}
    for C in cams:
        rng = np.random.default_rng(C)
        lh = rng.standard_normal((3, 6, K, P)).astype(np.float32)
        lh[:, :, K_obs:] = 0.0  # padding slots carry zero rows
        cam = rng.integers(0, C, (K, P)).astype(np.int32)
        cam[K_obs:] = 0
        gL = rng.standard_normal((3, P)).astype(np.float32)
        args = (jnp.asarray(lh.reshape(18 * K, P)), jnp.asarray(gL),
                jnp.asarray(cam))
        fn = jax.jit(schur_pcg.gram_soa_xla, static_argnums=3)
        compiled = fn.lower(*args, C).compile()
        secs, (S, r) = _timed(lambda *a: compiled(*a), *args)
        S_ref, S_abs, r_ref = _gram_reference(lh, gL, cam, C)
        err = np.abs(np.asarray(S, np.float64) - S_ref)
        worst = float(np.max(err / (S_abs + 1e-30)))
        r_err = float(np.max(np.abs(np.asarray(r, np.float64) - r_ref))
                      / np.max(np.abs(r_ref)))
        n1 = 6 * C + 1
        flops = 2.0 * 3 * P * n1 * n1
        bytes_ = 4.0 * (3 * P * n1 + n1 * n1 + P * K * C)
        share, bound = _roofline(secs, flops, bytes_, peaks["f32_flops"],
                                 peaks["hbm_bytes_per_s"])
        _say(f"gram_soa_xla C={C} P={P} K={K}: {secs * 1e3:.2f} ms, "
             f"roofline share {share:.3f} ({bound}-bound, f32 peak), "
             f"max |S-S_ref|/sum|terms| {worst:.2e} (limit {GRAM_RTOL}), "
             f"rhs rel err {r_err:.2e}; {_mem(compiled)}")
        if not (worst <= GRAM_RTOL and r_err <= GRAM_RTOL):
            raise SystemExit(f"Gram at C={C} outside tolerance")
        out[C] = {"ms": secs * 1e3, "roofline": share, "err": worst}

    # PCG on the explicit system at the largest C.
    hi = jax.lax.Precision.HIGHEST
    n = schur_pcg.padded_dim(max(cams))
    A = jax.random.normal(jax.random.PRNGKey(1), (n, n)) / np.sqrt(n)
    S = jnp.matmul(A, A.T, precision=hi) + 2 * jnp.eye(n)
    Minv = jnp.diag(1.0 / jnp.diag(S))
    rhs = jax.random.normal(jax.random.PRNGKey(2), (n,))
    iters = 40
    pcg = jax.jit(schur_pcg.pcg_xla, static_argnums=3)
    secs, x = _timed(pcg, S, Minv, rhs, iters)
    res = float(jnp.linalg.norm(jnp.matmul(S, x, precision=hi) - rhs)
                / jnp.linalg.norm(rhs))
    flops = 4.0 * n * n * iters
    bytes_ = 2.0 * 4 * n * n * iters
    share, bound = _roofline(secs, flops, bytes_, peaks["f32_flops"],
                             peaks["hbm_bytes_per_s"])
    _say(f"pcg_xla n={n} iters={iters}: {secs * 1e3:.2f} ms, roofline "
         f"share {share:.3f} ({bound}-bound), residual {res:.1e}")
    if not np.isfinite(res) or res > 1e-2:
        raise SystemExit("PCG did not solve the SPD system")
    out["pcg"] = {"ms": secs * 1e3, "roofline": share}
    return out


def _top2_ref(d1, d2, v1, v2):
    """Brute-force integer top-2 in both directions (numpy).

    The dot products are integers below 2^23, computed exactly by a
    float64 matmul; results are returned as int64.  Invalid rows and
    columns score -1e9, as in the matcher.
    """
    import numpy as np

    big = -1e9
    dots = d1.astype(np.float64) @ d2.astype(np.float64).T
    dots[~v1, :] = big
    dots[:, ~v2] = big
    outs = []
    for axis in (1, 0):
        idx = np.argmax(dots, axis=axis)
        rows = np.arange(len(idx))
        at = (rows, idx) if axis == 1 else (idx, rows)
        best = dots[at]
        dots[at] = -np.inf
        second = dots.max(axis=axis)
        dots[at] = best
        outs += [best.astype(np.int64), second.astype(np.int64), idx]
    return outs


def check_matcher(peaks, n=8192, n_img=16) -> dict:
    """The XLA matcher at 8192 x 8192 over one scheduler chunk vs numpy."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np

    from privacy_preserving_sfm_tpu.features import matching, schedulers

    chunk = schedulers.pairs_per_dispatch(n)
    rng = np.random.default_rng(2)
    desc = rng.integers(0, 256, (n_img, n, 128), dtype=np.uint8)
    valid = np.ones((n_img, n), bool)
    valid[3, n // 2:] = False  # padded rows
    valid[7, n - 100:] = False
    desc[5, 10] = desc[6, 20]  # exact duplicates -> ties
    desc[6, 21] = desc[6, 20]
    pairs = np.stack([rng.permutation(n_img)[:2] for _ in range(chunk)])
    pairs[0] = (5, 6)
    pairs[1] = (3, 7)
    d, v, p = jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(pairs)

    top2 = jax.jit(lambda d, v, p: matching._top2_both_batched(
        d[p[:, 0]], d[p[:, 1]], v[p[:, 0]], v[p[:, 1]]))
    full = schedulers._matcher_fn(0.8, 0.7, True)
    compiled = full.lower(d, v, p).compile()
    m = compiled.memory_analysis()
    per_dot = (m.temp_size_in_bytes / (chunk * n * n)) if m else float("nan")
    _say(f"matcher chunk={chunk} pairs at {n}x{n}: {_mem(compiled)}; "
         f"temp bytes per dot-matrix element {per_dot:.2f}")
    secs, _ = _timed(compiled, d, v, p, reps=3)
    flops = 2.0 * n * n * 128 * chunk
    bytes_ = 3 * 4.0 * n * n * chunk  # write + two reads of the dots
    share, bound = _roofline(secs, flops, bytes_, peaks["tf32_flops"],
                             peaks["hbm_bytes_per_s"])
    _say(f"matcher: {secs * 1e3:.1f} ms per chunk = "
         f"{chunk / secs:.1f} pairs/s, roofline share {share:.3f} "
         f"({bound}-bound, TF32 peak)")
    got = [np.asarray(a) for a in top2(d, v, p)]
    with ThreadPoolExecutor(8) as pool:
        refs = list(pool.map(
            lambda ij: _top2_ref(desc[ij[0]], desc[ij[1]], valid[ij[0]],
                                 valid[ij[1]]), pairs))
    for b, ((i, j), ref) in enumerate(zip(pairs, refs)):
        for name, g, r in zip(("best12", "second12", "idx12", "best21",
                               "second21", "idx21"), got, ref):
            if not np.array_equal(g[b].astype(np.int64), r):
                bad = int(np.sum(g[b].astype(np.int64) != r))
                raise SystemExit(f"matcher pair {b} ({i},{j}): {name} "
                                 f"differs in {bad} rows")
    _say(f"matcher: best/second dots and indices exactly equal to the "
         f"integer brute force on all {chunk} pairs")
    return {"chunk": chunk, "ms": secs * 1e3, "roofline": share,
            "temp_bytes_per_dot": per_dot}


def _sift_batch_fn():
    import jax

    from privacy_preserving_sfm_tpu.features import extraction, sift

    opts = sift.SiftOptions()

    def one(key, img, params, grav):
        feats = sift.extract_sift(img.astype("float32") / 255.0, opts)
        lifted = extraction.lift_features(key, feats, "SIMPLE_PINHOLE",
                                          params, grav)
        return feats, lifted.lines

    return jax.jit(jax.vmap(one)), opts


def _match_keypoints(kg, vg, kc, vc):
    """Index of the CPU keypoint matching each valid GPU keypoint, or -1."""
    import numpy as np

    g = np.nonzero(vg)[0]
    c = np.nonzero(vc)[0]
    out = np.full(len(g), -1)
    if len(c) == 0:
        return g, out
    for s in range(0, len(g), 1024):
        a = kg[g[s:s + 1024]]
        dxy = np.hypot(a[:, None, 0] - kc[None, c, 0],
                       a[:, None, 1] - kc[None, c, 1])
        dang = np.abs(np.angle(np.exp(1j * (a[:, None, 3]
                                            - kc[None, c, 3]))))
        dscale = np.abs(a[:, None, 2] / np.maximum(kc[None, c, 2], 1e-9) - 1)
        cost = np.where((dxy <= 0.25) & (dang <= 0.05) & (dscale <= 0.02),
                        dxy, np.inf)
        j = np.argmin(cost, axis=1)
        ok = np.isfinite(cost[np.arange(len(j)), j])
        out[s:s + 1024] = np.where(ok, c[j], -1)
    return g, out


def check_sift(data: str, peaks, B=8) -> dict:
    """SIFT+lift batch (B=8, 640x480) on the GPU vs the same jitted
    function on the CPU backend."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from privacy_preserving_sfm_tpu.utils import png

    imgs = np.stack([png.read_png(os.path.join(data, f"img{i:03d}.png"))
                     for i in range(B)])
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    params = np.tile(np.asarray([400.0, 320.0, 240.0], np.float32), (B, 1))
    grav = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (B, 1))
    fn, opts = _sift_batch_fn()
    args = (keys, jnp.asarray(imgs), jnp.asarray(params), jnp.asarray(grav))
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    _say(f"sift+lift B={B} {imgs.shape[2]}x{imgs.shape[1]} (dense_half_res={opts.dense_half_res}, "
         f"dense_bf16={opts.dense_bf16}): compile {t_compile:.1f} s, "
         f"{_mem(compiled)}")
    secs, (fg, lines_g) = _timed(compiled, *args, reps=5)
    _say(f"sift+lift: {secs * 1e3:.1f} ms per batch = {B / secs:.1f} img/s")
    cpu = jax.devices("cpu")[0]
    fc, lines_c = fn(*[jax.device_put(a, cpu) for a in args])
    kg, vg, dg = (np.asarray(fg.keypoints), np.asarray(fg.valid),
                  np.asarray(fg.descriptors, np.float64))
    kc, vc, dc = (np.asarray(fc.keypoints), np.asarray(fc.valid),
                  np.asarray(fc.descriptors, np.float64))
    if not np.all(np.isfinite(np.asarray(lines_g)[vg])):
        raise SystemExit("non-finite lifted lines on the GPU")
    matched, total, cos_all = 0, 0, []
    for b in range(B):
        g, c = _match_keypoints(kg[b], vg[b], kc[b], vc[b])
        ok = c >= 0
        matched += int(ok.sum())
        total += max(len(g), int(vc[b].sum()))
        a, r = dg[b][g[ok]], dc[b][c[ok]]
        cos_all.append(np.sum(a * r, 1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(r, axis=1), 1e-9))
    cos = np.concatenate(cos_all)
    frac = matched / max(total, 1)
    med = float(np.median(cos)) if len(cos) else 0.0
    c95 = float(np.mean(cos >= 0.95)) if len(cos) else 0.0
    _say(f"sift vs CPU: {int(vg.sum())} GPU / {int(vc.sum())} CPU "
         f"keypoints, matched share {frac:.4f} (min {SIFT_MIN_MATCHED}), "
         f"descriptor cos median {med:.5f} (min {SIFT_MIN_MEDIAN_COS}), "
         f"share cos>=0.95 {c95:.4f} (min {SIFT_MIN_COS95})")
    if not (frac >= SIFT_MIN_MATCHED and med >= SIFT_MIN_MEDIAN_COS
            and c95 >= SIFT_MIN_COS95):
        raise SystemExit("SIFT GPU/CPU agreement outside tolerance")
    return {"compile_s": t_compile, "img_per_s": B / secs,
            "matched": frac, "cos_median": med}


def child_kernels(data: str):
    import jax

    sys.path.insert(0, ROOT)
    from privacy_preserving_sfm_tpu.utils.jax_setup import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    peaks = _peaks()
    result = {"device": jax.devices()[0].device_kind}
    result["ba"] = check_ba(peaks)
    result["gram"] = check_gram(peaks)
    result["matcher"] = check_matcher(peaks)
    result["sift"] = check_sift(data, peaks)
    _emit(result)


def _compile_seconds():
    """Register a listener that sums XLA compile, trace and lowering time."""
    import jax

    total = {"s": 0.0}

    def listen(event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            total["s"] += duration

    jax.monitoring.register_event_duration_secs_listener(listen)
    return total


def _evaluate(ws: str, data: str) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from evaluate import evaluate, read_gt_poses, read_model_poses

    model = os.path.join(ws, "sparse", "0")
    if not os.path.isdir(model):
        raise SystemExit("no model produced")
    rec, est = read_model_poses(model)
    rep = evaluate(est, read_gt_poses(os.path.join(data, "gt_poses.txt")))
    rep.pop("per_image")
    rep["mean_reproj_error"] = rec.compute_mean_reprojection_error()
    return rep


def _check_bounds(rep: dict):
    _say(f"registered {rep['num_registered']}/50 (min {MIN_REGISTERED}), "
         f"ATE RMSE {rep['ate_rmse']:.5f} (max {MAX_ATE}), mean rotation "
         f"error {rep['mean_rot_deg']:.4f} deg (max {MAX_ROT_DEG}), mean "
         f"point-to-line reprojection error "
         f"{rep['mean_reproj_error']:.4f} px")
    if not (rep["num_registered"] >= MIN_REGISTERED
            and rep["ate_rmse"] <= MAX_ATE
            and rep["mean_rot_deg"] <= MAX_ROT_DEG):
        raise SystemExit("box50 reconstruction outside its bounds")


def child_e2e(data: str):
    import jax

    from privacy_preserving_sfm_tpu.exe import ppsfm

    compile_s = _compile_seconds()
    phases = {}

    def timed_phase(name, fn):
        def run(args):
            c0, t0 = compile_s["s"], time.perf_counter()
            fn(args)
            phases[name] = {"seconds": time.perf_counter() - t0,
                            "compile_s": compile_s["s"] - c0}
        return run

    # automatic_reconstructor calls these by module-global name.
    for name in ("feature_extractor", "exhaustive_matcher", "mapper"):
        attr = f"cmd_{name}"
        setattr(ppsfm, attr, timed_phase(name, getattr(ppsfm, attr)))
    ws = os.path.join(OUT, "box50_ws")
    shutil.rmtree(ws, ignore_errors=True)
    t0 = time.perf_counter()
    ppsfm.main(["automatic_reconstructor", "--workspace_path", ws,
                "--image_path", data])
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", -1)
    for name, ph in phases.items():
        _say(f"{name}: {ph['seconds']:.1f} s, of which compile (set-up) "
             f"{ph['compile_s']:.1f} s")
    rep = _evaluate(ws, data)
    mapper_s = phases["mapper"]["seconds"]
    _say(f"total {wall:.1f} s; images registered/s "
         f"{rep['num_registered'] / mapper_s:.4f} (mapper phase, compile "
         f"included); peak_bytes_in_use {peak / 2**30:.2f} GiB")
    _check_bounds(rep)
    _emit({"phases": phases, "wall_s": wall, "peak_bytes_in_use": peak,
           "img_per_s": rep["num_registered"] / mapper_s,
           **{k: rep[k] for k in ("num_registered", "ate_rmse",
                                  "mean_rot_deg", "mean_reproj_error")}})


def child_dist_ba():
    """bundle_adjust_sharded over 4 GPUs vs the single-device solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, ROOT)
    import bench
    from privacy_preserving_sfm_tpu.optim import ba
    from privacy_preserving_sfm_tpu.parallel import distributed_ba

    opts = ba.BAOptions(max_iterations=40, cg_iterations=40,
                        function_tolerance=1e-10)
    problem = bench.build_problem(np.random.default_rng(0), jnp.float32,
                                  meas_noise=1e-3)
    t0 = time.perf_counter()
    _, _, _, s1 = jax.jit(lambda p: ba.bundle_adjust(
        p, "SIMPLE_PINHOLE", opts))(problem)
    c1 = float(s1.final_cost)
    t1 = time.perf_counter()
    mesh = distributed_ba.make_mesh(4)
    sharded, _ = distributed_ba.shard_problem(problem, 4)
    _, _, _, s4 = jax.jit(lambda p: distributed_ba.bundle_adjust_sharded(
        p, mesh, "SIMPLE_PINHOLE", opts))(sharded)
    c4 = float(s4.final_cost)
    t2 = time.perf_counter()
    rel = abs(c4 - c1) / abs(c1)
    _say(f"distributed BA over {mesh.devices.size} GPUs: final cost "
         f"{c4:.6e} ({int(s4.num_iterations)} iters, {t2 - t1:.1f} s incl. "
         f"compile) vs single device {c1:.6e} ({int(s1.num_iterations)} "
         f"iters, {t1 - t0:.1f} s incl. compile): rel {rel:.2e} "
         f"(limit {BA_RTOL})")
    if not rel <= BA_RTOL:
        raise SystemExit("sharded BA disagrees with the single-device solve")
    _emit({"cost_1": c1, "cost_4": c4, "rel": rel})


def child_hier(data: str):
    """Extract + match on one card, then the 4-worker hierarchical mapper
    (its own process: the pool's parent touches no device)."""
    ws = os.path.join(OUT, "box50_hier")
    shutil.rmtree(ws, ignore_errors=True)
    os.makedirs(ws)
    db = os.path.join(ws, "database.db")
    cli = [sys.executable, "-m", "privacy_preserving_sfm_tpu.exe"]
    steps = [
        ["feature_extractor", "--database_path", db, "--image_path", data,
         "--max_image_size", "3200", "--max_num_features", "8192"],
        ["exhaustive_matcher", "--database_path", db],
        ["hierarchical_mapper", "--database_path", db, "--output_path",
         os.path.join(ws, "sparse"), "--num_workers", "4", "--block_size",
         "15", "--overlap", "5"],
    ]
    for step in steps:
        t0 = time.perf_counter()
        r = subprocess.run(cli + step, cwd=ROOT, capture_output=True,
                           text=True)
        print(r.stdout[-4000:], r.stderr[-4000:])
        _say(f"{step[0]}: rc {r.returncode} in "
             f"{time.perf_counter() - t0:.1f} s")
        if r.returncode != 0:
            raise SystemExit(f"{step[0]} failed")
    rep = _evaluate(ws, data)
    _check_bounds(rep)
    _emit({k: rep[k] for k in ("num_registered", "ate_rmse",
                               "mean_rot_deg", "mean_reproj_error")})


CHILDREN = {
    "device": child_device, "render": child_render, "tests": child_tests,
    "kernels": child_kernels, "ba_ref": child_ba_ref, "e2e": child_e2e,
    "dist_ba": child_dist_ba, "hier": child_hier,
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths")
    ap.add_argument("--child", choices=sorted(CHILDREN),
                    help=argparse.SUPPRESS)
    ap.add_argument("rest", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, ROOT)
        CHILDREN[args.child](*args.rest)
    else:
        parent(args.four)


if __name__ == "__main__":
    main()
