"""Distributed-BA scaling benchmark (BASELINE config 5 evidence).

Runs the point-sharded / camera-psum distributed LM BA
(``parallel/distributed_ba.py``) on a virtual device mesh at 1/2/4/8
devices and reports throughput + the per-iteration collective volume.

On a CPU host the virtual devices share the same cores, so wall-clock
does NOT speed up with the mesh — the value of the CPU run is (a)
correctness of the sharded kernel at every mesh size and (b) the
measured collective volume, which is what determines real multi-chip
scaling: per CG step the only cross-device traffic is a psum of
(C, 6) f32 camera vectors + a handful of scalars, i.e. ~24*C bytes —
independent of points/observations.  Over NVLink (450 GB/s each way per
H100, published) a C=1000-camera psum is well under a microsecond of
wire time against milliseconds of local point-elimination work per LM
iteration: compute-bound scaling until the camera system itself
saturates a card.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/scaling_bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import bench
    from privacy_preserving_sfm_tpu.optim import ba as ba_mod
    from privacy_preserving_sfm_tpu.parallel import distributed_ba as dba

    rng = np.random.default_rng(0)
    problem = bench.build_problem(rng, jnp.float32)
    num_obs = int(np.sum(np.asarray(problem.obs_weight) > 0))
    C = problem.qvecs.shape[0]
    opts = ba_mod.BAOptions(max_iterations=10, cg_iterations=30,
                            function_tolerance=0.0)

    results = {}
    final_costs = {}
    initial_cost = None
    for n_dev in (1, 2, 4, 8):
        mesh = dba.make_mesh(n_dev)
        sharded, meta = dba.shard_problem(problem, n_dev)
        q, t, X, summary = dba.bundle_adjust_sharded(
            sharded, mesh, "SIMPLE_PINHOLE", opts)  # compile+run
        jax.block_until_ready(X)
        iters = int(summary.num_iterations)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = dba.bundle_adjust_sharded(
                sharded, mesh, "SIMPLE_PINHOLE", opts)
            jax.block_until_ready(out[2])
            times.append(time.perf_counter() - t0)
        results[n_dev] = num_obs * iters / min(times)
        final_costs[n_dev] = float(summary.final_cost)
        initial_cost = float(summary.initial_cost)

    # Every mesh size must make the same optimization progress.  Bitwise
    # trajectories diverge across mesh sizes (different psum reduction
    # orders flip individual LM accept decisions mid-run), so the gate is
    # convergence, not equality; exact agreement at convergence is
    # asserted by tests/test_parallel.py.
    costs = list(final_costs.values())
    rel_spread = (max(costs) - min(costs)) / max(abs(costs[0]), 1e-30)
    psum_bytes_per_cg_step = 24 * C  # (C, 6) f32 camera vector

    print(json.dumps({
        "metric": "distributed_ba_obs_iters_per_s",
        "unit": "obs*iter/s (virtual CPU mesh: correctness + structure, "
                "not wall-clock scaling)",
        "by_devices": results,
        "final_cost_rel_spread": rel_spread,
        "psum_bytes_per_cg_step": psum_bytes_per_cg_step,
        "collective_note": "per-CG-step cross-device traffic is one "
                           "(C,6) f32 psum, independent of P/obs",
    }))
    for n_dev, c in final_costs.items():
        assert c < 0.05 * initial_cost, (
            f"{n_dev}-device mesh failed to optimize: {c} vs {initial_cost}")


if __name__ == "__main__":
    main()
