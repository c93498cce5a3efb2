"""Per-stage profile of the SIFT+lift front-end on the GPU.

Times, with in-jit repeat loops (amortizing per-call launch overhead):
  pyramid   — Gaussian pyramid + DoG for every octave
  extrema   — reduce-window extrema + subpixel refinement (all octaves)
  dense     — dense-conv orientation + descriptor stage (all octaves)
  full      — extract_and_lift (single image) and the B=8 batch, with the
              B=8 batch's cold compile time

``--plan f32`` turns off the half-resolution and bf16 dense-stage plan
(``SiftOptions.dense_half_res`` / ``dense_bf16``) to compare the two.
Reference regime: ``src/feature/sift.cc:399-545`` of the reference.

Usage: python tools/profile_sift.py [--size 640x480] [--loop 8]
       [--plan default|f32]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def timed(fn, *args, loop=1, warm=1):
    import jax
    for _ in range(warm):
        out = fn(*args)
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="640x480")
    ap.add_argument("--loop", type=int, default=8)
    ap.add_argument("--plan", choices=["default", "f32"], default="default")
    args = ap.parse_args()

    import bench

    platform, kind, _ = bench.require_gpu()
    import jax
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.features import extraction, sift
    from privacy_preserving_sfm_tpu.utils.jax_setup import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    w, h = (int(v) for v in args.size.split("x"))
    print(f"device: {kind}  image {w}x{h}  plan {args.plan}", flush=True)

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((h, w)), jnp.float32)
    opts = sift.SiftOptions()
    if args.plan == "f32":
        opts = opts._replace(dense_half_res=False, dense_bf16=False)
    L = args.loop

    def loopify(stage_fn):
        """Run stage_fn L times inside one jit with a data perturbation."""
        def run(x):
            def body(i, acc):
                out = stage_fn(x + acc * 1e-12)
                return acc + jax.tree_util.tree_reduce(
                    lambda a, b: a + jnp.sum(b.astype(jnp.float32)) * 0.0,
                    out, jnp.float32(0)) + 1.0
            return jax.lax.fori_loop(0, L, body, jnp.float32(0))
        return jax.jit(run)

    # -- stage: pyramid+DoG over all octaves ------------------------------
    def pyramid_all(x):
    # mirrors extract_sift's octave loop heads (sift.py: _octave_pyramid)
        outs = []
        base = sift._upsample2(x) if opts.first_octave < 0 else x
        oc = base
        for _ in range(opts.num_octaves):
            gauss, dog = sift._octave_pyramid(oc, opts)
            outs.append(dog)
            oc = sift._downsample2(gauss[opts.octave_resolution])
        return outs

    t = timed(loopify(pyramid_all), img, loop=L)
    print(f"pyramid+dog (all octaves): {t*1e3:8.2f} ms", flush=True)

    # -- stage: extrema + refine ------------------------------------------
    def extrema_all(x):
        outs = []
        base = sift._upsample2(x) if opts.first_octave < 0 else x
        oc = base
        for oi in range(opts.num_octaves):
            gauss, dog = sift._octave_pyramid(oc, opts)
            outs.append(sift._octave_candidates(
                dog, opts, jnp.float32,
                sift._octave_budget(opts, oi)))
            oc = sift._downsample2(gauss[opts.octave_resolution])
        return outs

    t2 = timed(loopify(extrema_all), img, loop=L)
    print(f"  + extrema+refine:        {t2*1e3:8.2f} ms "
          f"(delta {(t2-t)*1e3:.2f})", flush=True)

    # -- stage: full single-image SIFT ------------------------------------
    full = jax.jit(lambda x: sift.extract_sift(x, opts))
    t3 = timed(full, img, loop=1)
    print(f"full extract_sift:         {t3*1e3:8.2f} ms "
          f"(dense stage+topk delta {(t3-t2/1)*1e3:.2f})", flush=True)

    # -- full front-end (extract + lift), single and batch ----------------
    key = jax.random.PRNGKey(0)
    params = jnp.asarray([500.0, w / 2, h / 2])
    grav = jnp.asarray([0.0, 1.0, 0.0])
    t4 = timed(lambda k, x: extraction.extract_and_lift_jit(
        k, x, "SIMPLE_PINHOLE", params, grav, opts), key, img, loop=1)
    print(f"extract_and_lift (1 img):  {t4*1e3:8.2f} ms", flush=True)

    B = 8
    keys = jax.random.split(key, B)
    imgs = jnp.stack([img] * B)
    paramsB = jnp.stack([params] * B)
    gravB = jnp.stack([grav] * B)
    t0 = time.perf_counter()
    jax.block_until_ready(extraction.extract_and_lift_batch_jit(
        keys, imgs, "SIMPLE_PINHOLE", paramsB, gravB, opts).lines)
    print(f"extract_and_lift (B=8) first call (compile): "
          f"{time.perf_counter() - t0:8.1f} s", flush=True)
    t5 = timed(lambda k, x: extraction.extract_and_lift_batch_jit(
        k, x, "SIMPLE_PINHOLE", paramsB, gravB, opts), keys, imgs, loop=1)
    print(f"extract_and_lift (B=8):    {t5*1e3:8.2f} ms  "
          f"=> {B/t5:6.2f} img/s", flush=True)


if __name__ == "__main__":
    main()
