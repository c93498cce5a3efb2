"""Process-level JAX configuration helpers.

The incremental pipeline compiles a bounded family of bucketed kernels
(init, P6L, triangulation, BA); with XLA's persistent compilation cache
enabled those compiles happen once per checkout instead of once per
process.  Called by the CLI entry point, the benchmark and the test
harness.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def accelerator() -> str:
    """The one device decision of the program: ``"gpu"`` or ``"cpu"``.

    Read from ``jax.devices()[0].platform``.  Every solver and kernel
    choice that depends on the device goes through this function; any
    other platform is an error rather than a silent default.
    """
    import jax

    platform = jax.devices()[0].platform
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: this program runs on "
            "an NVIDIA GPU ('gpu') or on the CPU ('cpu')")
    return platform


def _machine_tag() -> str:
    """Short fingerprint of the host CPU feature set + effective ISA cap.

    XLA:CPU persists AOT executables specialized to the compile host's
    ISA features; loading them on a machine with a different feature set
    crashes.  Scoping the CPU cache directory by this tag makes stale
    cross-machine entries unreachable.  The ``--xla_cpu_max_isa`` cap
    (the AVX512 miscompile mitigation, reports/sift_segv_r5.md) changes
    the generated code too, so it joins the fingerprint.
    """
    import hashlib

    isa = ""
    for tok in os.environ.get("XLA_FLAGS", "").split():
        if "xla_cpu_max_isa" in tok:
            isa = tok.split("=")[-1]
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return hashlib.sha1(
                        (" ".join(sorted(line.split()[2:])) + isa)
                        .encode()).hexdigest()[:10]
    except OSError:
        pass
    import platform

    return platform.machine() + isa


def cache_dir() -> str:
    """Where the persistent compile cache lives.

    ``$JAX_COMPILATION_CACHE_DIR`` when it is set; otherwise the fixed,
    git-ignored ``<checkout>/.jax_cache``.  Processes pinned to the CPU
    backend (``JAX_PLATFORMS=cpu``) use a subdirectory keyed by the
    host's CPU features, jaxlib version and x64 flag.  Decided from the
    configuration alone: this must not initialize a device, because a
    parent that opens the GPU before spawning per-card workers would
    hold three quarters of card 0's memory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    import jaxlib

    if (jax.config.jax_platforms or "").strip() == "cpu":
        x64 = "x64" if jax.config.jax_enable_x64 else "x32"
        return os.path.join(
            DEFAULT_CACHE_DIR,
            f"cpu_{_machine_tag()}_{jaxlib.__version__}_{x64}")
    return DEFAULT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Enable XLA's persistent compile cache at ``cache_dir()``.

    Where ``$JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    no other directory is configured here.  Thresholds sit at JAX's
    default minimum compile time (1.0 s): tiny entries cost more in reads
    than they save in compiles.
    """
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
