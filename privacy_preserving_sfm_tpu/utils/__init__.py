"""Runtime utilities: configuration, timing, logging, device setup.

Counterpart of ``src/util/`` minus what JAX/Python already provide
(threading pools, PRNG wrappers, OpenGL plumbing).  Submodules are
imported on their own: ``png``, ``jax_setup`` and ``gpu_workers`` must
stay importable without JAX.
"""
