"""Optimization: point-to-line bundle adjustment (Levenberg-Marquardt).

Replaces the reference's Ceres-based ``BundleAdjuster``
(``src/optim/bundle_adjustment.{h,cc}``) with an accelerator-native implicit
Schur-complement LM: the point blocks are eliminated analytically and the
reduced camera system is solved with Schur-Jacobi-preconditioned CG, all as
segment reductions over a flat observation array — one jitted kernel for
every problem size (the reference switches DENSE/SPARSE/ITERATIVE_SCHUR by
image count, ``bundle_adjustment.cc:276-286``).
"""

from privacy_preserving_sfm_tpu.optim import ba  # noqa: F401
