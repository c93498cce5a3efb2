"""Privacy-preserving Structure-from-Motion in JAX, for NVIDIA GPUs.

A brand-new JAX/XLA implementation of the privacy-preserving SfM
pipeline (Geppert et al., ECCV 2020): SIFT keypoints are lifted to random 2D
lines (half gravity-aligned) so that a processing server never observes point
locations; every downstream stage — matching, minimal pose solvers,
triangulation, bundle adjustment — operates on point-to-line constraints
``l . (P X) = 0``.

Architecture: functional core / thin shell.  All geometry and solver code is
pure jitted JAX over fixed-shape batched arrays; RANSAC is vectorized
(B parallel hypotheses scored with one masked reduction); the incremental-SfM
control flow lives on host and calls device kernels.  Multi-chip scaling uses
``jax.sharding`` meshes with XLA collectives (see ``parallel/``).

Reference behavioral spec: colmap/privacy_preserving_sfm (C++/Ceres), see
SURVEY.md at the repo root for the full component inventory and thresholds.
"""

__version__ = "0.1.0"
