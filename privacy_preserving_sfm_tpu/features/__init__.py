"""Feature front-end: SIFT extraction, line lifting, descriptor matching.

Replaces the reference's VLFeat/SiftGPU extraction kernels and FLANN
matcher (``src/feature/``, ``lib/VLFeat``, ``lib/SiftGPU``, ``lib/FLANN``)
with batched XLA kernels: the descriptor matcher is an exact top-2 over a
dense matmul (no approximate kd-trees needed at SfM scales), and SIFT is a
fixed-shape Gaussian-pyramid pipeline with top-k extrema selection.
"""

from privacy_preserving_sfm_tpu.features import matching  # noqa: F401
from privacy_preserving_sfm_tpu.features import sift  # noqa: F401
