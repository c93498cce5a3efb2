"""Robust estimation: vectorized RANSAC harness + minimal solvers.

The reference's RANSAC templates (``src/optim/ransac.h``, ``loransac.h``,
RansacLib's LO-MSAC) run a *sequential adaptive* hypothesis loop.  On an accelerator we
invert the structure: draw a fixed batch of B hypotheses, vmap the minimal
solver over them, score all N residuals per hypothesis with one reduction,
and argmax — the adaptive trial bound becomes a between-batch early-exit on
the host (see ``ransac.py``).
"""

from privacy_preserving_sfm_tpu.solvers import ransac  # noqa: F401
from privacy_preserving_sfm_tpu.solvers import p6l  # noqa: F401
