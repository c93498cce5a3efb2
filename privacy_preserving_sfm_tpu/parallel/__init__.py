"""Multi-chip scaling: sharded matching and distributed bundle adjustment.

The reference is single-process (``src/util/threading.h`` thread pools; no
MPI/NCCL anywhere — SURVEY.md §2.3).  This package *creates* the
distributed capability the multi-GPU build needs (BASELINE.json north star):

  * matching sharded over image pairs (pure map over a mesh axis),
  * distributed BA: tracks/points partitioned across devices so point
    marginalization is local, the reduced camera system is ``psum``-reduced
    over NVLink, and the (small, replicated) camera CG solve runs everywhere —
    replacing Ceres' shared-memory SPARSE_SCHUR with XLA collectives.
"""

from privacy_preserving_sfm_tpu.parallel import distributed_ba  # noqa: F401
from privacy_preserving_sfm_tpu.parallel import sharded_matching  # noqa: F401
