"""Multi-host (multi-process) runtime for the distributed pipeline.

The reference is strictly single-process (SURVEY.md §2.3); the accelerator
design scales across hosts with ``jax.distributed``: every process owns a
slice of the global device mesh, point/observation shards live on local
devices, and the per-CG-step camera psums ride NVLink within a host (the
network only between hosts).  This module provides:

  * ``initialize_from_env()`` — one-call ``jax.distributed.initialize``
    driven by environment variables (coordinator/world-size/rank), with
    sensible torchrun/JAX-style fallbacks;
  * ``global_mesh()`` — a 1-D mesh over ALL processes' devices;
  * ``make_global_problem()`` — lift a host-replicated (numpy) sharded
    ``BAProblem`` (from ``distributed_ba.shard_problem``) into global
    jax.Arrays with the right ``NamedSharding``s, each process providing
    only its addressable shards;
  * ``gather_points()`` — collect the sharded point output back to every
    host after a solve.

Tested by ``tests/test_multihost.py``, which spawns 2 real processes with
4 virtual CPU devices each and asserts the distributed result matches the
single-process solver.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or environment.

    Environment: ``PPSFM_COORDINATOR`` (host:port), ``PPSFM_NUM_PROCESSES``,
    ``PPSFM_PROCESS_ID``.  Returns True when running multi-process.
    """
    import jax

    coordinator = coordinator or os.environ.get("PPSFM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PPSFM_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PPSFM_PROCESS_ID", "0"))
    if not coordinator or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id)
    return True


def global_mesh(axis: str = "shard"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def _make_global(x: np.ndarray, mesh, spec):
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: np.asarray(x[idx]))


def make_global_problem(sharded, mesh, axis: str = "shard"):
    """Host-replicated sharded BAProblem -> global jax.Arrays.

    ``sharded`` must come from ``distributed_ba.shard_problem`` with
    ``n_shards == mesh.size`` so the leading axis of each point/obs array
    splits evenly over the mesh.  Every process must hold the same numpy
    content (the SfM host state is replicated across hosts).
    """
    from jax.sharding import PartitionSpec as P

    from privacy_preserving_sfm_tpu.optim import ba as ba_mod

    rep = P()
    shard = P(axis)
    return ba_mod.BAProblem(
        qvecs=_make_global(np.asarray(sharded.qvecs), mesh, rep),
        tvecs=_make_global(np.asarray(sharded.tvecs), mesh, rep),
        cam_params=_make_global(np.asarray(sharded.cam_params), mesh, rep),
        points3d=_make_global(np.asarray(sharded.points3d), mesh, shard),
        obs_cam=_make_global(np.asarray(sharded.obs_cam), mesh, shard),
        obs_point=_make_global(np.asarray(sharded.obs_point), mesh, shard),
        obs_line=_make_global(np.asarray(sharded.obs_line), mesh, shard),
        obs_weight=_make_global(np.asarray(sharded.obs_weight), mesh, shard),
        cam_dof_mask=_make_global(np.asarray(sharded.cam_dof_mask), mesh,
                                  rep),
        point_mask=_make_global(np.asarray(sharded.point_mask), mesh, shard),
    )


def gather_points(X) -> np.ndarray:
    """All-gather a point-sharded solve output to host numpy (every host)."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(X)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(X, tiled=True))
