"""Block-parallel (hierarchical) mapper: the images-registered/s scale axis.

Upstream COLMAP ships a HierarchicalMapper (scene clustering -> SfM per
cluster -> model merging); the privacy-preserving fork removed it and
reconstructs strictly sequentially
(``/root/reference/src/controllers/incremental_mapper.cc:382-591``), so its
images-registered/s is bounded by one registration at a time.  An
accelerator deployment scales out differently: partition the collection
into blocks with shared anchor images, reconstruct every block *in
parallel* (one block per worker process, each worker on a GPU of its
own), then chain-merge:

  1. ``partition_sequential``: contiguous blocks with ``overlap`` shared
     images (sequential capture order — the reference's own sequential
     matcher assumption, ``feature/matching.h:279-310``);
  2. per-block incremental reconstruction with the proven controller,
     restricted via ``DatabaseCache.load(image_names=...)``;
  3. ``merge_into``: Umeyama similarity on shared camera centers (block 0
     fixes the gauge), pose copy for new images, track union keyed on
     shared (image, line) observations — a line observes at most one 3D
     point, so shared observations define the track correspondence;
  4. one joint iterative global refinement (complete/merge/BA/filter) on
     the merged model over the FULL correspondence graph, which also
     triangulates the cross-block tracks the blocks could not see.

Privacy note: blocks only ever see lifted lines (never keypoints), so the
parallel split does not change the privacy surface.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from privacy_preserving_sfm_tpu.utils import gpu_workers
from privacy_preserving_sfm_tpu.models.database import Database
from privacy_preserving_sfm_tpu.models.database_cache import DatabaseCache
from privacy_preserving_sfm_tpu.models.reconstruction import Reconstruction
from privacy_preserving_sfm_tpu.sfm.controller import (
    ControllerOptions, IncrementalMapperController,
)
from privacy_preserving_sfm_tpu.sfm.incremental_mapper import (
    IncrementalMapper,
)


def partition_sequential(names: Sequence[str], block_size: int,
                         overlap: int) -> List[List[str]]:
    """Contiguous blocks over name-sorted images with ``overlap`` shared."""
    if block_size <= overlap:
        raise ValueError("block_size must exceed overlap")
    names = sorted(names)
    n = len(names)
    blocks: List[List[str]] = []
    start = 0
    while True:
        end = min(start + block_size, n)
        blocks.append(list(names[start:end]))
        if end >= n:
            break
        start = end - overlap
    return blocks


def umeyama(src: np.ndarray, dst: np.ndarray) -> Tuple[float, np.ndarray,
                                                       np.ndarray]:
    """Similarity (s, R, t) with dst ~= s * R @ src + t (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-30))
    t = mu_d - s * R @ mu_s
    return s, R, t


def reconstruct_block(database_path: str, image_names: Sequence[str],
                      options: ControllerOptions) -> Optional[Reconstruction]:
    """Run the incremental controller restricted to ``image_names``."""
    with Database(database_path) as db:
        cache = DatabaseCache.load(db, options.min_num_matches,
                                   image_names=set(image_names))
        aligned_names = {img.name for img in cache.images.values()
                         if img.aligned.any()}
        aligned = DatabaseCache.load(db, 4, image_names=aligned_names)
    ctrl = IncrementalMapperController(options, database_cache=cache,
                                       aligned_cache=aligned)
    recs = ctrl.run()
    if not recs:
        return None
    return max(recs, key=lambda r: r.num_registered())


def _block_worker(args) -> Optional[dict]:
    """Process-pool entry: reconstruct one block, return poses + tracks.

    Returns a plain-dict snapshot (picklable) instead of the full
    Reconstruction: per registered image (qvec, tvec) and per point
    (xyz, track).
    """
    database_path, image_names, options, platform = args
    if platform:
        import os

        if platform == "cpu" and "PPSFM_WORKER_THREADS" in os.environ:
            # Parallel CPU workers oversubscribe the host unless each
            # XLA:CPU client is capped (4 workers x all-cores Eigen pools
            # thrash a 4-core host).  Must be set before jax imports.
            n = os.environ["PPSFM_WORKER_THREADS"]
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_cpu_multi_thread_eigen={'false' if n == '1' else 'true'}"
                  f" intra_op_parallelism_threads={n}")
        import jax

        jax.config.update("jax_platforms", platform)
    rec = reconstruct_block(database_path, image_names, options)
    if rec is None:
        return None
    return snapshot_model(rec)


def snapshot_model(rec: Reconstruction) -> dict:
    return {
        "poses": {int(iid): (np.array(rec.images[iid].qvec),
                             np.array(rec.images[iid].tvec))
                  for iid in rec.reg_image_ids},
        "points": [(np.array(pt.xyz), [(int(i), int(l)) for i, l in pt.track])
                   for pt in rec.points3d.values()],
    }


def merge_into(dst: Reconstruction, snap: dict,
               min_common: int = 3) -> bool:
    """Merge a block snapshot into ``dst`` (gauge of ``dst`` wins).

    Alignment uses camera centers of the images registered in both; new
    images copy their (similarity-mapped) block pose; tracks sharing a
    (image, line) observation with an existing dst point merge into it.
    """
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = snap["poses"]
    shared = [iid for iid in poses
              if iid in dst.images and dst.images[iid].registered]

    if dst.num_registered() == 0:
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    else:
        if len(shared) < min_common:
            return False
        from privacy_preserving_sfm_tpu.ops import lie_np

        def center(q, tv):
            Rm = lie_np.quat_to_rotmat(q)
            return -Rm.T @ tv

        src_c = np.stack([center(*poses[i]) for i in shared])
        dst_c = np.stack([dst.images[i].projection_center()
                          for i in shared])
        s, R, t = umeyama(src_c, dst_c)

    from privacy_preserving_sfm_tpu.ops import lie_np

    for iid, (q, tv) in poses.items():
        if iid not in dst.images or dst.images[iid].registered:
            continue  # dst pose wins on shared images
        # World map x' = s R x + t; camera x_c = Rc x + tc becomes
        # Rc' = Rc R^T, tc' = s tc - Rc' t  (same algebra as
        # Reconstruction.transform).
        Rc = lie_np.quat_to_rotmat(q)
        Rc_new = Rc @ R.T
        img = dst.images[iid]
        img.qvec = lie_np.rotmat_to_quat(Rc_new)
        img.tvec = s * tv - Rc_new @ t
        dst.register_image(iid)

    n_merged = n_new = 0
    for xyz, track in snap["points"]:
        track = [(i, l) for i, l in track
                 if i in dst.images and dst.images[i].registered]
        if len(track) < 2:
            continue
        target = -1
        for i, l in track:
            pid = int(dst.images[i].point3d_ids[l])
            if pid >= 0:
                target = pid
                break
        if target < 0:
            free = [(i, l) for i, l in track
                    if dst.images[i].point3d_ids[l] < 0]
            if len(free) >= 2:
                dst.add_point3d(s * (R @ xyz) + t, free)
                n_new += 1
        else:
            for i, l in track:
                if dst.images[i].point3d_ids[l] < 0:
                    dst.add_observation(target, i, l)
            n_merged += 1
    return True


@dataclasses.dataclass
class HierarchicalOptions:
    block_size: int = 30
    overlap: int = 5
    num_workers: int = 1
    min_common: int = 3
    controller: ControllerOptions = dataclasses.field(
        default_factory=ControllerOptions)


def hierarchical_map(database_path: str,
                     options: HierarchicalOptions,
                     platform: Optional[str] = None,
                     verbose: bool = True) -> Optional[Reconstruction]:
    """Partition -> parallel block SfM -> chain merge -> joint refinement."""

    def log(msg):
        if verbose:
            print(msg, flush=True)

    ctrl_opts = dataclasses.replace(
        options.controller,
        # One model per block: the chain merge needs each block to commit
        # to its largest model, and block-local "multiple models" would
        # fragment the anchors.
        multiple_models=False,
        min_model_size=min(options.controller.min_model_size,
                           max(4, options.block_size // 2)))

    with Database(database_path) as db:
        names = sorted(v["name"] for v in db.read_images().values())
    blocks = partition_sequential(names, options.block_size, options.overlap)
    log(f"Hierarchical mapper: {len(names)} images -> {len(blocks)} blocks "
        f"(size {options.block_size}, overlap {options.overlap}, "
        f"{options.num_workers} workers)")

    jobs = [(database_path, blk, ctrl_opts, platform) for blk in blocks]
    if options.num_workers > 1:
        import multiprocessing as mp

        # One card per worker, pinned before the worker imports JAX; this
        # process touches no device until the pool has closed.
        cards = gpu_workers.assign_gpus(options.num_workers, platform)
        ctx = mp.get_context("spawn")
        card_queue = ctx.Queue()
        for card in cards:
            card_queue.put(card)
        with ctx.Pool(options.num_workers,
                      initializer=gpu_workers.pin_worker_gpu,
                      initargs=(card_queue,)) as pool:
            snaps = pool.map(_block_worker, jobs)
    else:
        snaps = [_block_worker(j) for j in jobs]

    ok = [i for i, s in enumerate(snaps) if s is not None]
    log(f"  => {len(ok)}/{len(blocks)} blocks reconstructed")
    if not ok:
        return None

    with Database(database_path) as db:
        full_cache = DatabaseCache.load(
            db, options.controller.min_num_matches)
    merged = full_cache.to_reconstruction()
    for img in merged.images.values():
        img.registered = False
        img.point3d_ids = np.full(img.num_lines, -1, np.int64)
    merged.reg_image_ids = []

    # Chain-merge in block order; retry skipped blocks once at the end
    # (a later block can supply the anchors an earlier skip was missing).
    pending = [snaps[i] for i in ok]
    for attempt in range(2):
        rest = []
        for snap in pending:
            if not merge_into(merged, snap, options.min_common):
                rest.append(snap)
        pending = rest
        if not pending:
            break
    if pending:
        log(f"  => WARNING: {len(pending)} block(s) had <"
            f"{options.min_common} shared registered images; dropped")

    log(f"  => Merged model: {merged.num_registered()} images, "
        f"{len(merged.points3d)} points")

    # Joint refinement over the full correspondence graph: completes the
    # cross-block tracks, then global BA + filtering (the controller's
    # IterativeGlobalRefinement semantics).
    mapper = IncrementalMapper(full_cache)
    mapper.begin_reconstruction(merged)
    ctrl = IncrementalMapperController(
        dataclasses.replace(options.controller, verbose=verbose),
        database_cache=full_cache)
    ctrl.iterative_global_refinement(mapper)
    mapper.end_reconstruction(discard=False)
    log(f"  => Refined model: {merged.num_registered()} images, "
        f"{len(merged.points3d)} points, mean reproj "
        f"{merged.compute_mean_reprojection_error():.3f}px")
    return merged
