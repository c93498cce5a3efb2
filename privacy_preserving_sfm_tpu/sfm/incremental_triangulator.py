"""Incremental triangulator: Find/Create/Continue/Merge/Complete.

Host-side port of ``src/sfm/incremental_triangulator.{h,cc}`` driving the
batched device kernels in ``solvers/triangulation`` and ``ops/lines``:

  * ``Create``: needs >= 3 untriangulated observations AND >= 1 random
    (non-aligned) line (``incremental_triangulator.cc:480-514``); robust
    angular-error LORANSAC with exhaustive C(n,3) sampling for pools <= 15;
    recursive re-create on >= 3 leftovers (``:555-558``);
  * ``Continue``: attach to the best existing point by angular error
    <= continue_max_angle_error (``:563-604``);
  * ``Merge``: weighted-centroid merge accepted only when ALL observations
    of both tracks pass the pixel line reprojection error, recursive
    (``:606-695``);
  * ``Complete``: transitive BFS growth (<= complete_max_transitivity hops)
    by pixel line error (``:697-765``);
  * ``CompleteImage``: additionally re-tries untriangulated observations
    with a pixel-residual LORANSAC (``:124-236``).

Options defaults = ``incremental_triangulator.h:47-90``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.models.correspondence_graph import (
    CorrespondenceGraph,
)
from privacy_preserving_sfm_tpu.models.reconstruction import Reconstruction
from privacy_preserving_sfm_tpu.ops import lines as line_ops
from privacy_preserving_sfm_tpu.solvers import triangulation as tri_est
from privacy_preserving_sfm_tpu.solvers import triangulation_batch as tri_batch

MAX_POOL = 24  # overall observation cap for the jitted estimator
# Pool-size buckets for the batch solver: a pool of n observations runs at
# the smallest bucket >= n, paying C(bucket, 3) hypotheses (<= 512 sampled
# at bucket 24) instead of a fixed C(24,3) = 2024.
N_BUCKETS = (4, 9, 24)
T_CHUNK = 1024  # max tracks per device call (bounds padded device-memory temps)


def _bucket_t(n: int, minimum: int = 128) -> int:
    # Coarse x4 grid: every (T, N) shape pair is a separate trace +
    # compile or compile-cache load (seconds); the padded hypothesis
    # scoring it avoids is cheap dense work (see _solve_pools).
    b = minimum
    while b < n:
        b *= 4
    return b


@dataclasses.dataclass
class TriangulatorOptions:
    max_transitivity: int = 1
    create_max_angle_error: float = 2.0  # degrees
    continue_max_angle_error: float = 2.0  # degrees
    merge_max_reproj_error: float = 4.0  # pixels
    complete_max_reproj_error: float = 4.0  # pixels
    complete_max_transitivity: int = 5
    re_max_angle_error: float = 5.0
    re_min_ratio: float = 0.2
    re_max_trials: int = 1
    min_angle: float = 1.5  # degrees
    ignore_two_view_tracks: bool = True
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0


class IncrementalTriangulator:
    def __init__(self, graph: CorrespondenceGraph, rec: Reconstruction,
                 view=None):
        self.graph = graph
        self.rec = rec
        self.view = view  # optional models.graph_view.GraphView fast path
        self.modified_point3d_ids: Set[int] = set()
        self._merge_trials: Dict[int, Set[int]] = {}
        self._jit_cache: Dict[Tuple, callable] = {}
        self._two_view_cache: Dict[int, np.ndarray] = {}
        self._phase_times: Dict[str, float] = {}

    def _tick(self, name: str, t0: float) -> float:
        """Accumulate wall time into the sub-phase profile; returns now."""
        import time as _time
        now = _time.perf_counter()
        self._phase_times[name] = self._phase_times.get(name, 0.0) \
            + (now - t0)
        return now

    # -- vectorized graph helpers ---------------------------------------

    def _corrs(self, image_id: int, line_idx: int):
        """Correspondences of one feature, CSR fast path when available."""
        view = self.view
        if view is not None and image_id in view.dense:
            f = int(view.feat_offset[view.dense[image_id]]) + line_idx
            a, b = view.row_offsets[f], view.row_offsets[f + 1]
            return [(int(view.image_id_arr[view.corr_img_dense[j]]),
                     int(view.corr_line[j])) for j in range(a, b)]
        return self.graph.find_correspondences(image_id, line_idx)

    def _registered_dense(self, view) -> np.ndarray:
        out = np.zeros(len(view.image_ids), bool)
        for d, iid in enumerate(view.image_ids):
            img = self.rec.images.get(iid)
            out[d] = img is not None and img.registered
        return out

    def _tri_flat(self, view) -> np.ndarray:
        """Flat per-feature bool: feature currently triangulated."""
        return view.concat_per_image(
            lambda iid: self.rec.images[iid].point3d_ids >= 0
            if iid in self.rec.images
            else np.zeros(view.num_lines[view.dense[iid]], bool))

    def _find_all(self, options: TriangulatorOptions, image_id: int):
        """Run ``_find`` for every line of an image in one vectorized pass.

        Returns [(line_idx, pool, num_triangulated)] for lines with a
        non-empty registered-correspondence pool.
        """
        view = self.view
        if view is None or options.max_transitivity != 1 \
                or image_id not in view.dense:
            out = []
            for line_idx in range(self.rec.images[image_id].num_lines):
                pool, ntri = self._find(options, image_id, line_idx)
                if pool:
                    out.append((line_idx, pool, ntri))
            return out
        s, e = view.corr_range(image_id)
        cim = view.corr_img_dense[s:e]
        cfl = view.corr_flat[s:e]
        cline = view.corr_line[s:e]
        reg = self._registered_dense(view)
        tri = self._tri_flat(view)
        mask = reg[cim]
        ro = view.image_row_offsets(image_id)
        base = ro[0]
        img_ids = view.image_id_arr
        cs = np.concatenate([[0], np.cumsum(mask)])
        out = []
        for li in range(len(ro) - 1):
            a, b = int(ro[li] - base), int(ro[li + 1] - base)
            if cs[b] - cs[a] == 0:
                continue
            idx = np.nonzero(mask[a:b])[0] + a
            pool = [(int(img_ids[cim[j]]), int(cline[j])) for j in idx]
            ntri = int(np.count_nonzero(tri[cfl[idx]]))
            out.append((li, pool, ntri))
        return out

    def _is_two_view(self, image_id: int, line_idx: int) -> bool:
        view = self.view
        if view is not None and image_id in view.dense:
            if image_id not in self._two_view_cache:
                self._two_view_cache[image_id] = \
                    view.two_view_flags(image_id)
            return bool(self._two_view_cache[image_id][line_idx])
        return self.graph.is_two_view_observation(image_id, line_idx)

    # -- device-kernel wrappers -----------------------------------------

    def _estimator(self, camera_model: str, residual: str):
        key = (camera_model, residual)
        if key not in self._jit_cache:
            if residual == "angular":
                def run(lines, proj, centers, params, valid, width, height,
                        max_err, min_ang):
                    return tri_est.estimate_triangulation(
                        lines, proj, centers, params, valid, camera_model,
                        width, height, max_err, min_ang)
            else:
                def run(lines, proj, centers, params, valid, width, height,
                        max_err, min_ang):
                    return _estimate_triangulation_pixel(
                        lines, proj, centers, params, valid, camera_model,
                        width, height, max_err, min_ang)
            self._jit_cache[key] = jax.jit(run, static_argnums=(5, 6))
        return self._jit_cache[key]

    def _pool_arrays(self, pool):
        """Pad a CorrData pool to MAX_POOL fixed-shape arrays."""
        n = len(pool)
        lines = np.zeros((MAX_POOL, 3))
        lines[:, 0] = 1.0
        projs = np.tile(np.eye(3, 4), (MAX_POOL, 1, 1))
        centers = np.zeros((MAX_POOL, 3))
        valid = np.zeros(MAX_POOL, bool)
        cam0 = self.rec.cameras[self.rec.images[pool[0][0]].camera_id]
        params = np.tile(cam0.params, (MAX_POOL, 1))
        for i, (iid, li) in enumerate(pool[:MAX_POOL]):
            img = self.rec.images[iid]
            cam = self.rec.cameras[img.camera_id]
            lines[i] = img.lines[li]
            projs[i] = img.projection_matrix()
            centers[i] = img.projection_center()
            params[i] = cam.params
            valid[i] = True
        return (jnp.asarray(lines), jnp.asarray(projs), jnp.asarray(centers),
                jnp.asarray(params), jnp.asarray(valid), cam0)

    def _robust_triangulate(self, pool, options: TriangulatorOptions,
                            residual: str):
        """Run the LORANSAC estimator on a pool of (image_id, line_idx)."""
        lines, projs, centers, params, valid, cam0 = self._pool_arrays(pool)
        run = self._estimator(cam0.model, residual)
        if residual == "angular":
            max_err = np.deg2rad(options.create_max_angle_error)
        else:
            max_err = options.complete_max_reproj_error
        res = run(lines, projs, centers, params, valid, cam0.width,
                  cam0.height, max_err, np.deg2rad(options.min_angle))
        return res

    def _pixel_error(self, image, line_idx: int, xyz: np.ndarray) -> float:
        from privacy_preserving_sfm_tpu.ops import lines_np
        cam = self.rec.cameras[image.camera_id]
        return float(lines_np.squared_line_reprojection_error(
            image.lines[line_idx], np.asarray(xyz, float),
            image.projection_matrix(), cam.model, cam.params,
            cam.width, cam.height))

    def _angular_error(self, image, line_idx: int, xyz) -> float:
        from privacy_preserving_sfm_tpu.ops import lines_np
        cam = self.rec.cameras[image.camera_id]
        return float(lines_np.line_angular_error(
            image.lines[line_idx], np.asarray(xyz, float),
            image.projection_matrix(), cam.model, cam.params,
            cam.width, cam.height))

    # -- Find ------------------------------------------------------------

    def _find(self, options, image_id: int, line_idx: int):
        """Registered-image correspondences + count of triangulated ones."""
        corrs = self.graph.find_transitive_correspondences(
            image_id, line_idx, options.max_transitivity)
        pool = []
        num_triangulated = 0
        for iid, li in corrs:
            img = self.rec.images.get(iid)
            if img is None or not img.registered:
                continue
            pool.append((iid, li))
            if img.point3d_ids[li] >= 0:
                num_triangulated += 1
        return pool, num_triangulated

    # -- Create ----------------------------------------------------------

    def _create(self, options: TriangulatorOptions, pool) -> int:
        create_pool = [(iid, li) for iid, li in pool
                       if self.rec.images[iid].point3d_ids[li] < 0]
        if len(create_pool) < 3:
            return 0
        num_random = sum(1 for iid, li in create_pool
                         if not self.rec.images[iid].aligned[li])
        if num_random < 1:
            return 0

        res = self._robust_triangulate(create_pool[:MAX_POOL], options,
                                       "angular")
        if not bool(res.success):
            return 0
        inl = np.asarray(res.inlier_mask)
        track = [create_pool[i] for i in range(min(len(create_pool), MAX_POOL))
                 if inl[i]]
        if len(track) < 2:
            return 0
        xyz = np.asarray(res.point3d)
        pid = self.rec.add_point3d(xyz, track)
        self.modified_point3d_ids.add(pid)

        # Recursive re-create on the leftovers (>= 3).
        if len(create_pool) - len(track) >= 3:
            return len(track) + self._create(options, create_pool)
        return len(track)

    # -- Continue --------------------------------------------------------

    def _continue(self, options: TriangulatorOptions, image_id: int,
                  line_idx: int, pool) -> int:
        from privacy_preserving_sfm_tpu.ops import lines_np

        img = self.rec.images[image_id]
        if img.point3d_ids[line_idx] >= 0:
            return 0
        # One vectorized angular-error evaluation over all candidate points
        # (single camera: the image being continued).
        pids: List[int] = []
        seen: Set[int] = set()
        for iid, li in pool:
            pid = int(self.rec.images[iid].point3d_ids[li])
            if pid >= 0 and pid not in seen:
                seen.add(pid)
                pids.append(pid)
        best_err = np.inf
        best_pid = None
        if pids:
            cam = self.rec.cameras[img.camera_id]
            xyzs = np.stack([self.rec.points3d[p].xyz for p in pids])
            errs = lines_np.line_angular_error(
                img.lines[line_idx], xyzs, img.projection_matrix(),
                cam.model, cam.params, cam.width, cam.height)
            k = int(np.argmin(errs))
            best_err = float(errs[k])
            best_pid = pids[k]
        if best_pid is not None and \
                best_err <= np.deg2rad(options.continue_max_angle_error):
            self.rec.add_observation(best_pid, image_id, line_idx)
            self.modified_point3d_ids.add(best_pid)
            return 1
        return 0

    # -- batched create (one vmapped device call per image) -------------

    def _batched_estimator(self, camera_model: str, residual: str):
        """Jitted SoA batch estimator; shapes specialize inside jit."""
        key = ("batch_soa", camera_model, residual)
        if key not in self._jit_cache:
            def run(lines, proj, centers, params, valid, width, height,
                    max_err, min_ang):
                return tri_batch.estimate_triangulation_batch(
                    lines, proj, centers, params, valid, camera_model,
                    width, height, max_err, min_ang, residual=residual)
            self._jit_cache[key] = jax.jit(run, static_argnums=(5, 6))
        return self._jit_cache[key]

    def _solve_pools(self, pools, residual: str, max_err, min_ang_rad,
                     phase: str):
        """Solve many pools: bucket by pool size, chunk the track axis.

        Pool-size buckets keep the combination count proportional to the
        actual pool (a 4-obs init pool pays C(4,3)=4 hypotheses, not
        C(24,3)=2024), and the SoA estimator bounds the padded-layout
        device-memory footprint; chunking bounds peak memory on huge rounds.

        Returns (success (T,), inlier_mask (T, MAX_POOL), xyz (T, 3))
        aligned with ``pools``.
        """
        import time as _time
        T = len(pools)
        success = np.zeros(T, bool)
        inl = np.zeros((T, MAX_POOL), bool)
        xyz = np.zeros((T, 3))
        sizes = np.fromiter((min(len(p), MAX_POOL) for p in pools),
                            np.int64, T)
        cam0 = self.rec.cameras[self.rec.images[pools[0][0][0]].camera_id]
        run = self._batched_estimator(cam0.model, residual)
        prev = 0
        for nb in N_BUCKETS:
            sel = np.nonzero((sizes > prev) & (sizes <= nb))[0]
            prev = nb
            for lo in range(0, len(sel), T_CHUNK):
                idx = sel[lo:lo + T_CHUNK]
                sub = [pools[i] for i in idx]
                t0 = _time.perf_counter()
                Tb = min(_bucket_t(len(sub)), T_CHUNK)
                lines, projs, centers, params, valid, _ = \
                    self._pools_to_arrays(sub, Tb, nb)
                t0 = self._tick(f"{phase}_pack", t0)
                res = run(jnp.asarray(lines), jnp.asarray(projs),
                          jnp.asarray(centers), jnp.asarray(params),
                          jnp.asarray(valid), cam0.width, cam0.height,
                          max_err, min_ang_rad)
                success[idx] = np.asarray(res.success)[:len(sub)]
                inl[idx, :nb] = np.asarray(res.inlier_mask)[:len(sub)]
                xyz[idx] = np.asarray(res.point3d)[:len(sub)]
                self._tick(f"{phase}_solve", t0)
        return success, inl, xyz

    def _flat_tables(self):
        """Per-feature line table (static) + per-call pose/param tables.

        Lines never change after extraction, so the (total_lines, 3) table
        is built once; projection matrices/centers/params are refreshed
        from the live reconstruction each call (cheap: one small matmul
        per image)."""
        view = self.view
        if getattr(self, "_lines_flat", None) is None:
            self._lines_flat = np.concatenate(
                [np.asarray(self.rec.images[iid].lines)
                 for iid in view.image_ids])
        n_img = len(view.image_ids)
        any_cam = next(iter(self.rec.cameras.values()))
        n_par = len(any_cam.params)
        proj = np.tile(np.eye(3, 4), (n_img, 1, 1))
        centers = np.zeros((n_img, 3))
        params = np.tile(any_cam.params, (n_img, 1))
        for d, iid in enumerate(view.image_ids):
            img = self.rec.images.get(iid)
            if img is not None and img.registered:
                proj[d] = img.projection_matrix()
                centers[d] = img.projection_center()
                params[d] = self.rec.cameras[img.camera_id].params
        return self._lines_flat, proj, centers, params

    def _pools_to_arrays(self, pools, t_bucket: int, n_pool: int = MAX_POOL):
        """Pad T pools to (t_bucket, n_pool) fixed-shape solver inputs.

        Vectorized: one flat-feature index list comprehension, then pure
        fancy-indexed gathers from the flat tables (the previous per-row
        numpy writes — ~300k single-element assignments per image — were
        a top-3 mapper host cost)."""
        view = self.view
        if view is None:
            return self._pools_to_arrays_slow(pools, t_bucket, n_pool)
        fo = view.feat_offset
        dense = view.dense
        lines_flat, proj_d, centers_d, params_d = self._flat_tables()
        feat = np.fromiter(
            (int(fo[dense[iid]]) + li
             for pool in pools for iid, li in pool[:n_pool]),
            np.int64)
        sizes = np.fromiter((min(len(p), n_pool) for p in pools),
                            np.int64, len(pools))
        ptr = np.concatenate([[0], np.cumsum(sizes)])
        t_idx = np.repeat(np.arange(len(pools)), sizes)
        slot = np.arange(len(feat)) - ptr[:-1][t_idx]
        img_d = np.searchsorted(fo, feat, "right") - 1

        cam0 = self.rec.cameras[self.rec.images[pools[0][0][0]].camera_id]
        lines = np.zeros((t_bucket, n_pool, 3))
        lines[..., 0] = 1.0
        projs = np.tile(np.eye(3, 4), (t_bucket, n_pool, 1, 1))
        centers = np.zeros((t_bucket, n_pool, 3))
        valid = np.zeros((t_bucket, n_pool), bool)
        params = np.tile(cam0.params, (t_bucket, n_pool, 1))
        lines[t_idx, slot] = lines_flat[feat]
        projs[t_idx, slot] = proj_d[img_d]
        centers[t_idx, slot] = centers_d[img_d]
        params[t_idx, slot] = params_d[img_d]
        valid[t_idx, slot] = True
        return lines, projs, centers, params, valid, cam0

    def _pools_to_arrays_slow(self, pools, t_bucket: int,
                              n_pool: int = MAX_POOL):
        """Per-row fallback when no CSR view exists (tiny graphs)."""
        lines = np.zeros((t_bucket, n_pool, 3))
        lines[..., 0] = 1.0
        projs = np.tile(np.eye(3, 4), (t_bucket, n_pool, 1, 1))
        centers = np.zeros((t_bucket, n_pool, 3))
        valid = np.zeros((t_bucket, n_pool), bool)
        cam0 = self.rec.cameras[self.rec.images[pools[0][0][0]].camera_id]
        params = np.tile(cam0.params, (t_bucket, n_pool, 1))
        proj_cache = {}
        for t, pool in enumerate(pools):
            for i, (iid, li) in enumerate(pool[:n_pool]):
                img = self.rec.images[iid]
                if iid not in proj_cache:
                    proj_cache[iid] = (img.projection_matrix(),
                                       img.projection_center())
                pm, pc = proj_cache[iid]
                lines[t, i] = img.lines[li]
                projs[t, i] = pm
                centers[t, i] = pc
                params[t, i] = self.rec.cameras[img.camera_id].params
                valid[t, i] = True
        return lines, projs, centers, params, valid, cam0

    def _batched_create(self, options: TriangulatorOptions, pools) -> int:
        """Triangulate many Create pools with one vmapped call per round.

        Departure from the reference's strictly sequential per-feature
        loop: all pools of an image are solved against the SAME snapshot of
        the reconstruction, and results are applied in order, dropping
        observations claimed by an earlier track in the batch.  Occasional
        duplicate points are cleaned by the (reference-exact) Merge step.
        Leftover pools (>= 3 unclaimed observations) re-run in following
        rounds, mirroring the recursive re-create.
        """
        import time as _time
        num_tris = 0
        rounds = 0
        while pools and rounds < 4:
            rounds += 1
            t0 = _time.perf_counter()
            success, inl, xyz = self._solve_pools(
                pools, "angular",
                np.deg2rad(options.create_max_angle_error),
                np.deg2rad(options.min_angle), "tri/create")

            next_pools = []
            for t, pool in enumerate(pools):
                if not success[t]:
                    continue
                track = [pool[i] for i in range(min(len(pool), MAX_POOL))
                         if inl[t, i] and
                         self.rec.images[pool[i][0]].point3d_ids[pool[i][1]] < 0]
                if len(track) < 2:
                    continue
                pid = self.rec.add_point3d(xyz[t], track)
                self.modified_point3d_ids.add(pid)
                num_tris += len(track)
                leftovers = [
                    (iid, li) for iid, li in pool
                    if self.rec.images[iid].point3d_ids[li] < 0]
                if len(leftovers) >= 3 and any(
                        not self.rec.images[iid].aligned[li]
                        for iid, li in leftovers):
                    next_pools.append(leftovers)
            self._tick("tri/create_apply", t0)
            pools = next_pools
        return num_tris

    # -- public API ------------------------------------------------------

    def triangulate_image(self, options: TriangulatorOptions,
                          image_id: int, batched: bool = True) -> int:
        """``TriangulateImage`` (``incremental_triangulator.cc:63-121``).

        ``batched=True`` (default) fuses all Create solves of the image
        into vmapped device calls (see ``_batched_create``); ``False``
        reproduces the reference's sequential per-feature behavior.
        """
        num_tris = 0
        self._merge_trials.clear()
        img = self.rec.images[image_id]
        if not img.registered:
            return 0
        if not batched:
            for line_idx in range(img.num_lines):
                pool, num_triangulated = self._find(options, image_id,
                                                    line_idx)
                if not pool:
                    continue
                if num_triangulated == 0:
                    num_tris += self._create(options,
                                             pool + [(image_id, line_idx)])
                else:
                    num_tris += self._continue(options, image_id, line_idx,
                                               pool)
                    num_tris += self._create(options,
                                             pool + [(image_id, line_idx)])
            return num_tris

        # Pass 1: Find everything; Continue (cheap, state-dependent) first.
        import time as _time
        t0 = _time.perf_counter()
        found = []
        all_found = self._find_all(options, image_id)
        t0 = self._tick("tri/find", t0)
        for line_idx, pool, num_triangulated in all_found:
            if num_triangulated > 0:
                num_tris += self._continue(options, image_id, line_idx, pool)
            found.append((line_idx, pool))
        t0 = self._tick("tri/continue", t0)

        # Pass 2: assemble Create pools against the post-Continue state.
        pools = []
        for line_idx, pool in found:
            full = pool + [(image_id, line_idx)]
            create_pool = [
                (iid, li) for iid, li in full
                if self.rec.images[iid].point3d_ids[li] < 0]
            if len(create_pool) < 3:
                continue
            if not any(not self.rec.images[iid].aligned[li]
                       for iid, li in create_pool):
                continue
            pools.append(create_pool)
        t0 = self._tick("tri/assemble", t0)
        num_tris += self._batched_create(options, pools)
        self._tick("tri/create", t0)
        return num_tris

    def complete_image(self, options: TriangulatorOptions,
                       image_id: int) -> int:
        """``CompleteImage`` (``incremental_triangulator.cc:123-236``)."""
        num_tris = 0
        self._merge_trials.clear()
        img = self.rec.images[image_id]
        if not img.registered:
            return 0
        import time as _time
        t0 = _time.perf_counter()
        found = {li: (pool, ntri)
                 for li, pool, ntri in self._find_all(options, image_id)}
        t0 = self._tick("cmp/find", t0)
        # Complete every already-triangulated observation of the image in
        # one batched BFS (was: per-line _complete — the mapper's hottest
        # host loop), then grow fresh tracks over the remaining lines.
        tri_pids = []
        seen_pids: Set[int] = set()
        for line_idx in range(img.num_lines):
            pid = int(img.point3d_ids[line_idx])
            if pid >= 0 and pid not in seen_pids:
                seen_pids.add(pid)
                tri_pids.append(pid)
        num_tris += self._complete_batch(options, tri_pids)
        t0 = self._tick("cmp/bfs", t0)
        # Assemble every fresh pool against the post-complete state, then
        # solve them ALL with one vmapped pixel-residual LORANSAC call
        # (was: one ~26ms device dispatch per line — the second-hottest
        # host path after the completion BFS).
        fresh = []
        for line_idx in range(img.num_lines):
            pid = int(img.point3d_ids[line_idx])
            if pid >= 0:
                continue
            if options.ignore_two_view_tracks and \
                    self._is_two_view(image_id, line_idx):
                continue
            pool, num_triangulated = found.get(line_idx, ([], 0))
            if num_triangulated or not pool:
                continue
            if any(self.rec.images[iid].point3d_ids[li] >= 0
                   for iid, li in pool):
                continue
            full = pool + [(image_id, line_idx)]
            if len(full) < 3:
                continue
            fresh.append(full)
        if fresh:
            success, inl, xyz = self._solve_pools(
                fresh, "pixel", options.complete_max_reproj_error,
                np.deg2rad(options.min_angle), "cmp/fresh")
            t0 = self._tick("cmp/fresh_solve", t0)
            for t, full in enumerate(fresh):
                if not success[t]:
                    continue
                # Live claim check: an earlier pool in this batch may have
                # claimed a shared observation.
                track = [full[i] for i in range(min(len(full), MAX_POOL))
                         if inl[t, i] and self.rec.images[full[i][0]]
                         .point3d_ids[full[i][1]] < 0]
                if len(track) < 2:
                    continue
                pid = self.rec.add_point3d(xyz[t], track)
                self.modified_point3d_ids.add(pid)
                num_tris += len(track)
        self._tick("cmp/fresh", t0)
        return num_tris

    def _complete(self, options: TriangulatorOptions, pid: int) -> int:
        """Transitive track growth (``incremental_triangulator.cc:697-765``)."""
        if pid not in self.rec.points3d:
            return 0
        max_sq = options.complete_max_reproj_error ** 2
        num_completed = 0
        queue = list(self.rec.points3d[pid].track)
        for transitivity in range(options.complete_max_transitivity):
            if not queue:
                break
            # Gather every untriangulated registered correspondence of the
            # BFS frontier, then evaluate all pixel errors in one host call.
            cand: List[Tuple[int, int]] = []
            seen_local: Set[Tuple[int, int]] = set()
            for qiid, qli in queue:
                for iid, li in self._corrs(qiid, qli):
                    if (iid, li) in seen_local:
                        continue
                    seen_local.add((iid, li))
                    img = self.rec.images.get(iid)
                    if img is None or not img.registered:
                        continue
                    if img.point3d_ids[li] >= 0:
                        continue
                    cand.append((iid, li))
            queue = []
            if not cand:
                continue
            xyz = self.rec.points3d[pid].xyz
            errs = self.rec.batch_squared_line_errors(
                np.asarray([c[0] for c in cand]),
                np.asarray([c[1] for c in cand]), xyz)
            for k, (iid, li) in enumerate(cand):
                if errs[k] > max_sq:
                    continue
                if self.rec.images[iid].point3d_ids[li] >= 0:
                    continue  # claimed earlier in this level
                self.rec.add_observation(pid, iid, li)
                self.modified_point3d_ids.add(pid)
                if transitivity < options.complete_max_transitivity - 1:
                    queue.append((iid, li))
                num_completed += 1
        return num_completed

    def _merge(self, options: TriangulatorOptions, pid: int) -> int:
        """Merge with corresponding tracks
        (``incremental_triangulator.cc:606-695``)."""
        if pid not in self.rec.points3d:
            return 0
        max_sq = options.merge_max_reproj_error ** 2
        point = self.rec.points3d[pid]
        for iid, li in list(point.track):
            for ciid, cli in self._corrs(iid, li):
                img = self.rec.images.get(ciid)
                if img is None or not img.registered:
                    continue
                cpid = int(img.point3d_ids[cli])
                if cpid < 0 or cpid == pid:
                    continue
                if cpid in self._merge_trials.setdefault(pid, set()):
                    continue
                self._merge_trials.setdefault(pid, set()).add(cpid)
                self._merge_trials.setdefault(cpid, set()).add(pid)
                corr_point = self.rec.points3d[cpid]
                n1, n2 = len(point.track), len(corr_point.track)
                merged_xyz = (n1 * point.xyz + n2 * corr_point.xyz) / (n1 + n2)
                both = list(point.track) + list(corr_point.track)
                errs = self.rec.batch_squared_line_errors(
                    np.asarray([o[0] for o in both]),
                    np.asarray([o[1] for o in both]), merged_xyz)
                ok = bool(np.all(errs <= max_sq))
                if ok:
                    num_merged = n1 + n2
                    mpid = self.rec.merge_points3d(pid, cpid)
                    self.modified_point3d_ids.discard(pid)
                    self.modified_point3d_ids.discard(cpid)
                    self.modified_point3d_ids.add(mpid)
                    rec_merged = self._merge(options, mpid)
                    return rec_merged if rec_merged > 0 else num_merged
        return 0

    def merge_tracks(self, options: TriangulatorOptions,
                     point3d_ids: Set[int]) -> int:
        self._merge_trials.clear()
        view = self.view
        if view is None:
            n = 0
            for pid in list(point3d_ids):
                n += self._merge(options, pid)
            return n
        return self._merge_batch(options, list(point3d_ids))

    def _merge_batch(self, options: TriangulatorOptions,
                     pids: List[int]) -> int:
        """Merge candidate discovery for MANY points, vectorized.

        One CSR expansion finds every (point, corresponding-point) pair
        instead of a Python ``_corrs`` walk per observation (which was
        ~80% of merge wall time); the trials themselves run sequentially
        with the exact accept rule of ``_merge``
        (``incremental_triangulator.cc:606-695``).  Deviation: candidate
        order is (point, flat-feature) rather than (point, track-insertion)
        order, which can pick a different (equally valid) merge when two
        partners both pass.
        """
        pids = [p for p in pids if p in self.rec.points3d]
        if not pids:
            return 0
        rec = self.rec
        view = self.view
        # Flat per-feature pid table (int64, -1 = untriangulated).
        pid_flat = view.concat_per_image(
            lambda iid: np.asarray(rec.images[iid].point3d_ids, np.int64)
            if iid in rec.images
            else np.full(int(view.num_lines[view.dense[iid]]), -1, np.int64))
        reg_flat = np.repeat(self._registered_dense(view), view.num_lines)
        pid_arr = np.asarray(pids, np.int64)

        src = np.nonzero(np.isin(pid_flat, pid_arr))[0]
        spid = pid_flat[src]
        # Group source features by the pids' given order.
        pid_order = np.argsort(pid_arr, kind="stable")
        k_of = pid_order[np.searchsorted(pid_arr[pid_order], spid)]
        by_k = np.argsort(k_of, kind="stable")
        src, spid = src[by_k], spid[by_k]

        ro = view.row_offsets
        starts = ro[src]
        degs = ro[src + 1] - starts
        m = int(degs.sum())
        if m == 0:
            return 0
        rep = np.repeat(np.arange(len(src)), degs)
        offs = np.arange(m) - np.repeat(np.cumsum(degs) - degs, degs)
        tgt = view.corr_flat[starts[rep] + offs]
        cpid = pid_flat[tgt]
        spid_e = spid[rep]
        keep = (cpid >= 0) & (cpid != spid_e) & reg_flat[tgt]
        cand_s, cand_c = spid_e[keep], cpid[keep]

        num_merged_total = 0
        max_sq = options.merge_max_reproj_error ** 2
        for s, c in zip(cand_s.tolist(), cand_c.tolist()):
            if s not in rec.points3d or c not in rec.points3d:
                continue  # merged away earlier in this call
            if c in self._merge_trials.setdefault(s, set()):
                continue
            self._merge_trials.setdefault(s, set()).add(c)
            self._merge_trials.setdefault(c, set()).add(s)
            point, corr_point = rec.points3d[s], rec.points3d[c]
            n1, n2 = len(point.track), len(corr_point.track)
            merged_xyz = (n1 * point.xyz + n2 * corr_point.xyz) / (n1 + n2)
            both = list(point.track) + list(corr_point.track)
            errs = rec.batch_squared_line_errors(
                np.asarray([o[0] for o in both]),
                np.asarray([o[1] for o in both]), merged_xyz)
            if not bool(np.all(errs <= max_sq)):
                continue
            mpid = rec.merge_points3d(s, c)
            self.modified_point3d_ids.discard(s)
            self.modified_point3d_ids.discard(c)
            self.modified_point3d_ids.add(mpid)
            rec_merged = self._merge(options, mpid)
            num_merged_total += rec_merged if rec_merged > 0 else n1 + n2
        return num_merged_total

    def merge_all_tracks(self, options: TriangulatorOptions) -> int:
        return self.merge_tracks(options, set(self.rec.points3d.keys()))

    def _complete_batch(self, options: TriangulatorOptions,
                        pids: List[int]) -> int:
        """Transitive track growth for MANY points, vectorized.

        Level-synchronous BFS over the CSR graph view: each transitivity
        level expands every point's frontier at once, gates all candidate
        observations with one vectorized pixel-error call, and claims
        contested features first-come-first-served in frontier order.
        Same accept criterion as the per-point ``_complete``
        (``incremental_triangulator.cc:697-765``); the only deviation is
        claim ordering when two points reach the same feature at
        different levels (sequential processing finished point A's whole
        BFS before starting B).  The per-point loop was 73% of mapper
        wall time at 50 images (Python graph walking); this path is
        O(levels) numpy calls.
        """
        view = self.view
        pids = [p for p in pids if p in self.rec.points3d]
        if not pids:
            return 0
        if view is None:
            return sum(self._complete(options, p) for p in pids)
        max_sq = options.complete_max_reproj_error ** 2
        fo = view.feat_offset
        ro = view.row_offsets
        reg_img = np.array(
            [self.rec.images.get(iid) is not None
             and self.rec.images[iid].registered
             for iid in view.image_ids])
        reg_flat = np.repeat(reg_img, view.num_lines)
        tri_flat = np.concatenate([
            np.asarray(self.rec.images[iid].point3d_ids, np.int64)
            if iid in self.rec.images
            else np.full(int(view.num_lines[d]), -1, np.int64)
            for d, iid in enumerate(view.image_ids)])
        xyz = np.stack([self.rec.points3d[p].xyz for p in pids])

        # Frontier seeding from the flat per-image point3d_id table
        # (tri_flat[f] == pid is the inverse of Track membership for every
        # image in the view, so no per-track Python walk is needed).
        pid_arr = np.asarray(pids, np.int64)
        fr_feat_a = np.nonzero(np.isin(tri_flat, pid_arr))[0]
        pid_order = np.argsort(pid_arr, kind="stable")
        fr_pid_a = pid_order[np.searchsorted(
            pid_arr[pid_order], tri_flat[fr_feat_a])]

        total = 0
        for level in range(options.complete_max_transitivity):
            if len(fr_feat_a) == 0:
                break
            starts = ro[fr_feat_a]
            degs = ro[fr_feat_a + 1] - starts
            m = int(degs.sum())
            if m == 0:
                break
            rep = np.repeat(np.arange(len(fr_feat_a)), degs)
            offs = np.arange(m) - np.repeat(np.cumsum(degs) - degs, degs)
            j = starts[rep] + offs
            tgt = view.corr_flat[j]  # flat feature index of the target
            keep = reg_flat[tgt] & (tri_flat[tgt] < 0)
            tgt, cpid = tgt[keep], fr_pid_a[rep[keep]]
            tgt_img_d = view.corr_img_dense[j[keep]]
            if len(tgt) == 0:
                break
            # Dedup (point, feature) pairs, keeping frontier order.
            key = cpid * np.int64(view.total_lines) + tgt
            _, first_idx = np.unique(key, return_index=True)
            order = np.sort(first_idx)
            tgt, cpid, tgt_img_d = tgt[order], cpid[order], tgt_img_d[order]
            iids = view.image_id_arr[tgt_img_d]
            lis = tgt - fo[tgt_img_d]
            errs = self.rec.batch_squared_line_errors(iids, lis, xyz[cpid])
            acc = errs <= max_sq
            tgt, cpid, iids, lis = tgt[acc], cpid[acc], iids[acc], lis[acc]
            if len(tgt) == 0:
                continue
            # Contested features: first claim in frontier order wins.
            _, fi2 = np.unique(tgt, return_index=True)
            order2 = np.sort(fi2)
            tgt, cpid, iids, lis = (tgt[order2], cpid[order2], iids[order2],
                                    lis[order2])
            for k, iid, li in zip(cpid, iids, lis):
                self.rec.add_observation(pids[int(k)], int(iid), int(li))
                self.modified_point3d_ids.add(pids[int(k)])
            tri_flat[tgt] = 1  # claimed; exact pid value not needed here
            total += len(tgt)
            if level < options.complete_max_transitivity - 1:
                fr_pid_a, fr_feat_a = cpid, tgt
            else:
                break
        return total

    def complete_tracks(self, options: TriangulatorOptions,
                        point3d_ids: Set[int]) -> int:
        return self._complete_batch(options, list(point3d_ids))

    def complete_all_tracks(self, options: TriangulatorOptions) -> int:
        return self.complete_tracks(options, set(self.rec.points3d.keys()))


def _estimate_triangulation_pixel(lines, proj, centers, params, valid,
                                  camera_model, width, height, max_err,
                                  min_ang):
    """Pixel-residual variant of the LORANSAC estimator (CompleteImage)."""
    from privacy_preserving_sfm_tpu.ops import triangulation as tri_ops
    from privacy_preserving_sfm_tpu.solvers import ransac as ransac_mod
    from privacy_preserving_sfm_tpu.solvers.triangulation import (
        _combinations3, TriangulationResult, BIG)

    n = lines.shape[0]
    combos = jnp.asarray(_combinations3(min(n, 15)))
    s_valid = jnp.all(valid[combos], axis=-1)
    s_lines = lines[combos]
    s_proj = proj[combos]
    s_centers = centers[combos]
    X = tri_ops.triangulate_three_lines(s_proj, s_lines)
    xyz = jnp.einsum("cnij,cj->cni", s_proj[..., :3], X) + s_proj[..., 3]
    cheiral = jnp.all(xyz[..., 2] > 0, axis=-1)
    ang01 = tri_ops.triangulation_angle(s_centers[:, 0], s_centers[:, 1], X)
    ang02 = tri_ops.triangulation_angle(s_centers[:, 0], s_centers[:, 2], X)
    ang12 = tri_ops.triangulation_angle(s_centers[:, 1], s_centers[:, 2], X)
    good_angle = (jnp.maximum(jnp.maximum(ang01, ang02), ang12) >= min_ang)
    s_valid = s_valid & cheiral & good_angle & jnp.all(jnp.isfinite(X), -1)

    err = line_ops.squared_line_reprojection_error(
        lines[None], X[:, None], proj[None], camera_model, params[None],
        width, height)
    err = jnp.where(s_valid[:, None], err, BIG)
    thresh = jnp.asarray(max_err) ** 2
    score, num, inl = ransac_mod.inlier_score(err, thresh, valid[None])
    best = ransac_mod.select_best(X, score, num, inl)

    X_lo = tri_ops.triangulate_multiview_lines(proj, lines,
                                               mask=best.inlier_mask)
    err_lo = line_ops.squared_line_reprojection_error(
        lines, X_lo[None], proj, camera_model, params, width, height)
    err_lo = jnp.where(jnp.all(jnp.isfinite(X_lo)), err_lo, BIG)
    score_lo, num_lo, inl_lo = ransac_mod.inlier_score(err_lo, thresh, valid)
    use_lo = score_lo > best.score
    point = jnp.where(use_lo, X_lo, best.model)
    num_f = jnp.where(use_lo, num_lo, best.num_inliers)
    inl_f = jnp.where(use_lo, inl_lo, best.inlier_mask)
    return TriangulationResult(point3d=point, num_inliers=num_f,
                               inlier_mask=inl_f, success=num_f >= 3)
