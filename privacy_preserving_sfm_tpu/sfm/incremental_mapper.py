"""Incremental mapper: init-set search, registration, local/global BA.

Host-side port of ``src/sfm/incremental_mapper.{h,cc}`` over the device
kernels (P6L RANSAC, 4-view initializer, implicit-Schur BA).  Key policies
(see SURVEY.md §8 for the full threshold spec):

  * ``register_initial_line_images``: enumerate 4-view aligned/unaligned
    tracks around <= 10 random seed images, require >= 20 of each per image
    set, rank by aligned-track count, try <= 10 candidate sets through the
    4-view initializer, keep the best inlier ratio
    (``incremental_mapper.cc:192-541``);
  * ``find_next_images``: rank by visible-points ratio, two buckets
    (fresh vs previously-failed/filtered) (``:139-191``);
  * ``register_next_image``: transitive 2D-3D search, P6L RANSAC with
    normalized threshold, refinement, continue inlier tracks (``:570-759``);
  * ``adjust_local_bundle``: local set by most-shared-3D-points with the
    8-step relaxing (tri-angle, overlap) schedule; 7-DoF gauge fixing;
    variable points = modified tracks <= 15 (``:781-888, 993-1160``);
  * ``adjust_global_bundle``: gauge fix + Normalize (``:893-939``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from privacy_preserving_sfm_tpu.init import initializer as init_mod
from privacy_preserving_sfm_tpu.models.database_cache import DatabaseCache
from privacy_preserving_sfm_tpu.models.reconstruction import Reconstruction
from privacy_preserving_sfm_tpu.ops import lie, triangulation as tri_ops
from privacy_preserving_sfm_tpu.optim import ba as ba_mod
from privacy_preserving_sfm_tpu.sfm.incremental_triangulator import (
    IncrementalTriangulator, TriangulatorOptions,
)
from privacy_preserving_sfm_tpu.solvers import p6l
from privacy_preserving_sfm_tpu.utils.jax_setup import accelerator


@dataclasses.dataclass
class MapperOptions:
    """``IncrementalMapper::Options`` (``incremental_mapper.h:50-113``)."""

    init_min_num_inliers: int = 20
    init_max_error: float = 5.0  # px
    init_min_tri_angle: float = 2.0  # degrees
    abs_pose_max_error: float = 12.0  # px
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    filter_max_reproj_error: float = 4.0  # px
    filter_min_tri_angle: float = 1.5  # degrees
    max_reg_trials: int = 3
    local_ba_num_images: int = 6
    local_ba_min_tri_angle: float = 6.0  # degrees
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    # Focal search at registration for prior-less cameras (reference
    # ``incremental_mapper.cc:660-714`` sets this machinery up; in the
    # line fork the estimator ignores it — dead code there.  Here the
    # search is real: candidate focals act on lifted lines as the
    # projective correction of ops/ba_intrinsics, scored by P6L RANSAC
    # support).  Off by default like ``abs_pose_refine_focal_length``.
    abs_pose_refine_focal_length: bool = False
    num_focal_length_samples: int = 30
    fix_existing_images: bool = False
    num_hypotheses: int = 4096  # P6L RANSAC batch (ref: 100..10000 trials)
    init_num_samples: int = 1024
    seed: int = 0


_JIT_POSE: Dict = {}
_JIT_INIT: Dict = {}
_JIT_BA: Dict = {}
_BA_SEEN: Set = set()


class IncrementalMapper:
    def __init__(self, database_cache: DatabaseCache):
        self.cache = database_cache
        self.rec: Optional[Reconstruction] = None
        self.triangulator: Optional[IncrementalTriangulator] = None
        self.num_reg_trials: Dict[int, int] = {}
        self.filtered_images: Set[int] = set()
        self.existing_image_ids: Set[int] = set()
        self.num_reg_images_per_camera: Dict[int, int] = {}
        # Cross-model bookkeeping (persists over begin/end_reconstruction;
        # ``incremental_mapper.cc:95-135,1160-1191``): how often each image
        # has been registered across ALL models of this mapper.
        self.num_registrations: Dict[int, int] = {}
        self.num_total_reg_images = 0
        self.num_shared_reg_images = 0
        self._rng = np.random.default_rng(0)
        # Traced-callable caches are MODULE-level: tracing the LM / init /
        # pose graphs costs seconds each, and hierarchical / multi-model /
        # relaxation-retry flows create several mapper instances per
        # process that hit identical (shape, options) keys.
        self._jit_pose = _JIT_POSE
        self._jit_init = _JIT_INIT
        self._jit_ba = _JIT_BA

    # -- lifecycle -------------------------------------------------------

    def begin_reconstruction(self, rec: Reconstruction):
        """``BeginReconstruction``: per-model state reset, replay of
        register events for resumed images (``incremental_mapper.cc:102-122``)."""
        assert self.rec is None, "end_reconstruction the previous model first"
        self.rec = rec
        self.view = getattr(self.cache, "view", None)
        self.triangulator = IncrementalTriangulator(self.cache.graph, rec,
                                                    view=self.view)
        self.num_shared_reg_images = 0
        self.num_reg_images_per_camera = {}
        self.existing_image_ids = set(rec.reg_image_ids)
        self.filtered_images = set()
        self.num_reg_trials = {}
        for iid in rec.reg_image_ids:
            self._register_image_event(iid)

    def end_reconstruction(self, discard: bool):
        """``EndReconstruction`` (``incremental_mapper.cc:124-135``)."""
        assert self.rec is not None
        if discard:
            for iid in list(self.rec.reg_image_ids):
                self._deregister_image_event(iid)
        self.rec = None
        self.triangulator = None

    def _register_image_event(self, image_id: int):
        cam_id = self.rec.images[image_id].camera_id
        self.num_reg_images_per_camera[cam_id] = \
            self.num_reg_images_per_camera.get(cam_id, 0) + 1
        n = self.num_registrations.get(image_id, 0) + 1
        self.num_registrations[image_id] = n
        if n == 1:
            self.num_total_reg_images += 1
        else:
            self.num_shared_reg_images += 1

    def _deregister_image_event(self, image_id: int):
        cam_id = self.rec.images[image_id].camera_id
        self.num_reg_images_per_camera[cam_id] = \
            self.num_reg_images_per_camera.get(cam_id, 1) - 1
        n = self.num_registrations.get(image_id, 1) - 1
        self.num_registrations[image_id] = n
        if n == 0:
            self.num_total_reg_images -= 1
        else:
            self.num_shared_reg_images -= 1

    # -- initialization --------------------------------------------------

    def register_initial_line_images(self, options: MapperOptions,
                                     aligned_cache: DatabaseCache) -> bool:
        """Bootstrap 4 poses (``incremental_mapper.cc:192-567``)."""
        import time as _time
        _t0 = _time.perf_counter()

        def _tick(name):
            nonlocal _t0
            t = _time.perf_counter()
            self._phase_times = getattr(self, "_phase_times", {})
            self._phase_times[name] = \
                self._phase_times.get(name, 0.0) + (t - _t0)
            _t0 = t

        self._rng = np.random.default_rng(options.seed)
        graph = aligned_cache.graph
        image_ids = sorted(aligned_cache.images.keys())
        if len(image_ids) < 4:
            return False
        # Prefer seed images not yet covered by ANY previous model: keeps
        # successive models exploring new parts of the image collection
        # instead of re-reconstructing the same sub-scene (the reference
        # only bounds per-model overlap, ``incremental_mapper.h:59-60``;
        # seeding from unseen images is our multi-model extension).
        unseen = [iid for iid in image_ids
                  if self.num_registrations.get(iid, 0) == 0]
        seed_pool = unseen if len(unseen) >= 4 else image_ids
        num_check = min(10, len(seed_pool))
        check_ids = self._rng.choice(seed_pool, num_check, replace=False)

        all_aligned: Dict[Tuple, Set[Tuple]] = {}
        all_unaligned: Dict[Tuple, Set[Tuple]] = {}

        if hasattr(graph, "assemble_four_view_tracks"):
            # Native C++ fast path (native/graph.cpp).
            flags = {iid: np.ascontiguousarray(
                aligned_cache.images[iid].aligned, np.uint8)
                for iid in image_ids}
            for want, container in ((True, all_aligned),
                                    (False, all_unaligned)):
                got = graph.assemble_four_view_tracks(
                    list(check_ids), image_ids, flags, want)
                for key, feats in got.items():
                    container[key] = {tuple(int(v) for v in row)
                                      for row in feats}
            check_ids = []  # skip the Python enumeration below

        for image_id in check_ids:
            img = aligned_cache.images[image_id]
            for line_idx in range(img.num_lines):
                is_aligned = bool(img.aligned[line_idx])
                corrs = [
                    (iid, li) for iid, li in
                    graph.find_correspondences(image_id, line_idx)
                    if bool(aligned_cache.images[iid].aligned[li]) == is_aligned
                ]
                if len(corrs) < 3:
                    continue
                container = all_aligned if is_aligned else all_unaligned
                n = len(corrs)
                for i in range(n):
                    for j in range(i + 1, n):
                        for k in range(j + 1, n):
                            cand = sorted(
                                {(image_id, line_idx), corrs[i], corrs[j],
                                 corrs[k]})
                            if len({c[0] for c in cand}) != 4:
                                continue
                            key = tuple(c[0] for c in cand)
                            feats = tuple(c[1] for c in cand)
                            container.setdefault(key, set()).add(feats)

        # Candidate image sets: >= 20 aligned AND >= 20 random tracks.
        MIN_TRACKS = 20
        candidates = []
        for key, atracks in all_aligned.items():
            utracks = all_unaligned.get(key, set())
            if len(atracks) >= MIN_TRACKS and len(utracks) >= MIN_TRACKS:
                candidates.append((key, len(atracks), len(utracks)))
        if not candidates:
            return False
        # Rank by aligned-track count only (unaligned weight = 0.0).
        candidates.sort(key=lambda c: -c[1])

        # Pack ALL candidate sets into one batched device call (the
        # reference tries every set and keeps the best inlier ratio,
        # ``incremental_mapper.cc:430-541`` — no early exit to preserve),
        # so init costs ONE dispatch instead of up to 10.
        cand = candidates[:10]
        # Fixed batch of 10 (repeat the last set when fewer) and a coarse
        # x4 track grid: the init kernel compiles per (B, na, nu) shape,
        # and a fresh compile costs seconds to tens of seconds against
        # ~1 s of redundant padded compute.
        cand = cand + [cand[-1]] * (10 - len(cand))
        B = len(cand)
        na = max(_bucket(len(all_aligned[key]), 128, growth=4)
                 for key, _, _ in cand)
        nu = max(_bucket(len(all_unaligned[key]), 128, growth=4)
                 for key, _, _ in cand)
        al_pad = np.zeros((B, 4, na, 3))
        al_pad[:, :, :, 0] = 1.0
        un_pad = np.zeros((B, 4, nu, 3))
        un_pad[:, :, :, 0] = 1.0
        av = np.zeros((B, na), bool)
        uv = np.zeros((B, nu), bool)
        gravity = np.zeros((B, 4, 3))
        max_error = np.zeros(B)
        for b, (key, _, _) in enumerate(cand):
            atr = sorted(all_aligned[key])
            utr = sorted(all_unaligned[key])
            for t, feats in enumerate(atr):
                for v in range(4):
                    al_pad[b, v, t] = \
                        aligned_cache.images[key[v]].lines[feats[v]]
            for t, feats in enumerate(utr):
                for v in range(4):
                    un_pad[b, v, t] = \
                        aligned_cache.images[key[v]].lines[feats[v]]
            gravity[b] = np.stack(
                [aligned_cache.images[k].gravity for k in key])
            max_error[b] = min(
                aligned_cache.cameras[aligned_cache.images[k].camera_id]
                .image_to_world_threshold(options.init_max_error)
                for k in key)
            av[b, :len(atr)] = True
            uv[b, :len(utr)] = True

        _tick("init_assemble")
        run = self._init_kernel_batch(B, na, nu, options.init_num_samples)
        res = run(jax.random.PRNGKey(options.seed), jnp.asarray(al_pad),
                  jnp.asarray(av), jnp.asarray(un_pad), jnp.asarray(uv),
                  jnp.asarray(gravity), jnp.asarray(max_error),
                  options.init_min_tri_angle,
                  options.init_min_num_inliers)
        success = np.asarray(res.success)
        _tick("init_solve")
        ratios = np.where(success, np.asarray(res.inlier_ratio), -1.0)
        best = int(np.argmax(ratios))
        if ratios[best] <= 0.0:
            return False
        best_poses = np.asarray(res.poses)[best]
        best_set = cand[best][0]
        best_inliers = int(np.asarray(res.num_inliers)[best])

        if best_inliers < options.init_min_num_inliers:
            return False

        from privacy_preserving_sfm_tpu.ops import lie_np
        for v, image_id in enumerate(best_set):
            img = self.rec.images[image_id]
            R = best_poses[v, :, :3]
            img.qvec = lie_np.rotmat_to_quat(R)
            img.tvec = best_poses[v, :, 3].copy()
            self.rec.register_image(image_id)
            self._register_image_event(image_id)

        tri_options = TriangulatorOptions()
        for image_id in list(self.rec.reg_image_ids):
            self.triangulate_image(tri_options, image_id)
        self.complete_tracks(tri_options)
        self.merge_tracks(tri_options)
        return True

    # -- next-image selection -------------------------------------------

    def _visible_stats(self, image_id: int) -> Tuple[int, int]:
        """(num_visible_points3d, num_observations) for ranking."""
        img = self.rec.images[image_id]
        num_vis = 0
        num_obs = 0
        for line_idx in range(img.num_lines):
            corrs = self.cache.graph.find_correspondences(image_id, line_idx)
            if not corrs:
                continue
            num_obs += 1
            for iid, li in corrs:
                other = self.rec.images.get(iid)
                if other is not None and other.registered and \
                        other.point3d_ids[li] >= 0:
                    num_vis += 1
                    break
        return num_vis, num_obs

    def _visible_stats_all(self) -> Dict[int, Tuple[int, int]]:
        """Vectorized ``_visible_stats`` for every unregistered image.

        One flat gather over the CSR view replaces the round-1
        O(lines x corrs) Python loop per candidate (VERDICT weak #2).
        """
        view = self.view
        out: Dict[int, Tuple[int, int]] = {}
        if view is None:
            for iid, img in self.rec.images.items():
                if not img.registered:
                    out[iid] = self._visible_stats(iid)
            return out
        reg = np.zeros(len(view.image_ids), bool)
        for d, iid in enumerate(view.image_ids):
            img = self.rec.images.get(iid)
            reg[d] = img is not None and img.registered
        tri = view.concat_per_image(
            lambda iid: self.rec.images[iid].point3d_ids >= 0
            if iid in self.rec.images
            else np.zeros(view.num_lines[view.dense[iid]], bool))
        for iid, img in self.rec.images.items():
            if img.registered or iid not in view.dense:
                continue
            s, e = view.corr_range(iid)
            vis = reg[view.corr_img_dense[s:e]] & tri[view.corr_flat[s:e]]
            per_line = view.per_line_counts(iid, vis)
            out[iid] = (int(np.count_nonzero(per_line)),
                        view.num_obs_per_image[iid])
        return out

    def find_next_images(self, options: MapperOptions) -> List[int]:
        ranked = []
        other = []
        stats = self._visible_stats_all()
        for iid, img in self.rec.images.items():
            if img.registered:
                continue
            num_vis, num_obs = stats.get(iid, (0, 0))
            if num_vis < options.abs_pose_min_num_inliers:
                continue
            trials = self.num_reg_trials.get(iid, 0)
            if trials >= options.max_reg_trials:
                continue
            rank = num_vis / max(num_obs, 1)  # MAX_VISIBLE_POINTS_RATIO
            if iid not in self.filtered_images and trials == 0:
                ranked.append((iid, rank))
            else:
                other.append((iid, rank))
        ranked.sort(key=lambda x: -x[1])
        other.sort(key=lambda x: -x[1])
        return [i for i, _ in ranked] + [i for i, _ in other]

    # -- registration ----------------------------------------------------

    def register_next_image(self, options: MapperOptions,
                            image_id: int) -> bool:
        img = self.rec.images[image_id]
        cam = self.rec.cameras[img.camera_id]
        assert not img.registered
        self.num_reg_trials[image_id] = \
            self.num_reg_trials.get(image_id, 0) + 1

        # 2D-3D correspondence search (transitivity 1), vectorized over the
        # CSR view: unique (line, point3D) pairs among registered neighbors.
        from privacy_preserving_sfm_tpu.ops import cameras as cam_ops

        def _corr_cam_ok(other) -> bool:
            """Reference skips correspondences from images with bogus
            cameras (``incremental_mapper.cc:631-637``)."""
            c = self.rec.cameras[other.camera_id]
            return not cam_ops.has_bogus_params(
                c.model, c.params, c.width, c.height,
                options.min_focal_length_ratio,
                options.max_focal_length_ratio, options.max_extra_param)

        view = self.view
        if view is not None and image_id in view.dense:
            reg = np.zeros(len(view.image_ids), bool)
            for d, iid in enumerate(view.image_ids):
                other = self.rec.images.get(iid)
                reg[d] = (other is not None and other.registered
                          and _corr_cam_ok(other))
            pid_flat = view.concat_per_image(
                lambda iid: self.rec.images[iid].point3d_ids
                if iid in self.rec.images
                else np.full(view.num_lines[view.dense[iid]], -1, np.int64))
            s, e = view.corr_range(image_id)
            pids = pid_flat[view.corr_flat[s:e]]
            ok = reg[view.corr_img_dense[s:e]] & (pids >= 0)
            pairs = np.stack([view.line_of_corr[s:e][ok], pids[ok]], axis=1)
            pairs = np.unique(pairs, axis=0) if len(pairs) else pairs
            tri_corrs = [(int(l), int(p)) for l, p in pairs]
        else:
            tri_corrs = []  # (line_idx, point3d_id)
            for line_idx in range(img.num_lines):
                pt_ids_here: Set[int] = set()
                for iid, li in self.cache.graph.find_correspondences(
                        image_id, line_idx):
                    other = self.rec.images.get(iid)
                    if other is None or not other.registered \
                            or not _corr_cam_ok(other):
                        continue
                    pid = int(other.point3d_ids[li])
                    if pid < 0 or pid in pt_ids_here:
                        continue
                    pt_ids_here.add(pid)
                    tri_corrs.append((line_idx, pid))

        if len(tri_corrs) < max(options.abs_pose_min_num_inliers, 6):
            return False

        if (options.abs_pose_refine_focal_length
                and not cam.prior_focal_length
                and not any(o.registered and o.camera_id == cam.camera_id
                            for o in self.rec.images.values())):
            # First registration of a prior-less camera: focal search
            # over geometric candidates, scored by P6L support
            # (reference analogue: incremental_mapper.cc:676-714 /
            # upstream COLMAP focal sampling).
            self._focal_search(options, image_id, tri_corrs)

        lines = np.stack([img.lines[li] for li, _ in tri_corrs])
        aligned = np.asarray([img.aligned[li] for li, _ in tri_corrs])
        points = np.stack([self.rec.points3d[pid].xyz
                           for _, pid in tri_corrs])

        n = _bucket(len(tri_corrs), 256, growth=4)
        lines_p = np.zeros((n, 3))
        lines_p[:, 0] = 1.0
        lines_p[:len(tri_corrs)] = lines
        aligned_p = np.zeros(n, bool)
        aligned_p[:len(tri_corrs)] = aligned
        points_p = np.zeros((n, 3))
        points_p[:len(tri_corrs)] = points
        valid = np.zeros(n, bool)
        valid[:len(tri_corrs)] = True

        thresh = cam.image_to_world_threshold(options.abs_pose_max_error)
        # Adaptive termination between fixed-size hypothesis batches
        # (``ransac.h:158-176`` bound, 100..10000 trials at conf 0.99999,
        # ``incremental_mapper.cc:679-681``): the common high-inlier case
        # stops after the first (smaller) batch.
        from privacy_preserving_sfm_tpu.solvers import ransac as ransac_mod
        schedule = (max(256, options.num_hypotheses // 4),
                    options.num_hypotheses, options.num_hypotheses)
        num_valid = int(valid.sum())
        res = None
        total_trials = 0
        for nh in schedule:
            key = jax.random.PRNGKey(int(self._rng.integers(0, 2 ** 31)))
            r = self._pose_kernel(n, nh)(
                key, jnp.asarray(lines_p), jnp.asarray(aligned_p),
                jnp.asarray(points_p), jnp.asarray(valid), thresh)
            total_trials += nh
            if bool(r.success) and (res is None or
                                    int(r.num_inliers) > int(res.num_inliers)):
                res = r
            if res is not None:
                needed = float(ransac_mod.num_trials_needed(
                    int(res.num_inliers), num_valid, 6))
                if total_trials >= min(needed, 10000):
                    break
        if res is None or not bool(res.success):
            return False
        if int(res.num_inliers) < options.abs_pose_min_num_inliers:
            return False

        inlier_mask = np.asarray(res.inlier_mask)[:len(tri_corrs)]

        # Refinement (Cauchy IRLS GN on inliers), jitted per bucket.
        refine_key = ("refine", n, cam.model)
        if refine_key not in self._jit_pose:
            model = cam.model
            self._jit_pose[refine_key] = jax.jit(
                lambda q0, t0, l, p, w, cp:
                p6l.refine_absolute_pose_from_lines(q0, t0, l, p, w,
                                                    model, cp))
        q1, t1 = self._jit_pose[refine_key](
            res.qvec, res.tvec, jnp.asarray(lines_p), jnp.asarray(points_p),
            jnp.asarray(np.concatenate([
                inlier_mask.astype(float),
                np.zeros(n - len(tri_corrs))])),
            jnp.asarray(cam.params))
        if not (np.isfinite(np.asarray(q1)).all()
                and np.isfinite(np.asarray(t1)).all()):
            return False
        img.qvec = np.asarray(q1)
        img.tvec = np.asarray(t1)

        self.rec.register_image(image_id)
        self._register_image_event(image_id)

        # Continue inlier tracks.
        for i, (line_idx, pid) in enumerate(tri_corrs):
            if inlier_mask[i] and img.point3d_ids[line_idx] < 0 \
                    and pid in self.rec.points3d:
                self.rec.add_observation(pid, image_id, line_idx)
                self.triangulator.modified_point3d_ids.add(pid)
        return True

    def _focal_search(self, options: MapperOptions, image_id: int,
                      tri_corrs) -> None:
        """Pick the focal factor with the best P6L RANSAC support.

        Candidate focals act on the lifted lines as ``(a, b, c/s)`` (the
        isotropic case of ba_intrinsics.corrected_line); all candidates
        are scored in ONE device call by vmapping the pose kernel over
        the factor axis, with per-candidate normalized thresholds.  The
        winning focal is baked into the camera and every image's lines.
        """
        from privacy_preserving_sfm_tpu.ops import cameras as cam_ops
        from privacy_preserving_sfm_tpu.optim import ba_intrinsics as bai

        img = self.rec.images[image_id]
        cam = self.rec.cameras[img.camera_id]
        S = options.num_focal_length_samples
        # Geometric factors spanning the plausible focal-ratio band
        # relative to the current (heuristic) focal.
        f0 = cam.mean_focal_length()
        max_dim = max(cam.width, cam.height)
        lo = options.min_focal_length_ratio * max_dim / f0
        hi = options.max_focal_length_ratio * max_dim / f0
        scales = np.geomspace(max(lo, 0.05), min(hi, 20.0), S)

        lines = np.stack([img.lines[li] for li, _ in tri_corrs])
        aligned = np.asarray([img.aligned[li] for li, _ in tri_corrs])
        points = np.stack([self.rec.points3d[pid].xyz
                           for _, pid in tri_corrs])
        n = _bucket(len(tri_corrs), 256, growth=4)
        lines_p = np.zeros((S, n, 3))
        lines_p[:, :, 0] = 1.0
        # l(s) = normalize_ab(a, b, c / s).
        cand = np.broadcast_to(lines, (S, len(tri_corrs), 3)).copy()
        cand[:, :, 2] /= scales[:, None]
        lines_p[:, :len(tri_corrs)] = cand
        aligned_p = np.zeros(n, bool)
        aligned_p[:len(tri_corrs)] = aligned
        points_p = np.zeros((n, 3))
        points_p[:len(tri_corrs)] = points
        valid = np.zeros(n, bool)
        valid[:len(tri_corrs)] = True
        thresh = options.abs_pose_max_error / (scales * f0)

        nh = max(256, options.num_hypotheses // 4)
        kkey = ("focal", S, n, nh)
        if kkey not in self._jit_pose:
            def run(k, ls, al, p, v, th):
                f = jax.vmap(
                    lambda l, t: p6l.estimate_absolute_pose_from_lines(
                        k, l, al, p, v, t, num_hypotheses=nh))
                return f(ls, th)
            self._jit_pose[kkey] = jax.jit(run)
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2 ** 31)))
        res = self._jit_pose[kkey](
            key, jnp.asarray(lines_p), jnp.asarray(aligned_p),
            jnp.asarray(points_p), jnp.asarray(valid), jnp.asarray(thresh))
        inl = np.where(np.asarray(res.success),
                       np.asarray(res.num_inliers), -1)
        best = int(np.argmax(inl))
        if inl[best] < options.abs_pose_min_num_inliers:
            return  # keep the heuristic focal; registration decides
        s_best = float(scales[best])
        if abs(s_best - 1.0) < 1e-6:
            return
        old = np.asarray(cam.params, float)
        spec = cam_ops.MODELS[cam.model]
        new = old.copy()
        for fi in spec.focal_idxs:
            new[fi] = old[fi] * s_best
        for other in self.rec.images.values():
            if other.camera_id == cam.camera_id and len(other.lines):
                other.lines = bai.correct_lines(other.lines, old, new,
                                                cam.model)
        cam.params = new
        self.triangulator._lines_flat = None
        print(f"  => Focal search: {f0:.1f} -> {f0 * s_best:.1f} "
              f"({inl[best]} inliers)")

    def _init_kernel(self, na: int, nu: int, num_samples: int,
                     chunk: int = 128):
        """Cached jitted 4-view initializer per padding bucket — candidate
        sets reuse one compilation instead of retracing per set."""
        key = (na, nu, num_samples, chunk)
        if key not in self._jit_init:
            def run(k, al, av, un, uv, g, max_error, min_tri, min_inl):
                opts = init_mod.InitOptions(
                    min_tri_angle_deg=min_tri,
                    min_num_inliers=min_inl,
                    max_error=max_error,
                    num_samples_fourview=num_samples,
                    num_samples_offset=num_samples,
                    chunk=chunk)
                return init_mod.initialize_reconstruction(
                    k, al, av, un, uv, g, opts)
            self._jit_init[key] = jax.jit(run)
        return self._jit_init[key]

    def _init_kernel_batch(self, nb: int, na: int, nu: int,
                           num_samples: int, chunk: int = 128):
        """All candidate image sets in one vmapped device call."""
        key = ("batch", nb, na, nu, num_samples, chunk)
        if key not in self._jit_init:
            def run(k, al, av, un, uv, g, max_error, min_tri, min_inl):
                opts = init_mod.InitOptions(
                    min_tri_angle_deg=min_tri,
                    min_num_inliers=min_inl,
                    max_error=max_error,
                    num_samples_fourview=num_samples,
                    num_samples_offset=num_samples,
                    chunk=chunk)
                return init_mod.initialize_reconstruction(
                    k, al, av, un, uv, g, opts)

            def batched(k, al, av, un, uv, g, max_errors, min_tri,
                        min_inl):
                f = jax.vmap(
                    lambda a1, a2, u1, u2, gv, me: run(
                        k, a1, a2, u1, u2, gv, me, min_tri, min_inl))
                return f(al, av, un, uv, g, max_errors)

            self._jit_init[key] = jax.jit(batched)
        return self._jit_init[key]

    def _pose_kernel(self, n: int, num_hypotheses: int):
        key = (n, num_hypotheses)
        if key not in self._jit_pose:
            self._jit_pose[key] = jax.jit(
                lambda k, l, a, p, v, th: p6l.estimate_absolute_pose_from_lines(
                    k, l, a, p, v, th, num_hypotheses=num_hypotheses))
        return self._jit_pose[key]

    # -- triangulation wrappers -----------------------------------------

    def triangulate_image(self, tri_options: TriangulatorOptions,
                          image_id: int) -> int:
        return self.triangulator.triangulate_image(tri_options, image_id)

    def complete_tracks(self, tri_options: TriangulatorOptions) -> int:
        return self.triangulator.complete_all_tracks(tri_options)

    def merge_tracks(self, tri_options: TriangulatorOptions) -> int:
        return self.triangulator.merge_all_tracks(tri_options)

    # -- bundle adjustment ----------------------------------------------

    def find_local_bundle(self, options: MapperOptions,
                          image_id: int) -> List[int]:
        """Most-connected covisible images with the 8-step relaxing
        (tri-angle, overlap) schedule (``incremental_mapper.cc:993-1160``)."""
        img = self.rec.images[image_id]
        shared: Dict[int, int] = {}
        pids = [int(p) for p in img.point3d_ids if p >= 0]
        for pid in pids:
            for iid, _ in self.rec.points3d[pid].track:
                if iid != image_id:
                    shared[iid] = shared.get(iid, 0) + 1
        overlapping = sorted(shared.items(), key=lambda kv: -kv[1])
        num_eff = min(options.local_ba_num_images - 1, len(overlapping))
        if len(overlapping) == num_eff:
            return [iid for iid, _ in overlapping]

        min_tri = np.deg2rad(options.local_ba_min_tri_angle)
        num_points = img.num_points3d()
        schedule = [(min_tri / 1.0, 0.6 * num_points),
                    (min_tri / 1.5, 0.6 * num_points),
                    (min_tri / 2.0, 0.5 * num_points),
                    (min_tri / 2.5, 0.4 * num_points),
                    (min_tri / 3.0, 0.3 * num_points),
                    (min_tri / 4.0, 0.2 * num_points),
                    (min_tri / 5.0, 0.1 * num_points),
                    (min_tri / 6.0, 0.1 * num_points)]
        center = img.projection_center()
        shared_xyz = np.stack([self.rec.points3d[pid].xyz for pid in pids]) \
            if pids else np.zeros((0, 3))
        local = []
        used = set()
        tri_angles: Dict[int, float] = {}
        for ang_th, overlap_th in schedule:
            for iid, count in overlapping:
                if count < overlap_th:
                    break
                if iid in used:
                    continue
                if iid not in tri_angles:
                    from privacy_preserving_sfm_tpu.ops import lines_np
                    ocenter = self.rec.images[iid].projection_center()
                    angs = lines_np.triangulation_angle(
                        center, ocenter, shared_xyz)
                    tri_angles[iid] = float(np.percentile(angs, 75)) \
                        if len(angs) else 0.0
                if tri_angles[iid] >= ang_th:
                    local.append(iid)
                    used.add(iid)
                    if len(local) >= num_eff:
                        break
            if len(local) >= num_eff:
                break
        if len(local) < num_eff:
            for iid, _ in overlapping:
                if iid not in used:
                    local.append(iid)
                    used.add(iid)
                    if len(local) >= num_eff:
                        break
        return local

    def adjust_local_bundle(self, options: MapperOptions,
                            ba_options: ba_mod.BAOptions,
                            tri_options: TriangulatorOptions,
                            image_id: int,
                            point3d_ids: Set[int]) -> Dict[str, int]:
        report = {"merged": 0, "completed": 0, "filtered": 0,
                  "adjusted": 0}
        local_bundle = self.find_local_bundle(options, image_id)
        if local_bundle:
            config_images = [image_id] + local_bundle
            const_pose: Set[int] = set()
            const_tvec_x: Set[int] = set()
            if len(local_bundle) == 1:
                const_pose.add(local_bundle[0])
                const_tvec_x.add(image_id)
            else:
                const_pose.add(local_bundle[-1])
                const_tvec_x.add(local_bundle[-2])
            variable_points = {
                pid for pid in point3d_ids
                if pid in self.rec.points3d and (
                    self.rec.points3d[pid].error < 0
                    or len(self.rec.points3d[pid].track) <= 15)}
            import time as _time
            _t0 = _time.perf_counter()
            _, report["adjusted"] = self._run_ba(
                config_images, const_pose, const_tvec_x,
                variable_points, ba_options)
            _t1 = _time.perf_counter()
            report["merged"] = self.triangulator.merge_tracks(
                tri_options, variable_points)
            _t2 = _time.perf_counter()
            report["completed"] = self.triangulator.complete_tracks(
                tri_options, variable_points)
            report["completed"] += self.triangulator.complete_image(
                tri_options, image_id)
            _t3 = _time.perf_counter()
            self._phase_times = getattr(self, "_phase_times", {})
            for k, v in (("ba", _t1 - _t0), ("merge", _t2 - _t1),
                         ("complete", _t3 - _t2)):
                self._phase_times[k] = self._phase_times.get(k, 0.0) + v

        # Filter modified images + changed points.
        filter_pids = set()
        for iid in [image_id] + local_bundle:
            img = self.rec.images.get(iid)
            if img is None:
                continue
            filter_pids.update(int(p) for p in img.point3d_ids if p >= 0)
        filter_pids.update(p for p in point3d_ids if p in self.rec.points3d)
        import time as _time
        _t0 = _time.perf_counter()
        report["filtered"] = self.rec.filter_points3d(
            options.filter_max_reproj_error, options.filter_min_tri_angle,
            filter_pids)
        self._phase_times = getattr(self, "_phase_times", {})
        self._phase_times["filter"] = (self._phase_times.get("filter", 0.0)
                                       + _time.perf_counter() - _t0)
        return report

    def adjust_global_bundle(self, options: MapperOptions,
                             ba_options: ba_mod.BAOptions) -> bool:
        reg = list(self.rec.reg_image_ids)
        assert len(reg) >= 2
        self.rec.filter_observations_with_negative_depth()
        const_pose = {reg[0]}
        const_tvec_x = {reg[1]}
        ok, _ = self._run_ba(reg, const_pose, const_tvec_x, None,
                             ba_options)
        self.rec.normalize()
        return ok

    def _run_ba(self, config_images: Sequence[int], const_pose: Set[int],
                const_tvec_x: Set[int],
                variable_points: Optional[Set[int]],
                ba_options: ba_mod.BAOptions) -> bool:
        """Assemble a fixed-shape BAProblem and run the device LM kernel."""
        import time as _time
        _t_start = _time.perf_counter()
        rec = self.rec
        config_set = set(config_images)
        obs: List[Tuple[int, int, int]] = []  # (image_id, line_idx, pid)
        point_ids: List[int] = []
        point_index: Dict[int, int] = {}

        def point_slot(pid: int) -> int:
            if pid not in point_index:
                point_index[pid] = len(point_ids)
                point_ids.append(pid)
            return point_index[pid]

        for iid in config_images:
            img = rec.images[iid]
            for li in np.nonzero(img.point3d_ids >= 0)[0]:
                pid = int(img.point3d_ids[li])
                point_slot(pid)
                obs.append((iid, int(li), pid))

        extra_images: List[int] = []
        if variable_points is not None:
            for pid in variable_points:
                if pid not in rec.points3d:
                    continue
                point_slot(pid)
                for iid, li in rec.points3d[pid].track:
                    if iid not in config_set:
                        if iid not in extra_images:
                            extra_images.append(iid)
                        obs.append((iid, li, pid))

        if len(obs) < 6 or len(point_ids) == 0:
            return False, 0

        # Cap observations per point at 128: the dense (K, P) layouts pad
        # every point to the MAX track length, and a handful of
        # scene-spanning tracks (box300: ~300 obs) would pull K to 512,
        # and every (K, P) tensor of a large global BA with it.
        # A >128-obs track is ~40x over-determined; a deterministic
        # stride subset keeps full-arc view coverage.  (Ceres' per-obs
        # sparse layout has no such coupling, hence no reference
        # analogue; the reference's local BA caps variable tracks at 15.)
        cnt: Dict[int, int] = {}
        for _, _, pid in obs:
            cnt[pid] = cnt.get(pid, 0) + 1
        if cnt and max(cnt.values()) > 128:
            keep: List[Tuple[int, int, int]] = []
            seen: Dict[int, int] = {}
            for o in obs:
                pid = o[2]
                n = cnt[pid]
                i = seen.get(pid, 0)
                seen[pid] = i + 1
                if n <= 128 or i * 128 // n != (i - 1) * 128 // n or i == 0:
                    keep.append(o)
            obs = keep

        cam_list = list(config_images) + extra_images
        cam_index = {iid: i for i, iid in enumerate(cam_list)}
        # Bucket every axis (cameras, points, observations) so repeated
        # local/global BAs reuse a handful of compiled LM kernels.  The
        # grid is deliberately COARSE: every new (shape, options) key
        # costs a trace plus a compile or compile-cache load (seconds),
        # while the padded-slot compute it avoids costs milliseconds.
        # C ladder 16/64 covers local bundles and small-model globals
        # (the Schur system pads to 128 lanes at C<=21 either way); past
        # 64 cameras the grid switches to multiples of 64 — C keys only
        # accrue as the model grows, and x4 growth there would pad a
        # 300-camera global to 1024.  P folds all local and early-global
        # point counts into 8192, then multiples of 16384.
        n_cam = len(cam_list)
        C = _bucket_cams(n_cam)
        P = _bucket(len(point_ids), 8192, knee=16384)
        O = _bucket(len(obs), knee=32768)

        camera0 = rec.cameras[rec.images[cam_list[0]].camera_id]
        n_params = len(camera0.params)
        qvecs = np.zeros((C, 4))
        qvecs[:, 0] = 1.0
        tvecs = np.zeros((C, 3))
        cam_params = np.tile(camera0.params, (C, 1))
        dof_mask = np.zeros((C, 6))  # padded cameras fully frozen
        for i, iid in enumerate(cam_list):
            img = rec.images[iid]
            qvecs[i] = img.qvec
            tvecs[i] = img.tvec
            cam_params[i] = rec.cameras[img.camera_id].params
            if iid in const_pose or iid in extra_images:
                pass  # stays frozen
            elif iid in const_tvec_x:
                dof_mask[i] = 1.0
                dof_mask[i, 3] = 0.0
            else:
                dof_mask[i] = 1.0

        points3d = np.zeros((P, 3))
        points3d[:len(point_ids)] = np.stack(
            [rec.points3d[pid].xyz for pid in point_ids])
        point_mask = np.zeros(P)  # padded points frozen
        point_mask[:len(point_ids)] = 1.0
        if variable_points is not None:
            for pid, slot in point_index.items():
                if pid not in variable_points:
                    point_mask[slot] = 0.0

        obs_cam = np.zeros(O, np.int32)
        obs_point = np.zeros(O, np.int32)
        obs_line = np.zeros((O, 3))
        obs_line[:, 0] = 1.0
        obs_weight = np.zeros(O)
        for k, (iid, li, pid) in enumerate(obs):
            obs_cam[k] = cam_index[iid]
            obs_point[k] = point_index[pid]
            obs_line[k] = rec.images[iid].lines[li]
            obs_weight[k] = 1.0

        problem = ba_mod.BAProblem(
            qvecs=jnp.asarray(qvecs), tvecs=jnp.asarray(tvecs),
            cam_params=jnp.asarray(cam_params),
            points3d=jnp.asarray(points3d),
            obs_cam=jnp.asarray(obs_cam), obs_point=jnp.asarray(obs_point),
            obs_line=jnp.asarray(obs_line),
            obs_weight=jnp.asarray(obs_weight),
            cam_dof_mask=jnp.asarray(dof_mask),
            point_mask=jnp.asarray(point_mask))

        if (ba_options.refine_focal_length
                or ba_options.refine_principal_point
                or ba_options.refine_extra_params):
            return self._run_ba_intrinsics(problem, cam_list, point_index,
                                           dof_mask, ba_options)
        # PPSFM_BA_PATH=flat|dense|soa and PPSFM_SCHUR_MODE=auto|
        # implicit|explicit override the defaults (debug / A-B testing).
        import os as _os
        ba_path = _os.environ.get("PPSFM_BA_PATH", "")
        schur_override = _os.environ.get("PPSFM_SCHUR_MODE", "")
        if schur_override:
            ba_options = ba_options._replace(schur_mode=schur_override)
        on_accel = accelerator() == "gpu"
        solver = choose_ba_solver(C, ba_path, ba_options.schur_mode)
        use_soa = solver == "soa"
        use_dense = solver == "dense"
        dump_path = _os.environ.get("PPSFM_BA_DUMP")
        if dump_path:
            # Debug aid: persist the assembled problem before the device
            # solve so a fatal device fault (which kills the process)
            # leaves the failing inputs on disk for standalone replay.
            # Per-process, per-call suffix: concurrent workers never clobber
            # each other and a later crash keeps every prior dump.
            self._ba_dump_seq = getattr(self, "_ba_dump_seq", 0) + 1
            path = f"{dump_path}.{_os.getpid()}.{self._ba_dump_seq:04d}"
            opt_fields = {f"opt_{k}": v
                          for k, v in ba_options._asdict().items()}
            np.savez(path, qvecs=qvecs, tvecs=tvecs,
                     cam_params=cam_params, points3d=points3d,
                     obs_cam=obs_cam, obs_point=obs_point,
                     obs_line=obs_line, obs_weight=obs_weight,
                     dof_mask=dof_mask, point_mask=point_mask,
                     model=camera0.model,
                     use_dense=use_dense, ba_path=ba_path,
                     **opt_fields)
        _t_assembled = _time.perf_counter()
        if use_soa:
            from privacy_preserving_sfm_tpu.optim import ba_dense, ba_soa
            # No gather tables: the SoA solver never reads them, and M
            # (max obs/camera) is the most retrace-volatile shape.
            dense = ba_dense.from_flat_problem(problem, gather_tables=False)
            # Loss/tolerance/iteration-cap knobs ride as TRACED scalars:
            # one compiled kernel per problem SHAPE serves all six option
            # sets the controller alternates between.
            opts_static = ba_mod.DynamicBAOptions.strip(ba_options)
            dyn = ba_mod.DynamicBAOptions.from_options(ba_options)
            ba_key = ("soa", dense.obs_cam.shape, C, P,
                      camera0.model, opts_static)
            if ba_key not in self._jit_ba:
                model = camera0.model
                self._jit_ba[ba_key] = jax.jit(
                    lambda prob, dy: ba_soa.bundle_adjust_soa(
                        prob, model, opts_static, dynamic=dy))
            q, t, X, summary = self._jit_ba[ba_key](dense, dyn)
        elif use_dense:
            from privacy_preserving_sfm_tpu.optim import ba_dense
            if on_accel and C > 170 and ba_options.cam_reduce == "onehot":
                # Large problems: the one-hot camera reduction
                # materializes a (P*K, C) f32 matrix, several GB at a
                # 192-camera global with 65k points and K=128.  The
                # camera-sorted gather layout is M-bounded; this regime
                # is rare (big-model globals past explicit_fits only).
                ba_options = ba_options._replace(cam_reduce="twolayout")
            dense = ba_dense.from_flat_problem(problem)
            ba_key = (dense.obs_cam.shape, dense.cam_gather.shape, P,
                      camera0.model, ba_options)
            if ba_key not in self._jit_ba:
                model = camera0.model
                self._jit_ba[ba_key] = jax.jit(
                    lambda prob: ba_dense.bundle_adjust_dense(
                        prob, model, ba_options))
            q, t, X, summary = self._jit_ba[ba_key](dense)
        else:
            ba_key = (C, P, O, camera0.model, ba_options)
            if ba_key not in self._jit_ba:
                model = camera0.model
                self._jit_ba[ba_key] = jax.jit(
                    lambda prob: ba_mod.bundle_adjust(prob, model,
                                                      ba_options))
            q, t, X, summary = self._jit_ba[ba_key](problem)
        q, t, X = np.asarray(q), np.asarray(t), np.asarray(X)
        _t_solved = _time.perf_counter()
        self._phase_times = getattr(self, "_phase_times", {})
        for k, v in (("ba_assemble", _t_assembled - _t_start),
                     ("ba_solve", _t_solved - _t_assembled)):
            self._phase_times[k] = self._phase_times.get(k, 0.0) + v
        ba_log = _os.environ.get("PPSFM_BA_LOG")
        if ba_log:
            # One line per solve: bucket key, first-use flag (compile /
            # persistent-cache load happens on first use of a key in the
            # process), wall seconds, LM iterations taken.
            first = ba_key not in _BA_SEEN
            _BA_SEEN.add(ba_key)
            path = "soa" if use_soa else ("dense" if use_dense else "flat")
            otag = abs(hash(ba_options)) % 10000
            kb = dense.obs_cam.shape[1] if use_soa or use_dense else 0
            with open(ba_log, "a") as f:
                f.write(f"{path} C={C} P={P} K={kb} O={O} opt={otag:04d} "
                        f"first={int(first)} "
                        f"solve_s={_t_solved - _t_assembled:.3f} "
                        f"iters={int(summary.num_iterations)} "
                        f"nobs={len(obs)}\n")
        if not (np.isfinite(q).all() and np.isfinite(t).all()
                and np.isfinite(X).all()):
            return False, len(obs)
        for i, iid in enumerate(cam_list):
            if dof_mask[i].any():
                self.rec.images[iid].qvec = q[i]
                self.rec.images[iid].tvec = t[i]
        for pid, slot in point_index.items():
            if point_mask[slot] > 0:
                self.rec.points3d[pid].xyz = X[slot]
        return True, len(obs)

    def _run_ba_intrinsics(self, problem: ba_mod.BAProblem,
                           cam_list: Sequence[int], point_index: Dict[int, int],
                           dof_mask: np.ndarray,
                           ba_options: ba_mod.BAOptions):
        """Variable-intrinsics solve (optim/ba_intrinsics) + line baking.

        Intrinsics are shared per unique camera id across the image slots
        (Ceres block-sharing semantics); after an accepted solve the
        projective line correction is baked into the stored lines of
        EVERY image of each refined camera so the reconstruction's
        lines/params stay mutually consistent (see ba_intrinsics module
        docstring).  Reference: ``bundle_adjustment.cc:490-528``.
        """
        from privacy_preserving_sfm_tpu.optim import ba_intrinsics as bai

        rec = self.rec
        C = problem.qvecs.shape[0]
        cam_ids = []  # unique camera ids, slot order
        cam_of_slot = np.zeros(C, np.int32)
        for i, iid in enumerate(cam_list):
            cid = rec.images[iid].camera_id
            if cid not in cam_ids:
                cam_ids.append(cid)
            cam_of_slot[i] = cam_ids.index(cid)
        # Padded slots keep camera 0 (their observations carry weight 0).
        model = rec.cameras[cam_ids[0]].model
        intr = np.stack([rec.cameras[cid].params for cid in cam_ids])
        mask1 = bai.intr_mask_for_model(
            model, ba_options.refine_focal_length,
            ba_options.refine_principal_point,
            ba_options.refine_extra_params)
        intr_mask = np.tile(mask1, (len(cam_ids), 1))
        iproblem = bai.IntrBAProblem(
            base=problem,
            cam_of_slot=jnp.asarray(cam_of_slot),
            intr_params=jnp.asarray(intr),
            intr_mask=jnp.asarray(intr_mask),
            lift_params=jnp.asarray(intr))
        ba_key = ("intr", problem.qvecs.shape, problem.points3d.shape,
                  problem.obs_cam.shape, len(cam_ids), model, ba_options)
        if ba_key not in self._jit_ba:
            self._jit_ba[ba_key] = jax.jit(
                lambda p: bai.bundle_adjust_intrinsics(p, model,
                                                       ba_options))
        q, t, X, intr_new, summary = self._jit_ba[ba_key](iproblem)
        q, t, X = np.asarray(q), np.asarray(t), np.asarray(X)
        intr_new = np.asarray(intr_new)
        if not (np.isfinite(q).all() and np.isfinite(t).all()
                and np.isfinite(X).all() and np.isfinite(intr_new).all()):
            return False, int(np.asarray(problem.obs_weight).sum())
        for i, iid in enumerate(cam_list):
            if dof_mask[i].any():
                rec.images[iid].qvec = q[i]
                rec.images[iid].tvec = t[i]
        point_mask = np.asarray(problem.point_mask)
        for pid, slot in point_index.items():
            if point_mask[slot] > 0:
                rec.points3d[pid].xyz = X[slot]
        # Bake the correction into params + ALL lines of each camera.
        baked = False
        for u, cid in enumerate(cam_ids):
            if not (intr_mask[u] > 0).any():
                continue
            old = np.asarray(rec.cameras[cid].params, float)
            new = intr_new[u]
            if np.allclose(old, new):
                continue
            for img in rec.images.values():
                if img.camera_id == cid and len(img.lines):
                    img.lines = bai.correct_lines(img.lines, old, new,
                                                  model)
            rec.cameras[cid].params = new
            baked = True
        if baked:
            # The triangulator caches a flat line table; line values moved.
            self.triangulator._lines_flat = None
        return True, int(np.asarray(problem.obs_weight).sum())

    # -- filtering -------------------------------------------------------

    def filter_images(self, options: MapperOptions) -> int:
        if self.rec.num_registered() < 20:
            return 0
        filtered = self.rec.filter_images(
            options.min_focal_length_ratio, options.max_focal_length_ratio,
            options.max_extra_param)
        for iid in filtered:
            self._deregister_image_event(iid)
        self.filtered_images.update(filtered)
        return len(filtered)

    def filter_points(self, options: MapperOptions) -> int:
        return self.rec.filter_points3d(options.filter_max_reproj_error,
                                        options.filter_min_tri_angle)


def choose_ba_solver(num_cams: int, ba_path: str = "",
                     schur_mode: str = "auto") -> str:
    """The BA solver for a (padded) camera count: "soa", "dense" or "flat".

    On the GPU the problem goes to dense per-point blocks, by size:
      soa   — SoA component-layout explicit Schur (optim/ba_soa.py): a
              dense 6Cx6C system and a few large kernels per LM
              iteration, while ``schur_pcg.explicit_fits(C)`` (C <= 1024);
      dense — per-point blocks with implicit Schur CG beyond that.
    On the CPU the flat segment_sum solver runs (no launch cost to
    amortize, and materializing S costs more than the matvecs).  The GPU
    crossover has not been measured yet (ROADMAP).  ``ba_path`` (the
    PPSFM_BA_PATH override) forces a solver.
    """
    from privacy_preserving_sfm_tpu.optim import schur_pcg

    if ba_path:
        return ba_path
    if accelerator() != "gpu":
        return "flat"
    if schur_pcg.explicit_fits(num_cams) and \
            schur_mode in ("auto", "explicit"):
        return "soa"
    return "dense"


def _bucket_cams(n_cam: int) -> int:
    """Camera-count padding ladder for the BA compile-key diet.

    16/64 covers local bundles and small-model globals; past 64 the grid
    is multiples of 64 (a 300-camera global pads to 320, not 1024).  The
    whole grid up to 1024 sits inside the SoA explicit-Schur regime
    (``schur_pcg.explicit_fits``): large globals should stay on the SoA
    path, because the dense fallback's (P, K, 6, 3) block tensors have
    tiny minor dimensions that XLA pads into multi-GB copies at
    K=128."""
    if n_cam <= 64:
        return _bucket(n_cam, 16, growth=4)
    if n_cam <= 128:
        return 128
    return _bucket(n_cam, 64, knee=64)


def _bucket(n: int, minimum: int = 64, knee: int = 1 << 30,
            growth: int = 2) -> int:
    """Round up to the next power of ``growth``, switching to multiples
    of ``knee`` past it: geometric growth bounds the padding waste on the
    big (late-pipeline) global BAs, where a linear grid costs a few extra
    compiles (amortized by the persistent cache) but halves the padded
    work."""
    b = minimum
    while b < n and b < knee:
        b *= growth
    if n <= b:
        return b
    return ((n + knee - 1) // knee) * knee
