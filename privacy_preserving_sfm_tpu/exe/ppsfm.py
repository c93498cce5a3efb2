"""ppsfm CLI: subcommand dispatch mirroring the reference executable.

Subcommands (``src/exe/ppsfm.cc:966-976``): automatic_reconstructor,
bundle_adjuster, database_creator, exhaustive_matcher, feature_extractor,
image_filterer, mapper, project_generator, sequential_matcher,
line_initializer.  (``gui`` is out of scope; use the PLY export + any
viewer.)

Usage: ``python -m privacy_preserving_sfm_tpu.exe <subcommand> [args]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_db_arg(p):
    p.add_argument("--database_path", required=True)


def cmd_database_creator(args):
    from privacy_preserving_sfm_tpu.models.database import Database

    with Database(args.database_path):
        pass
    print(f"Created database at {args.database_path}")


def cmd_feature_extractor(args):
    import jax
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.features import extraction, sift
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.ops.cameras import MODELS
    from privacy_preserving_sfm_tpu.utils.timer import Timer, print_heading1

    print_heading1("Feature extraction")
    timer = Timer()
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
    names = sorted(n for n in os.listdir(args.image_path)
                   if n.lower().endswith(exts))
    sift_opts = sift.SiftOptions(max_num_features=args.max_num_features)
    key = jax.random.PRNGKey(args.seed)

    with Database(args.database_path) as db:
        existing = {v["name"]: k for k, v in db.read_images().items()}
        camera_ids = {}
        groups = {}  # (shape, model, n_params, has_mask) -> pending records
        for idx, name in enumerate(names):
            path = os.path.join(args.image_path, name)
            cam_info = extraction.read_camera_model_file(path)
            gravity = extraction.read_gravity_file(path)
            if gravity is None:
                print(f"  {name}: no .gravity.txt, skipping")
                continue

            img = extraction.load_image_grayscale_u8(path)
            h, w = img.shape
            prior_focal = True
            if cam_info is None:
                # No explicit calibration: EXIF focal-length cascade
                # (bitmap.cc:286-370 / image_reader.cc:117-139).
                from privacy_preserving_sfm_tpu.features.exif_focal import (
                    exif_focal_length,
                )
                focal, prior_focal = exif_focal_length(path, w, h)
                cam_info = ("SIMPLE_PINHOLE",
                            np.array([focal, w / 2.0, h / 2.0]))
                print(f"  {name}: focal from "
                      f"{'EXIF' if prior_focal else 'heuristic'} "
                      f"({focal:.1f} px)")
            model, params = cam_info
            assert model in MODELS, f"unknown camera model {model}"
            img_r, scale = extraction.resize_to_max(img, args.max_image_size)
            params_scaled = params.copy()
            if scale != 1.0:
                spec = MODELS[model]
                for i in spec.focal_idxs + spec.principal_idxs:
                    params_scaled[i] *= scale

            cam_key = (model, tuple(params), w, h)
            if cam_key not in camera_ids:
                camera_ids[cam_key] = db.write_camera(
                    model, w, h, params, prior_focal=prior_focal)
            if name in existing:
                iid = existing[name]
            else:
                # EXIF GPS (or .gps.txt sidecar) -> image prior position
                # (image_reader.cc:252-259).
                gps = extraction.read_exif_gps(path)
                iid = db.write_image(name, camera_ids[cam_key],
                                     prior_t=gps)
            if db.exists_lines(iid) and db.exists_descriptors(iid):
                continue

            mask = extraction.read_mask(path)
            mask_r = None
            if mask is not None:
                mask_r = np.asarray(jax.image.resize(
                    jnp.asarray(mask, jnp.float32), img_r.shape,
                    "nearest")) > 0.5

            key, k1 = jax.random.split(key)
            gkey = (img_r.shape, model, len(params_scaled),
                    mask_r is not None)
            groups.setdefault(gkey, []).append(dict(
                iid=iid, name=name, img=img_r, key=k1, model=model,
                params=np.asarray(params_scaled, np.float32),
                gravity=gravity, mask=mask_r))
            if len(groups[gkey]) >= args.batch_size:
                _flush_extraction_batch(db, groups.pop(gkey), sift_opts,
                                        args.aligned_line_ratio,
                                        args.batch_size)
        for batch in groups.values():
            _flush_extraction_batch(db, batch, sift_opts,
                                    args.aligned_line_ratio,
                                    args.batch_size)
        db.commit()
    timer.print_minutes()


def _flush_extraction_batch(db, batch, sift_opts, aligned_ratio,
                            batch_size):
    """One device call for up to ``batch_size`` same-shape images.

    A short tail is padded by repeating the last record (one compiled
    shape per group) and the padded outputs discarded.
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.features import extraction

    t0 = _time.perf_counter()
    n = len(batch)
    padded = batch + [batch[-1]] * (batch_size - n)
    keys = jnp.stack([r["key"] for r in padded])
    imgs = jnp.asarray(np.stack([r["img"] for r in padded]))
    params = jnp.asarray(np.stack([r["params"] for r in padded]))
    gravs = jnp.asarray(np.stack([r["gravity"] for r in padded]),
                        jnp.float32)
    masks = None
    if batch[0]["mask"] is not None:
        masks = jnp.asarray(np.stack([r["mask"] for r in padded]))
    lf = extraction.extract_and_lift_batch_jit(
        keys, imgs, batch[0]["model"], params, gravs, sift_opts,
        aligned_ratio, masks=masks)
    # One batched device-to-host transfer for the whole group.
    valid, desc, lines, aligned = jax.device_get(
        (lf.valid, lf.descriptors, lf.lines, lf.aligned))
    t1 = _time.perf_counter()
    for i, r in enumerate(batch):
        v = valid[i]
        db.write_descriptors(r["iid"], desc[i][v])
        db.write_lines(r["iid"], lines[i][v], aligned[i][v])
        db.write_gravity(r["iid"], r["gravity"])
        print(f"  {r['name']}: {int(v.sum())} features "
              f"({int(aligned[i][v].sum())} aligned)")
    print(f"  [batch of {n}: device {t1 - t0:.2f}s, "
          f"db {_time.perf_counter() - t1:.2f}s]", flush=True)


def _run_matcher(args, scheduler: str):
    from privacy_preserving_sfm_tpu.features import schedulers
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.utils.timer import Timer, print_heading1

    print_heading1(f"{scheduler.capitalize()} feature matching")
    timer = Timer()
    with Database(args.database_path) as db:
        images = db.read_images()
        ids = sorted(images.keys(), key=lambda i: images[i]["name"])
        if scheduler == "exhaustive":
            pairs = schedulers.exhaustive_pairs(ids, args.block_size)
        else:
            pairs = schedulers.sequential_pairs(ids, args.overlap)
        n = schedulers.match_pair_list(
            db, ids, pairs, min_num_matches=args.min_num_matches,
            verbose=True)
        print(f"  => {n}/{len(pairs)} pairs above threshold")
    timer.print_minutes()


def cmd_exhaustive_matcher(args):
    _run_matcher(args, "exhaustive")


def cmd_sequential_matcher(args):
    _run_matcher(args, "sequential")


def cmd_spatial_matcher(args):
    """Spatial matcher over prior positions (matching.h:331-360).

    Positions come from the image prior translations in the database (e.g.
    EXIF GPS converted to ENU at import time).
    """
    from privacy_preserving_sfm_tpu.features import schedulers
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.utils.timer import Timer, print_heading1

    print_heading1("Spatial feature matching")
    timer = Timer()
    with Database(args.database_path) as db:
        rows = db.conn.execute(
            "SELECT image_id, prior_tx, prior_ty, prior_tz FROM images;"
        ).fetchall()
        positions = {r[0]: np.asarray(r[1:4], float) for r in rows
                     if r[1] is not None}
        if getattr(args, "is_gps", True) and positions:
            # Priors are EXIF (lat, lon, alt): convert to metric ENU
            # around the first image (matching.h:331-360 semantics).
            from privacy_preserving_sfm_tpu.utils import gps as gps_mod
            keys_sorted = sorted(positions)
            lats = np.asarray([positions[k][0] for k in keys_sorted])
            lons = np.asarray([positions[k][1] for k in keys_sorted])
            alts = np.asarray([positions[k][2] for k in keys_sorted])
            if np.all(np.abs(lats) <= 90) and np.all(np.abs(lons) <= 180):
                enu = gps_mod.ell_to_enu(lats, lons, alts,
                                         lats[0], lons[0], alts[0])
                positions = {k: np.asarray(enu)[i]
                             for i, k in enumerate(keys_sorted)}
        ids = sorted(db.read_images().keys())
        pairs = schedulers.spatial_pairs(
            ids, positions, args.max_num_neighbors, args.max_distance)
        n = schedulers.match_pair_list(
            db, ids, pairs, min_num_matches=args.min_num_matches,
            verbose=True)
        print(f"  => {n}/{len(pairs)} pairs above threshold")
    timer.print_minutes()


def cmd_transitive_matcher(args):
    """Transitive closure matcher (matching.h:362-381)."""
    from privacy_preserving_sfm_tpu.features import schedulers
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.utils.timer import Timer, print_heading1

    print_heading1("Transitive feature matching")
    timer = Timer()
    with Database(args.database_path) as db:
        ids = sorted(db.read_images().keys())
        pairs = schedulers.transitive_pairs(
            db, args.num_iterations, args.min_num_matches)
        n = schedulers.match_pair_list(
            db, ids, pairs, min_num_matches=args.min_num_matches,
            verbose=True)
        print(f"  => {n}/{len(pairs)} closure pairs above threshold")
    timer.print_minutes()


def _import_raw_feature_pairs(db, match_list_path: str) -> int:
    """FeaturePairsFeatureMatcher (``matching.cc:995-1087``): blocks of

        name1 name2
        idx1 idx2
        ...
        <blank line>

    write explicit feature-index matches straight to the database.
    """
    images = db.read_images()
    by_name = {v["name"]: k for k, v in images.items()}
    num_pairs = 0
    with open(match_list_path) as f:
        lines = iter(f)
        for line in lines:
            header = line.split()
            if not header:
                continue
            assert len(header) == 2, f"bad pair header: {line!r}"
            name1, name2 = header
            matches = []
            for mline in lines:
                parts = mline.split()
                if not parts:
                    break
                matches.append((int(parts[0]), int(parts[1])))
            if name1 not in by_name or name2 not in by_name:
                print(f"SKIP: {name1} - {name2} (not in database)")
                continue
            id1, id2 = by_name[name1], by_name[name2]
            if db.exists_matches(id1, id2):
                print(f"SKIP: {name1} - {name2} (matches exist)")
                continue
            db.write_matches(id1, id2,
                             np.asarray(matches, np.uint32).reshape(-1, 2))
            num_pairs += 1
    db.commit()
    return num_pairs


def cmd_matches_importer(args):
    """Match an explicit image-pair list (``ImagePairsFeatureMatcher``) or
    import raw feature-index matches (``FeaturePairsFeatureMatcher``,
    ``--match_type raw``).
    """
    from privacy_preserving_sfm_tpu.features import schedulers
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.utils.timer import Timer, print_heading1

    print_heading1("Importing image pair matches")
    timer = Timer()
    if getattr(args, "match_type", "pairs") == "raw":
        with Database(args.database_path) as db:
            n = _import_raw_feature_pairs(db, args.match_list_path)
            print(f"  => imported {n} pairs")
        timer.print_minutes()
        return
    with Database(args.database_path) as db:
        images = db.read_images()
        by_name = {v["name"]: k for k, v in images.items()}
        pairs = []
        with open(args.match_list_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 2:
                    continue
                if parts[0] in by_name and parts[1] in by_name:
                    a, b = by_name[parts[0]], by_name[parts[1]]
                    pairs.append((min(a, b), max(a, b)))
        ids = sorted(images.keys())
        n = schedulers.match_pair_list(
            db, ids, pairs, min_num_matches=args.min_num_matches,
            verbose=True)
        print(f"  => {n}/{len(pairs)} pairs above threshold")
    timer.print_minutes()


def cmd_mapper(args):
    from privacy_preserving_sfm_tpu.sfm.controller import (
        ControllerOptions, IncrementalMapperController,
    )
    from privacy_preserving_sfm_tpu.utils.config import AllOptions
    from privacy_preserving_sfm_tpu.utils.timer import Timer

    timer = Timer()
    opts = ControllerOptions()
    input_rec = None
    if getattr(args, "input_path", ""):
        from privacy_preserving_sfm_tpu.models.reconstruction import (
            Reconstruction,
        )
        input_rec = Reconstruction.read_text(args.input_path)
        print(f"  resuming from {args.input_path} "
              f"({input_rec.num_registered()} images)")
    ctrl = IncrementalMapperController(opts, database_path=args.database_path,
                                       input_reconstruction=input_rec)
    t0 = __import__("time").perf_counter()
    recs = ctrl.run()
    mapper_wall = __import__("time").perf_counter() - t0
    num_reg = sum(r.num_registered() for r in recs)
    print(ctrl.profiler.report())
    print(f"  => images registered/s: {num_reg / max(mapper_wall, 1e-9):.3f}"
          f" ({num_reg} images in {mapper_wall:.1f}s)")
    os.makedirs(args.output_path, exist_ok=True)
    for i, rec in enumerate(recs):
        out = os.path.join(args.output_path, str(i))
        rec.write_text(out)
        all_opts = AllOptions(database_path=args.database_path,
                              image_path=args.image_path or "")
        all_opts.save(os.path.join(out, "project.ini"))
        print(f"  model {i}: {rec.num_registered()} images, "
              f"{len(rec.points3d)} points, "
              f"mean reproj {rec.compute_mean_reprojection_error():.3f}px")
    timer.print_minutes()


def cmd_hierarchical_mapper(args):
    """Block-parallel mapper (upstream COLMAP's hierarchical_mapper role;
    absent from the reference fork — see sfm/hierarchical.py)."""
    import time

    from privacy_preserving_sfm_tpu.sfm.controller import ControllerOptions
    from privacy_preserving_sfm_tpu.sfm.hierarchical import (
        HierarchicalOptions, hierarchical_map,
    )
    from privacy_preserving_sfm_tpu.utils.timer import Timer

    timer = Timer()
    opts = HierarchicalOptions(block_size=args.block_size,
                               overlap=args.overlap,
                               num_workers=args.num_workers,
                               controller=ControllerOptions())
    t0 = time.perf_counter()
    rec = hierarchical_map(args.database_path, opts,
                           platform=os.environ.get("PPSFM_PLATFORM"))
    wall = time.perf_counter() - t0
    if rec is None:
        print("  => no model produced")
        return
    print(f"  => images registered/s: "
          f"{rec.num_registered() / max(wall, 1e-9):.3f} "
          f"({rec.num_registered()} images in {wall:.1f}s)")
    out = os.path.join(args.output_path, "0")
    rec.write_text(out)
    print(f"  model 0: {rec.num_registered()} images, "
          f"{len(rec.points3d)} points, "
          f"mean reproj {rec.compute_mean_reprojection_error():.3f}px")
    timer.print_minutes()


def cmd_bundle_adjuster(args):
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.models.database_cache import DatabaseCache
    from privacy_preserving_sfm_tpu.models.reconstruction import Reconstruction
    from privacy_preserving_sfm_tpu.optim import ba as ba_mod
    from privacy_preserving_sfm_tpu.sfm.incremental_mapper import (
        IncrementalMapper, MapperOptions,
    )
    from privacy_preserving_sfm_tpu.utils.timer import Timer, print_heading1

    print_heading1("Global bundle adjustment")
    timer = Timer()
    rec = Reconstruction.read_text(args.input_path)
    rec.filter_observations_with_negative_depth()
    # A standalone BA needs no correspondence graph; reuse the mapper's
    # problem assembly with an empty cache.
    cache = DatabaseCache()
    cache.cameras = rec.cameras
    cache.images = rec.images
    mapper = IncrementalMapper(cache)
    mapper.begin_reconstruction(rec)
    opts = ba_mod.BAOptions(max_iterations=args.max_num_iterations)
    mapper.adjust_global_bundle(MapperOptions(), opts)
    os.makedirs(args.output_path, exist_ok=True)
    rec.write_text(args.output_path)
    print(f"  mean reproj error: "
          f"{rec.compute_mean_reprojection_error():.4f}px")
    timer.print_minutes()


def cmd_image_filterer(args):
    from privacy_preserving_sfm_tpu.models.reconstruction import Reconstruction

    rec = Reconstruction.read_text(args.input_path)
    before = rec.num_registered()
    rec.filter_points3d(args.max_reproj_error, args.min_tri_angle)
    filtered = rec.filter_images()
    os.makedirs(args.output_path, exist_ok=True)
    rec.write_text(args.output_path)
    print(f"Filtered {len(filtered)} of {before} images")


def cmd_line_initializer(args):
    """Standalone 4-view init debug tool (``ppsfm.cc:510-960``)."""
    from privacy_preserving_sfm_tpu.models.database import Database
    from privacy_preserving_sfm_tpu.models.database_cache import DatabaseCache
    from privacy_preserving_sfm_tpu.sfm.incremental_mapper import (
        IncrementalMapper, MapperOptions,
    )

    with Database(args.database_path) as db:
        cache = DatabaseCache.load(db, min_num_matches=4)
    rec = cache.to_reconstruction()
    mapper = IncrementalMapper(cache)
    mapper.begin_reconstruction(rec)
    ok = mapper.register_initial_line_images(MapperOptions(), cache)
    if not ok:
        print("Initialization failed")
        sys.exit(1)
    os.makedirs(args.output_path, exist_ok=True)
    rec.write_text(args.output_path)
    print(f"Initialized with images {rec.reg_image_ids} "
          f"({len(rec.points3d)} points)")


def cmd_model_viewer(args):
    """Headless replacement for the Qt model viewer (``ui/model_viewer_
    widget.cc``): renders the sparse model to PNG (single view or
    turntable sequence)."""
    from privacy_preserving_sfm_tpu.models.reconstruction import Reconstruction
    from privacy_preserving_sfm_tpu.viz import render_model, render_turntable

    rec = Reconstruction.read_text(args.input_path)
    if getattr(args, "html", None):
        from privacy_preserving_sfm_tpu.viz.interactive import export_html

        export_html(rec, args.html)
        print(f"Wrote interactive viewer {args.html}")
        return
    if not args.output_path:
        raise SystemExit("model_viewer: need --output_path or --html")
    if args.turntable > 0:
        paths = render_turntable(rec, args.output_path,
                                 num_frames=args.turntable,
                                 elev=args.elev, color_by=args.color_by)
        print(f"Wrote {len(paths)} frames to {args.output_path}")
    else:
        render_model(rec, args.output_path, elev=args.elev, azim=args.azim,
                     color_by=args.color_by)
        print(f"Wrote {args.output_path}")


def cmd_project_generator(args):
    from privacy_preserving_sfm_tpu.utils.config import AllOptions

    opts = AllOptions(database_path=args.database_path or "",
                      image_path=args.image_path or "")
    if args.quality:
        opts.apply_quality_preset(args.quality)
    opts.save(args.output_path)
    print(f"Wrote project file to {args.output_path}")


def cmd_automatic_reconstructor(args):
    from privacy_preserving_sfm_tpu.utils.config import AllOptions

    opts = AllOptions()
    if args.quality:
        opts.apply_quality_preset(args.quality)
    args.database_path = os.path.join(args.workspace_path, "database.db")
    args.max_image_size = opts.extraction.max_image_size
    args.max_num_features = opts.extraction.sift.max_num_features
    args.aligned_line_ratio = opts.extraction.aligned_line_ratio
    args.seed = 0
    args.min_num_matches = opts.matching.min_num_matches
    args.block_size = opts.matching.block_size
    args.output_path = os.path.join(args.workspace_path, "sparse")
    os.makedirs(args.workspace_path, exist_ok=True)
    cmd_feature_extractor(args)
    # One process for all phases: compiled executables and the device
    # client are set up once.
    if getattr(args, "matcher", "exhaustive") == "sequential":
        if not hasattr(args, "overlap"):
            args.overlap = 10
        cmd_sequential_matcher(args)
    else:
        cmd_exhaustive_matcher(args)
    cmd_mapper(args)


def main(argv=None):
    from privacy_preserving_sfm_tpu.utils.jax_setup import (
        enable_persistent_cache,
    )
    # Backend selection is JAX's own JAX_PLATFORMS; PPSFM_PLATFORM is an
    # explicit user choice applied through jax.config.
    platform = os.environ.get("PPSFM_PLATFORM")
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    enable_persistent_cache()
    parser = argparse.ArgumentParser(
        prog="ppsfm", description="Privacy-preserving SfM in JAX")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("database_creator")
    _add_db_arg(p)
    p.set_defaults(func=cmd_database_creator)

    p = sub.add_parser("feature_extractor")
    _add_db_arg(p)
    p.add_argument("--image_path", required=True)
    p.add_argument("--max_image_size", type=int, default=3200)
    p.add_argument("--max_num_features", type=int, default=8192)
    p.add_argument("--aligned_line_ratio", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per device call (amortizes dispatch)")
    p.set_defaults(func=cmd_feature_extractor)

    for name in ("exhaustive_matcher", "sequential_matcher"):
        p = sub.add_parser(name)
        _add_db_arg(p)
        p.add_argument("--min_num_matches", type=int, default=15)
        p.add_argument("--block_size", type=int, default=50)
        p.add_argument("--overlap", type=int, default=10)
        p.set_defaults(func=cmd_exhaustive_matcher
                       if name == "exhaustive_matcher"
                       else cmd_sequential_matcher)

    p = sub.add_parser("spatial_matcher")
    _add_db_arg(p)
    p.add_argument("--min_num_matches", type=int, default=15)
    p.add_argument("--max_num_neighbors", type=int, default=50)
    p.add_argument("--max_distance", type=float, default=100.0)
    p.add_argument("--is_gps", type=int, default=1,
                   help="priors are EXIF lat/lon/alt; convert to ENU")
    p.set_defaults(func=cmd_spatial_matcher)

    p = sub.add_parser("transitive_matcher")
    _add_db_arg(p)
    p.add_argument("--min_num_matches", type=int, default=15)
    p.add_argument("--num_iterations", type=int, default=3)
    p.set_defaults(func=cmd_transitive_matcher)

    p = sub.add_parser("matches_importer")
    _add_db_arg(p)
    p.add_argument("--match_list_path", required=True)
    p.add_argument("--min_num_matches", type=int, default=15)
    p.add_argument("--match_type", choices=["pairs", "raw"],
                   default="pairs")
    p.set_defaults(func=cmd_matches_importer)

    p = sub.add_parser("mapper")
    _add_db_arg(p)
    p.add_argument("--image_path", default="")
    p.add_argument("--input_path", default="")
    p.add_argument("--output_path", required=True)
    p.set_defaults(func=cmd_mapper)

    p = sub.add_parser("hierarchical_mapper")
    _add_db_arg(p)
    p.add_argument("--output_path", required=True)
    p.add_argument("--block_size", type=int, default=30)
    p.add_argument("--overlap", type=int, default=5)
    p.add_argument("--num_workers", type=int, default=1)
    p.set_defaults(func=cmd_hierarchical_mapper)

    p = sub.add_parser("bundle_adjuster")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_num_iterations", type=int, default=100)
    p.set_defaults(func=cmd_bundle_adjuster)

    p = sub.add_parser("image_filterer")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--max_reproj_error", type=float, default=4.0)
    p.add_argument("--min_tri_angle", type=float, default=1.5)
    p.set_defaults(func=cmd_image_filterer)

    p = sub.add_parser("line_initializer")
    _add_db_arg(p)
    p.add_argument("--output_path", required=True)
    p.set_defaults(func=cmd_line_initializer)

    p = sub.add_parser("model_viewer")
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=False, default="",
                   help="PNG path (or directory with --turntable)")
    p.add_argument("--html", default="",
                   help="write a self-contained interactive HTML viewer "
                        "(orbit/pan/zoom, color-by, frusta) instead of PNG")
    p.add_argument("--turntable", type=int, default=0,
                   help="render N azimuth frames instead of one view")
    p.add_argument("--elev", type=float, default=-60.0)
    p.add_argument("--azim", type=float, default=-90.0)
    p.add_argument("--color_by", choices=["track", "error", "depth"],
                   default="track")
    p.set_defaults(func=cmd_model_viewer)

    p = sub.add_parser("project_generator")
    p.add_argument("--database_path", default="")
    p.add_argument("--image_path", default="")
    p.add_argument("--output_path", required=True)
    p.add_argument("--quality", default="")
    p.set_defaults(func=cmd_project_generator)

    p = sub.add_parser("automatic_reconstructor")
    p.add_argument("--workspace_path", required=True)
    p.add_argument("--image_path", required=True)
    p.add_argument("--quality", default="high")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--matcher", choices=["exhaustive", "sequential"],
                   default="exhaustive")
    p.add_argument("--overlap", type=int, default=10)
    p.set_defaults(func=cmd_automatic_reconstructor)

    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
