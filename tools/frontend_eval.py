"""Front-end parity evidence: repeatability + match inlier rate vs GT.

On a rendered synthetic dataset (tools/synth_dataset.py), for image pairs
with known ground-truth homographies:

  * keypoint repeatability under viewpoint change: fraction of keypoints
    of image A whose H-mapped location has a keypoint of image B within
    ``tol`` pixels;
  * match inlier rate: fraction of ratio-test matches consistent with the
    GT homography within ``tol`` pixels;

measured for BOTH feature-selection policies (top-scale, the reference's
ExtractTopScaleFeatures at ``feature.cc:79-114``, and top-response) —
VERDICT r1 item 5.

Usage: python tools/frontend_eval.py DATASET_DIR [--pairs 3] [--json OUT]
Runs on CPU by default (--gpu to use the GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def view_homography(meta, R, t):
    """Texture->image homography of a view (synth_dataset composition)."""
    f, w, h = meta["f"], meta["width"], meta["height"]
    S, z0 = meta["plane_S"], meta["plane_z0"]
    ax_c, ay_c = meta["plane_ax"], meta["plane_ay"]
    tex = meta["tex_size"]
    M = np.array([[1.0, 0, 0], [0, 1.0, 0], [ax_c, ay_c, z0]])
    T = np.array([[2 * S / tex, 0, -S], [0, 2 * S / tex, -S], [0, 0, 1.0]])
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    return K @ (R @ M + t[:, None] @ np.array([[0.0, 0.0, 1.0]])) @ T


def apply_h(H, xy):
    hom = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ H.T
    return hom[:, :2] / hom[:, 2:3]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--step", type=int, default=2,
                    help="index gap between pair members")
    ap.add_argument("--tol", type=float, default=3.0)
    ap.add_argument("--max_features", type=int, default=4096)
    ap.add_argument("--descriptor_mode", default="dense",
                    choices=("dense", "gather"))
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--json", dest="json_out")
    args = ap.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from privacy_preserving_sfm_tpu.features import matching, sift
    from privacy_preserving_sfm_tpu.features.extraction import (
        load_image_grayscale,
    )
    from privacy_preserving_sfm_tpu.ops import lie_np
    from privacy_preserving_sfm_tpu.utils.jax_setup import (
        enable_persistent_cache,
    )

    enable_persistent_cache()
    with open(os.path.join(args.dataset, "meta.json")) as fh:
        meta = json.load(fh)
    poses = {}
    with open(os.path.join(args.dataset, "gt_poses.txt")) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            poses[p[0]] = (lie_np.quat_to_rotmat([float(v) for v in p[1:5]]),
                           np.asarray([float(v) for v in p[5:8]]))
    names = sorted(poses)
    pair_names = [(names[i], names[i + args.step])
                  for i in range(0, args.pairs * args.step, args.step)]

    report = {}
    for selection in ("scale", "response"):
        opts = sift.SiftOptions(max_num_features=args.max_features,
                                selection=selection,
                                descriptor_mode=args.descriptor_mode)
        extract = jax.jit(lambda im: sift.extract_sift(im, opts))
        feats = {}
        for name in {n for p in pair_names for n in p}:
            img = load_image_grayscale(os.path.join(args.dataset, name))
            f = extract(jnp.asarray(img))
            feats[name] = (np.asarray(f.keypoints),
                           np.asarray(f.descriptors),
                           np.asarray(f.valid))

        rep_rates, inlier_rates, match_counts = [], [], []
        for na, nb in pair_names:
            kpa, da, va = feats[na]
            kpb, db_, vb = feats[nb]
            Ha = view_homography(meta, *poses[na])
            Hb = view_homography(meta, *poses[nb])
            H_ab = Hb @ np.linalg.inv(Ha)

            xa = kpa[va, :2]
            xb = kpb[vb, :2]
            xa_in_b = apply_h(H_ab, xa)
            w, h = meta["width"], meta["height"]
            vis = ((xa_in_b[:, 0] >= 0) & (xa_in_b[:, 0] < w)
                   & (xa_in_b[:, 1] >= 0) & (xa_in_b[:, 1] < h))
            if vis.sum() == 0:
                continue
            d2 = ((xa_in_b[vis, None] - xb[None]) ** 2).sum(-1)
            rep = (d2.min(1) <= args.tol ** 2).mean()
            rep_rates.append(float(rep))

            res = matching.match_descriptors(
                jnp.asarray(da), jnp.asarray(db_),
                jnp.asarray(va.astype(bool)), jnp.asarray(vb.astype(bool)))
            idx2 = np.asarray(res.matches if hasattr(res, "matches")
                              else res)
            rows = np.nonzero(idx2 >= 0)[0]
            m1 = kpa[rows, :2]
            m2 = kpb[idx2[rows], :2]
            err = np.linalg.norm(apply_h(H_ab, m1) - m2, axis=1)
            inlier_rates.append(float((err <= args.tol).mean())
                                if len(err) else 0.0)
            match_counts.append(int(len(rows)))

        report[selection] = {
            "mean_repeatability": float(np.mean(rep_rates)),
            "mean_match_inlier_rate": float(np.mean(inlier_rates)),
            "mean_num_matches": float(np.mean(match_counts)),
            "num_pairs": len(rep_rates),
        }

    print(json.dumps(report, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(report, fh, indent=2)


if __name__ == "__main__":
    main()
