"""One-command north-star report (one JSON file).

Chains: synthetic dataset (rendered images + gravity + calibration) ->
automatic_reconstructor (SIFT -> line lift -> exhaustive match -> mapper)
-> pose-parity evaluation vs ground truth (tools/evaluate.py protocol) ->
front-end metrics (tools/frontend_eval.py) -> one JSON report covering
BASELINE.md configs 1-4.

Parity is reported against ground-truth poses, per the protocol of
``compare_colmap_poses.m`` — documented in the report.

Usage:
  python tools/make_report.py --out report.json \
      [--workspace /tmp/ws50c --dataset /tmp/synth50]  # reuse a run
  python tools/make_report.py --fresh --platform gpu   # run everything
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="report.json")
    ap.add_argument("--dataset", default="/tmp/synth50")
    ap.add_argument("--workspace", default="/tmp/ws50c")
    ap.add_argument("--num-images", type=int, default=50)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--fresh", action="store_true",
                    help="regenerate dataset + rerun the pipeline")
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from privacy_preserving_sfm_tpu.utils.jax_setup import (
        enable_persistent_cache,
    )

    enable_persistent_cache()

    report = {
        "report": "north-star parity + throughput (BASELINE.md configs 1-4)",
        "dataset": {
            "kind": "rendered synthetic (tools/synth_dataset.py)",
            "num_images": args.num_images,
            "path": args.dataset,
        },
        "platform": args.platform,
        "reference_head_to_head": (
            "blocked: the reference C++ requires Eigen/Ceres/Boost/"
            "FreeImage/glog which are not installed and cannot be "
            "installed in this environment; parity is measured against "
            "ground-truth poses with the compare_colmap_poses.m protocol "
            "instead"),
    }

    if args.fresh or not os.path.exists(
            os.path.join(args.dataset, "gt_poses.txt")):
        from tools.synth_dataset import make_dataset  # type: ignore
        make_dataset(args.dataset, args.num_images)

    sparse0 = os.path.join(args.workspace, "sparse", "0")
    if args.fresh or not os.path.exists(sparse0):
        from privacy_preserving_sfm_tpu.exe.ppsfm import main as ppsfm_main
        t0 = time.time()
        ppsfm_main(["automatic_reconstructor",
                    "--workspace_path", args.workspace,
                    "--image_path", args.dataset])
        report["pipeline_wall_s"] = time.time() - t0

    # Pose parity vs GT (config 3/4).
    import importlib.util

    def load_tool(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    evaluate = load_tool("evaluate")
    rec, est = evaluate.read_model_poses(sparse0)
    ref = evaluate.read_gt_poses(os.path.join(args.dataset, "gt_poses.txt"))
    pose_report = evaluate.evaluate(est, ref, align=True)
    pose_report.pop("per_image")
    pose_report["mean_reproj_error_px"] = \
        rec.compute_mean_reprojection_error()
    pose_report["mean_track_length"] = rec.compute_mean_track_length()
    pose_report["num_points3d"] = len(rec.points3d)
    report["pose_parity_vs_gt"] = pose_report

    print(json.dumps(report, indent=2))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
