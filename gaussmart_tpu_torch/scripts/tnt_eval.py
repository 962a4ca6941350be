#!/usr/bin/env python3
"""Tanks & Temples benchmark driver: train (with DINO passthrough) ->
unbounded mesh -> F-score vs official GT (counterpart of
scripts/tnt_eval.py, on the port's CLIs).

Pipeline parity with reference scripts/tnt_eval.py:22-73 (incl. the
--dino_start_iter/--lambda_dino passthrough unique to this driver).
eval.tnt_fscore runs on the host and takes no --device.

    python -m gaussmart_tpu_torch.scripts.tnt_eval --TNT_data <root> --TNT_GT <GT root> \
        [--output_path ./eval/tnt] [--device cpu] [--iterations N] [--scenes Barn,...]
"""
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.scripts.driver_common import (add_port_args, device_arg,
                                                       require, run_stages, train_extra)

TNT_SCENES = ["Barn", "Caterpillar", "Ignatius", "Truck"]
TNT_LARGE = ["Meetingroom", "Courthouse"]
ALL = TNT_SCENES + TNT_LARGE


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Full TnT evaluation")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval/tnt")
    parser.add_argument("--TNT_data", type=str, default=None)
    parser.add_argument("--TNT_GT", type=str, default=None)
    parser.add_argument("--dino_start_iter", type=int, default=3000)
    parser.add_argument("--lambda_dino", type=float, default=0.05)
    add_port_args(parser, ALL)
    return parser


def commands(args):
    py, out, it = sys.executable, args.output_path, args.iterations
    stages = []
    if not args.skip_training:
        require(args.TNT_data, "--TNT_data dataset root required for training")
        common = (f"--quiet --eval --depth_ratio 1.0 -r 2 "
                  f"--dino_start_iter {args.dino_start_iter} "
                  f"--lambda_dino {args.lambda_dino}")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.train "
            f"-s {args.TNT_data}/{s} -m {out}/{s} "
            f"{common} --lambda_dist {100 if s in TNT_SCENES else 10}{train_extra(args)}"
            for s in args.scenes])
    if not args.skip_rendering:
        require(args.TNT_data, "--TNT_data dataset root required for rendering")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.render_cli --iteration {it} "
            f"-s {args.TNT_data}/{s} -m {out}/{s} --quiet "
            f"--depth_ratio 1.0 --num_cluster 1 --unbounded --mesh_res 1024"
            f"{device_arg(args)}"
            for s in args.scenes])
    if not args.skip_metrics:
        require(args.TNT_GT, "--TNT_GT ground-truth root required for metrics")
        for s in args.scenes:
            stages.append([
                f"{py} -m gaussmart_tpu_torch.eval.tnt_fscore "
                f"--dataset-dir {args.TNT_GT}/{s} "
                f"--traj-path {args.TNT_GT}/{s}/{s}_COLMAP_SfM.log "
                f"--ply-path {out}/{s}/train/ours_{it}/fuse_unbounded_post.ply "
                f"--out-dir {out}/{s}"])
    return stages


def main(argv=None) -> int:
    return run_stages(commands(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
