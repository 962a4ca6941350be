#!/usr/bin/env python3
"""NeRF-synthetic benchmark driver (8 scenes, white background), pipeline
parity with reference scripts/nerf_eval.py:10-40 (counterpart of
scripts/nerf_eval.py, on the port's CLIs). Rendering takes the latest
snapshot, as the JAX driver's does.

    python -m gaussmart_tpu_torch.scripts.nerf_eval --nerf <root> \
        [--output_path ./eval/nerf] [--device cpu] [--iterations N] [--scenes lego,...]
"""
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.scripts.driver_common import (add_port_args, device_arg,
                                                       require, run_stages, train_extra)

NERF_SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials",
               "mic", "ship"]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Full NeRF-synthetic evaluation")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval/nerf")
    parser.add_argument("--nerf", type=str, default=None)
    add_port_args(parser, NERF_SCENES)
    return parser


def commands(args):
    py, out, dev = sys.executable, args.output_path, device_arg(args)
    stages = []
    if not args.skip_training:
        require(args.nerf, "--nerf dataset root required for training")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.train -s {args.nerf}/{s} "
            f"-m {out}/{s} --eval --white_background "
            f"--lambda_normal 0.0 --quiet{train_extra(args)}"
            for s in args.scenes])
    if not args.skip_rendering:
        stages.append([
            f"{py} -m gaussmart_tpu_torch.render_cli "
            f"-m {out}/{s} --skip_train --skip_mesh --quiet{dev}"
            for s in args.scenes])
    if not args.skip_metrics:
        stages.append([f"{py} -m gaussmart_tpu_torch.eval.metrics_cli -m "
                       + " ".join(f"{out}/{s}" for s in args.scenes) + dev])
    return stages


def main(argv=None) -> int:
    return run_stages(commands(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
