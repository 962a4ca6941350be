#!/usr/bin/env python3
"""Mip-NeRF 360 benchmark driver (5 outdoor -r4 + 4 indoor -r2 scenes),
pipeline parity with reference scripts/m360_eval.py (counterpart of
scripts/m360_eval.py, on the port's CLIs).

    python -m gaussmart_tpu_torch.scripts.m360_eval --m360 <root> \
        [--output_path ./eval/m360] [--device cpu] [--iterations N] [--scenes garden,...]
"""
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.scripts.driver_common import (add_port_args, device_arg,
                                                       require, run_stages, train_extra)

OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
INDOOR = ["room", "counter", "kitchen", "bonsai"]
RESOLUTION = {**{s: 4 for s in OUTDOOR}, **{s: 2 for s in INDOOR}}


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Full Mip-NeRF360 evaluation")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval/m360")
    parser.add_argument("--m360", "-m360", type=str, default=None)
    add_port_args(parser, OUTDOOR + INDOOR)
    return parser


def commands(args):
    py, out, dev = sys.executable, args.output_path, device_arg(args)
    stages = []
    if not args.skip_training:
        require(args.m360, "--m360 dataset root required for training")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.train -s {args.m360}/{s} "
            f"-m {out}/{s} --quiet --eval -r {RESOLUTION[s]} "
            f"--depth_ratio 0.0{train_extra(args)}"
            for s in args.scenes])
    if not args.skip_rendering:
        require(args.m360, "--m360 dataset root required for rendering")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.render_cli --iteration {args.iterations} "
            f"-s {args.m360}/{s} -m {out}/{s} --quiet --skip_mesh{dev}"
            for s in args.scenes])
    if not args.skip_metrics:
        stages.append([f"{py} -m gaussmart_tpu_torch.eval.metrics_cli -m "
                       + " ".join(f"{out}/{s}" for s in args.scenes) + dev])
    return stages


def main(argv=None) -> int:
    return run_stages(commands(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
