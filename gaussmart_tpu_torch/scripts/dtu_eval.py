#!/usr/bin/env python3
"""DTU photometric benchmark driver (15 scans): train -> render -> metrics
(counterpart of scripts/dtu_eval.py, on the port's CLIs).

Pipeline parity with reference scripts/dtu_eval.py:44-69 (segmentation
preprocessing enabled, normal/dist/segment lambdas zeroed). Scenes are
independent; GAUSSMART_PARALLEL_JOBS runs several scans at once.

    python -m gaussmart_tpu_torch.scripts.dtu_eval --dtu <root> \
        [--output_path eval/dtu] [--device cpu] [--iterations N] [--scenes scan24,...]
"""
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.scripts.driver_common import (add_port_args, device_arg,
                                                       require, run_stages, train_extra)

DTU_SCENES = ["scan24", "scan37", "scan40", "scan55", "scan63", "scan65",
              "scan69", "scan83", "scan97", "scan105", "scan106", "scan110",
              "scan114", "scan118", "scan122"]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Full DTU evaluation (photometric)")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="eval/dtu")
    parser.add_argument("--clean_pc", action="store_true")
    parser.add_argument("--dtu", "-dtu", type=str, default=None)
    add_port_args(parser, DTU_SCENES)
    return parser


def commands(args):
    py, out, dev = sys.executable, args.output_path, device_arg(args)
    stages = []
    if not args.skip_training:
        require(args.dtu, "--dtu dataset root required for training")
        seg = ("--dataset_type dtu --run_segmentation --lambda_normal 0.0 "
               "--lambda_dist 0.0 --lambda_segment 0.0")
        if args.clean_pc:
            seg += " --clean"
        stages.append([
            f"{py} -m gaussmart_tpu_torch.train -s {args.dtu}/{s} "
            f"-m {out}/{s} --quiet --eval {seg}{train_extra(args)}"
            for s in args.scenes])
    if not args.skip_rendering:
        require(args.dtu, "--dtu dataset root required for rendering")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.render_cli --iteration {args.iterations} "
            f"-s {args.dtu}/{s} -m {out}/{s} --quiet --skip_mesh{dev}"
            for s in args.scenes])
    if not args.skip_metrics:
        stages.append([f"{py} -m gaussmart_tpu_torch.eval.metrics_cli -m "
                       + " ".join(f"{out}/{s}" for s in args.scenes) + dev])
    return stages


def main(argv=None) -> int:
    return run_stages(commands(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
