#!/usr/bin/env python3
"""DTU geometry benchmark driver: train (mesh recipe) -> TSDF mesh ->
Chamfer vs official STL ground truth (counterpart of
scripts/dtu_eval_mesh.py, on the port's CLIs).

Recipe parity with reference scripts/dtu_eval_mesh.py:22-50:
`--depth_ratio 1.0 -r 2 --lambda_dist 1000`, TSDF voxel .004 sdf_trunc
.016 depth_trunc 3.0, then mask culling and Chamfer with ObsMask
filtering (eval.cull, on the host: it takes no --device). Each scan's
culled mesh and results.json go to tmp/scan<id> beside this file, as
the JAX driver writes them beside itself.

    python -m gaussmart_tpu_torch.scripts.dtu_eval_mesh --dtu <root> --DTU <official GT> \
        [--output_path ./eval/dtu] [--device cpu] [--iterations N] [--scenes scan24,...]
"""
import os
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.scripts.driver_common import (add_port_args, device_arg,
                                                       require, run_stages, train_extra)

DTU_SCENES = ["scan24", "scan37", "scan40", "scan55", "scan63", "scan65",
              "scan69", "scan83", "scan97", "scan105", "scan106", "scan110",
              "scan114", "scan118", "scan122"]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Full DTU evaluation (mesh/Chamfer)")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval/dtu")
    parser.add_argument("--dtu", "-dtu", type=str, default=None)
    parser.add_argument("--DTU_Official", "-DTU", type=str, default=None)
    add_port_args(parser, DTU_SCENES)
    return parser


def cull_dir(scan_id: str) -> str:
    """Where eval.cull writes a scan's culled mesh and results.json."""
    return f"{os.path.dirname(os.path.abspath(__file__))}/tmp/scan{scan_id}"


def commands(args):
    py, out, it = sys.executable, args.output_path, args.iterations
    stages = []
    if not args.skip_training:
        require(args.dtu, "--dtu dataset root required for training")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.train -s {args.dtu}/{s} "
            f"-m {out}/{s} --quiet --depth_ratio 1.0 -r 2 "
            f"--lambda_dist 1000{train_extra(args)}"
            for s in args.scenes])
    if not args.skip_rendering:
        require(args.dtu, "--dtu dataset root required for rendering")
        stages.append([
            f"{py} -m gaussmart_tpu_torch.render_cli --iteration {it} "
            f"-s {args.dtu}/{s} -m {out}/{s} --quiet --skip_train "
            f"--depth_ratio 1.0 --num_cluster 1 --voxel_size 0.004 "
            f"--sdf_trunc 0.016 --depth_trunc 3.0{device_arg(args)}"
            for s in args.scenes])
    if not args.skip_metrics:
        require(args.DTU_Official, "--DTU_Official ground-truth root required for metrics")
        for s in args.scenes:
            scan_id = s[4:]
            stages.append([
                f"{py} -m gaussmart_tpu_torch.eval.cull "
                f"--input_mesh {out}/{s}/train/ours_{it}/fuse_post.ply "
                f"--scan_id {scan_id} --output_dir {cull_dir(scan_id)} "
                f"--mask_dir {args.dtu} --DTU {args.DTU_Official}"])
    return stages


def main(argv=None) -> int:
    return run_stages(commands(build_parser().parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
