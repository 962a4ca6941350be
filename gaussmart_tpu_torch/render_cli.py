"""Render CLI — ``python -m gaussmart_tpu_torch.render_cli -m <model> --skip_mesh``.

The flags and output layout of gaussmart_tpu/render_cli.py:
train|test/ours_N/{renders,gt,vis} and, with --render_path, the traj
videos; plus ``--device {cuda,cpu}`` (default cuda: no CUDA device is an
error, never a silent CPU run). Mesh export (run unless --skip_mesh) comes
with the TSDF slice and multi-device rendering (--n_devices > 1) with the
multi-device slice: both raise before any work.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

from gaussmart_tpu_torch.config import (ModelParams, PipelineParams, add_group_args,
                                        extract_group, get_combined_args)
from gaussmart_tpu_torch.mesh.extract import GaussianExtractor
from gaussmart_tpu_torch.runtime import resolve_device, setup
from gaussmart_tpu_torch.scene import Scene
from gaussmart_tpu_torch.trajectory import create_video, generate_path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="gaussmart_tpu_torch rendering")
    add_group_args(parser, ModelParams, sentinel=True)
    add_group_args(parser, PipelineParams)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--skip_mesh", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--render_path", action="store_true")
    parser.add_argument("--voxel_size", default=-1.0, type=float)
    parser.add_argument("--depth_trunc", default=-1.0, type=float)
    parser.add_argument("--sdf_trunc", default=-1.0, type=float)
    parser.add_argument("--num_cluster", default=50, type=int)
    parser.add_argument("--unbounded", action="store_true")
    parser.add_argument("--mesh_res", default=1024, type=int)
    parser.add_argument("--n_devices", default=1, type=int,
                        help="multi-device inference")
    parser.add_argument("--shard_mode", default="row",
                        choices=["row", "gaussian"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to render (cuda unless asked otherwise)")
    return parser


def main(argv=None):
    args = get_combined_args(build_parser(), argv)
    if not args.skip_mesh:
        raise NotImplementedError(
            "mesh export (TSDF fusion) comes with the TSDF slice of the "
            "port; pass --skip_mesh")
    if args.n_devices > 1:
        raise NotImplementedError(
            "--n_devices > 1 comes with the multi-device slice of the port")
    setup()
    device = resolve_device(args.device)
    print("Rendering " + args.model_path)
    if args.quiet:
        sys.stdout = open(os.devnull, "w")

    dataset = extract_group(args, ModelParams)
    pipe = extract_group(args, PipelineParams)
    scene = Scene(dataset, load_iteration=args.iteration, shuffle=False,
                  device=device)
    bg = [1, 1, 1] if dataset.white_background else [0, 0, 0]

    it = scene.loaded_iter
    train_dir = os.path.join(args.model_path, "train", f"ours_{it}")
    test_dir = os.path.join(args.model_path, "test", f"ours_{it}")
    extractor = GaussianExtractor(scene.gaussians, bg_color=bg,
                                  depth_ratio=pipe.depth_ratio,
                                  backend=pipe.backend)

    if not args.skip_train:
        print("export training images ...")
        extractor.reconstruction(scene.get_train_cameras())
        extractor.export_image(train_dir)

    if not args.skip_test and len(scene.get_test_cameras()) > 0:
        print("export rendered testing images ...")
        extractor.reconstruction(scene.get_test_cameras())
        extractor.export_image(test_dir)

    if args.render_path:
        print("render videos ...")
        traj_dir = os.path.join(args.model_path, "traj", f"ours_{it}")
        cam_traj = generate_path(scene.get_train_cameras(), n_frames=240)
        extractor.reconstruction(cam_traj)
        extractor.export_image(traj_dir)
        create_video([r.permute(1, 2, 0).cpu().numpy() for r in extractor.rgbmaps],
                     os.path.join(traj_dir, "render_traj.mp4"))
        # depth: log curve with [3, 97] percentile limits from frame 0,
        # turbo-coloured; normals map [-1,1] -> [0,1]
        import matplotlib
        d0 = extractor.depthmaps[0][0].cpu().numpy()
        pos = d0[d0 > 0]
        lims = np.percentile(pos if pos.size else np.ones(1), [3, 97])
        lo, hi = np.log(np.maximum(lims, 1e-6))
        turbo = matplotlib.colormaps["turbo"]

        def depth_frame(d):
            x = np.log(np.maximum(d[0].cpu().numpy(), 1e-6))
            x = np.clip((x - min(lo, hi)) / max(abs(hi - lo), 1e-9), 0, 1)
            return turbo(x)[..., :3]

        create_video([depth_frame(d) for d in extractor.depthmaps],
                     os.path.join(traj_dir, "depth_traj.mp4"))
        create_video([n.permute(1, 2, 0).cpu().numpy() * 0.5 + 0.5
                      for n in extractor.normalmaps],
                     os.path.join(traj_dir, "normal_traj.mp4"))
    return extractor


if __name__ == "__main__":
    main()
