"""Render / mesh / video CLI — ``python -m gaussmart_tpu_torch.render_cli -m <model>``.

The flags and output layout of gaussmart_tpu/render_cli.py:
train|test/ours_N/{renders,gt,vis}, with --render_path the traj videos,
and unless --skip_mesh the train views' TSDF mesh, fuse.ply and
fuse_post.ply (fuse_unbounded*.ply with --unbounded) with the same
defaults (depth_trunc = 2*radius, voxel = depth_trunc/mesh_res, sdf_trunc
= 5*voxel) and a diffuse texture (active_sh_degree 0); plus ``--device
{cuda,cpu}`` (default cuda: no CUDA device is an error, never a silent
CPU run). ``--n_devices D`` renders over D device slots
(parallel/sharding.py: D cards, or D slots sharing one card or the CPU):
``--shard_mode row`` (default) splits the image rows, ``--shard_mode
gaussian`` depth strata of the splats (the seeded tiled core K3 unless
the pipeline's backend is dense); the TSDF fusion then runs on slot 0's
device, where the maps are gathered.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.config import (ModelParams, PipelineParams, add_group_args,
                                        extract_group, get_combined_args)
from gaussmart_tpu_torch.mesh.extract import GaussianExtractor
from gaussmart_tpu_torch.mesh.meshing import post_process_mesh, save_mesh_ply
from gaussmart_tpu_torch.runtime import resolve_device, setup
from gaussmart_tpu_torch.scene import Scene
from gaussmart_tpu_torch.trajectory import create_video, depth_video_frames, generate_path


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
                        help="render over this many device slots")
    parser.add_argument("--shard_mode", default="row",
                        choices=["row", "gaussian"],
                        help="row: image rows split over the slots; gaussian: "
                             "depth strata of the splats")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to render (cuda unless asked otherwise)")
    return parser


def main(argv=None):
    args = get_combined_args(build_parser(), argv)
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

    mesh, backend = None, pipe.backend
    if args.n_devices > 1:
        from gaussmart_tpu_torch.parallel.sharding import (make_mesh,
                                                           sharded_render_backend)
        mesh = make_mesh(args.n_devices, device)
        backend = (sharded_render_backend(pipe.backend) if args.shard_mode == "gaussian"
                   else "row_sharded")

    it = scene.loaded_iter
    train_dir = os.path.join(args.model_path, "train", f"ours_{it}")
    test_dir = os.path.join(args.model_path, "test", f"ours_{it}")
    state = scene.gaussians
    extractor = GaussianExtractor(state, bg_color=bg,
                                  depth_ratio=pipe.depth_ratio,
                                  backend=backend, mesh=mesh)

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
        create_video(depth_video_frames([d[0].cpu().numpy() for d in extractor.depthmaps]),
                     os.path.join(traj_dir, "depth_traj.mp4"))
        create_video([n.permute(1, 2, 0).cpu().numpy() * 0.5 + 0.5
                      for n in extractor.normalmaps],
                     os.path.join(traj_dir, "normal_traj.mp4"))

    if not args.skip_mesh:
        print("export mesh ...")
        os.makedirs(train_dir, exist_ok=True)
        # diffuse-only texture (reference render.py:90)
        extractor.state = state.replace(active_sh_degree=0)
        extractor.reconstruction(scene.get_train_cameras())
        if args.unbounded:
            name = "fuse_unbounded.ply"
            mesh = extractor.extract_mesh_unbounded(resolution=args.mesh_res)
        else:
            name = "fuse.ply"
            depth_trunc = (extractor.radius * 2.0 if args.depth_trunc < 0
                           else args.depth_trunc)
            voxel_size = (depth_trunc / args.mesh_res if args.voxel_size < 0
                          else args.voxel_size)
            sdf_trunc = 5.0 * voxel_size if args.sdf_trunc < 0 else args.sdf_trunc
            mesh = extractor.extract_mesh_bounded(
                voxel_size=voxel_size, sdf_trunc=sdf_trunc, depth_trunc=depth_trunc)
        save_mesh_ply(os.path.join(train_dir, name), mesh)
        print(f"mesh saved at {os.path.join(train_dir, name)}")
        mesh_post = post_process_mesh(mesh, cluster_to_keep=args.num_cluster)
        post_path = os.path.join(train_dir, name.replace(".ply", "_post.ply"))
        save_mesh_ply(post_path, mesh_post)
        print(f"mesh post processed saved at {post_path}")
    return extractor


if __name__ == "__main__":
    main()
