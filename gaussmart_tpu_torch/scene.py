"""Scene orchestrator — dataset + cameras + Gaussian state (counterpart of
gaussmart_tpu/scene.py).

Scene-type autodetect, camera lists per resolution scale, the seeded
camera shuffle and cameras_extent (the nerf++ radius). A new model starts
from the scene's point cloud (augmented by segment mask areas or
uniformly, then init_from_pcd) and gets input.ply and cameras.json copied
into its directory; ``load_iteration`` loads the snapshot under
point_cloud/iteration_N/ instead.
"""
from __future__ import annotations

import json
import os
import random
import shutil
from typing import Dict, List, Optional

import numpy as np

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.config import ModelParams
from gaussmart_tpu_torch.io.dataset import (AUTO_CAP_WIDTH, SceneInfo,
                                            camera_to_json, detect_and_read,
                                            load_camera)
from gaussmart_tpu_torch.io.gaussian_ply import load_gaussian_ply, save_gaussian_ply
from gaussmart_tpu_torch.io.images import image_size
from gaussmart_tpu_torch.models.gaussians import GaussianState, init_from_pcd
from gaussmart_tpu_torch.semantics.augment import (augment_by_mask_areas,
                                                   augment_uniform)


def search_max_iteration(folder: str) -> int:
    iters = [int(d.split("_")[-1]) for d in os.listdir(folder)
             if d.startswith("iteration_")]
    return max(iters)


class Scene:
    def __init__(self, args: ModelParams, load_iteration: Optional[int] = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 capacity: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        self.model_path = args.model_path
        self.args = args
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info: SceneInfo = detect_and_read(
            args.source_path, args.images, args.white_background, args.eval)
        self.info = info

        if self.loaded_iter is None:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cams = list(info.test_cameras) + list(info.train_cameras)
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)

        if shuffle:
            rnd = random.Random(seed)
            rnd.shuffle(info.train_cameras)
            rnd.shuffle(info.test_cameras)

        self.cameras_extent = float(info.nerf_normalization["radius"])
        # the photos' own widths (as the JAX loader decodes them), not the
        # intrinsics': `-i images_4` holds copies below the cap
        if args.resolution == -1 and any(
                image_size(c.image_path)[0] > AUTO_CAP_WIDTH
                for c in info.train_cameras + info.test_cameras):
            print("[ INFO ] large input images detected; rescaling to 1.6K "
                  "width (use --resolution 1 to disable)")

        self.train_cameras: Dict[float, List[Camera]] = {}
        self.test_cameras: Dict[float, List[Camera]] = {}
        for scale in resolution_scales:
            print("Loading training cameras")
            self.train_cameras[scale] = [
                load_camera(c, args.resolution, scale) for c in info.train_cameras]
            print("Loading test cameras")
            self.test_cameras[scale] = [
                load_camera(c, args.resolution, scale) for c in info.test_cameras]

        if self.loaded_iter is not None:
            self.gaussians = load_gaussian_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}", "point_cloud.ply"),
                max_sh_degree=args.sh_degree,
                spatial_lr_scale=self.cameras_extent,
                capacity=capacity, device=device)
        else:
            pcd = info.point_cloud
            pts, cols, segs = pcd.points, pcd.colors, pcd.segments
            if pcd.mask_areas:
                print("Performing mask-area-based augmentation...")
                pts, cols, segs = augment_by_mask_areas(
                    pts, cols, segs, pcd.mask_areas, seed=seed)
            elif args.uniform_upsampling:
                print("Performing uniform augmentation...")
                pts, cols = augment_uniform(pts, cols, seed=seed)
                segs = np.zeros(len(pts), np.int32)
            print(f"Final point count: {len(pts)}")
            self.gaussians = init_from_pcd(
                pts, cols, segs, max_sh_degree=args.sh_degree,
                spatial_lr_scale=self.cameras_extent, capacity=capacity,
                seed=seed, device=device)

    def save(self, iteration: int, state: Optional[GaussianState] = None):
        state = state if state is not None else self.gaussians
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        save_gaussian_ply(path, state)

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]
