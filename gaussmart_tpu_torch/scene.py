"""Scene orchestrator — dataset + cameras + Gaussian state (counterpart of
gaussmart_tpu/scene.py).

This slice serves trained models, so only the ``load_iteration`` path is
here: scene-type autodetect, camera lists per resolution scale, and the
snapshot under point_cloud/iteration_N/. Building a state from the
scene's point cloud (augmentation + init_from_pcd) is training work.
"""
from __future__ import annotations

import os
import random
from typing import Dict, List, Optional

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.config import ModelParams
from gaussmart_tpu_torch.io.dataset import (AUTO_CAP_WIDTH, SceneInfo,
                                            detect_and_read, load_camera)
from gaussmart_tpu_torch.io.gaussian_ply import load_gaussian_ply, save_gaussian_ply
from gaussmart_tpu_torch.models.gaussians import GaussianState


def search_max_iteration(folder: str) -> int:
    iters = [int(d.split("_")[-1]) for d in os.listdir(folder)
             if d.startswith("iteration_")]
    return max(iters)


class Scene:
    def __init__(self, args: ModelParams, load_iteration: Optional[int] = None,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 capacity: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        if load_iteration is None:
            raise NotImplementedError(
                "building a Gaussian state from the scene's point cloud "
                "(augmentation + init_from_pcd) comes with the training "
                "slice of the port; pass load_iteration to load a trained "
                "snapshot")
        self.model_path = args.model_path
        self.args = args
        if load_iteration == -1:
            self.loaded_iter = search_max_iteration(
                os.path.join(self.model_path, "point_cloud"))
        else:
            self.loaded_iter = load_iteration
        print(f"Loading trained model at iteration {self.loaded_iter}")

        info: SceneInfo = detect_and_read(
            args.source_path, args.images, args.white_background, args.eval)
        self.info = info

        if shuffle:
            rnd = random.Random(seed)
            rnd.shuffle(info.train_cameras)
            rnd.shuffle(info.test_cameras)

        self.cameras_extent = float(info.nerf_normalization["radius"])
        if args.resolution == -1 and any(
                c.width > AUTO_CAP_WIDTH
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

        self.gaussians = load_gaussian_ply(
            os.path.join(self.model_path, "point_cloud",
                         f"iteration_{self.loaded_iter}", "point_cloud.ply"),
            max_sh_degree=args.sh_degree,
            spatial_lr_scale=self.cameras_extent,
            capacity=capacity, device=device)

    def save(self, iteration: int, state: Optional[GaussianState] = None):
        state = state if state is not None else self.gaussians
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        save_gaussian_ply(path, state)

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]
