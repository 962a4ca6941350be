"""GaussianExtractor — render every view and export the images
(counterpart of gaussmart_tpu/mesh/extract.py).

``reconstruction`` caches rgb, surf-depth and unit render-normal maps per
view; ``export_image`` writes renders/gt/vis. The tiled binning never
drops a (splat, tile) pair, so there is no duplicate budget to escalate.
TSDF fusion and mesh extraction come with the meshing slice.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.models.gaussians import GaussianState
from gaussmart_tpu_torch.render.api import render
from gaussmart_tpu_torch.trajectory import (estimate_bounding_sphere, save_img_f32,
                                            save_img_u8)


class GaussianExtractor:
    def __init__(self, state: GaussianState, bg_color=None,
                 depth_ratio: float = 0.0, backend: str = "auto"):
        self.state = state
        self.bg = torch.tensor(bg_color if bg_color is not None else [0, 0, 0],
                               dtype=torch.float32, device=state.device)
        self.depth_ratio = depth_ratio
        self.backend = backend
        self.clean()

    def clean(self):
        self.rgbmaps: List[torch.Tensor] = []
        self.depthmaps: List[torch.Tensor] = []
        self.normalmaps: List[torch.Tensor] = []
        self.viewpoint_stack: List[Camera] = []

    @torch.inference_mode()
    def reconstruction(self, viewpoint_stack: List[Camera]):
        self.clean()
        self.viewpoint_stack = list(viewpoint_stack)
        for cam in self.viewpoint_stack:
            pkg = render(cam.params(self.state.device), self.state, self.bg,
                         depth_ratio=self.depth_ratio, backend=self.backend)
            self.rgbmaps.append(pkg["render"])
            self.depthmaps.append(pkg["surf_depth"])
            n = pkg["rend_normal"]
            n = n / torch.clamp_min(torch.linalg.norm(n, dim=0, keepdim=True), 1e-9)
            self.normalmaps.append(n)
        self.center, self.radius = estimate_bounding_sphere(self.viewpoint_stack)
        print(f"The estimated bounding radius is {self.radius:.2f}")
        print(f"Use at least {2.0 * self.radius:.2f} for depth_trunc")

    def export_image(self, path: str):
        render_path = os.path.join(path, "renders")
        gts_path = os.path.join(path, "gt")
        vis_path = os.path.join(path, "vis")
        for p in (render_path, gts_path, vis_path):
            os.makedirs(p, exist_ok=True)
        for idx, cam in enumerate(self.viewpoint_stack):
            if cam.image is not None:
                save_img_u8(np.transpose(cam.image, (1, 2, 0)),
                            os.path.join(gts_path, f"{idx:05d}.png"))
            save_img_u8(self.rgbmaps[idx].permute(1, 2, 0).cpu().numpy(),
                        os.path.join(render_path, f"{idx:05d}.png"))
            save_img_f32(self.depthmaps[idx][0].cpu().numpy(),
                         os.path.join(vis_path, f"depth_{idx:05d}.tiff"))
            save_img_u8(self.normalmaps[idx].permute(1, 2, 0).cpu().numpy() * 0.5 + 0.5,
                        os.path.join(vis_path, f"normal_{idx:05d}.png"))
