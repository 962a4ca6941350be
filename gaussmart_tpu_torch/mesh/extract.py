"""GaussianExtractor — render all views, fuse TSDF, extract meshes
(counterpart of gaussmart_tpu/mesh/extract.py).

``reconstruction`` caches rgb, surf-depth and unit render-normal maps per
view; ``extract_mesh_bounded`` fuses them into a dense TSDF grid and
``extract_mesh_unbounded`` in contracted space with blockwise marching
(reference utils/mesh_utils.py:73-295); ``export_image`` writes
renders/gt/vis. The maps stay on the device they were rendered on (slot
0's under a sharded backend), and the fusion runs there. The tiled
binning never drops a (splat, tile) pair, so there is no duplicate budget
to escalate.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.mesh.marching import marching_cubes_with_contraction
from gaussmart_tpu_torch.mesh.meshing import TriMesh
from gaussmart_tpu_torch.mesh.tsdf import TSDFVolume, contract, fuse_samples, uncontract
from gaussmart_tpu_torch.models.gaussians import GaussianState
from gaussmart_tpu_torch.ops.depth_normal import depths_to_points
from gaussmart_tpu_torch.render.api import render
from gaussmart_tpu_torch.trajectory import (estimate_bounding_sphere, save_img_f32,
                                            save_img_u8)


class GaussianExtractor:
    def __init__(self, state: GaussianState, bg_color=None,
                 depth_ratio: float = 0.0, backend: str = "auto", mesh=None):
        """`mesh` (parallel.make_mesh) renders over device slots with a
        sharded `backend`."""
        self.state = state
        self.mesh = mesh
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
                         depth_ratio=self.depth_ratio, backend=self.backend,
                         mesh=self.mesh)
            self.rgbmaps.append(pkg["render"])
            self.depthmaps.append(pkg["surf_depth"])
            n = pkg["rend_normal"]
            n = n / torch.clamp_min(torch.linalg.norm(n, dim=0, keepdim=True), 1e-9)
            self.normalmaps.append(n)
        self.center, self.radius = estimate_bounding_sphere(self.viewpoint_stack)
        print(f"The estimated bounding radius is {self.radius:.2f}")
        print(f"Use at least {2.0 * self.radius:.2f} for depth_trunc")

    def _masked_depth(self, cam: Camera, depth: torch.Tensor,
                      mask_background: bool) -> torch.Tensor:
        d = depth[0]
        if mask_background and cam.alpha_mask is not None:
            alpha = torch.as_tensor(cam.alpha_mask[0], device=d.device)
            d = torch.where(alpha < 0.5, torch.zeros_like(d), d)
        return d

    @torch.no_grad()
    def _observed_bounds(self, depth_trunc: float, sdf_trunc: float,
                         mask_background: bool):
        """Bounding box of the OBSERVED surface (valid rendered depth
        unprojected to world), padded by the truncation band. The reference
        ScalableTSDFVolume is unbounded — it integrates anything within
        depth_trunc of any CAMERA, which can lie well outside
        center ± depth_trunc (e.g. floors running behind a camera ring) —
        so a dense grid must be sized to the content, not the center."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for cam, depth in zip(self.viewpoint_stack, self.depthmaps):
            d = self._masked_depth(cam, depth, mask_background)
            valid = ((d > 0) & (d <= depth_trunc)).reshape(-1)
            pts = depths_to_points(cam.params(d.device), d[None])
            inf = torch.tensor(np.inf, dtype=pts.dtype, device=pts.device)
            big = torch.where(valid[:, None], pts, -inf).amax(dim=0)
            small = torch.where(valid[:, None], pts, inf).amin(dim=0)
            lo = np.minimum(lo, small.cpu().numpy())
            hi = np.maximum(hi, big.cpu().numpy())
        if not np.all(np.isfinite(lo)) or not np.all(np.isfinite(hi)):
            return self.center - depth_trunc, self.center + depth_trunc
        pad = 3.0 * sdf_trunc
        return lo - pad, hi + pad

    def extract_mesh_bounded(self, voxel_size=0.004, sdf_trunc=0.02,
                             depth_trunc=3.0, mask_background=True) -> TriMesh:
        print("Running tsdf volume integration ...")
        print(f"voxel_size: {voxel_size}\nsdf_trunc: {sdf_trunc}\n"
              f"depth_trunc: {depth_trunc}")
        lo, hi = self._observed_bounds(depth_trunc, sdf_trunc, mask_background)
        dev = self.depthmaps[0].device
        vol = TSDFVolume(lo, hi, voxel_size, sdf_trunc, device=dev)
        for cam, rgb, depth in zip(self.viewpoint_stack, self.rgbmaps,
                                   self.depthmaps):
            d = self._masked_depth(cam, depth, mask_background)
            vol.integrate(d, torch.clamp(rgb, 0, 1), cam.params(dev), depth_trunc)
        return vol.extract_mesh()

    def extract_mesh_unbounded(self, resolution: int = 1024) -> TriMesh:
        dev = self.depthmaps[0].device
        depths = torch.stack([d[0] for d in self.depthmaps])
        rgbs = torch.stack([torch.clamp(r, 0, 1) for r in self.rgbmaps])
        projs = torch.stack([torch.as_tensor(c.full_proj, device=dev)
                             for c in self.viewpoint_stack])
        center = np.asarray(self.center, np.float32)
        radius = float(self.radius)
        voxel_size = radius * 2 / resolution
        print(f"Computing sdf grid resolution {resolution}^3, "
              f"voxel_size {voxel_size}")

        def sdf_fn(pts_contracted: np.ndarray) -> np.ndarray:
            tsdf, _ = fuse_samples(pts_contracted, depths, rgbs, projs,
                                   voxel_size, center, radius, adaptive=True)
            return tsdf

        # bounding radius in contracted space from the splats' 95th pct
        xyz = self.state.params.xyz[self.state.aux.active].detach().cpu().numpy()
        normed = (xyz - center) / radius
        Rq = torch.linalg.norm(contract(torch.as_tensor(normed)), dim=-1).numpy()
        R = min(float(np.quantile(Rq, 0.95)) + 0.01, 1.9)

        def inv_contraction(v):
            return uncontract(torch.as_tensor(v, dtype=torch.float32)).numpy() * radius + center

        block = 128 if resolution % 128 == 0 else 64
        mesh = marching_cubes_with_contraction(
            sdf=sdf_fn, resolution=resolution,
            bounding_box_min=(-R, -R, -R), bounding_box_max=(R, R, R),
            level=0.0, inv_contraction=inv_contraction, block=block)

        if len(mesh.vertices):
            print("texturing mesh ...")
            _, rgbv = fuse_samples(mesh.vertices.astype(np.float32), depths,
                                   rgbs, projs, voxel_size, center, radius,
                                   adaptive=False)
            mesh.vertex_colors = rgbv
        return mesh

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
