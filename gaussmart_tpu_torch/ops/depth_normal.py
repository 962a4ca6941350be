"""Depth map -> world points -> pseudo surface normals (counterpart of
gaussmart_tpu/ops/depth_normal.py): ray-grid unprojection,
central-difference cross-product normals, zero border."""
from __future__ import annotations

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.transforms import safe_normalize


def _c2w_and_intrins(cam: CameraParams):
    W, H = cam.width, cam.height
    c2w = torch.linalg.inv(cam.world_view.T)      # column-vector cam-to-world
    ndc2pix = torch.tensor([
        [W / 2.0, 0.0, 0.0, W / 2.0],
        [0.0, H / 2.0, 0.0, H / 2.0],
        [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=cam.device).T
    projection = c2w.T @ cam.full_proj            # == pure projection matrix
    intrins = (projection @ ndc2pix)[:3, :3].T
    return c2w, intrins


def depths_to_points(cam: CameraParams, depthmap: torch.Tensor) -> torch.Tensor:
    """[1,H,W] depth -> [H*W, 3] world points along pixel rays."""
    W, H = cam.width, cam.height
    c2w, intrins = _c2w_and_intrins(cam)
    dev = depthmap.device
    grid_y, grid_x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                    torch.arange(W, dtype=torch.float32, device=dev),
                                    indexing="ij")
    points = torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=-1).reshape(-1, 3)
    rays_d = points @ torch.linalg.inv(intrins).T @ c2w[:3, :3].T
    rays_o = c2w[:3, 3]
    return depthmap.reshape(-1, 1) * rays_d + rays_o


def depth_to_normal(cam: CameraParams, depth: torch.Tensor) -> torch.Tensor:
    """[1,H,W] depth -> [H,W,3] normals (zero at the 1px border)."""
    H, W = depth.shape[1], depth.shape[2]
    points = depths_to_points(cam, depth).reshape(H, W, 3)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = safe_normalize(torch.linalg.cross(dx, dy, dim=-1))
    out = torch.zeros_like(points)
    out[1:-1, 1:-1] = n
    return out
