"""Camera model (counterpart of gaussmart_tpu/cameras.py).

Row-vector matrices, i.e. ``x_view = x_world_h @ world_view`` and
``x_clip = x_world_h @ full_proj``; znear=0.01, zfar=100, z_sign=+1
perspective with w_clip = z_view. The host-side matrices are numpy, as in
the JAX package; ``params(device)`` puts them on a device as torch tensors
in the same [4,4] layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale=1.0) -> np.ndarray:
    """Row-vector world->view transform."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return Rt.T.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Row-vector perspective projection."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.T


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Device-side camera: float32 tensors on one device."""
    world_view: torch.Tensor      # [4,4]
    full_proj: torch.Tensor       # [4,4]
    camera_center: torch.Tensor   # [3]
    tanfovx: float
    tanfovy: float
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    def to(self, device) -> "CameraParams":
        return dataclasses.replace(self, world_view=self.world_view.to(device),
                                   full_proj=self.full_proj.to(device),
                                   camera_center=self.camera_center.to(device))


def _params(world_view, full_proj, camera_center, fovx, fovy, width, height,
            device) -> CameraParams:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CameraParams(world_view=t(world_view), full_proj=t(full_proj),
                        camera_center=t(camera_center),
                        tanfovx=math.tan(fovx * 0.5),
                        tanfovy=math.tan(fovy * 0.5),
                        width=int(width), height=int(height))


@dataclasses.dataclass
class Camera:
    """Host-side camera with its GT image."""
    uid: int
    colmap_id: int
    image_name: str
    R: np.ndarray               # [3,3] cam-to-world rotation (COLMAP style)
    T: np.ndarray               # [3] world-to-cam translation
    fovx: float
    fovy: float
    width: int
    height: int
    image: Optional[np.ndarray] = None        # [3,H,W] float32 in [0,1]
    alpha_mask: Optional[np.ndarray] = None   # [1,H,W] or None
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        self.world_view = world_to_view(self.R, self.T, self.trans, self.scale)
        self.proj = projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj = (self.world_view @ self.proj).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view)[3, :3].astype(np.float32)

    @property
    def image_width(self) -> int:
        return self.width

    @property
    def image_height(self) -> int:
        return self.height

    def params(self, device="cuda") -> CameraParams:
        return _params(self.world_view, self.full_proj, self.camera_center,
                       self.fovx, self.fovy, self.width, self.height, device)

    def c2w(self) -> np.ndarray:
        """Column-vector camera-to-world 4x4 (for trajectory utils)."""
        return np.linalg.inv(self.world_view.T)


class MiniCam:
    """Viewer-protocol camera."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.width = int(width)
        self.height = int(height)
        self.image_width = int(width)
        self.image_height = int(height)
        self.fovx = fovx
        self.fovy = fovy
        self.znear = znear
        self.zfar = zfar
        self.world_view = np.asarray(world_view_transform, np.float32)
        self.full_proj = np.asarray(full_proj_transform, np.float32)
        self.camera_center = np.linalg.inv(self.world_view)[3, :3]

    def params(self, device="cuda") -> CameraParams:
        return _params(self.world_view, self.full_proj, self.camera_center,
                       self.fovx, self.fovy, self.width, self.height, device)
