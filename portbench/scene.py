"""A configuration's inputs, made from the seed on the device: the splats
(raw parameters as the optimiser holds them), the cameras, the targets and
the DINO tower's weights. The configuration file names its camera rig and
its splat layout; each kind is a file of its own under cameras/ and
splats/."""
from __future__ import annotations

import zipfile
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from portbench import common
from portbench.reference.raster import Camera, camera_matrices

SH_C0 = 0.28209479177387814
CAPACITY_MULTIPLE = 256


class Scene(NamedTuple):
    params: Dict[str, torch.Tensor]   # xyz, features_dc, features_rest, scaling, rotation, opacity
    active: torch.Tensor              # [C] bool
    cams: List[dict]                  # R (camera-to-world), t (world-to-camera), fovx, fovy
    width: int
    height: int
    spatial_lr_scale: float


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent stream of the seed for each kind of draw."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % (1 << 63))


def bimodal_opacity_logit(n, gen, device):
    """bench.py's mid-training opacity: 60% in [0.7, 0.99], the rest in
    [0.05, 0.3], as logits."""
    u = torch.rand((3, n), generator=gen, device=device)
    op = torch.where(u[0] < 0.6, 0.7 + 0.29 * u[1], 0.05 + 0.25 * u[2])
    return torch.log(op / (1 - op))[:, None]


def build(cfg: dict, seed: int, device) -> Scene:
    n, deg = cfg["splats"], cfg["sh_degree"]
    raw = common.module("splats", cfg["layout"]["kind"]).make(cfg["layout"], n, deg, seed, device)
    raw["opacity"] = bimodal_opacity_logit(n, generator(seed, 3, device), device)
    C = -(-n // CAPACITY_MULTIPLE) * CAPACITY_MULTIPLE
    pad = {"xyz": 0.0, "features_dc": 0.0, "features_rest": 0.0, "scaling": -10.0,
           "rotation": 0.0, "opacity": -10.0}
    params = {}
    for k, v in raw.items():
        extra = torch.full((C - n,) + v.shape[1:], pad[k], dtype=torch.float32, device=device)
        if k == "rotation":
            extra[:, 0] = 1.0
        params[k] = torch.cat([v.float(), extra]).contiguous()
    active = torch.arange(C, device=device) < n
    cams = common.module("cameras", cfg["cameras"]["kind"]).make(cfg["cameras"], cfg["views"], seed)
    scale = cfg.get("spatial_lr_scale", "cameras")
    if scale == "cameras":
        scale = camera_extent(cams)
    return Scene(params, active, cams, cfg["width"], cfg["height"], float(scale))


def camera_extent(cams) -> float:
    """The NeRF++ normalisation radius of the camera centres, x1.1."""
    centres = np.stack([-np.asarray(c["R"]) @ np.asarray(c["t"]) for c in cams])
    return float(1.1 * np.linalg.norm(centres - centres.mean(0), axis=1).max())


def camera(c: dict, width: int, height: int, device) -> Camera:
    return camera_matrices(c["R"], c["t"], c["fovx"], c["fovy"], width, height, device)


def targets(n_views: int, width: int, height: int, seed: int, device) -> torch.Tensor:
    """[views, 3, H, W] seeded target images in [0, 1], in one draw."""
    return torch.rand((n_views, 3, height, width), generator=generator(seed, 4, device),
                      device=device)


def train_views(cfg: dict, cams: List[dict]) -> List[int]:
    """The training views: every `holdout`-th view is held out, as --eval."""
    hold = cfg["cameras"].get("holdout", 0)
    return [i for i in range(len(cams)) if not hold or i % hold != 0]


def dino_weights(dino: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The tower's weights from the seed, on the device, as the tower kind
    that the configuration's `dino` names draws them."""
    return common.tower(dino).draw(dino, seed, device)


def write_dino_npz(w: Dict[str, torch.Tensor], dino: dict, path: str):
    """The weights and the tower kind's `meta_*` entries in the npz layout
    the system's encoder reads (np.savez's), written one array at a time
    through one host buffer of the largest array's size: the host holds one
    array of the tower at once, and no array pays a fresh allocation's page
    faults (on an H100's host those made the write of ViT-B/16 ~0.3 s
    slower than np.savez's)."""
    arrays = dict(w, **common.tower(dino).npz_meta(dino))
    staged = torch.empty(max(v.numel() * v.element_size() for v in w.values()), dtype=torch.uint8)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor):
                a = staged[:v.numel() * v.element_size()].view(v.dtype).view(v.shape)
                a = a.copy_(v.detach()).numpy()
            else:
                a = np.asarray(v)
            with zf.open(f"{k}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, a, allow_pickle=False)
