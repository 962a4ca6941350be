"""A configuration's inputs, made from the seed on the device: the splats
(raw parameters as the optimiser holds them), the cameras, the targets and
the DINO tower's weights. The configuration file names its camera rig and
its splat layout; each kind is a file of its own under cameras/ and
splats/."""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from portbench import common
from portbench.reference import dino as ref_dino
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
    """The tower's weights at the configuration's widths: matrices, CLS and
    registers N(0, 0.02), LayerScale U(0.5, 1.5), biases 0, norms 1, drawn
    on the device in two calls."""
    shapes = ref_dino.weight_shapes(dino["depth"], dino["dim"], dino["patch"],
                                    dino["registers"])
    normal_keys = [k for k in shapes if k.endswith("_w") or k in ("cls_token", "register_tokens")]
    ls_keys = [k for k in shapes if k.endswith(".ls1") or k.endswith(".ls2")]
    gen = generator(seed, 5, device)
    sizes = [math.prod(shapes[k]) for k in normal_keys]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
    ls = 0.5 + torch.rand((len(ls_keys), dino["dim"]), generator=gen, device=device)
    w = {k: t.reshape(shapes[k]) for k, t in zip(normal_keys, torch.split(flat, sizes))}
    w.update({k: ls[i] for i, k in enumerate(ls_keys)})
    for k, s in shapes.items():
        if k not in w:
            fill = 1.0 if k.endswith("_g") else 0.0
            w[k] = torch.full(s, fill, dtype=torch.float32, device=device)
    return w


def write_dino_npz(w: Dict[str, torch.Tensor], dino: dict, path: str):
    """The weights in the npz layout the system's encoder reads."""
    arrays = {k: v.detach().cpu().numpy() for k, v in w.items()}
    arrays.update(meta_rope_theta=np.float32(dino["rope_theta"]),
                  meta_ln_eps=np.float32(dino["ln_eps"]),
                  meta_patch=np.int32(dino["patch"]), meta_n_heads=np.int32(dino["heads"]),
                  meta_image_size=np.int32(dino["image_size"]))
    np.savez(path, **arrays)
