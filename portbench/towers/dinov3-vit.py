"""The DINOv3 ViT with an exact-GELU MLP, as the configurations run
ViT-B/16 (facebook/dinov3-vitb16-pretrain-lvd1689m): the tower of a
configuration whose `dino` names no `kind`. Every width comes from the
`dino` dict's keys: depth, dim, heads, mlp, patch, registers, image_size,
rope_theta, ln_eps. The encoder is reference/dino.py's.

A tower kind provides draw(dino, seed, device), npz_meta(dino),
Tower(weights, dino, mm) with .embed(image), and term_flops(dino, height,
width)."""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from portbench import scene
from portbench.reference import dino as ref_dino

STREAM = 5


def draw(dino: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights from the seed: matrices, CLS and registers N(0, 0.02),
    LayerScale U(0.5, 1.5), biases 0, norms 1, drawn on the device in two
    calls of the seed's stream STREAM."""
    shp = ref_dino.weight_shapes(dino["depth"], dino["dim"], dino["mlp"], dino["patch"],
                                 dino["registers"])
    normal_keys = [k for k in shp if k.endswith("_w") or k in ("cls_token", "register_tokens")]
    ls_keys = [k for k in shp if k.endswith(".ls1") or k.endswith(".ls2")]
    gen = scene.generator(seed, STREAM, device)
    sizes = [math.prod(shp[k]) for k in normal_keys]
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.02
    ls = 0.5 + torch.rand((len(ls_keys), dino["dim"]), generator=gen, device=device)
    w = {k: t.reshape(shp[k]) for k, t in zip(normal_keys, torch.split(flat, sizes))}
    w.update({k: ls[i] for i, k in enumerate(ls_keys)})
    for k, s in shp.items():
        if k not in w:
            fill = 1.0 if k.endswith("_g") else 0.0
            w[k] = torch.full(s, fill, dtype=torch.float32, device=device)
    return w


def npz_meta(dino: dict) -> Dict[str, np.ndarray]:
    """The `meta_*` entries the system's encoder reads beside the weights."""
    return dict(meta_rope_theta=np.float32(dino["rope_theta"]),
                meta_ln_eps=np.float32(dino["ln_eps"]), meta_patch=np.int32(dino["patch"]),
                meta_n_heads=np.int32(dino["heads"]),
                meta_image_size=np.int32(dino["image_size"]))


class Tower(ref_dino.Tower):
    def __init__(self, weights: Dict[str, torch.Tensor], dino: dict,
                 mm: Callable = torch.matmul):
        super().__init__(weights, heads=dino["heads"], patch=dino["patch"],
                         size=dino["image_size"], theta=dino["rope_theta"], eps=dino["ln_eps"],
                         mm=mm)


def term_flops(dino: dict, height: int, width: int) -> float:
    """Float32 operations of the DINO term on a height x width render: the
    render's and the target's forwards and the backward to the render (each
    product's input gradient costs its forward again, attention's two
    products twice), counted from the widths; norms, GELU and softmax left
    out."""
    S, p, L, D, M = dino["image_size"], dino["patch"], dino["depth"], dino["dim"], dino["mlp"]
    N = 1 + dino["registers"] + (S // p) ** 2
    resize = 2 * 3 * height * width * S + 2 * 3 * S * height * S
    dense = 2 * (S // p) ** 2 * 3 * p * p * D + L * (2 * N * D * 3 * D + 2 * N * D * D
                                                      + 2 * 2 * N * D * M)
    attention = L * 2 * 2 * N * N * D
    return 2 * (resize + dense + attention) + resize + dense + 2 * attention
