"""The DINOv3 ViT with a gated SiLU MLP, as DINOv3 ViT-7B/16 is published
(facebook/dinov3-vit7b16-pretrain-lvd1689m; transformers' DINOv3ViTModel
with use_gated_mlp=True, hidden_act="silu"): each block's MLP is
down(silu(gate(h)) * up(h)), the attention's q/k/v products carry no bias,
its output projection and the MLP's three do. Every width comes from the
`dino` dict's keys: depth, dim, heads, mlp, patch, registers, image_size,
rope_theta, ln_eps. The encoder is written here in plain PyTorch on
reference/dino.py's resize and RoPE tables, and imports nothing of the
program.

A tower kind provides draw(dino, seed, device), npz_meta(dino),
Tower(weights, dino, mm) with .embed(image), and term_flops(dino, height,
width)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from portbench import common, scene
from portbench.reference import dino as ref_dino

STREAM = 5


def weight_shapes(dino: dict) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the tower's weights in the layout the system's
    encoder reads (semantics/dino.py: `gate`, `up`, `down` for the MLP, no
    `qkv_b`)."""
    D, M, p = dino["dim"], dino["mlp"], dino["patch"]
    shapes = {"patch_w": (3 * p * p, D), "patch_b": (D,), "cls_token": (D,),
              "register_tokens": (dino["registers"], D), "norm_g": (D,), "norm_b": (D,)}
    for i in range(dino["depth"]):
        b = f"blocks.{i}"
        shapes.update({
            f"{b}.norm1_g": (D,), f"{b}.norm1_b": (D,), f"{b}.norm2_g": (D,), f"{b}.norm2_b": (D,),
            f"{b}.attn.qkv_w": (D, 3 * D), f"{b}.attn.proj_w": (D, D), f"{b}.attn.proj_b": (D,),
            f"{b}.ls1": (D,), f"{b}.ls2": (D,),
            f"{b}.gate_w": (D, M), f"{b}.gate_b": (M,), f"{b}.up_w": (D, M), f"{b}.up_b": (M,),
            f"{b}.down_w": (M, D), f"{b}.down_b": (D,)})
    return shapes


def draw(dino: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights from the seed: matrices, CLS and registers N(0, 0.02),
    LayerScale U(0.5, 1.5), biases 0, norms 1, drawn on the device one
    array at a time from the seed's stream STREAM and scaled in place, so
    the draw holds the tower once (25 GiB at 7B)."""
    gen = scene.generator(seed, STREAM, device)
    w = {}
    for k, s in weight_shapes(dino).items():
        if k.endswith("_w") or k in ("cls_token", "register_tokens"):
            w[k] = torch.randn(s, generator=gen, device=device).mul_(0.02)
        elif k.endswith((".ls1", ".ls2")):
            w[k] = torch.rand(s, generator=gen, device=device).add_(0.5)
        else:
            w[k] = torch.full(s, 1.0 if k.endswith("_g") else 0.0, dtype=torch.float32,
                              device=device)
    return w


def npz_meta(dino: dict):
    """The `meta_*` entries the system's encoder reads beside the weights
    (those of the exact-GELU kind: the MLP is told by its weights' names)."""
    return common.module("towers", "dinov3-vit").npz_meta(dino)


class Tower(ref_dino.Tower):
    """The gated encoder over weights `w` (tensors on one device); every
    product goes through `mm`."""

    def __init__(self, weights: Dict[str, torch.Tensor], dino: dict,
                 mm: Callable = torch.matmul):
        super().__init__(weights, heads=dino["heads"], patch=dino["patch"],
                         size=dino["image_size"], theta=dino["rope_theta"], eps=dino["ln_eps"],
                         mm=mm)

    def _dense(self, x, name):
        y = self.mm(x, self.w[f"{name}_w"])
        b = self.w.get(f"{name}_b")
        return y if b is None else y + b

    def embed(self, image: torch.Tensor) -> torch.Tensor:
        """[3,H,W] in [0,1] -> the CLS embedding [dim]."""
        mm, S, p, w = self.mm, self.size, self.patch, self.w
        _, H, W = image.shape
        x = image
        if W != S:
            x = mm(x, self._rs(W))
        if H != S:
            x = mm(self._rs(H).T, x)
        mean = torch.tensor(ref_dino.MEAN, device=x.device).reshape(3, 1, 1)
        std = torch.tensor(ref_dino.STD, device=x.device).reshape(3, 1, 1)
        x = (x - mean) / std
        g = S // p
        x = x.reshape(3, g, p, g, p).permute(1, 3, 0, 2, 4).reshape(g * g, 3 * p * p)
        x = self._dense(x, "patch")
        x = torch.cat([w["cls_token"][None], w["register_tokens"], x], dim=0)
        D = x.shape[1]
        hd = D // self.heads
        for i in range(self.depth):
            b = f"blocks.{i}"
            h = F.layer_norm(x, (D,), w[f"{b}.norm1_g"], w[f"{b}.norm1_b"], self.eps)
            qkv = self._dense(h, f"{b}.attn.qkv")
            q, k, v = (t.reshape(-1, self.heads, hd).transpose(0, 1) for t in qkv.chunk(3, -1))
            q, k = self._rope(q), self._rope(k)
            att = torch.softmax(mm(q, k.transpose(1, 2)) / math.sqrt(hd), dim=-1)
            h = mm(att, v).transpose(0, 1).reshape(-1, D)
            x = x + self._dense(h, f"{b}.attn.proj") * w[f"{b}.ls1"]
            h = F.layer_norm(x, (D,), w[f"{b}.norm2_g"], w[f"{b}.norm2_b"], self.eps)
            h = F.silu(self._dense(h, f"{b}.gate")) * self._dense(h, f"{b}.up")
            x = x + self._dense(h, f"{b}.down") * w[f"{b}.ls2"]
        x = F.layer_norm(x, (D,), w["norm_g"], w["norm_b"], self.eps)
        return x[0]


def term_flops(dino: dict, height: int, width: int) -> float:
    """Float32 operations of the DINO term on a height x width render: the
    render's and the target's forwards and the backward to the render (each
    product's input gradient costs its forward again, attention's two
    products twice), counted from the widths: per block q/k/v, the output
    projection and the MLP's three products; norms, SiLU, the gate's
    product and softmax left out."""
    S, p, L, D, M = dino["image_size"], dino["patch"], dino["depth"], dino["dim"], dino["mlp"]
    N = 1 + dino["registers"] + (S // p) ** 2
    resize = 2 * 3 * height * width * S + 2 * 3 * S * height * S
    dense = 2 * (S // p) ** 2 * 3 * p * p * D + L * (2 * N * D * 3 * D + 2 * N * D * D
                                                      + 3 * 2 * N * D * M)
    attention = L * 2 * 2 * N * N * D
    return 2 * (resize + dense + attention) + resize + dense + 2 * attention
