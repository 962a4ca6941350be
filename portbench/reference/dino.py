"""Plain PyTorch DINOv3 ViT encoder: the benchmark's reference for the
DINO term.

DINOv3 ViT-B/16 as published (facebook/dinov3-vitb16-pretrain-lvd1689m;
transformers' DINOv3ViTModel): the image resized to 224x224 by
jax.image.resize's antialiased bilinear weights (one product per axis),
ImageNet normalisation, 16x16 patches embedded by one product, CLS and 4
register tokens in front, 12 pre-norm blocks (LayerNorm eps 1e-5,
attention with 12 heads and RoPE over patch-centre coordinates in [-1, 1]
with theta 100 on the patch tokens only, LayerScale, an exact-GELU MLP of
width 3072, LayerScale), a final LayerNorm, and the CLS token as the
embedding. Weights are a dict of tensors named as in `weight_shapes`.
Imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def weight_shapes(depth: int, dim: int, mlp: int, patch: int, registers: int):
    """{name: shape} of the tower's weights, with an MLP of width `mlp`."""
    shapes = {"patch_w": (3 * patch * patch, dim), "patch_b": (dim,), "cls_token": (dim,),
              "register_tokens": (registers, dim), "norm_g": (dim,), "norm_b": (dim,)}
    for i in range(depth):
        p = f"blocks.{i}"
        shapes.update({
            f"{p}.norm1_g": (dim,), f"{p}.norm1_b": (dim,),
            f"{p}.norm2_g": (dim,), f"{p}.norm2_b": (dim,),
            f"{p}.attn.qkv_w": (dim, 3 * dim), f"{p}.attn.qkv_b": (3 * dim,),
            f"{p}.attn.proj_w": (dim, dim), f"{p}.attn.proj_b": (dim,),
            f"{p}.ls1": (dim,), f"{p}.ls2": (dim,),
            f"{p}.fc1_w": (dim, mlp), f"{p}.fc1_b": (mlp,),
            f"{p}.fc2_w": (mlp, dim), f"{p}.fc2_b": (dim,)})
    return shapes


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of an antialiased bilinear (triangle) resize as
    jax.image.resize computes them: the kernel widened by the scale when
    shrinking, columns normalised, samples outside the input zeroed."""
    inv = np.float32(n_in / n_out)
    width = max(inv, np.float32(1.0))
    s = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(s[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / width
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, np.float32(1.0)), np.float32(0.0))
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def rope_tables(grid: int, head_dim: int, theta: float):
    """cos, sin [grid*grid, head_dim] of DINOv3's 2-D RoPE: y then x
    frequency bands, each angle 2 pi coord freq, repeated for the two
    halves that rotate together."""
    c = ((np.arange(grid, dtype=np.float32) + 0.5) / grid) * 2.0 - 1.0
    yy, xx = np.meshgrid(c, c, indexing="ij")
    coords = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=1)
    freq = 1.0 / theta ** np.arange(0, 1, 4.0 / head_dim, dtype=np.float32)
    ang = (2.0 * np.pi * coords[:, :, None] * freq[None, None, :]).reshape(grid * grid, -1)
    ang = np.tile(ang, (1, 2))
    return np.cos(ang), np.sin(ang)


class Tower:
    """The encoder over weights `w` (tensors on one device)."""

    def __init__(self, w: Dict[str, torch.Tensor], heads: int = 12, patch: int = 16,
                 size: int = 224, theta: float = 100.0, eps: float = 1e-5,
                 mm: Callable = torch.matmul):
        self.w, self.heads, self.patch, self.size = w, heads, patch, size
        self.eps, self.mm = eps, mm
        self.depth = sum(1 for k in w if k.endswith(".norm1_g"))
        dim = w["cls_token"].shape[0]
        dev = w["cls_token"].device
        cos, sin = rope_tables(size // patch, dim // heads, theta)
        self.cos = torch.from_numpy(cos).to(dev)
        self.sin = torch.from_numpy(sin).to(dev)
        self.n_prefix = 1 + w["register_tokens"].shape[0]
        self._resize = {}

    def _rs(self, n):
        if n not in self._resize:
            self._resize[n] = torch.from_numpy(resize_matrix(n, self.size)).to(self.cos.device)
        return self._resize[n]

    def _dense(self, x, name):
        return self.mm(x, self.w[f"{name}_w"]) + self.w[f"{name}_b"]

    def embed(self, image: torch.Tensor) -> torch.Tensor:
        """[3,H,W] in [0,1] -> the CLS embedding [dim]."""
        mm, S, p = self.mm, self.size, self.patch
        _, H, W = image.shape
        x = image
        if W != S:
            x = mm(x, self._rs(W))
        if H != S:
            x = mm(self._rs(H).T, x)
        mean = torch.tensor(MEAN, device=x.device).reshape(3, 1, 1)
        std = torch.tensor(STD, device=x.device).reshape(3, 1, 1)
        x = (x - mean) / std
        g = S // p
        x = x.reshape(3, g, p, g, p).permute(1, 3, 0, 2, 4).reshape(g * g, 3 * p * p)
        x = self._dense(x, "patch")
        x = torch.cat([self.w["cls_token"][None], self.w["register_tokens"], x], dim=0)
        D = x.shape[1]
        hd = D // self.heads
        for i in range(self.depth):
            b = f"blocks.{i}"
            h = F.layer_norm(x, (D,), self.w[f"{b}.norm1_g"], self.w[f"{b}.norm1_b"], self.eps)
            qkv = self._dense(h, f"{b}.attn.qkv")
            q, k, v = (t.reshape(-1, self.heads, hd).transpose(0, 1) for t in qkv.chunk(3, -1))
            q, k = self._rope(q), self._rope(k)
            att = torch.softmax(mm(q, k.transpose(1, 2)) / math.sqrt(hd), dim=-1)
            h = mm(att, v).transpose(0, 1).reshape(-1, D)
            x = x + self._dense(h, f"{b}.attn.proj") * self.w[f"{b}.ls1"]
            h = F.layer_norm(x, (D,), self.w[f"{b}.norm2_g"], self.w[f"{b}.norm2_b"], self.eps)
            h = self._dense(F.gelu(self._dense(h, f"{b}.fc1")), f"{b}.fc2")
            x = x + h * self.w[f"{b}.ls2"]
        x = F.layer_norm(x, (D,), self.w["norm_g"], self.w["norm_b"], self.eps)
        return x[0]

    def _rope(self, t):
        n = self.n_prefix
        pat = t[:, n:]
        half = pat.shape[-1] // 2
        rot = torch.cat([-pat[..., half:], pat[..., :half]], dim=-1)
        return torch.cat([t[:, :n], pat * self.cos + rot * self.sin], dim=1)


def dino_term(tower: Tower, image, target, lam: float):
    """lam * (1 - cos(e(image), e(target))), the target's embedding held
    fixed."""
    e1 = tower.embed(image)
    with torch.no_grad():
        e2 = tower.embed(target)
    cos = torch.dot(e1, e2) / torch.clamp_min(torch.linalg.norm(e1) * torch.linalg.norm(e2),
                                              1e-8)
    return lam * (1.0 - cos)
