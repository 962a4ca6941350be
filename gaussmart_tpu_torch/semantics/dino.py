"""DINO image encoder in torch for the embedding-alignment loss (the port's
own copy of gaussmart_tpu/semantics/dino.py, with the same names, weight
layout and npz files).

Two architectures share the forward skeleton, selected by the weights:

* **DINOv3** (`transformers.DINOv3ViTModel` semantics): RoPE over
  patch-centre coordinates in [-1,1] (theta=rope_theta, per-axis frequency
  bands, rotate-half convention, prefix tokens not rotated),
  `num_register_tokens` register tokens between CLS and patches,
  per-branch LayerScale, no learned position embedding, LN eps 1e-5,
  separate q/k/v biases with a zero key bias. Detected by
  `meta_rope_theta` in the params.
* **plain ViT** (HF `ViTModel`): a learned absolute position embedding
  added to [CLS, patches], no LayerScale, LN eps 1e-12.

Both pool as the final-LN CLS token. The MLP is read from the weights
too: `blocks.{i}.gate_w`/`up_w`/`down_w` give DINOv3's gated SiLU block,
down(silu(gate(h)) * up(h)) (ViT-7B/16), else `fc1`/`fc2` the exact-GELU
one. A projection whose `<name>_b` is absent is a plain product (the 7B
has no q/k/v bias). Inside the tower each block's two branches are the
spans `attn` and `mlp`, named under the span that holds the call
(`losses.dino.render.attn`, ...; logging_utils.child). The input is
resized to the fixed `image_size` with the JAX package's antialiased
bilinear resize, written as two products with per-axis weight matrices
(the weights of `jax.image.resize`, built in numpy), so the backward is
two matmuls and deterministic on the card. Every product is a float32
matmul, attention included (matmul, softmax, matmul); the patch embedding
is a reshape and a matmul, not a convolution.

Weights: `DinoEncoder(params, device=...)` takes the JAX package's layout
as any mapping of names to arrays (a dict, an open npz, or tensors) and
copies each array in turn to its buffer on `device`. `create(device)`
reads an npz named by $GAUSSMART_DINO_WEIGHTS or found at DEFAULT_PATHS
(the second is the JAX package's, so one converted file serves both) one
member at a time, each into one reused host buffer (page-locked for a
card) and on to its buffer, so the host holds one array of the tower at
once (the 7B is 25 GiB); it builds `random()` when the variable is "random" and
raises FileNotFoundError when there is none. `to_device` copies an
encoder to another device without the host. `convert_hf_dino` converts a
locally cached HF checkpoint (it imports transformers inside the call).
"""
from __future__ import annotations

import math
import os
import struct
import zipfile
from typing import Any, Dict, Iterator, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from gaussmart_tpu_torch.logging_utils import child

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

WEIGHT_ENV = "GAUSSMART_DINO_WEIGHTS"
DEFAULT_PATHS = [
    os.path.join(os.path.dirname(__file__), "weights", "dino_vitb16.npz"),
    os.path.expanduser("~/.cache/gaussmart_tpu/dino_vitb16.npz"),
]


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of `jax.image.resize`'s
    antialiased bilinear resize along one axis (jax/_src/image/scale.py
    compute_weight_mat, triangle kernel, no translation): the kernel is
    widened by max(in/out, 1), each column normalised, columns whose
    sample lies outside the input zeroed. out[j] = sum_i x[i] * W[i, j]."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _rope_cos_sin(gh: int, gw: int, head_dim: int, theta: float):
    """DINOv3 rotary tables for a gh x gw patch grid -> ([gh*gw, head_dim],
    [gh*gw, head_dim]) float32 numpy cos/sin, computed as the JAX package
    computes them (DINOv3ViTRopePositionEmbedding in eval mode):
    patch-centre coords normalised to [-1,1] per axis, inv_freq =
    theta^-arange(0,1,4/head_dim), angles = 2*pi*coord*freq flattened (y
    then x bands) and tiled x2 for the rotate-half halves."""
    cy = ((np.arange(gh, dtype=np.float32) + 0.5) / gh) * 2.0 - 1.0
    cx = ((np.arange(gw, dtype=np.float32) + 0.5) / gw) * 2.0 - 1.0
    yy, xx = np.meshgrid(cy, cx, indexing="ij")
    coords = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=1)  # (N, 2) y,x
    inv_freq = 1.0 / theta ** np.arange(0, 1, 4.0 / head_dim,
                                        dtype=np.float32)        # (hd/4,)
    angles = 2.0 * np.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = angles.reshape(gh * gw, -1)                          # (N, hd/2)
    angles = np.tile(angles, (1, 2))                              # (N, hd)
    return np.cos(angles), np.sin(angles)


def _dense(x, p, name):
    b = p.get(f"{name}_b")
    if b is None:
        return x @ p[f"{name}_w"]
    return torch.addmm(b, x, p[f"{name}_w"])


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _attention(x, p, prefix, n_heads, rope=None):
    N, D = x.shape
    hd = D // n_heads
    q, k, v = (t.reshape(N, n_heads, hd).transpose(0, 1)
               for t in _dense(x, p, f"{prefix}.qkv").chunk(3, dim=-1))
    if rope is not None:
        cos, sin, n_pre = rope

        def rot(t):
            pre, pat = t[:, :n_pre], t[:, n_pre:]
            return torch.cat([pre, pat * cos + _rotate_half(pat) * sin], dim=1)

        q, k = rot(q), rot(k)
    att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(hd), dim=-1)
    out = (att @ v).transpose(0, 1).reshape(N, D)
    return _dense(out, p, f"{prefix}.proj")


def _block(x, p, i, n_heads, eps, rope=None):
    pre = f"blocks.{i}"
    D = x.shape[-1]
    with child("attn"):
        h = F.layer_norm(x, (D,), p[f"{pre}.norm1_g"], p[f"{pre}.norm1_b"], eps)
        h = _attention(h, p, f"{pre}.attn", n_heads, rope=rope)
        if f"{pre}.ls1" in p:
            h = h * p[f"{pre}.ls1"]
        x = x + h
    with child("mlp"):
        h = F.layer_norm(x, (D,), p[f"{pre}.norm2_g"], p[f"{pre}.norm2_b"], eps)
        if f"{pre}.gate_w" in p:                                  # gated SiLU
            h = F.silu(_dense(h, p, f"{pre}.gate")) * _dense(h, p, f"{pre}.up")
            h = _dense(h, p, f"{pre}.down")
        else:
            h = F.gelu(_dense(h, p, f"{pre}.fc1"), approximate="none")   # exact (erf) GELU
            h = _dense(h, p, f"{pre}.fc2")
        if f"{pre}.ls2" in p:
            h = h * p[f"{pre}.ls2"]
        x = x + h
    return x


def _buffer(key: str) -> str:
    return key.replace(".", "__")


def _copy_to(a, device) -> torch.Tensor:
    """A float32 copy of one array (numpy, or a tensor anywhere) on `device`."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
    return t.to(device=device, dtype=torch.float32, copy=True)


class _NpzMembers(Mapping):
    """An npz that np.load opened from its path: its arrays by name, each
    read when it is asked for. A member stored uncompressed (np.savez's
    layout) is read with one read straight into one host buffer, which the
    next member read reuses: an array is valid until then, and its CRC is
    not checked. Any other member comes through numpy. `pinned`: the
    buffer is page-locked, for copies to a card at the link's speed."""

    def __init__(self, z, pinned: bool = False):
        self._z, self._pinned = z, pinned
        self._buf = np.empty(0, np.uint8)

    def __iter__(self) -> Iterator[str]:
        return iter(self._z.files)

    def __len__(self) -> int:
        return len(self._z.files)

    def __contains__(self, key) -> bool:
        return key in self._z.files

    def __getitem__(self, key: str) -> np.ndarray:
        try:
            info = self._z.zip.getinfo(f"{key}.npy")
        except KeyError:
            return self._z[key]
        if info.compress_type != zipfile.ZIP_STORED:
            return self._z[key]
        f = self._z.fid                                  # np.load's own file object
        f.seek(info.header_offset + 26)                  # the local header's name, extra lengths
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        f.seek(info.header_offset + 30 + name_len + extra_len)
        if np.lib.format.read_magic(f) != (1, 0):
            return self._z[key]
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        if dtype.hasobject:
            return self._z[key]
        n = math.prod(shape) * dtype.itemsize
        if self._buf.size < n:
            self._buf = (torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
                         if self._pinned else np.empty(n, np.uint8))
        if f.readinto(memoryview(self._buf)[:n]) != n:
            raise ValueError(f"{key}: the npz member ends early")
        return self._buf[:n].view(dtype).reshape(shape, order="F" if fortran else "C")


class DinoEncoder(torch.nn.Module):
    """DINO(v3) encoder: image [3,H,W] in [0,1] -> pooled embedding [D].
    The weights are buffers (frozen: nothing differentiates them), each
    copied from `params` to `device` in turn (the CPU by default)."""

    def __init__(self, params: Mapping[str, Any], patch: int = 16,
                 n_heads: int = 12, image_size: int = 224, device=None):
        super().__init__()
        self.patch = patch
        self.n_heads = n_heads
        self.image_size = image_size
        # meta_* entries are python-scalar config, not weights
        self.rope_theta = float(params["meta_rope_theta"]) \
            if "meta_rope_theta" in params else None
        self.ln_eps = float(params["meta_ln_eps"]) \
            if "meta_ln_eps" in params else (
                1e-5 if self.rope_theta is not None else 1e-12)
        self._keys = [k for k in params if not k.startswith("meta_")]
        for k in self._keys:
            self.register_buffer(_buffer(k), _copy_to(params[k], device))
        # per-device tables: (kind, sizes, device) -> tensor
        self._tables: Dict[tuple, torch.Tensor] = {}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The weights under the JAX package's names (views of the buffers)."""
        return {k: getattr(self, _buffer(k)) for k in self._keys}

    @property
    def device(self) -> torch.device:
        return getattr(self, _buffer("cls_token")).device

    @property
    def is_v3(self) -> bool:
        return self.rope_theta is not None

    @property
    def n_prefix(self) -> int:
        """Tokens before the patch tokens (CLS [+ registers])."""
        if self.is_v3 and "register_tokens" in self._keys:
            return 1 + getattr(self, _buffer("register_tokens")).shape[0]
        return 1

    @property
    def n_layers(self) -> int:
        i = 0
        while f"blocks.{i}.norm1_g" in self._keys:
            i += 1
        return i

    def _table(self, key, make, device) -> torch.Tensor:
        full = key + (device,)
        if full not in self._tables:
            self._tables[full] = torch.from_numpy(make()).to(device)
        return self._tables[full]

    def resize(self, image: torch.Tensor) -> torch.Tensor:
        """[3,H,W] -> [3,S,S] as jax.image.resize(..., "bilinear"): one
        product per axis whose size changes."""
        S = self.image_size
        _, H, W = image.shape
        x = image
        if W != S:
            x = x @ self._table(("resize", W, S), lambda: resize_weights(W, S), x.device)
        if H != S:
            wy = self._table(("resize", H, S), lambda: resize_weights(H, S), x.device)
            x = wy.T @ x
        return x

    def tokens(self, image: torch.Tensor) -> torch.Tensor:
        """Full forward -> all final-norm tokens [n_prefix+(S/p)^2, D]
        (CLS first, then registers for v3, then patches). The loss
        (__call__) and the CLS-patch heatmap both ride it."""
        p = self.params
        S = self.image_size
        dev = image.device
        x = self.resize(image)
        norm = self._table(("imagenet",), lambda: np.stack([IMAGENET_MEAN, IMAGENET_STD]),
                           dev)
        x = (x - norm[0].reshape(3, 1, 1)) / norm[1].reshape(3, 1, 1)

        # patch embedding as one matmul: [(S/p)^2, 3*p*p] @ W
        g = S // self.patch
        x = x.reshape(3, g, self.patch, g, self.patch)
        x = x.permute(1, 3, 0, 2, 4).reshape(g * g, -1)
        x = _dense(x, p, "patch")                                 # [N, D]

        cls = p["cls_token"].reshape(1, -1)
        if self.is_v3:
            pre = [cls]
            if "register_tokens" in p:
                pre.append(p["register_tokens"])
            x = torch.cat(pre + [x], dim=0)
            hd = cls.shape[1] // self.n_heads
            cos_sin = self._table(("rope", g, hd),
                                  lambda: np.stack(_rope_cos_sin(g, g, hd, self.rope_theta)),
                                  dev)
            rope = (cos_sin[0], cos_sin[1], self.n_prefix)
        else:
            x = torch.cat([cls, x], dim=0) + p["pos_embed"]
            rope = None
        for i in range(self.n_layers):
            x = _block(x, p, i, self.n_heads, self.ln_eps, rope=rope)
        return F.layer_norm(x, (x.shape[-1],), p["norm_g"], p["norm_b"], self.ln_eps)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.tokens(image)[0]                              # CLS pooled

    # -- constructors -------------------------------------------------------
    def to_device(self, device) -> "DinoEncoder":
        """A copy of the encoder on `device`, each buffer copied there from
        where it lies (device to device, not through the host)."""
        meta = {"meta_ln_eps": self.ln_eps}
        if self.is_v3:
            meta["meta_rope_theta"] = self.rope_theta
        return DinoEncoder({**meta, **self.params}, patch=self.patch, n_heads=self.n_heads,
                           image_size=self.image_size, device=device)

    @staticmethod
    def create(device=None) -> "DinoEncoder":
        """The encoder of $GAUSSMART_DINO_WEIGHTS (an npz, or "random") or
        of the first of DEFAULT_PATHS that exists, on `device` (the CPU by
        default). An npz is read one member at a time, each straight into
        its buffer."""
        path = os.environ.get(WEIGHT_ENV)
        if path == "random":
            # testing escape hatch: a small random-weight encoder so the
            # training loop exercises the differentiable DINO path
            return DinoEncoder.random(device=device)
        cands = ([path] if path else []) + DEFAULT_PATHS
        for c in cands:
            if c and os.path.exists(c):
                with np.load(c) as z:
                    members = _NpzMembers(
                        z, pinned=device is not None and torch.device(device).type == "cuda")
                    return DinoEncoder(
                        members,
                        patch=int(members.get("meta_patch", 16)),
                        n_heads=int(members.get("meta_n_heads", 12)),
                        image_size=int(members.get("meta_image_size", 224)),
                        device=device)
        raise FileNotFoundError(
            f"No DINO weights found (set ${WEIGHT_ENV} or place "
            f"{DEFAULT_PATHS[0]})")

    @staticmethod
    def random(depth: int = 2, dim: int = 192, n_heads: int = 3,
               image_size: int = 64, patch: int = 16, seed: int = 0,
               n_registers: int = 4, device=None) -> "DinoEncoder":
        """Random-weight DINOv3-architecture tower (RoPE + registers +
        LayerScale), the same arrays as the JAX package's for a seed."""
        return DinoEncoder(random_params(depth, dim, patch, seed, n_registers),
                           patch=patch, n_heads=n_heads, image_size=image_size,
                           device=device)


def random_params(depth: int = 2, dim: int = 192, patch: int = 16, seed: int = 0,
                  n_registers: int = 4) -> Dict[str, np.ndarray]:
    """The weight dict of DinoEncoder.random, drawn from
    np.random.default_rng(seed) in the JAX package's order."""
    rng = np.random.default_rng(seed)
    D = dim
    p = {
        "patch_w": rng.normal(0, 0.02, (3 * patch * patch, D)).astype(np.float32),
        "patch_b": np.zeros(D, np.float32),
        "cls_token": rng.normal(0, 0.02, (D,)).astype(np.float32),
        "register_tokens": rng.normal(0, 0.02, (n_registers, D)).astype(np.float32),
        "norm_g": np.ones(D, np.float32),
        "norm_b": np.zeros(D, np.float32),
        "meta_rope_theta": np.float32(100.0),
        "meta_ln_eps": np.float32(1e-5),
    }
    for i in range(depth):
        pre = f"blocks.{i}"
        p[f"{pre}.norm1_g"] = np.ones(D, np.float32)
        p[f"{pre}.norm1_b"] = np.zeros(D, np.float32)
        p[f"{pre}.norm2_g"] = np.ones(D, np.float32)
        p[f"{pre}.norm2_b"] = np.zeros(D, np.float32)
        p[f"{pre}.attn.qkv_w"] = rng.normal(0, 0.02, (D, 3 * D)).astype(np.float32)
        p[f"{pre}.attn.qkv_b"] = np.zeros(3 * D, np.float32)
        p[f"{pre}.attn.proj_w"] = rng.normal(0, 0.02, (D, D)).astype(np.float32)
        p[f"{pre}.attn.proj_b"] = np.zeros(D, np.float32)
        p[f"{pre}.ls1"] = np.full(D, 1.0, np.float32)
        p[f"{pre}.ls2"] = np.full(D, 1.0, np.float32)
        p[f"{pre}.fc1_w"] = rng.normal(0, 0.02, (D, 4 * D)).astype(np.float32)
        p[f"{pre}.fc1_b"] = np.zeros(4 * D, np.float32)
        p[f"{pre}.fc2_w"] = rng.normal(0, 0.02, (4 * D, D)).astype(np.float32)
        p[f"{pre}.fc2_b"] = np.zeros(D, np.float32)
    return p


def _convert_dinov3(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """`DINOv3ViTModel` state dict -> DinoEncoder params.

    Layout (transformers 4.57, modeling_dinov3_vit.py): embeddings.{cls_token,
    register_tokens, patch_embeddings.{weight,bias}}, layer.{i}.{norm1, norm2,
    attention.{q,k,v,o}_proj, layer_scale{1,2}.lambda1, mlp.{up,down}_proj
    (and mlp.gate_proj with use_gated_mlp)}, norm.{weight,bias}. The q/k/v
    biases pack into qkv_b with zeros for the absent ones (key_bias=False);
    with none of them, and for every other bias the state dict lacks
    (mlp_bias=False, proj_bias=False), the entry is left out."""
    D = int(cfg.hidden_size)
    gated = bool(getattr(cfg, "use_gated_mlp", False))
    act = getattr(cfg, "hidden_act", "silu" if gated else "gelu")
    if act != ("silu" if gated else "gelu"):
        raise NotImplementedError(
            f"DINOv3 with hidden_act={act!r} (gated={gated}): the encoder runs "
            "gated SiLU and exact GELU blocks only")
    out = {
        "patch_w": sd["embeddings.patch_embeddings.weight"].reshape(D, -1).T,
        "cls_token": sd["embeddings.cls_token"].reshape(-1),
        "norm_g": sd["norm.weight"],
        "norm_b": sd["norm.bias"],
        "meta_rope_theta": np.float32(cfg.rope_theta),
        "meta_ln_eps": np.float32(cfg.layer_norm_eps),
        "meta_patch": np.int32(cfg.patch_size),
        "meta_n_heads": np.int32(cfg.num_attention_heads),
        "meta_image_size": np.int32(cfg.image_size),
    }

    def put(key, name):
        if name in sd:
            out[key] = sd[name]

    put("patch_b", "embeddings.patch_embeddings.bias")
    if int(getattr(cfg, "num_register_tokens", 0) or 0) > 0:
        out["register_tokens"] = sd["embeddings.register_tokens"].reshape(-1, D)
    mlp = {"gate": "gate", "up": "up", "down": "down"} if gated else {"fc1": "up", "fc2": "down"}
    i = 0
    while f"layer.{i}.attention.q_proj.weight" in sd:
        pre, blk = f"layer.{i}", f"blocks.{i}"
        q = sd[f"{pre}.attention.q_proj.weight"]
        k = sd[f"{pre}.attention.k_proj.weight"]
        v = sd[f"{pre}.attention.v_proj.weight"]
        out[f"{blk}.attn.qkv_w"] = np.concatenate([q, k, v], 0).T
        qkv_b = [f"{pre}.attention.{n}_proj.bias" for n in "qkv"]
        if any(n in sd for n in qkv_b):
            out[f"{blk}.attn.qkv_b"] = np.concatenate(
                [sd[n] if n in sd else np.zeros(D, np.float32) for n in qkv_b])
        out[f"{blk}.attn.proj_w"] = sd[f"{pre}.attention.o_proj.weight"].T
        put(f"{blk}.attn.proj_b", f"{pre}.attention.o_proj.bias")
        out[f"{blk}.norm1_g"] = sd[f"{pre}.norm1.weight"]
        out[f"{blk}.norm1_b"] = sd[f"{pre}.norm1.bias"]
        out[f"{blk}.norm2_g"] = sd[f"{pre}.norm2.weight"]
        out[f"{blk}.norm2_b"] = sd[f"{pre}.norm2.bias"]
        out[f"{blk}.ls1"] = sd[f"{pre}.layer_scale1.lambda1"]
        out[f"{blk}.ls2"] = sd[f"{pre}.layer_scale2.lambda1"]
        for ours, theirs in mlp.items():
            out[f"{blk}.{ours}_w"] = sd[f"{pre}.mlp.{theirs}_proj.weight"].T
            put(f"{blk}.{ours}_b", f"{pre}.mlp.{theirs}_proj.bias")
        i += 1
    return out


def _convert_vit(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF `ViTModel`/DINO(v1)/DINOv2-style state dict -> DinoEncoder params."""
    def find(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(names)

    D = find("embeddings.cls_token").reshape(-1).shape[0]
    out = {
        "patch_w": find("embeddings.patch_embeddings.projection.weight")
        .reshape(D, -1).T,
        "patch_b": find("embeddings.patch_embeddings.projection.bias"),
        "cls_token": find("embeddings.cls_token").reshape(-1),
        "pos_embed": find("embeddings.position_embeddings").reshape(-1, D),
        "norm_g": find("layernorm.weight"),
        "norm_b": find("layernorm.bias"),
    }
    i = 0
    while f"encoder.layer.{i}.attention.attention.query.weight" in sd:
        pre = f"encoder.layer.{i}"
        q = sd[f"{pre}.attention.attention.query.weight"]
        k = sd[f"{pre}.attention.attention.key.weight"]
        v = sd[f"{pre}.attention.attention.value.weight"]
        out[f"blocks.{i}.attn.qkv_w"] = np.concatenate([q, k, v], 0).T
        out[f"blocks.{i}.attn.qkv_b"] = np.concatenate([
            sd[f"{pre}.attention.attention.query.bias"],
            sd[f"{pre}.attention.attention.key.bias"],
            sd[f"{pre}.attention.attention.value.bias"]])
        out[f"blocks.{i}.attn.proj_w"] = sd[f"{pre}.attention.output.dense.weight"].T
        out[f"blocks.{i}.attn.proj_b"] = sd[f"{pre}.attention.output.dense.bias"]
        out[f"blocks.{i}.norm1_g"] = sd[f"{pre}.layernorm_before.weight"]
        out[f"blocks.{i}.norm1_b"] = sd[f"{pre}.layernorm_before.bias"]
        out[f"blocks.{i}.norm2_g"] = sd[f"{pre}.layernorm_after.weight"]
        out[f"blocks.{i}.norm2_b"] = sd[f"{pre}.layernorm_after.bias"]
        out[f"blocks.{i}.fc1_w"] = sd[f"{pre}.intermediate.dense.weight"].T
        out[f"blocks.{i}.fc1_b"] = sd[f"{pre}.intermediate.dense.bias"]
        out[f"blocks.{i}.fc2_w"] = sd[f"{pre}.output.dense.weight"].T
        out[f"blocks.{i}.fc2_b"] = sd[f"{pre}.output.dense.bias"]
        i += 1
    return out


def convert_hf_dino(model_name_or_path: str, out_path: str) -> str:
    """Convert a locally cached HF DINOv3 / plain-ViT checkpoint to the
    DinoEncoder npz layout (the JAX package's: one file serves both).
    DINOv3 (`DINOv3ViTModel`) is detected by its `layer.N.attention.q_proj`
    state-dict keys; the generic `ViTModel` layout is also read."""
    from transformers import AutoModel

    model = AutoModel.from_pretrained(model_name_or_path)
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}

    if "layer.0.attention.q_proj.weight" in sd:
        out = _convert_dinov3(sd, model.config)
    else:
        out = _convert_vit(sd)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    return out_path
