"""Quaternion / rotation helpers (counterpart of gaussmart_tpu/transforms.py).

Quaternions are (w, x, y, z); quat_to_rotmat normalizes first.
"""
from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3], normalizing the quaternion."""
    ss = torch.sum(q * q, dim=-1, keepdim=True)
    q = q / torch.sqrt(torch.where(ss > 1e-12, ss, torch.ones_like(ss)))
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def safe_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize; zero vectors stay zero, with NaN-free gradients (the
    squared sum is guarded before the sqrt)."""
    ss = torch.sum(x * x, dim=dim, keepdim=True)
    good = ss > eps
    norm = torch.sqrt(torch.where(good, ss, torch.ones_like(ss)))
    return torch.where(good, x / norm, torch.zeros_like(x))
