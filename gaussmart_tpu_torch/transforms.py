"""Quaternion / rotation helpers and the learning-rate schedule
(counterpart of gaussmart_tpu/transforms.py).

Quaternions are (w, x, y, z); quat_to_rotmat normalizes first.
"""
from __future__ import annotations

import math

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


def exponential_lr(step, lr_init, lr_final, lr_delay_steps=0,
                   lr_delay_mult=1.0, max_steps=1000000) -> float:
    """Plenoxels-style log-lerp learning rate at integer `step`, computed
    in float32 as the JAX package does (a host float here: the port's
    iteration counter lives on the host)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    f32 = torch.float32
    s = torch.tensor(float(step), dtype=f32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(s / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(s / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(torch.tensor(lr_init, dtype=f32)) * (1 - t)
                         + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    lr = delay_rate * log_lerp
    return 0.0 if step < 0 else float(lr)
