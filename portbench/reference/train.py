"""Plain PyTorch training step of GauSSmart past its gates: the benchmark's
reference for the steps of a training cell.

One view per step: the render of reference/raster.py with all SH bands
live; the loss (1 - 0.2) L1 + 0.2 (1 - SSIM) (11x11 Gaussian window,
sigma 1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2, variances clamped at 0
and the covariance held within the Cauchy-Schwarz bound), the normal
consistency term 0.05 mean(1 - <rend_normal, surf_normal>) past iteration
7000, the DINO term of reference/dino.py when a tower is given; then
Adam (beta 0.9 / 0.999, eps 1e-15, bias-corrected) with the 2DGS
learning rates (xyz on the log-linear decay from 1.6e-4 to 1.6e-6 over
30,000 iterations times the scene's spatial scale, features 2.5e-3, the
higher bands 1/20 of it, opacity 0.05, scaling 5e-3, rotation 1e-3),
inactive slots untouched. Imports nothing of the program.

`fault="half"` takes the photometric loss over the top half of the
rows only (half of the batch left out, the mean over the rest), a fault
the comparison has to catch.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import raster
from portbench.reference.dino import Tower, dino_term

GROUPS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
LAMBDA_DSSIM = 0.2
LAMBDA_NORMAL = 0.05
NORMAL_FROM = 7000


def _window(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x, w):
    """Separable zero-padded blur of [C,H,W] by depthwise convolutions."""
    C = x.shape[0]
    k = torch.from_numpy(w).to(x.device)
    pad = len(w) // 2
    x = F.conv2d(x[None], k.reshape(1, 1, 1, -1).repeat(C, 1, 1, 1), padding=(0, pad), groups=C)
    x = F.conv2d(x, k.reshape(1, 1, -1, 1).repeat(C, 1, 1, 1), padding=(pad, 0), groups=C)
    return x[0]


def ssim(a, b):
    w = _window()
    mu1, mu2 = _blur(a, w), _blur(b, w)
    s1 = torch.clamp_min(_blur(a * a, w) - mu1 * mu1, 0.0)
    s2 = torch.clamp_min(_blur(b * b, w) - mu2 * mu2, 0.0)
    s12 = _blur(a * b, w) - mu1 * mu2
    bound = torch.sqrt(s1 * s2).detach()
    s12 = torch.minimum(torch.maximum(s12, -bound), bound)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def position_lr(iteration: int, scale: float) -> float:
    t = min(max(iteration / 30000.0, 0.0), 1.0)
    return math.exp(math.log(1.6e-4 * scale) * (1 - t) + math.log(1.6e-6 * scale) * t)


def learning_rates(iteration: int, scale: float) -> Dict[str, float]:
    return dict(xyz=position_lr(iteration, scale), features_dc=2.5e-3,
                features_rest=2.5e-3 / 20.0, opacity=0.05, scaling=5e-3, rotation=1e-3)


def init_adam(params):
    return dict(m={g: torch.zeros_like(params[g]) for g in GROUPS},
                v={g: torch.zeros_like(params[g]) for g in GROUPS}, t=0)


def losses(params, active, cam, gt, iteration: int, tower: Optional[Tower],
           lambda_dino: float, mm: Callable = torch.matmul, fault: Optional[str] = None,
           stats=None):
    """{total, l1, normal, dino} of one view (tensors, differentiable)."""
    pkg = raster.render(raster.activated(params, active), cam, mm, stats)
    image = pkg["render"]
    a, b = (image, gt) if fault != "half" else (image[:, :image.shape[1] // 2],
                                                 gt[:, :gt.shape[1] // 2])
    l1 = torch.abs(a - b).mean()
    total = (1.0 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1.0 - ssim(a, b))
    lam_n = LAMBDA_NORMAL if iteration > NORMAL_FROM else 0.0
    normal = lam_n * (1.0 - (pkg["rend_normal"] * pkg["surf_normal"]).sum(0)).mean()
    total = total + normal
    zero = torch.zeros((), device=image.device)
    dino = dino_term(tower, image, gt, lambda_dino) if tower is not None else zero
    return dict(total=total + dino, l1=l1, normal=normal, dino=dino)


@torch.no_grad()
def adam_step(params, grads, state, active, lrs):
    t = state["t"] + 1
    bc1, bc2 = 1.0 - BETA1 ** t, 1.0 - BETA2 ** t
    out, m_new, v_new = {}, {}, {}
    for g in GROUPS:
        mask = active.reshape((-1,) + (1,) * (params[g].dim() - 1))
        m = BETA1 * state["m"][g] + (1 - BETA1) * grads[g]
        v = BETA2 * state["v"][g] + (1 - BETA2) * grads[g] * grads[g]
        upd = lrs[g] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        out[g] = torch.where(mask, params[g] - upd, params[g])
        m_new[g] = torch.where(mask, m, state["m"][g])
        v_new[g] = torch.where(mask, v, state["v"][g])
    return out, dict(m=m_new, v=v_new, t=t)


def step(params, state, active, cam, gt, iteration: int, spatial_lr_scale: float,
         tower: Optional[Tower] = None, lambda_dino: float = 0.0,
         mm: Callable = torch.matmul, fault: Optional[str] = None, stats=None):
    """One training step: (losses as floats, gradients, params, Adam state)."""
    leaves = {g: params[g].detach().requires_grad_() for g in GROUPS}
    terms = losses(leaves, active, cam, gt, iteration, tower, lambda_dino, mm, fault, stats)
    grads = torch.autograd.grad(terms["total"], [leaves[g] for g in GROUPS],
                                allow_unused=True)
    grads = {g: (d if d is not None else torch.zeros_like(params[g]))
             for g, d in zip(GROUPS, grads)}
    new, state = adam_step(params, grads, state, active,
                           learning_rates(iteration, spatial_lr_scale))
    return {k: float(v.detach()) for k, v in terms.items()}, grads, new, state
