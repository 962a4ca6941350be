"""Windowed SSIM (counterpart of gaussmart_tpu/ops/ssim.py): 11x11
Gaussian window, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero 'SAME'
padding, the separable blur written as shifted adds (a convolution would
run through cuDNN in TF32, too coarse for the E[x^2] moments), variances
clamped at 0 and the covariance bounded by Cauchy-Schwarz."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur over [N, C, H, W] with zero padding: k
    shifted, weighted adds per axis, in float32."""
    k = window.shape[0]
    pad = k // 2

    def blur_axis(x, axis):
        size = x.shape[axis]
        padding = [0, 0, 0, 0]
        padding[2 * (3 - axis)] = padding[2 * (3 - axis) + 1] = pad
        xp = torch.nn.functional.pad(x, padding)
        out = None
        for i in range(k):
            term = float(window[i]) * xp.narrow(axis, i, size)
            out = term if out is None else out + term
        return out

    return blur_axis(blur_axis(img, 2), 3)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, size_average: bool = True) -> torch.Tensor:
    """SSIM between [C,H,W] or [N,C,H,W] images in [0,1]."""
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    window = _gaussian_window(window_size, sigma)

    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = torch.clamp_min(_blur(img1 * img1, window) - mu1_sq, 0.0)
    sigma2_sq = torch.clamp_min(_blur(img2 * img2, window) - mu2_sq, 0.0)
    sigma12 = _blur(img1 * img2, window) - mu1_mu2
    # the bound binds only where the moments are inconsistent, and
    # sqrt'(0) = inf would poison the backward: no gradient through it
    bound = torch.sqrt(sigma1_sq * sigma2_sq).detach()
    sigma12 = torch.minimum(torch.maximum(sigma12, -bound), bound)

    c1 = 0.01**2
    c2 = 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
