"""Image metrics and basic losses (counterpart of gaussmart_tpu/ops/image.py)."""
from __future__ import annotations

import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b).mean()


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over [N, ...] -> [N, 1]."""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR per image for range [0, 1]; MSE floored at 1e-10 (100 dB cap)."""
    m = torch.clamp_min(mse(img1, img2), 1e-10)
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))


def gradient_map(image: torch.Tensor) -> torch.Tensor:
    """Sobel gradient magnitude of a [C,H,W] image -> [1,H,W], zero-padded.
    Written as shifted adds (no convolution: cuDNN would run it in TF32)."""
    c, h, w = image.shape
    x = torch.nn.functional.pad(image, (1, 1, 1, 1))

    def at(dy, dx):            # x[:, y+dy, x+dx] for dy, dx in {-1, 0, 1}
        return x[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (-at(-1, -1) + at(-1, 1) - 2 * at(0, -1) + 2 * at(0, 1)
          - at(1, -1) + at(1, 1)) / 4.0
    gy = (-at(-1, -1) - 2 * at(-1, 0) - at(-1, 1) + at(1, -1)
          + 2 * at(1, 0) + at(1, 1)) / 4.0
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    return torch.linalg.norm(mag, dim=0, keepdim=True)
