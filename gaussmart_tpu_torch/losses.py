"""Training losses (counterpart of gaussmart_tpu/losses.py): photometric
L1 + D-SSIM mix, depth-distortion and normal-consistency regularizers with
their 3000/7000 iteration gates, and the DINO embedding term.

A lambda that is statically zero skips its term, so no cotangent reaches
the rasterizer channel it reads and the tiled backward can leave that
channel's terms out.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from gaussmart_tpu_torch.logging_utils import is_tracing, span
from gaussmart_tpu_torch.ops.image import l1_loss
from gaussmart_tpu_torch.ops.ssim import ssim


def photometric_loss(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float):
    ll1 = l1_loss(image, gt)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt))
    return loss, ll1


def regularization_losses(render_pkg: Dict[str, torch.Tensor], iteration: int,
                          lambda_dist: float, lambda_normal: float,
                          lambda_dist_ramp: int = 0,
                          lambda_dist_clip: float = 0.0):
    """dist gated at iteration > 3000 (or ramped over `lambda_dist_ramp`
    iterations after it), normal gated at > 7000; `lambda_dist_clip` > 0
    caps the raw per-view mean distortion entering the loss."""
    dev = render_pkg["render"].device
    it = float(iteration)
    if lambda_normal == 0.0:
        normal_loss = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        lam_n = lambda_normal if it > 7000 else 0.0
        normal_error = 1.0 - (render_pkg["rend_normal"]
                              * render_pkg["surf_normal"]).sum(dim=0)
        normal_loss = lam_n * normal_error.mean()
    if lambda_dist == 0.0:
        dist_loss = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        if lambda_dist_ramp > 0:
            lam_d = lambda_dist * min(max((it - 3000.0) / lambda_dist_ramp, 0.0), 1.0)
        else:
            lam_d = lambda_dist if it > 3000 else 0.0
        raw = render_pkg["rend_dist"].mean()
        if lambda_dist_clip > 0.0:
            raw = torch.clamp_max(raw, lambda_dist_clip)
        dist_loss = lam_d * raw
    return dist_loss, normal_loss


def dino_term(image: torch.Tensor, gt: torch.Tensor,
              encoder: Callable[[torch.Tensor], torch.Tensor],
              lambda_dino: float, mode: str = "fixed") -> torch.Tensor:
    """DINO embedding alignment: mode "parity" is +lambda*cos with no
    gradient through either embedding (it changes the logs only), "fixed"
    is lambda*(1-cos) with the gradient flowing into the render."""
    if mode == "parity":
        with torch.no_grad():
            cos = _cosine(encoder(image), encoder(gt))
        return lambda_dino * cos
    with span("losses.dino.render"):
        if is_tracing():
            held = []
            e1 = _TowerMark.apply(encoder(_TowerMark.apply(image, held, False)), held, True)
        else:
            e1 = encoder(image)
    with torch.no_grad(), span("losses.dino.target"):
        e2 = encoder(gt)
    return lambda_dino * (1.0 - _cosine(e1, e2))


class _TowerMark(torch.autograd.Function):
    """Identity that marks the DINO tower's backward while tracing: at the
    tower's output (`opens`) its backward, the first of the tower's, opens
    the span backward.dino (kept in `held`); at the tower's input, the
    last, closes it."""

    @staticmethod
    def forward(ctx, x, held, opens):
        ctx.held, ctx.opens = held, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opens:
            s = span("backward.dino")
            s.__enter__()
            ctx.held.append(s)
        elif ctx.held:
            ctx.held.pop().__exit__(None, None, None)
        return g, None, None


def smooth_loss(disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware disparity smoothness."""
    gdx = torch.abs(disp[:, 1:-1, :-2] + disp[:, 1:-1, 2:]
                    - 2 * disp[:, 1:-1, 1:-1])
    gdy = torch.abs(disp[:, :-2, 1:-1] + disp[:, 2:, 1:-1]
                    - 2 * disp[:, 1:-1, 1:-1])
    gix = torch.mean(torch.abs(img[:, 1:-1, :-2] - img[:, 1:-1, 2:]), 0,
                     keepdim=True) * 0.5
    giy = torch.mean(torch.abs(img[:, :-2, 1:-1] - img[:, 2:, 1:-1]), 0,
                     keepdim=True) * 0.5
    return (gdx * torch.exp(-gix)).mean() + (gdy * torch.exp(-giy)).mean()


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.reshape(-1)
    b = b.reshape(-1)
    denom = torch.linalg.norm(a) * torch.linalg.norm(b)
    return torch.dot(a, b) / torch.clamp_min(denom, 1e-8)
