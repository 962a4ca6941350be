"""Masked per-group Adam for the Gaussian parameter groups (counterpart of
gaussmart_tpu/optim.py).

Per-group learning rates (xyz on the log-lerp schedule, f_rest at
feature_lr / 20), beta = (0.9, 0.999), eps = 1e-15, the JAX package's
bias-correction formula, inactive capacity slots left untouched, and the
moment surgery densification and opacity reset need (zero_moments_at,
zero_group_moments). Plain functions under torch.no_grad() that return
new tensors; torch.optim.Adam neither masks slots nor does the surgery.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from gaussmart_tpu_torch.models.gaussians import GaussianParams
from gaussmart_tpu_torch.transforms import exponential_lr

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15
NAMES = tuple(f.name for f in dataclasses.fields(GaussianParams))


@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    step: torch.Tensor  # int32 scalar (the groups always step together)


def _map(fn, *groups: GaussianParams) -> GaussianParams:
    return GaussianParams(**{n: fn(*(getattr(g, n) for g in groups)) for n in NAMES})


def init_adam(params: GaussianParams) -> AdamState:
    return AdamState(mu=_map(torch.zeros_like, params),
                     nu=_map(torch.zeros_like, params),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=params.xyz.device))


def group_lrs(opt_cfg, iteration: int, spatial_lr_scale: float) -> Dict[str, float]:
    """Per-group learning rates at `iteration`."""
    return dict(
        xyz=exponential_lr(iteration,
                           lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
                           lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
                           lr_delay_mult=opt_cfg.position_lr_delay_mult,
                           max_steps=opt_cfg.position_lr_max_steps),
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        opacity=opt_cfg.opacity_lr,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
    )


@torch.no_grad()
def adam_step(params: GaussianParams, grads: GaussianParams, state: AdamState,
              lrs: Dict[str, float], active: torch.Tensor):
    """One masked Adam step; `active` is the [C] live-splat mask and
    inactive slots keep their params and moments. Returns (params, adam)."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(BETA1, dtype=torch.float32, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(BETA2, dtype=torch.float32, device=t.device), t)
    out = {}
    for name in NAMES:
        p, g = getattr(params, name), getattr(grads, name)
        m, v = getattr(state.mu, name), getattr(state.nu, name)
        mask = active.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)
        m_new = BETA1 * m + (1 - BETA1) * g
        v_new = BETA2 * v + (1 - BETA2) * g * g
        update = lrs[name] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
        out[name] = (p - mask * update, torch.where(mask > 0, m_new, m),
                     torch.where(mask > 0, v_new, v))
    pick = lambda i: GaussianParams(**{n: out[n][i] for n in NAMES})
    return pick(0), AdamState(mu=pick(1), nu=pick(2), step=step)


def zero_moments_at(state: AdamState, slot_mask: torch.Tensor) -> AdamState:
    """Zero both moments at the [C] slots (fresh slots after densify)."""
    def z(a):
        return torch.where(slot_mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                           torch.zeros_like(a), a)
    return AdamState(mu=_map(z, state.mu), nu=_map(z, state.nu), step=state.step)


def zero_group_moments(state: AdamState, name: str) -> AdamState:
    """Zero one group's moments over every slot (opacity reset)."""
    mu = dataclasses.replace(state.mu, **{name: torch.zeros_like(getattr(state.mu, name))})
    nu = dataclasses.replace(state.nu, **{name: torch.zeros_like(getattr(state.nu, name))})
    return AdamState(mu=mu, nu=nu, step=state.step)
