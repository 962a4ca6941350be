"""Gaussian scene state: fixed-capacity tensors plus an active mask
(counterpart of gaussmart_tpu/models/gaussians.py).

Parameter layout (the PLY channel contract):
  xyz [C,3], features_dc [C,1,3], features_rest [C,K-1,3] (K=(deg+1)^2),
  scaling [C,2] (log, 2-axis surfel), rotation [C,4] (wxyz, unnormalized),
  opacity [C,1] (logit), segments [C] (int32, not optimized).

Building a state from a point cloud (``init_from_pcd``) is training work
and comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class GaussianParams:
    """Differentiable leaves (the Adam-optimized tensors)."""
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor


@dataclasses.dataclass
class GaussianAux:
    """Non-differentiable per-splat bookkeeping."""
    active: torch.Tensor       # [C] bool
    segments: torch.Tensor     # [C] int32
    max_radii2d: torch.Tensor  # [C] f32
    grad_accum: torch.Tensor   # [C] f32 — ||screen grad|| accumulator
    denom: torch.Tensor        # [C] f32


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    aux: GaussianAux
    max_sh_degree: int
    active_sh_degree: int
    spatial_lr_scale: float

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def n_active(self) -> torch.Tensor:
        return self.aux.active.sum()

    # -- activations ----------------------------------------------------------
    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.params.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        q = self.params.rotation
        return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)

    def replace(self, **kw) -> "GaussianState":
        return dataclasses.replace(self, **kw)


def empty_params(capacity: int, max_sh_degree: int, device="cuda") -> GaussianParams:
    n_rest = (max_sh_degree + 1) ** 2 - 1

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    rotation = full((capacity, 4), 0.0)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=full((capacity, 3), 0.0),
        features_dc=full((capacity, 1, 3), 0.0),
        features_rest=full((capacity, n_rest, 3), 0.0),
        scaling=full((capacity, 2), -10.0),
        rotation=rotation,
        opacity=full((capacity, 1), -10.0),
    )


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """Per-point mean squared distance to the 3 nearest neighbours (the
    scale-init rule). Host-side scipy cKDTree."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    k = min(4, len(points))
    d, _ = tree.query(points, k=k)
    if k > 1:
        return (d[:, 1:] ** 2).mean(axis=1)
    return np.full(len(points), 1e-7)


def state_from_numpy(params: Dict[str, np.ndarray], active: np.ndarray,
                     segments: np.ndarray, max_sh_degree: int,
                     active_sh_degree: int, spatial_lr_scale: float,
                     device="cuda") -> GaussianState:
    """Build the port's state from the JAX ``GaussianParams`` fields as
    numpy arrays (``jax.tree.map(np.asarray, state.params)``, or its
    ``vars()``), so both packages can run on the same splats."""
    names = [f.name for f in dataclasses.fields(GaussianParams)]

    def t(a, dtype):
        return torch.tensor(np.asarray(a), device=device).to(dtype)

    p = GaussianParams(**{k: t(params[k], torch.float32) for k in names})
    cap = p.xyz.shape[0]
    zeros = torch.zeros(cap, dtype=torch.float32, device=device)
    aux = GaussianAux(active=t(active, torch.bool),
                      segments=t(segments, torch.int32),
                      max_radii2d=zeros, grad_accum=zeros.clone(),
                      denom=zeros.clone())
    return GaussianState(params=p, aux=aux, max_sh_degree=max_sh_degree,
                         active_sh_degree=active_sh_degree,
                         spatial_lr_scale=spatial_lr_scale)
