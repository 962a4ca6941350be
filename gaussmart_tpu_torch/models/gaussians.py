"""Gaussian scene state: fixed-capacity tensors plus an active mask
(counterpart of gaussmart_tpu/models/gaussians.py).

Parameter layout (the PLY channel contract):
  xyz [C,3], features_dc [C,1,3], features_rest [C,K-1,3] (K=(deg+1)^2),
  scaling [C,2] (log, 2-axis surfel), rotation [C,4] (wxyz, unnormalized),
  opacity [C,1] (logit), segments [C] (int32, not optimized).

Every array has a fixed ``capacity`` rows and an ``active`` mask:
densification fills free slots and pruning clears mask bits
(models/densify.py); the capacity grows on the host when it overflows
(``grow_capacity``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gaussmart_tpu_torch.ops.sh import rgb2sh
from gaussmart_tpu_torch.transforms import inverse_sigmoid


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

    def oneup_sh_degree(self) -> "GaussianState":
        if self.active_sh_degree < self.max_sh_degree:
            return dataclasses.replace(self, active_sh_degree=self.active_sh_degree + 1)
        return self

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


def adam_from_numpy(mu: Dict[str, np.ndarray], nu: Dict[str, np.ndarray],
                    step, device="cuda"):
    """Build the port's AdamState from the JAX ``AdamState`` moments as
    numpy arrays (``vars(jax.tree.map(np.asarray, adam.mu))``, same for
    ``nu``, and ``adam.step``)."""
    from gaussmart_tpu_torch.optim import AdamState
    names = [f.name for f in dataclasses.fields(GaussianParams)]

    def group(d):
        return GaussianParams(**{k: torch.tensor(np.asarray(d[k], np.float32),
                                                 device=device) for k in names})
    return AdamState(mu=group(mu), nu=group(nu),
                     step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                       device=device))


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def init_from_pcd(points: np.ndarray, colors: np.ndarray,
                  segments: Optional[np.ndarray], max_sh_degree: int,
                  spatial_lr_scale: float, capacity: Optional[int] = None,
                  seed: int = 0, device="cuda") -> GaussianState:
    """A state from a point cloud, with the JAX package's numpy draws, so
    both start identical from the same seed: log(sqrt(mean 3-NN squared
    distance)) on both surfel axes, uniform random quaternions from
    ``default_rng(seed)``, opacity logit(0.1), DC features from RGB."""
    n = len(points)
    if capacity is None:
        capacity = max(1024, _next_multiple(int(n * 4), 256))
    capacity = max(capacity, n)

    rng = np.random.default_rng(seed)
    dist2 = np.maximum(mean_sq_dist_to_3nn(points), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(2, axis=1)
    rots = rng.random((n, 4)).astype(np.float32)

    params = {k: v.cpu().numpy() for k, v in
              vars(empty_params(capacity, max_sh_degree, device="cpu")).items()}
    params["xyz"][:n] = points.astype(np.float32)
    params["features_dc"][:n, 0] = rgb2sh(colors.astype(np.float32))
    params["scaling"][:n] = scales.astype(np.float32)
    params["rotation"][:n] = rots
    params["opacity"][:n] = inverse_sigmoid(
        torch.full((n, 1), 0.1, dtype=torch.float32)).numpy()
    seg = np.zeros(capacity, np.int32)
    if segments is not None:
        seg[:n] = segments.astype(np.int32)
    return state_from_numpy(params, np.arange(capacity) < n, seg, max_sh_degree,
                            active_sh_degree=0, spatial_lr_scale=spatial_lr_scale,
                            device=device)


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Host-side re-pad of every array to `new_capacity` rows; the new
    slots are empty (inactive, empty_params filler)."""
    old = state.capacity
    if new_capacity < old:
        raise ValueError(f"capacity can only grow: {old} -> {new_capacity}")
    pad_n = new_capacity - old
    if pad_n == 0:
        return state
    dev = state.device
    fresh = empty_params(pad_n, state.max_sh_degree, device=dev)
    params = GaussianParams(**{k: torch.cat([v, getattr(fresh, k)])
                               for k, v in vars(state.params).items()})

    def pad(a):
        return torch.cat([a, torch.zeros((pad_n,) + a.shape[1:], dtype=a.dtype,
                                         device=dev)])
    aux = GaussianAux(**{k: pad(v) for k, v in vars(state.aux).items()})
    return state.replace(params=params, aux=aux)


def compact(state: GaussianState) -> GaussianState:
    """Pack the active splats to the front, in slot order (host-side)."""
    order = torch.argsort((~state.aux.active).to(torch.int8), stable=True)
    params = GaussianParams(**{k: v[order] for k, v in vars(state.params).items()})
    aux = GaussianAux(**{k: v[order] for k, v in vars(state.aux).items()})
    return state.replace(params=params, aux=aux)
