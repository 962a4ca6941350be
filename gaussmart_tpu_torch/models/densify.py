"""Adaptive density control in a fixed-capacity arena (counterpart of
gaussmart_tpu/models/densify.py): clone, split and prune with the Adam
moment surgery and stat resets, the same slot assignment as the JAX
package (clones take the first free slots in order, then split children),
so both packages place every new splat in the same slot.

Kept quirks of the reference: split children sample a zero third axis
(surfel) and scale by 1/(0.8*N); max_radii2d is reset before the size
prune reads it, so the view-space size prune never fires; densification
stats reset after every call.

The split noise is injectable: pass `eps`, one [C, 2] array per child
(the JAX package draws jax.random.normal(split(key, 2)[j], (C, 2))),
or a torch.Generator to draw it from.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gaussmart_tpu_torch.models.gaussians import GaussianAux, GaussianParams, GaussianState
from gaussmart_tpu_torch.optim import AdamState, zero_group_moments, zero_moments_at
from gaussmart_tpu_torch.transforms import inverse_sigmoid, quat_to_rotmat

SPLIT_N = 2


def add_densification_stats(aux: GaussianAux, means2d_grad: torch.Tensor,
                            radii: torch.Tensor) -> GaussianAux:
    """Accumulate ||screen-space grad|| and max radii of the visible
    (radii > 0) splats."""
    visible = radii > 0
    gnorm = torch.linalg.norm(means2d_grad, dim=-1)
    return dataclasses.replace(
        aux,
        grad_accum=aux.grad_accum + torch.where(visible, gnorm, 0.0),
        denom=aux.denom + visible.to(torch.float32),
        max_radii2d=torch.where(visible, torch.maximum(aux.max_radii2d, radii),
                                aux.max_radii2d),
    )


def _first(mask: torch.Tensor, C: int) -> torch.Tensor:
    """Indices where `mask` holds, ascending, padded with C to length C
    (jnp.nonzero(mask, size=C, fill_value=C))."""
    idx = torch.nonzero(mask).flatten()
    return torch.cat([idx, torch.full((C - idx.numel(),), C, dtype=idx.dtype,
                                      device=idx.device)])


def _scatter_rows(params: GaussianParams, src: torch.Tensor, dst: torch.Tensor,
                  transform=None) -> GaussianParams:
    """Copy rows src -> dst across every group; dst == C drops the row."""
    C = params.xyz.shape[0]
    keep = dst < C
    s, d = torch.clamp(src, 0, C - 1)[keep], dst[keep]

    def one(name, leaf):
        rows = leaf[s]
        if transform is not None:
            rows = transform(name, rows, keep)
        out = leaf.clone()
        out[d] = rows
        return out

    return GaussianParams(**{k: one(k, v) for k, v in vars(params).items()})


@torch.no_grad()
def densify_and_prune(state: GaussianState, adam: AdamState, *,
                      max_grad: float, min_opacity: float, extent: float,
                      percent_dense: float, use_size_prune: bool,
                      eps: Optional[Sequence] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[GaussianState, AdamState, int]:
    """One densify + prune pass. Returns (state, adam, n_dropped), the
    number of new splats that found no free slot."""
    params, aux = state.params, state.aux
    C = state.capacity
    dev = state.device

    grads = torch.nan_to_num(aux.grad_accum / torch.clamp_min(aux.denom, 1.0), nan=0.0)
    scaling = torch.exp(params.scaling)
    max_scale = scaling.max(dim=-1).values
    grad_ok = (grads >= max_grad) & aux.active
    clone_mask = grad_ok & (max_scale <= percent_dense * extent)
    split_mask = grad_ok & (max_scale > percent_dense * extent)

    free = _first(~aux.active, C)
    clone_src = _first(clone_mask, C)
    split_src = _first(split_mask, C)
    n_clone = int(clone_mask.sum())

    # clones: copied verbatim into the first free slots
    clone_dst = torch.where(clone_src < C, free, C)
    params = _scatter_rows(params, clone_src, clone_dst)

    # splits: SPLIT_N children in the following free slots, offsets drawn
    # in the splat's tangent frame ~ N(0, diag(s_u, s_v, 0)); the source dies
    idx = torch.arange(C, device=dev)
    safe_split = torch.clamp(split_src, 0, C - 1)
    child_dst = []
    for j in range(SPLIT_N):
        slot = n_clone + SPLIT_N * idx + j
        child_dst.append(torch.where((split_src < C) & (slot < C),
                                     free[torch.clamp(slot, 0, C - 1)], C))
    R = quat_to_rotmat(params.rotation[safe_split])
    s = scaling[safe_split]
    for j in range(SPLIT_N):
        if eps is not None:
            e = torch.tensor(np.asarray(eps[j], np.float32), device=dev)
        else:
            e = torch.randn((C, 2), generator=generator, dtype=torch.float32,
                            device="cpu" if generator is None else generator.device
                            ).to(dev)
        local = torch.cat([e * s, torch.zeros((C, 1), dtype=torch.float32, device=dev)],
                          dim=1)
        offset = torch.einsum("nij,nj->ni", R, local)

        def transform(name, rows, keep, offset=offset):
            if name == "xyz":
                return rows + offset[keep]
            if name == "scaling":
                return torch.log(torch.exp(rows) / (0.8 * SPLIT_N))
            return rows

        params = _scatter_rows(params, split_src, child_dst[j], transform)

    newly_alloc = torch.zeros(C, dtype=torch.bool, device=dev)
    for dst in [clone_dst] + child_dst:
        newly_alloc[dst[dst < C]] = True
    active = (aux.active | newly_alloc) & ~split_mask

    segments = aux.segments.clone()
    for src, dst in [(clone_src, clone_dst)] + [(split_src, d) for d in child_dst]:
        keep = dst < C
        segments[dst[keep]] = aux.segments[torch.clamp(src, 0, C - 1)[keep]]

    # prune the post-densify population
    prune = torch.sigmoid(params.opacity[:, 0]) < min_opacity
    if use_size_prune:
        prune = prune | (torch.exp(params.scaling).max(dim=-1).values > 0.1 * extent)
    active = active & ~prune

    adam = zero_moments_at(adam, newly_alloc)
    zeros = torch.zeros(C, dtype=torch.float32, device=dev)
    aux = GaussianAux(active=active, segments=segments, max_radii2d=zeros,
                      grad_accum=zeros.clone(), denom=zeros.clone())
    wanted = n_clone + SPLIT_N * int(split_mask.sum())
    n_dropped = wanted - int(newly_alloc.sum())
    return state.replace(params=params, aux=aux), adam, n_dropped


@torch.no_grad()
def reset_opacity(state: GaussianState, adam: AdamState
                  ) -> Tuple[GaussianState, AdamState]:
    """Clamp opacity to <= 0.01 and zero its Adam moments."""
    op = torch.sigmoid(state.params.opacity)
    params = dataclasses.replace(state.params,
                                 opacity=inverse_sigmoid(torch.clamp_max(op, 0.01)))
    return state.replace(params=params), zero_group_moments(adam, "opacity")
