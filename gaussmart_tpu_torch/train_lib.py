"""The training step and the densify / opacity-reset steps (counterpart of
gaussmart_tpu/train_lib.py).

The JAX package compiles the iteration into one XLA program; here it runs
eagerly: forward render (on a CUDA device the preprocess is K8's autograd
Function, render/api.render_leaves), losses, loss.backward() (the tiled
backward is K2 plus the per-splat reduction, then K8's VJP; means2d's
.grad is the screen-space gradient), densification statistics, and the
masked Adam step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.config import OptimizationParams
from gaussmart_tpu_torch.logging_utils import span
from gaussmart_tpu_torch.losses import photometric_loss, regularization_losses
from gaussmart_tpu_torch.models.densify import (add_densification_stats,
                                                densify_and_prune, reset_opacity)
from gaussmart_tpu_torch.models.gaussians import GaussianAux, GaussianParams
from gaussmart_tpu_torch.optim import NAMES, AdamState, adam_step, group_lrs
from gaussmart_tpu_torch.render.api import leaf_route, render_arrays, render_leaves

__all__ = ["StepMetrics", "make_train_step", "make_densify_step", "reset_opacity"]


class StepMetrics(NamedTuple):
    total: torch.Tensor
    l1: torch.Tensor
    dist: torch.Tensor
    normal: torch.Tensor
    dino: torch.Tensor
    psnr: torch.Tensor
    n_active: torch.Tensor
    n_dropped: torch.Tensor


def _render_inputs(params: GaussianParams, aux_state: GaussianAux) -> dict:
    return dict(xyz=params.xyz, scaling=torch.exp(params.scaling),
                rotation=params.rotation, opacity=torch.sigmoid(params.opacity[:, 0]),
                features=torch.cat([params.features_dc, params.features_rest], dim=1),
                active=aux_state.active)


def _loss_and_aux(params, means2d, aux_state, cam: CameraParams, gt_image,
                  iteration: int, opt: OptimizationParams, bg, sh_degree: int,
                  depth_ratio: float, backend: str,
                  dino_fn: Optional[Callable] = None,
                  phase: Optional[Callable[[str], None]] = None, mesh=None):
    """Render, losses and metrics of one view. With a Gaussian-sharded
    backend and `mesh`, params, means2d and aux_state are lists of per-slot
    chunks, and extras["radii"] is too."""
    mark = phase or (lambda name: None)
    # the SH schedule inside the step: bands above iteration // 1000 are
    # masked to zero
    active_degree = min(max(iteration // 1000, 0), sh_degree)
    if leaf_route(params, backend):
        pkg = render_leaves(cam, params, aux_state.active, bg, means2d=means2d,
                            sh_degree=sh_degree, active_degree=active_degree,
                            depth_ratio=depth_ratio, need_dist_grad=(opt.lambda_dist != 0.0))
    else:
        if isinstance(params, list):
            chunks = [_render_inputs(p, a) for p, a in zip(params, aux_state)]
            arrays = {k: [c[k] for c in chunks] for k in chunks[0]}
        else:
            with span("render.preprocess"):
                arrays = _render_inputs(params, aux_state)
        pkg = render_arrays(
            cam,
            **arrays,
            sh_degree=sh_degree,
            bg_color=bg,
            means2d=means2d,
            depth_ratio=depth_ratio,
            backend=backend,
            active_degree=active_degree,
            need_dist_grad=(opt.lambda_dist != 0.0),
            mesh=mesh,
        )
    mark("render")
    image = pkg["render"]
    with span("losses.photometric"):
        loss, ll1 = photometric_loss(image, gt_image, opt.lambda_dssim)
    with span("losses.regularization"):
        dist_loss, normal_loss = regularization_losses(
            pkg, iteration, opt.lambda_dist, opt.lambda_normal,
            lambda_dist_ramp=opt.lambda_dist_ramp,
            lambda_dist_clip=opt.lambda_dist_clip)
    with span("losses.dino"):
        dino = torch.zeros((), dtype=torch.float32, device=image.device)
        if dino_fn is not None:
            dino = dino_fn(image, gt_image, iteration)
    total = loss + dist_loss + normal_loss + dino
    mark("losses")
    with torch.no_grad():
        mse = torch.mean((torch.clamp(image, 0, 1) - torch.clamp(gt_image, 0, 1)) ** 2)
        psnr = 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))
    extras = dict(radii=pkg["radii"], l1=ll1, dist=dist_loss, normal=normal_loss,
                  dino=dino, psnr=psnr, n_dropped=pkg["n_dropped"])
    return total, extras


def _leaves(params: GaussianParams) -> GaussianParams:
    """Fresh autograd leaves holding `params`' values."""
    return GaussianParams(**{n: getattr(params, n).detach().requires_grad_()
                             for n in NAMES})


def _grads(leaves: GaussianParams) -> GaussianParams:
    return GaussianParams(**{n: (getattr(leaves, n).grad if getattr(leaves, n).grad
                                 is not None else torch.zeros_like(getattr(leaves, n)))
                             for n in NAMES})


def _check_adam_on_densify(adam_on_densify: str):
    if adam_on_densify not in ("apply", "drop"):
        raise ValueError(f"adam_on_densify={adam_on_densify!r}: expected 'apply' or 'drop'")


def _drops_adam(opt: OptimizationParams, iteration: int, adam_on_densify: str) -> bool:
    """adam_on_densify="drop" skips the Adam update on densify iterations."""
    return (adam_on_densify == "drop" and iteration < opt.densify_until_iter
            and iteration > opt.densify_from_iter
            and iteration % opt.densification_interval == 0)


@torch.no_grad()
def _apply_update(params: GaussianParams, grads: GaussianParams, adam: AdamState,
                  aux_state: GaussianAux, means2d_grad: torch.Tensor,
                  radii: torch.Tensor, iteration: int, opt: OptimizationParams,
                  spatial_lr_scale: float, adam_on_densify: str):
    """Densify statistics inside the densify window, then the masked Adam
    step, skipped on densify iterations under adam_on_densify="drop".
    Returns (params, adam, aux_state)."""
    if iteration < opt.densify_until_iter:
        with span("update.stats"):
            aux_state = add_densification_stats(aux_state, means2d_grad, radii)
    if not _drops_adam(opt, iteration, adam_on_densify):
        with span("update.adam"):
            lrs = group_lrs(opt, iteration, spatial_lr_scale)
            params, adam = adam_step(params, grads, adam, lrs, aux_state.active)
    return params, adam, aux_state


def make_train_step(opt: OptimizationParams, *, sh_degree: int,
                    white_background: bool, depth_ratio: float = 0.0,
                    backend: str = "auto", dino_fn: Optional[Callable] = None,
                    spatial_lr_scale: float = 1.0,
                    adam_on_densify: str = "drop",
                    phase: Optional[Callable[[str], None]] = None):
    """The single-iteration update
    ``step(params, adam, aux, cam, gt_image, iteration) ->
    (params, adam, aux, StepMetrics, iteration + 1)``.

    adam_on_densify: "drop" (default) skips the Adam update on densify
    iterations, as the reference does, or "apply" keeps it. `phase`, when
    given, is called with "render", "losses", "backward" and "adam" as each
    stage of the step has been issued (chip_smoke.py records a CUDA event
    there for its per-stage breakdown)."""
    _check_adam_on_densify(adam_on_densify)
    bg_values = [1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0]
    mark = phase or (lambda name: None)

    def step(params: GaussianParams, adam: AdamState, aux_state: GaussianAux,
             cam: CameraParams, gt_image: torch.Tensor, iteration: int):
        with span("step", id=iteration):
            dev = params.xyz.device
            bg = torch.tensor(bg_values, dtype=torch.float32, device=dev)
            leaves = _leaves(params)
            means2d = torch.zeros((params.xyz.shape[0], 2), dtype=torch.float32,
                                  device=dev, requires_grad=True)
            total, extras = _loss_and_aux(leaves, means2d, aux_state, cam, gt_image,
                                          iteration, opt, bg, sh_degree, depth_ratio,
                                          backend, dino_fn, mark)
            with span("backward"):
                total.backward()
            mark("backward")
            params, adam, aux_state = _apply_update(
                params, _grads(leaves), adam, aux_state, means2d.grad, extras["radii"],
                iteration, opt, spatial_lr_scale, adam_on_densify)
            metrics = _metrics(total, extras, aux_state.active.sum())
            mark("adam")
        return params, adam, aux_state, metrics, iteration + 1

    return step


def _metrics(total, extras, n_active) -> StepMetrics:
    return StepMetrics(total=total.detach(), l1=extras["l1"].detach(),
                       dist=extras["dist"].detach(), normal=extras["normal"].detach(),
                       dino=extras["dino"].detach(), psnr=extras["psnr"],
                       n_active=n_active, n_dropped=extras["n_dropped"])


def make_densify_step(opt: OptimizationParams, *, extent: float):
    """``densify(state, adam, generator, use_size_prune) -> (state, adam,
    n_dropped)`` with the optimisation group's thresholds."""

    def densify(state, adam, generator: torch.Generator, use_size_prune: bool):
        with span("densify"):
            return densify_and_prune(
                state, adam, max_grad=opt.densify_grad_threshold,
                min_opacity=opt.opacity_cull, extent=extent,
                percent_dense=opt.percent_dense, use_size_prune=use_size_prune,
                generator=generator)

    return densify
