"""Public render API (counterpart of gaussmart_tpu/render/api.py), with
the same output dict: render, viewspace_points, visibility_filter, radii,
rend_alpha, rend_normal, rend_dist, surf_depth, surf_normal, n_dropped.

Backends: "auto" and "pallas" take the tiled compositor (the CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor), "dense" the dense
compositor. The sharded backends belong to the multi-device slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.models.gaussians import GaussianState
from gaussmart_tpu_torch.ops.depth_normal import depth_to_normal
from gaussmart_tpu_torch.render import raster_common
from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels
from gaussmart_tpu_torch.render.raster_tiled import rasterize_tiled

_SHARDED = ("gaussian_sharded", "gaussian_sharded_pallas", "row_sharded")


def render(
    cam: CameraParams,
    state: GaussianState,
    bg_color: torch.Tensor,
    *,
    means2d: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    depth_ratio: float = 0.0,
    backend: str = "auto",
    chunk: int = 64,
) -> Dict[str, torch.Tensor]:
    return render_arrays(
        cam,
        xyz=state.params.xyz,
        scaling=state.get_scaling,
        rotation=state.params.rotation,
        opacity=state.get_opacity[:, 0],
        features=state.get_features,
        active=state.aux.active,
        sh_degree=state.active_sh_degree,
        bg_color=bg_color,
        means2d=means2d,
        scaling_modifier=scaling_modifier,
        override_color=override_color,
        depth_ratio=depth_ratio,
        backend=backend,
        chunk=chunk,
    )


def render_arrays(
    cam: CameraParams,
    *,
    xyz: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    opacity: torch.Tensor,
    features: torch.Tensor,
    active: torch.Tensor,
    sh_degree: int,
    bg_color: torch.Tensor,
    means2d: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    depth_ratio: float = 0.0,
    backend: str = "auto",
    chunk: int = 64,
    active_degree: Optional[int] = None,
    need_dist_grad: bool = True,
) -> Dict[str, torch.Tensor]:
    """Render from raw (already activated) arrays, differentiably: pass
    `means2d` as a zero leaf that requires grad and its .grad is the
    screen-space (viewspace) gradient. `active_degree` masks SH bands
    above it (see preprocess). `need_dist_grad=False` leaves the
    distortion term out of the tiled backward (valid when the loss ignores
    rend_dist); the median term is left out when depth_ratio is 0."""
    if backend in _SHARDED:
        raise NotImplementedError(
            f"backend {backend!r} comes with the multi-device slice of the port")
    if backend not in ("auto", "pallas", "dense"):
        raise ValueError(f"unknown backend {backend!r}: "
                         "expected 'auto', 'pallas' or 'dense'")
    n = xyz.shape[0]
    if means2d is None:
        means2d = torch.zeros((n, 2), dtype=torch.float32, device=xyz.device)

    prep = raster_common.preprocess(
        xyz, scaling, rotation, opacity, features, active, cam,
        sh_degree=sh_degree, scale_modifier=scaling_modifier,
        override_color=override_color, active_degree=active_degree)
    if backend == "dense":
        out = rasterize_pixels(prep, means2d, bg_color, cam.width, cam.height,
                               chunk=chunk)
    else:
        out = rasterize_tiled(prep, means2d, bg_color, cam.width, cam.height,
                              need_dist_grad=need_dist_grad,
                              need_med_grad=(depth_ratio != 0.0))

    image, allmap = out["image"], out["allmap"]

    # --- aux decode --------------------------------------------------------
    render_alpha = allmap[1:2]
    # view->world normals
    render_normal = torch.einsum("chw,cd->dhw", allmap[2:5],
                                 cam.world_view[:3, :3].T)
    render_depth_median = allmap[5:6]
    # masked division: guard the denominator (dividing then replacing NaN
    # would leak NaN gradients at empty pixels)
    has_alpha = render_alpha > 1e-12
    render_depth_expected = torch.where(
        has_alpha, allmap[0:1] / torch.where(has_alpha, render_alpha, 1.0), 0.0)
    render_dist = allmap[6:7]

    surf_depth = (render_depth_expected * (1 - depth_ratio)
                  + depth_ratio * render_depth_median)
    surf_normal = depth_to_normal(cam, surf_depth).permute(2, 0, 1)
    surf_normal = surf_normal * render_alpha.detach()

    return {
        "render": image,
        "viewspace_points": means2d,
        "visibility_filter": prep.radius > 0,
        "radii": prep.radius,
        "rend_alpha": render_alpha,
        "rend_normal": render_normal,
        "rend_dist": render_dist,
        "surf_depth": surf_depth,
        "surf_normal": surf_normal,
        # (splat, tile) pairs dropped by the binning: always 0 here
        "n_dropped": out.get("n_dropped", torch.zeros((), dtype=torch.int32,
                                                      device=image.device)),
    }
