"""Public render API (counterpart of gaussmart_tpu/render/api.py), with
the same output dict: render, viewspace_points, visibility_filter, radii,
rend_alpha, rend_normal, rend_dist, surf_depth, surf_normal, n_dropped.

Backends: "auto" and "pallas" take the tiled compositor (the CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor), "dense" the dense
compositor. With `mesh` (parallel/sharding.py's device slots):
"gaussian_sharded" composites depth strata of the splats on the slots
with the dense compositor and folds them, "gaussian_sharded_pallas" does
so with the seeded tiled core (K3/K4), and "row_sharded" composites
blocks of image rows on the slots.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.logging_utils import span
from gaussmart_tpu_torch.models.gaussians import GaussianState
from gaussmart_tpu_torch.ops.depth_normal import depth_to_normal
from gaussmart_tpu_torch.render import raster_common
from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels
from gaussmart_tpu_torch.render.raster_tiled import rasterize_tiled

BACKENDS = ("auto", "pallas", "dense", "gaussian_sharded", "gaussian_sharded_pallas",
            "row_sharded")


def render(
    cam: CameraParams,
    state: Union[GaussianState, List[GaussianState]],
    bg_color: torch.Tensor,
    *,
    means2d: Optional[torch.Tensor] = None,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    depth_ratio: float = 0.0,
    backend: str = "auto",
    chunk: int = 64,
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """`state` is one GaussianState, or with a Gaussian-sharded backend
    the per-slot chunks of one (the sharded training state)."""
    chunks = state if isinstance(state, list) else None

    def field(get):
        return [get(s) for s in chunks] if chunks else get(state)
    return render_arrays(
        cam,
        xyz=field(lambda s: s.params.xyz),
        scaling=field(lambda s: s.get_scaling),
        rotation=field(lambda s: s.params.rotation),
        opacity=field(lambda s: s.get_opacity[:, 0]),
        features=field(lambda s: s.get_features),
        active=field(lambda s: s.aux.active),
        sh_degree=(chunks or [state])[0].active_sh_degree,
        bg_color=bg_color,
        means2d=means2d,
        scaling_modifier=scaling_modifier,
        override_color=override_color,
        depth_ratio=depth_ratio,
        backend=backend,
        chunk=chunk,
        mesh=mesh,
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
    mesh=None,
) -> Dict[str, torch.Tensor]:
    """Render from raw (already activated) arrays, differentiably: pass
    `means2d` as a zero leaf that requires grad and its .grad is the
    screen-space (viewspace) gradient. `active_degree` masks SH bands
    above it (see preprocess). `need_dist_grad=False` leaves the
    distortion term out of the tiled backward (valid when the loss ignores
    rend_dist); the median term is left out when depth_ratio is 0.

    The sharded backends need `mesh`. With a Gaussian-sharded backend the
    per-splat arrays (and means2d) may be lists of per-slot chunks: each
    chunk is preprocessed on its slot, and visibility_filter, radii and
    viewspace_points come back as lists too."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{', '.join(BACKENDS)}")
    sharded = backend in BACKENDS[3:]
    if sharded and mesh is None:
        raise ValueError(f"backend {backend!r} needs mesh= (parallel.make_mesh)")
    chunked = isinstance(xyz, list)
    if chunked and not backend.startswith("gaussian_sharded"):
        raise ValueError("per-slot chunks render only with a gaussian_sharded backend")
    if means2d is None:
        means2d = ([torch.zeros((x.shape[0], 2), dtype=torch.float32, device=x.device)
                    for x in xyz] if chunked else
                   torch.zeros((xyz.shape[0], 2), dtype=torch.float32, device=xyz.device))

    def prep_of(xyz, scaling, rotation, opacity, features, active, override_color):
        return raster_common.preprocess(
            xyz, scaling, rotation, opacity, features, active, cam.to(xyz.device),
            sh_degree=sh_degree, scale_modifier=scaling_modifier,
            override_color=override_color, active_degree=active_degree)

    if chunked:
        n = len(xyz)
        prep = [prep_of(*a) for a in zip(xyz, scaling, rotation, opacity, features,
                                         active, override_color if override_color is not None
                                         else [None] * n)]
    else:
        with span("render.preprocess"):
            prep = prep_of(xyz, scaling, rotation, opacity, features, active,
                           override_color)
    if backend.startswith("gaussian_sharded"):
        from gaussmart_tpu_torch.parallel.sharding import render_gaussian_sharded
        out = render_gaussian_sharded(
            mesh, prep, means2d, bg_color, cam.width, cam.height, chunk=chunk,
            backend="pallas" if backend.endswith("_pallas") else "dense",
            need_dist_grad=need_dist_grad, need_med_grad=(depth_ratio != 0.0))
    elif backend == "row_sharded":
        from gaussmart_tpu_torch.parallel.sharding import render_row_sharded
        # pad the row count to a multiple of the slots and crop after: the
        # extra rows are pixels past the image, the projection lives in prep
        h_pad = -(-cam.height // mesh.size) * mesh.size
        out = render_row_sharded(mesh, prep, means2d, bg_color, cam.width, h_pad,
                                 chunk=chunk)
        out = {k: v[:, :cam.height] for k, v in out.items()}
    elif backend == "dense":
        out = rasterize_pixels(prep, means2d, bg_color, cam.width, cam.height,
                               chunk=chunk)
    else:
        out = rasterize_tiled(prep, means2d, bg_color, cam.width, cam.height,
                              need_dist_grad=need_dist_grad,
                              need_med_grad=(depth_ratio != 0.0))

    image, allmap = out["image"], out["allmap"]
    with span("render.decode"):

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

    radii = [p.radius for p in prep] if chunked else prep.radius
    return {
        "render": image,
        "viewspace_points": means2d,
        "visibility_filter": [r > 0 for r in radii] if chunked else radii > 0,
        "radii": radii,
        "rend_alpha": render_alpha,
        "rend_normal": render_normal,
        "rend_dist": render_dist,
        "surf_depth": surf_depth,
        "surf_normal": surf_normal,
        # (splat, tile) pairs dropped by the binning: always 0 here
        "n_dropped": out.get("n_dropped", torch.zeros((), dtype=torch.int32,
                                                      device=image.device)),
    }
