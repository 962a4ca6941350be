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

render() without a gradient (a single state on a CUDA device, backend
"auto" or "pallas", no override colour, no means2d: the viewer,
render_cli, the mesh export and the evaluation renders) builds the
compositor's rows from the raw parameters in one pass, K6
(render/preprocess_fused.py). render_leaves, the training step's render
of one state's raw parameters with a gradient on a CUDA device (the
same conditions with the gradient wanted: leaf_route), does so in K8's
autograd Function (render/preprocess_grad.py). Every other call goes
through render_arrays and its chain.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.logging_utils import span
from gaussmart_tpu_torch.models.gaussians import GaussianState
from gaussmart_tpu_torch.ops.depth_normal import depth_to_normal
from gaussmart_tpu_torch.render import raster_common
from gaussmart_tpu_torch.render.preprocess_fused import preprocess_fused, rows_prep
from gaussmart_tpu_torch.render.preprocess_grad import PreprocessCore
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
    if fused_route(state, backend, override_color, means2d):
        return _render_fused(cam, state, bg_color, scaling_modifier, depth_ratio)

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

    radii = [p.radius for p in prep] if chunked else prep.radius
    return _package(cam, out, means2d, radii, depth_ratio)


def fused_route(state, backend: str, override_color: Optional[torch.Tensor],
                means2d: Optional[torch.Tensor]) -> bool:
    """Whether render() takes K6: no gradient wanted, one GaussianState on
    a CUDA device, the tiled backend, no override colour and no means2d."""
    return (not isinstance(state, list) and state.device.type == "cuda"
            and backend in ("auto", "pallas") and override_color is None
            and means2d is None and not torch.is_grad_enabled())


def _render_fused(cam: CameraParams, state: GaussianState, bg_color: torch.Tensor,
                  scaling_modifier: float, depth_ratio: float) -> Dict[str, torch.Tensor]:
    """render() without a gradient: K6's blob and conic rows, then the
    tiled compositor, as render_arrays would composite them."""
    cam = cam.to(state.device)
    with span("render.preprocess"):
        fused = preprocess_fused(state, cam, scaling_modifier)
    means2d = torch.zeros((state.capacity, 2), dtype=torch.float32, device=state.device)
    out = rasterize_tiled(fused.prep, means2d, bg_color, cam.width, cam.height,
                          need_med_grad=(depth_ratio != 0.0), blob=fused.blob,
                          conics=fused.conics)
    return _package(cam, out, means2d, fused.prep.radius, depth_ratio)


def leaf_route(params, backend: str) -> bool:
    """Whether render_leaves takes K8 (PreprocessCore): a gradient wanted,
    one state's parameters (not per-slot chunks) on a CUDA device, the
    tiled backend (render_leaves has no override colour). fused_route's
    conditions with the gradient's reversed."""
    return (not isinstance(params, list) and params.xyz.device.type == "cuda"
            and backend in ("auto", "pallas") and torch.is_grad_enabled())


def render_leaves(cam: CameraParams, params, active: torch.Tensor, bg_color: torch.Tensor, *,
                  means2d: torch.Tensor, sh_degree: int, active_degree: int,
                  depth_ratio: float = 0.0, need_dist_grad: bool = True
                  ) -> Dict[str, torch.Tensor]:
    """The differentiable render of one state's raw parameters (`params`,
    a GaussianParams of autograd leaves) and means2d through K8: its blob
    and conic rows, then the tiled compositor, as render_arrays would
    composite the activated arrays with active_degree's SH mask. Gradients
    reach `params` and means2d through PreprocessCore's VJP. Callers take
    it where leaf_route holds."""
    cam = cam.to(params.xyz.device)
    with span("render.preprocess"):
        blob, conics, aux, valid = PreprocessCore.apply(
            params.xyz, params.scaling, params.rotation, params.opacity, params.features_dc,
            params.features_rest, means2d, active, cam, sh_degree, active_degree, 1.0)
        prep = rows_prep(blob, aux, valid)
    out = rasterize_tiled(prep, means2d, bg_color, cam.width, cam.height,
                          need_dist_grad=need_dist_grad, need_med_grad=(depth_ratio != 0.0),
                          blob=blob, conics=conics)
    return _package(cam, out, means2d, prep.radius, depth_ratio)


def _package(cam: CameraParams, out: Dict[str, torch.Tensor], means2d, radii,
             depth_ratio: float) -> Dict[str, torch.Tensor]:
    """The output dict from the compositor's image and allmap; `radii` (and
    means2d) are lists of per-slot chunks for a chunked render."""
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

    return {
        "render": image,
        "viewspace_points": means2d,
        "visibility_filter": [r > 0 for r in radii] if isinstance(radii, list) else radii > 0,
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
