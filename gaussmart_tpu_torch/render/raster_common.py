"""Shared per-splat preprocessing for the 2DGS surfel rasterizer
(counterpart of gaussmart_tpu/render/raster_common.py, same f32
expressions in the same order).

Builds the 3x3 homogeneous splat->pixel transform T, projects centres,
computes bounding radii, the tight opacity-aware footprint (rx, ry), the
c_cut-level conic (ell) for per-tile culling, camera-facing view-space
normals, and SH colours. Both the dense and the tiled compositors consume
its outputs.

Geometry convention (row vectors): [u, v, 1] @ T = (px * z, py * z, z),
so T's columns are (Tu, Tv, Tw) with Tw giving view-space depth.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.ops.sh import eval_sh
from gaussmart_tpu_torch.transforms import quat_to_rotmat, safe_normalize

NEAR_PLANE = 0.2          # near cull + distortion mapping near
FAR_PLANE = 100.0         # distortion mapping far
FILTER_INV_SQUARE = 2.0   # screen-space low-pass: sigma^2 = 0.5 px
ALPHA_EPS = 1.0 / 255.0   # skip threshold
T_EPS = 1e-4              # front-to-back early termination
ALPHA_MAX = 0.99


class Preprocessed(NamedTuple):
    """Per-splat rasterization inputs, all shape [N, ...]."""
    T: torch.Tensor           # [N,3,3] splat->homogeneous-pixel transform
    center2d: torch.Tensor    # [N,2] projected center (pixels)
    radius: torch.Tensor      # [N] float screen bounding radius (0 = culled)
    depth: torch.Tensor       # [N] view-space z of center
    normal: torch.Tensor      # [N,3] view-space normal (camera-facing)
    color: torch.Tensor       # [N,3] RGB
    opacity: torch.Tensor     # [N] in [0,1], zero where not valid
    valid: torch.Tensor       # [N] bool
    rx: torch.Tensor          # [N] tight per-axis half-extent (px, 0 = culled)
    ry: torch.Tensor          # [N] tight per-axis half-extent (px, 0 = culled)
    ell: torch.Tensor         # [N,5] centered c_cut-level conic (A, B, C,
    #                           ccx, ccy): the splat contributes where
    #                           A dx^2 + B dx dy + C dy^2 <= 1 with
    #                           (dx, dy) = pixel - (ccx, ccy); A=B=C=0 means
    #                           "no usable ellipse": keep every tile.


def _ndc2pix_cols(width: int, height: int, device) -> torch.Tensor:
    """Columns [0,1,3] of the (transposed) NDC->pixel matrix; the depth
    column is unused because Tw already carries view-space z."""
    return torch.tensor([
        [width / 2.0, 0.0, 0.0],
        [0.0, height / 2.0, 0.0],
        [0.0, 0.0, 0.0],
        [(width - 1) / 2.0, (height - 1) / 2.0, 1.0],
    ], dtype=torch.float32, device=device)


def preprocess(
    means3d: torch.Tensor,       # [N,3]
    scales: torch.Tensor,        # [N,2] activated (exp'd) 2-axis scales
    quats: torch.Tensor,         # [N,4] unnormalized (w,x,y,z)
    opacities: torch.Tensor,     # [N] activated (sigmoid'd)
    shs: torch.Tensor,           # [N,K,3] SH coeffs (DC first)
    active: torch.Tensor,        # [N] bool mask of live splats
    cam: CameraParams,
    sh_degree: int,
    scale_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    active_degree: Optional[int] = None,
) -> Preprocessed:
    """`sh_degree` is the max degree evaluated; `active_degree` (optional)
    masks the coefficient bands above it to zero, as the JAX package does,
    so the whole degree schedule evaluates the same bands."""
    W, H = cam.width, cam.height
    N = means3d.shape[0]
    dev = means3d.device
    R = quat_to_rotmat(quats)                         # [N,3,3]
    axis_u = R[..., :, 0] * (scales[:, 0:1] * scale_modifier)
    axis_v = R[..., :, 1] * (scales[:, 1:2] * scale_modifier)
    normal_world = R[..., :, 2]

    # Splat->pixel transform: rows [axis_u; axis_v; mean] with homog (0,0,1).
    M = torch.stack([axis_u, axis_v, means3d], dim=1)  # [N,3,3]
    hom = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                       device=dev)[None, :, None].expand(N, 3, 1)
    Mh = torch.cat([M, hom], dim=2)                    # [N,3,4]
    world2pix = cam.full_proj @ _ndc2pix_cols(W, H, dev)   # [4,3]
    T = Mh @ world2pix                                 # [N,3,3]

    # View-space center & normal.
    wv = cam.world_view
    p_view = means3d @ wv[:3, :3] + wv[3, :3]
    z_view = p_view[:, 2]
    n_view = normal_world @ wv[:3, :3]
    # Flip normals toward the camera.
    facing = torch.sum(p_view * n_view, dim=-1)
    n_view = n_view * torch.where(facing < 0, 1.0, -1.0)[:, None]

    # Screen-space center + extent from T: the projected conic of the
    # surfel, f = (1,1,-1)/dist.
    Tu, Tv, Tw = T[..., 0], T[..., 1], T[..., 2]      # [N,3] each (columns)
    dist = Tw[:, 0] ** 2 + Tw[:, 1] ** 2 - Tw[:, 2] ** 2
    safe_dist = torch.where(torch.abs(dist) < 1e-12, 1.0, dist)
    cx = (Tu[:, 0] * Tw[:, 0] + Tu[:, 1] * Tw[:, 1] - Tu[:, 2] * Tw[:, 2]) / safe_dist
    cy = (Tv[:, 0] * Tw[:, 0] + Tv[:, 1] * Tw[:, 1] - Tv[:, 2] * Tw[:, 2]) / safe_dist
    su = (Tu[:, 0] ** 2 + Tu[:, 1] ** 2 - Tu[:, 2] ** 2) / safe_dist
    sv = (Tv[:, 0] ** 2 + Tv[:, 1] ** 2 - Tv[:, 2] ** 2) / safe_dist
    ext_x = torch.sqrt(torch.clamp_min(cx * cx - su, 1e-4))
    ext_y = torch.sqrt(torch.clamp_min(cy * cy - sv, 1e-4))
    radius = torch.ceil(3.0 * torch.maximum(ext_x, ext_y))

    # Frustum / screen culling.
    on_screen = ((cx + radius > 0) & (cx - radius < W) &
                 (cy + radius > 0) & (cy - radius < H))
    valid = (active & (z_view > NEAR_PLANE) & (torch.abs(dist) >= 1e-12) & on_screen)
    radius = torch.where(valid, radius, 0.0)

    # Tight per-axis footprint for binning, exact w.r.t. the compositor's
    # per-pixel skip: alpha = o*exp(-rho/2) falls below ALPHA_EPS wherever
    # rho > c_cut = 2*ln(o/ALPHA_EPS), so a tile outside both the
    # rho3d<=c_cut level conic and the rho2d<=c_cut disc composites zero.
    # Clipped to the isotropic 3-sigma square so tiles the square cuts stay
    # cut. o <= ALPHA_EPS makes the footprint empty.
    c_cut = 2.0 * torch.log(torch.clamp_min(opacities, 1e-12) / ALPHA_EPS)
    inv_c = 1.0 / torch.clamp_min(c_cut, 1e-12)
    dist_c = Tw[:, 0] ** 2 + Tw[:, 1] ** 2 - Tw[:, 2] ** 2 * inv_c
    safe_dc = torch.where(torch.abs(dist_c) < 1e-12, 1.0, dist_c)
    cx_c = (Tu[:, 0] * Tw[:, 0] + Tu[:, 1] * Tw[:, 1]
            - Tu[:, 2] * Tw[:, 2] * inv_c) / safe_dc
    cy_c = (Tv[:, 0] * Tw[:, 0] + Tv[:, 1] * Tw[:, 1]
            - Tv[:, 2] * Tw[:, 2] * inv_c) / safe_dc
    su_c = (Tu[:, 0] ** 2 + Tu[:, 1] ** 2 - Tu[:, 2] ** 2 * inv_c) / safe_dc
    sv_c = (Tv[:, 0] ** 2 + Tv[:, 1] ** 2 - Tv[:, 2] ** 2 * inv_c) / safe_dc
    ex2 = cx_c * cx_c - su_c
    ey2 = cy_c * cy_c - sv_c
    # well-conditioned ellipse only; anything degenerate falls back to the
    # full square
    good = ((torch.abs(dist_c) >= 1e-12) & (dist_c * safe_dist > 0)
            & (ex2 >= 0) & (ey2 >= 0))
    extc_x = torch.sqrt(torch.clamp_min(ex2, 0.0))
    extc_y = torch.sqrt(torch.clamp_min(ey2, 0.0))
    r2d = torch.sqrt(torch.clamp_min(c_cut, 0.0) * 0.5)
    tx = torch.maximum(torch.abs(cx_c - cx) + extc_x, r2d)
    ty = torch.maximum(torch.abs(cy_c - cy) + extc_y, r2d)
    rx = torch.minimum(radius, torch.ceil(torch.where(good, tx, radius)))
    ry = torch.minimum(radius, torch.ceil(torch.where(good, ty, radius)))
    tight_ok = valid & (c_cut > 0.0)
    rx = torch.where(tight_ok, rx, 0.0)
    ry = torch.where(tight_ok, ry, 0.0)

    # Exact c_cut-level conic of rho3d in pixel space for the per-(splat,
    # tile) cull in the binning: centre (cx_c, cy_c) and 2x2 support
    # matrix P, built in coordinates recentred at (cx, cy). The cull may
    # only ever keep too much: P must be positive definite with
    # det >= 1e-4*trace^2 and the ellipse must contain the projected
    # centre; otherwise A = B = C = 0 ("keep the whole rect row").
    Tuc = Tu - cx[:, None] * Tw
    Tvc = Tv - cy[:, None] * Tw

    def dotc(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] - a[:, 2] * b[:, 2] * inv_c

    exo = dotc(Tuc, Tw) / safe_dc      # conic center offset from (cx, cy)
    eyo = dotc(Tvc, Tw) / safe_dc
    pxx = exo * exo - dotc(Tuc, Tuc) / safe_dc
    pxy = exo * eyo - dotc(Tuc, Tvc) / safe_dc
    pyy = eyo * eyo - dotc(Tvc, Tvc) / safe_dc
    detp = pxx * pyy - pxy * pxy
    trp = pxx + pyy
    is_ell = (good & (c_cut > 0.0) & (pxx > 0) & (pyy > 0)
              & (detp > 1e-4 * trp * trp))
    inv_det = torch.where(is_ell, 1.0 / torch.where(is_ell, detp, 1.0), 0.0)
    eA = pyy * inv_det
    eB = -2.0 * pxy * inv_det
    eC = pxx * inv_det
    q_ctr = eA * exo * exo + eB * exo * eyo + eC * eyo * eyo
    is_ell = is_ell & (q_ctr <= 1.0)
    zero_bad = is_ell.to(torch.float32)
    ell = torch.stack([eA * zero_bad, eB * zero_bad, eC * zero_bad,
                       cx + torch.where(is_ell, exo, 0.0),
                       cy + torch.where(is_ell, eyo, 0.0)], dim=1)

    # Color: SH evaluated toward the camera.
    if override_color is None:
        dirs = safe_normalize(means3d - cam.camera_center[None, :])
        sh_in = shs
        if active_degree is not None:
            k = (sh_degree + 1) ** 2
            bands = torch.floor(torch.sqrt(torch.arange(k, dtype=torch.float64)))
            mask = (bands <= float(active_degree)).to(shs.dtype).to(shs.device)
            sh_in = shs * mask[None, :k, None]
        color = torch.clamp_min(
            eval_sh(sh_degree, sh_in.transpose(1, 2), dirs) + 0.5, 0.0)
    else:
        color = override_color

    return Preprocessed(
        T=T,
        center2d=torch.stack([cx, cy], dim=-1),
        radius=radius,
        depth=z_view,
        normal=n_view,
        color=color,
        opacity=opacities * valid.to(opacities.dtype),
        valid=valid,
        rx=rx,
        ry=ry,
        ell=ell,
    )


def mapped_depth(depth: torch.Tensor) -> torch.Tensor:
    """Depth remap used by the distortion regularizer integral."""
    return FAR_PLANE / (FAR_PLANE - NEAR_PLANE) * (1.0 - NEAR_PLANE / depth)
