"""Dense 2DGS surfel compositor in plain PyTorch (the forward of
gaussmart_tpu/render/raster_dense.py::rasterize_pixels).

Splats are depth-sorted once and composited front to back in chunks of K,
each chunk vectorised over all P pixels: sequential compositing inside a
chunk is rewritten with exclusive cumulative products/sums, with the same
early-termination rule (the splat that would push T below T_EPS is itself
excluded) and the same tile-rect cut as the tiled path. It serves
``backend="dense"`` and is the oracle of the tiled compositor: it
composites in exact depth order with no binning.

The 7-channel aux map: expected depth, alpha, view-space normal (3),
median depth, depth distortion.
"""
from __future__ import annotations

from typing import Dict

import torch

from gaussmart_tpu_torch.render.raster_common import (
    ALPHA_EPS, ALPHA_MAX, FILTER_INV_SQUARE, NEAR_PLANE, T_EPS,
    Preprocessed, mapped_depth)

TILE = 16.0


def _exclusive_cumprod(x):
    cp = torch.cumprod(x, dim=0)
    return torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)


def _exclusive_cumsum(x):
    return torch.cat([torch.zeros_like(x[:1]), torch.cumsum(x, dim=0)[:-1]], dim=0)


def _chunk_body(carry: Dict[str, torch.Tensor], chunk: Dict[str, torch.Tensor],
                px: torch.Tensor, py: torch.Tensor, half_wh: torch.Tensor):
    """Composite one chunk of K depth-sorted splats over all P pixels.

    A splat composites only into pixels of 16x16 tiles inside its binned
    footprint rect (the tiled path's binning): the rect is clamped to the
    ceil(3*sigma) square while the alpha cut can reach further, so this cut
    is not redundant with the alpha >= ALPHA_EPS skip."""
    T9 = chunk["T"]              # [K,9] row-major splat->pixel transform
    K = T9.shape[0]
    Tu = T9[:, 0::3]             # [K,3] columns of the 3x3 T
    Tv = T9[:, 1::3]
    Tw = T9[:, 2::3]

    shift = chunk["means2d"] * half_wh[None, :]          # [K,2] px units
    px_eff = px[None, :] - shift[:, 0:1]                 # [K,P]
    py_eff = py[None, :] - shift[:, 1:2]

    # Ray-splat intersection: planes k = px*Tw - Tu, l = py*Tw - Tv;
    # intersection point (u,v) from p = k x l.
    kx = px_eff * Tw[:, 0:1] - Tu[:, 0:1]
    ky = px_eff * Tw[:, 1:2] - Tu[:, 1:2]
    kz = px_eff * Tw[:, 2:3] - Tu[:, 2:3]
    lx = py_eff * Tw[:, 0:1] - Tv[:, 0:1]
    ly = py_eff * Tw[:, 1:2] - Tv[:, 1:2]
    lz = py_eff * Tw[:, 2:3] - Tv[:, 2:3]
    p_x = ky * lz - kz * ly
    p_y = kz * lx - kx * lz
    p_z = kx * ly - ky * lx
    degenerate = torch.abs(p_z) < 1e-12
    inv_pz = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, p_z))
    su = p_x * inv_pz
    sv = p_y * inv_pz
    rho3d = torch.where(degenerate, torch.inf, su * su + sv * sv)
    depth3d = su * Tw[:, 0:1] + sv * Tw[:, 1:2] + Tw[:, 2:3]

    # Screen-space low-pass (sigma^2 = 0.5px) around the projected center.
    dx = chunk["center"][:, 0:1] - px_eff
    dy = chunk["center"][:, 1:2] - py_eff
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)

    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, depth3d, Tw[:, 2:3])

    # tile-rect membership (binning mirror)
    cx_c = chunk["center"][:, 0:1]
    cy_c = chunk["center"][:, 1:2]
    rxk = chunk["rx"][:, None]
    ryk = chunk["ry"][:, None]
    tpx = torch.floor(px * (1.0 / TILE))[None, :]
    tpy = torch.floor(py * (1.0 / TILE))[None, :]
    in_rect = ((rxk > 0) & (ryk > 0)
               & (tpx >= torch.floor((cx_c - rxk) / TILE))
               & (tpx <= torch.floor((cx_c + rxk) / TILE))
               & (tpy >= torch.floor((cy_c - ryk) / TILE))
               & (tpy <= torch.floor((cy_c + ryk) / TILE)))

    alpha = torch.clamp_max(chunk["opacity"][:, None] * torch.exp(-0.5 * rho), ALPHA_MAX)
    alpha = torch.where((alpha >= ALPHA_EPS) & (depth >= NEAR_PLANE) & in_rect,
                        alpha, 0.0)

    # Front-to-back transmittance with the early-termination rule.
    T_before = carry["T"][None, :] * _exclusive_cumprod(1.0 - alpha)
    test_T = T_before * (1.0 - alpha)
    bad = ((test_T < T_EPS) & (alpha > 0)) | carry["done"][None, :]
    excluded = torch.cumsum(bad.to(torch.float32), dim=0) >= 1.0
    w = torch.where(excluded, 0.0, alpha * T_before)     # [K,P]

    feats = torch.cat([chunk["color"], chunk["normal"]], dim=1)   # [K,6]
    acc = torch.einsum("kp,kc->cp", w, feats)
    dsafe = torch.where(w > 0, depth, 1.0)
    depth_add = torch.sum(w * dsafe, dim=0)
    alpha_add = torch.sum(w, dim=0)

    # Depth distortion integral (m in remapped [near,far] space).
    m = torch.where(w > 0, mapped_depth(dsafe), 0.0)
    mw = m * w
    m2w = m * mw
    A_before = 1.0 - T_before
    M1_before = carry["M1"][None, :] + _exclusive_cumsum(mw)
    M2_before = carry["M2"][None, :] + _exclusive_cumsum(m2w)
    dist_add = torch.sum((m * m * A_before + M2_before - 2.0 * m * M1_before) * w, dim=0)

    # Median depth: depth of the last included splat with T_before > 0.5.
    med_mask = (w > 0) & (T_before > 0.5)
    kid = torch.arange(K, dtype=torch.int64, device=w.device)[:, None]
    last = torch.max(torch.where(med_mask, kid, -1), dim=0).values   # [P]
    med_depth = torch.gather(depth, 0, last.clamp_min(0)[None, :])[0]
    median = torch.where(last >= 0, med_depth, carry["median"])

    # Transmittance carry: stop exactly at the first early-termination hit.
    any_bad = torch.any(bad, dim=0)
    first = torch.argmax(bad.to(torch.int8), dim=0)
    T_at_cut = torch.gather(T_before, 0, first[None, :])[0]
    T_full = carry["T"] * torch.prod(1.0 - alpha, dim=0)
    new_T = torch.where(any_bad, T_at_cut, T_full)

    # min test transmittance over CONSIDERED entries (incl. the terminating
    # one, which T never records)
    bad_i = bad.to(torch.int32)
    prior_bad = (torch.cumsum(bad_i, dim=0) - bad_i) >= 1
    considered = (alpha > 0) & ~prior_bad & ~carry["done"][None, :]
    mt_chunk = torch.min(torch.where(considered, test_T, 2.0), dim=0).values

    return {
        "T": new_T,
        "min_test": torch.minimum(carry["min_test"], mt_chunk),
        "done": carry["done"] | any_bad,
        "color": carry["color"] + acc[0:3],
        "normal": carry["normal"] + acc[3:6],
        "depth": carry["depth"] + depth_add,
        "alpha": carry["alpha"] + alpha_add,
        "M1": carry["M1"] + torch.sum(mw, dim=0),
        "M2": carry["M2"] + torch.sum(m2w, dim=0),
        "dist": carry["dist"] + dist_add,
        "median": median,
    }


def rasterize_pixels(
    prep: Preprocessed,
    means2d: torch.Tensor,        # [N,2] zeros (screen-space grad side channel)
    bg: torch.Tensor,             # [3]
    width: int,
    height: int,
    chunk: int = 64,
) -> Dict[str, torch.Tensor]:
    """Composite preprocessed splats into an image + 7-channel aux map."""
    N = prep.depth.shape[0]
    dev = prep.depth.device
    P = width * height
    half_wh = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                           device=dev)

    # Global front-to-back order.
    sort_key = torch.where(prep.valid, prep.depth, torch.inf)
    order = torch.argsort(sort_key, stable=True)
    fields = {
        "T": prep.T.reshape(N, 9),
        "center": prep.center2d,
        "opacity": prep.opacity,
        "color": prep.color,
        "normal": prep.normal,
        "means2d": means2d,
        "rx": prep.rx,
        "ry": prep.ry,
    }
    fields = {k: v[order] for k, v in fields.items()}

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    px = xs.reshape(P)
    py = ys.reshape(P)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    carry = {
        "T": zeros(P) + 1.0,
        "min_test": zeros(P) + 2.0,
        "done": torch.zeros(P, dtype=torch.bool, device=dev),
        "color": zeros(3, P), "normal": zeros(3, P),
        "depth": zeros(P), "alpha": zeros(P),
        "M1": zeros(P), "M2": zeros(P), "dist": zeros(P), "median": zeros(P),
    }
    for s in range(0, N, chunk):
        carry = _chunk_body(carry, {k: v[s:s + chunk] for k, v in fields.items()},
                            px, py, half_wh)

    image = carry["color"] + carry["T"][None, :] * bg[:, None]
    allmap = torch.stack([
        carry["depth"],
        carry["alpha"],
        carry["normal"][0], carry["normal"][1], carry["normal"][2],
        carry["median"],
        carry["dist"],
    ], dim=0)
    return {
        "image": image.reshape(3, height, width),
        "allmap": allmap.reshape(7, height, width),
    }
