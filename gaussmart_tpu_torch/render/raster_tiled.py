"""Tile-binned 2DGS compositor (counterpart of
gaussmart_tpu/render/raster_pallas.py, forward only).

Three stages, the same semantics as the JAX package's tiled path:

  build_blob      per-splat [N+1, 20] rows: T (3x3, row-major), projected
                  centre, means2d shift in pixels, opacity, colour, normal;
                  the last row is zero.
  binning         every splat's clipped 16x16-tile rect from (rx, ry), cut
                  per tile row by the exact c_cut-level conic interval (the
                  same f32 expressions and margins as the JAX _binning, so
                  the (splat, tile) sets match), then one sort by the key
                  (tile << 32) | float_bits(depth). Valid depths are > 0.2,
                  so positive float bit patterns sort as integers: exact
                  depth order within a tile. Buffers are sized from exact
                  counts held in int64, with one host sync per frame;
                  nothing is ever dropped.
  composite_tiles the forward compositor K1: the CUDA kernel
                  csrc/raster_fwd.cu for CUDA tensors, composite_tiles_plain
                  for CPU tensors. A CUDA tensor never takes the plain
                  version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from gaussmart_tpu_torch import kernels
from gaussmart_tpu_torch.render.raster_common import (
    ALPHA_EPS, ALPHA_MAX, FILTER_INV_SQUARE, NEAR_PLANE, T_EPS, Preprocessed,
    mapped_depth)

TILE = 16
F = 20              # blob columns (see build_blob)
CH = 14             # float framebuffer channels
FB_CHANNELS = ("C0", "C1", "C2", "D", "A", "N0", "N1", "N2", "med", "dist",
               "T", "M1", "M2", "mt")
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3

# K1 launches in this process; chip_smoke.py zeroes it before driving the
# main path and reads it after
launches = 0


def tile_grid(width: int, height: int) -> Tuple[int, int]:
    return -(-width // TILE), -(-height // TILE)


def build_blob(prep: Preprocessed, means2d: torch.Tensor, width: int,
               height: int) -> torch.Tensor:
    """[N+1, F] per-splat rows (last row zero)."""
    N = prep.depth.shape[0]
    half_wh = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                           device=means2d.device)
    shift = means2d * half_wh[None, :]
    blob = torch.cat([prep.T.reshape(N, 9), prep.center2d, shift,
                      prep.opacity[:, None], prep.color, prep.normal], dim=1)
    return torch.cat([blob, blob.new_zeros(1, F)], dim=0).contiguous()


def _row_intervals(prep: Preprocessed, sid, ty, tx0, nx):
    """Column interval [cx0, cx1) of tile row `ty` that splat `sid` can
    touch: the conservative hull of its c_cut-level conic (prep.ell) and
    its filter disc over the row's pixel band, widened by the JAX
    package's margins (raster_pallas.py::_binning); rows of splats with no
    usable ellipse keep their full rect row."""
    c_cut = 2.0 * torch.log(torch.clamp_min(prep.opacity, 1e-12) / ALPHA_EPS)
    eA, eB, eC, ccx, ccy = prep.ell[sid].unbind(1)
    scx = prep.center2d[sid, 0]
    scy = prep.center2d[sid, 1]
    rd2 = (0.5 * c_cut)[sid]                        # filter-disc radius^2
    usable = (eA > 0) & (eC > 0)
    b0 = ty.to(torch.float32) * TILE                # pixel centres at ints
    b1 = b0 + float(TILE - 1)
    # ellipse x-extent over the band: the rightmost point of the ellipse is
    # at dy_m = -B dx_m / (2C); x+(dy) is concave, so its max over the band
    # is at clamp(dy_m) (symmetrically for x-)
    d0 = b0 - ccy
    d1 = b1 - ccy
    safeA = torch.where(usable, eA, 1.0)
    safeC = torch.where(usable, eC, 1.0)
    D4 = torch.clamp_min(4.0 * eA * eC - eB * eB, 1e-20)
    dx_m = 2.0 * torch.sqrt(torch.clamp_min(eC, 0.0) / D4)
    dy_r = -eB * dx_m / (2.0 * safeC)
    dy_rc = torch.clamp(dy_r, d0, d1)
    dy_lc = torch.clamp(-dy_r, d0, d1)
    disc_r = 4.0 * eA - D4 * dy_rc * dy_rc
    disc_l = 4.0 * eA - D4 * dy_lc * dy_lc
    dy_near = torch.clamp(torch.zeros_like(d0), d0, d1)
    e_hit = usable & (D4 * dy_near * dy_near <= 4.0 * eA * (1.0 + 2e-2) + 1e-6)
    xhi_e = ccx + (-eB * dy_rc + torch.sqrt(torch.clamp_min(disc_r, 0.0))) / (2.0 * safeA)
    xlo_e = ccx + (-eB * dy_lc - torch.sqrt(torch.clamp_min(disc_l, 0.0))) / (2.0 * safeA)
    err_e = 2e-2 * (dx_m + torch.abs(dy_rc) + torch.abs(dy_lc)) + 0.51
    # filter disc x-extent over the band
    dmin_d = torch.clamp_min(torch.maximum(b0 - scy, scy - b1), 0.0)
    d_hit = dmin_d * dmin_d <= rd2 * (1.0 + 1e-5) + 1e-5
    hw = torch.sqrt(torch.clamp_min(rd2 - dmin_d * dmin_d, 0.0)) + 0.51
    BIGX = 1e9
    xlo = torch.minimum(torch.where(e_hit, xlo_e - err_e, BIGX),
                        torch.where(d_hit, scx - hw, BIGX))
    xhi = torch.maximum(torch.where(e_hit, xhi_e + err_e, -BIGX),
                        torch.where(d_hit, scx + hw, -BIGX))
    xlo = torch.where(usable, xlo, -BIGX)
    xhi = torch.where(usable, xhi, BIGX)
    inv_t = 1.0 / TILE
    cx0 = torch.clamp(torch.floor(xlo * inv_t).to(torch.int64), tx0, tx0 + nx)
    cx1 = torch.clamp(torch.floor(xhi * inv_t).to(torch.int64) + 1, tx0, tx0 + nx)
    return cx0, torch.clamp_min(cx1 - cx0, 0)


def binning(prep: Preprocessed, tiles_x: int, tiles_y: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (entry_ids [M'] int32 splat ids sorted by (tile, depth),
    tile_ranges [tiles_x*tiles_y, 2] int32 (start, end) into entry_ids).
    M' is the rect pair count; entries past the last range are unused."""
    dev = prep.depth.device
    N = prep.depth.shape[0]
    n_tiles = tiles_x * tiles_y
    cx, cy = prep.center2d[:, 0], prep.center2d[:, 1]
    rx, ry = prep.rx, prep.ry
    valid = prep.valid & (rx > 0) & (ry > 0)

    def span(lo, hi, n):
        a = torch.clamp(torch.floor(lo / TILE), 0, n).to(torch.int64)
        b = torch.clamp(torch.floor(hi / TILE) + 1, 0, n).to(torch.int64)
        return a, b

    tx0, tx1 = span(cx - rx, cx + rx, tiles_x)
    ty0, ty1 = span(cy - ry, cy + ry, tiles_y)
    nx = torch.where(valid, tx1 - tx0, 0)
    ny = torch.where(valid, ty1 - ty0, 0)
    # the frame's one host sync: rect row and (splat, tile) pair counts
    n_rows, n_rect = torch.stack([ny.sum(), (nx * ny).sum()]).tolist()
    if n_rect == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(n_tiles, 2, dtype=torch.int32, device=dev))

    # splat -> (splat, tile row) over its rect rows
    sid = torch.repeat_interleave(torch.arange(N, device=dev), ny,
                                  output_size=n_rows)
    row0 = torch.cumsum(ny, 0) - ny
    ty = ty0[sid] + (torch.arange(n_rows, device=dev) - row0[sid])
    cx0, cnt = _row_intervals(prep, sid, ty, tx0[sid], nx[sid])

    # (splat, tile row) -> (splat, tile): the culled pair count is known
    # only on the device, so the pair buffer is sized by the rect count
    # and unused slots get the largest key
    cum = torch.cumsum(cnt, 0)
    slot = torch.arange(n_rect, device=dev)
    row = torch.searchsorted(cum, slot, right=True)
    live = row < n_rows
    row = torch.clamp_max(row, n_rows - 1)
    col = cx0[row] + slot - (cum[row] - cnt[row])
    tile = ty[row] * tiles_x + col
    pair_sid = sid[row]
    depth_bits = prep.depth.contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(live, (tile << 32) | depth_bits[pair_sid],
                      torch.iinfo(torch.int64).max)
    key, perm = torch.sort(key, stable=True)
    entry_ids = pair_sid[perm].to(torch.int32)
    edges = torch.searchsorted(
        key, torch.arange(n_tiles + 1, device=dev, dtype=torch.int64) << 32)
    tile_ranges = torch.stack([edges[:-1], edges[1:]], dim=1).to(torch.int32)
    return entry_ids, tile_ranges.contiguous()


def composite_tiles_plain(blob: torch.Tensor, entry_ids: torch.Tensor,
                          tile_ranges: torch.Tensor, width: int, height: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, vectorised over every tile's 256
    pixels, looping over entry position up to the longest tile list. Same
    per-entry expressions, in the same order, as csrc/raster_fwd.cu."""
    tiles_x, tiles_y = tile_grid(width, height)
    n_tiles = tiles_x * tiles_y
    dev = blob.device
    starts = tile_ranges[:, 0].to(torch.int64)
    counts = (tile_ranges[:, 1] - tile_ranges[:, 0]).to(torch.int64)
    t = torch.arange(n_tiles, device=dev)[:, None]
    p = torch.arange(TILE * TILE, device=dev)[None, :]
    px = ((t % tiles_x) * TILE + p % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + p // TILE).to(torch.float32)

    def zeros():
        return torch.zeros_like(px)

    T, M1, M2, mt = zeros() + 1.0, zeros(), zeros(), zeros() + 2.0
    acc = {k: zeros() for k in ("C0", "C1", "C2", "D", "A", "N0", "N1", "N2",
                                "med", "dist")}
    done = torch.zeros_like(px, dtype=torch.bool)
    n_contrib = torch.zeros_like(px, dtype=torch.int32)
    med_e = n_contrib - 1

    max_count = int(counts.max()) if n_tiles else 0
    for e in range(max_count):
        in_range = (e < counts)[:, None]
        idx = entry_ids[torch.clamp(starts + e, 0, max(entry_ids.shape[0] - 1, 0))]
        rows = blob[idx.to(torch.int64)]                 # [n_tiles, F]
        r = [rows[:, i:i + 1] for i in range(F)]
        b = r[:9]
        pxe = px - r[11]
        pye = py - r[12]
        kx = pxe * b[2] - b[0]
        ky = pxe * b[5] - b[3]
        kz = pxe * b[8] - b[6]
        lx = pye * b[2] - b[1]
        ly = pye * b[5] - b[4]
        lz = pye * b[8] - b[7]
        p_x = ky * lz - kz * ly
        p_y = kz * lx - kx * lz
        p_z = kx * ly - ky * lx
        degenerate = torch.abs(p_z) < 1e-12
        inv_pz = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, p_z))
        su = p_x * inv_pz
        sv = p_y * inv_pz
        rho3d = torch.where(degenerate, torch.inf, su * su + sv * sv)
        depth3d = su * b[2] + sv * b[5] + b[8]
        dx = r[9] - pxe
        dy = r[10] - pye
        rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
        rho = torch.minimum(rho3d, rho2d)
        depth = torch.where(rho3d <= rho2d, depth3d, b[8])
        alpha = torch.clamp_max(r[13] * torch.exp(-0.5 * rho), ALPHA_MAX)
        ok = (alpha >= ALPHA_EPS) & (depth >= NEAR_PLANE) & in_range
        alpha = torch.where(ok, alpha, 0.0)

        alive = ~done
        has_a = alpha > 0
        test_T = T * (1.0 - alpha)
        considered = alive & has_a
        trigger = considered & (test_T < T_EPS)
        contrib = considered & (test_T >= T_EPS)
        w = torch.where(contrib, alpha * T, 0.0)
        m = torch.where(contrib, mapped_depth(torch.where(contrib, depth, 1.0)), 0.0)
        dsel = torch.where(contrib, depth, 0.0)
        A_before = 1.0 - T
        acc["dist"] = acc["dist"] + (m * m * A_before + M2 - 2.0 * m * M1) * w
        M1 = M1 + m * w
        M2 = M2 + m * m * w
        med_hit = contrib & (T > 0.5)
        acc["med"] = torch.where(med_hit, dsel, acc["med"])
        med_e = torch.where(med_hit, e, med_e)
        for name, col in zip(("C0", "C1", "C2", "N0", "N1", "N2"), r[14:20]):
            acc[name] = acc[name] + w * col
        acc["D"] = acc["D"] + w * dsel
        acc["A"] = acc["A"] + w
        T = torch.where(contrib, test_T, T)
        done = done | trigger
        n_contrib = torch.where(contrib, e + 1, n_contrib)
        mt = torch.where(considered, torch.minimum(mt, test_T), mt)

    planes = dict(acc, T=T, M1=M1, M2=M2, mt=mt)
    fb = torch.stack([planes[k] for k in FB_CHANNELS])
    ints = torch.stack([n_contrib, med_e]).to(torch.int32)

    def to_image(x):    # [C, n_tiles, 256] -> [C, H_pad, W_pad]
        C = x.shape[0]
        x = x.reshape(C, tiles_y, tiles_x, TILE, TILE).permute(0, 1, 3, 2, 4)
        return x.reshape(C, tiles_y * TILE, tiles_x * TILE).contiguous()

    return to_image(fb), to_image(ints)


def composite_tiles(blob: torch.Tensor, entry_ids: torch.Tensor,
                    tile_ranges: torch.Tensor, width: int, height: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (fb [14, H_pad, W_pad] f32, ints [2, H_pad, W_pad] i32).

    CPU tensors take composite_tiles_plain. CUDA tensors launch
    csrc/raster_fwd.cu on the current stream or raise."""
    if blob.device.type == "cpu":
        return composite_tiles_plain(blob, entry_ids, tile_ranges, width, height)
    if blob.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on CPU or CUDA tensors, not {blob.device}")
    tiles_x, tiles_y = tile_grid(width, height)
    for name, x, dtype, ndim in (("blob", blob, torch.float32, 2),
                                 ("entry_ids", entry_ids, torch.int32, 1),
                                 ("tile_ranges", tile_ranges, torch.int32, 2)):
        if x.device != blob.device or x.dtype != dtype or x.dim() != ndim \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor "
                             f"on {blob.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    if blob.shape[1] != F or tuple(tile_ranges.shape) != (tiles_x * tiles_y, 2):
        raise ValueError(f"blob {tuple(blob.shape)} must be [N+1, {F}] and "
                         f"tile_ranges {tuple(tile_ranges.shape)} "
                         f"[{tiles_x * tiles_y}, 2]")
    fn = kernels.load("raster_fwd", _ARGTYPES)
    h_pad, w_pad = tiles_y * TILE, tiles_x * TILE
    fb = torch.empty((CH, h_pad, w_pad), dtype=torch.float32, device=blob.device)
    ints = torch.empty((2, h_pad, w_pad), dtype=torch.int32, device=blob.device)
    with torch.cuda.device(blob.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(blob.data_ptr(), entry_ids.data_ptr(), tile_ranges.data_ptr(),
                 tiles_x, tiles_y, fb.data_ptr(), ints.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"raster_fwd launch failed with CUDA error {err}")
    global launches
    launches += 1
    return fb, ints


def rasterize_tiled(prep: Preprocessed, means2d: torch.Tensor, bg: torch.Tensor,
                    width: int, height: int) -> Dict[str, torch.Tensor]:
    """Tiled forward: image [3,H,W], allmap [7,H,W] (expected depth, alpha,
    normal x3, median depth, distortion) and n_dropped, which is always 0
    because the binning never truncates."""
    tiles_x, tiles_y = tile_grid(width, height)
    blob = build_blob(prep, means2d, width, height)
    entry_ids, tile_ranges = binning(prep, tiles_x, tiles_y)
    fb, _ = composite_tiles(blob, entry_ids, tile_ranges, width, height)
    maps = fb[:, :height, :width]
    image = maps[0:3] + maps[10][None] * bg[:, None, None]
    allmap = maps[[3, 4, 5, 6, 7, 8, 9]]
    return {"image": image, "allmap": allmap,
            "n_dropped": torch.zeros((), dtype=torch.int32, device=fb.device)}
