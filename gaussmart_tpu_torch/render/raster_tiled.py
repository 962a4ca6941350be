"""Tile-binned 2DGS compositor (counterpart of
gaussmart_tpu/render/raster_pallas.py), forward and backward.

Three forward stages, the same semantics as the JAX package's tiled path:

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
                  nothing is ever dropped. It also returns the per-splat
                  terms of its interval test (build_conics), which the
                  kernel's cull reuses, and the backward's reduction plan:
                  the splat-major work-slot map of its (splat, tile) pairs
                  (inv_slots, slot_starts, slot_tile), written only where
                  a backward can run (wants_plan). For CUDA tensors it is
                  K7, csrc/binning.cu, three kernels around one torch.sort;
                  binning_plain, its twin, for CPU tensors.
  composite_tiles the forward compositor K1: the CUDA kernel
                  csrc/raster_fwd.cu for CUDA tensors, composite_tiles_plain
                  for CPU tensors. A CUDA tensor never takes the plain
                  version. Given a per-pixel seed `init` (T0, M1_0, M2_0)
                  it is K3, the seeded compositor of Gaussian-sharded
                  rendering: the walk starts from the seed instead of
                  (1, 0, 0), so a depth-contiguous stratum of a larger
                  splat set composites against the global incoming state.
                  The kernel also reads the binning's conic rows, for its
                  cull of (entry, warp) pairs (band_mask_plain is its
                  twin).

The backward (RasterCore, a torch.autograd.Function like the JAX custom
VJP _raster_core) runs K2, composite_tiles_bwd: the reverse walk writes
one gradient row of the 20 blob fields per (splat, tile) entry, and
grad_reduce sums the rows per splat through the binning's work-slot map
with K5 (render/segsum.py), in a fixed order. RasterCoreSeeded (the JAX
_raster_core_seeded) runs K3 forward and K4 backward: K2 plus
cotangents on the raw M1/M2 outputs, the seeded distortion terms and the
seed's own gradient.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gaussmart_tpu_torch import kernels
from gaussmart_tpu_torch.logging_utils import count, is_tracing, span
from gaussmart_tpu_torch.render import segsum
from gaussmart_tpu_torch.render.raster_common import (
    ALPHA_EPS, ALPHA_MAX, FAR_PLANE, FILTER_INV_SQUARE, NEAR_PLANE, T_EPS,
    Preprocessed, mapped_depth)

TILE = 16
F = 20              # blob columns (see build_blob)
FC = 8              # conic columns (see build_conics)
WARP_ROWS, WARP_COLS = 4, 8     # raster_fwd.cu's warp: a 4x8 block of a tile's pixels
CH = 14             # float framebuffer channels
FB_CHANNELS = ("C0", "C1", "C2", "D", "A", "N0", "N1", "N2", "med", "dist",
               "T", "M1", "M2", "mt")
CT = 11             # channels with cotangents: C0..2 D A N0..2 med dist T
CT_SEEDED = 13      # the seeded core's: also M1 and M2 (they feed the fold)
FARNEAR = (FAR_PLANE * NEAR_PLANE) / (FAR_PLANE - NEAR_PLANE)  # d(mapped)/d(depth) * depth^2
MAPPED_SCALE = FAR_PLANE / (FAR_PLANE - NEAR_PLANE)             # mapped_depth's factor


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


def _conic_terms(ell: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """[N, FC] per-splat terms of the conservative interval test
    (_x_extent): (A, B, ccx, ccy) of the c_cut-level conic `ell` (prep.ell,
    A set to 0 where the ellipse is not usable), D4 = 4AC - B^2 (at least
    1e-20), the ellipse's half-width dx_m, the row offset dy_r of its
    rightmost point, and the filter disc's radius^2 rd2 = c_cut / 2."""
    eA, eB, eC, ccx, ccy = ell.unbind(-1)
    usable = (eA > 0) & (eC > 0)
    safeC = torch.where(usable, eC, 1.0)
    D4 = torch.clamp_min(4.0 * eA * eC - eB * eB, 1e-20)
    dx_m = 2.0 * torch.sqrt(torch.clamp_min(eC, 0.0) / D4)
    dy_r = -eB * dx_m / (2.0 * safeC)
    c_cut = 2.0 * torch.log(torch.clamp_min(opacity, 1e-12) / ALPHA_EPS)
    return torch.stack([torch.where(usable, eA, 0.0), eB, ccx, ccy, D4, dx_m, dy_r,
                        0.5 * c_cut], dim=-1)


def build_conics(prep: Preprocessed) -> torch.Tensor:
    """[N+1, FC] per-splat rows of _conic_terms (32-byte rows), the last
    row zero: the binning's interval test reads them, and raster_fwd.cu's
    band cull. It carries no gradient."""
    terms = _conic_terms(prep.ell.detach(), prep.opacity.detach())
    return torch.nn.functional.pad(terms, (0, 0, 0, 1)).contiguous()


def _x_extent(terms, scx, scy, b0, b1):
    """x-extent [xlo, xhi] (pixels) that a splat can reach in the pixel
    rows [b0, b1]: the conservative hull of its c_cut-level conic and its
    filter disc (centre (scx, scy)) over the band, from its _conic_terms,
    widened by the JAX package's margins (raster_pallas.py::_binning); a
    splat with no usable ellipse reaches every column. The binning takes it
    over a tile row's 16 pixel rows, raster_fwd.cu's band cull
    (band_mask_plain) over a warp's 4."""
    eA, eB, ccx, ccy, D4, dx_m, dy_r, rd2 = terms.unbind(-1)
    usable = eA > 0
    # ellipse x-extent over the band: the rightmost point of the ellipse is
    # at dy_m = -B dx_m / (2C); x+(dy) is concave, so its max over the band
    # is at clamp(dy_m) (symmetrically for x-)
    d0 = b0 - ccy
    d1 = b1 - ccy
    safeA = torch.where(usable, eA, 1.0)
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
    return torch.where(usable, xlo, -BIGX), torch.where(usable, xhi, BIGX)


def _row_intervals(conics, center2d, sid, ty, tx0, nx):
    """Column interval [cx0, cx1) of tile row `ty` that splat `sid` can
    touch (_x_extent over the row's 16 pixel rows, on its build_conics
    row); rows of splats with no usable ellipse keep their full rect
    row."""
    b0 = ty.to(torch.float32) * TILE                # pixel centres at ints
    # each splat's row gathered element by element: on CUDA, gathering whole
    # 32-byte rows (conics[sid], index_select, gather) takes PyTorch's
    # vectorized gather, a block for each row (vectorized_gather_kernel in
    # chip_smoke.py's serving-frame profile)
    fc = conics.shape[1]
    rows = conics.reshape(-1)[sid[:, None] * fc + torch.arange(fc, device=sid.device)]
    xlo, xhi = _x_extent(rows, center2d[sid, 0], center2d[sid, 1], b0,
                         b0 + float(TILE - 1))
    inv_t = 1.0 / TILE
    cx0 = torch.clamp(torch.floor(xlo * inv_t).to(torch.int64), tx0, tx0 + nx)
    cx1 = torch.clamp(torch.floor(xhi * inv_t).to(torch.int64) + 1, tx0, tx0 + nx)
    return cx0, torch.clamp_min(cx1 - cx0, 0)


class Binned(NamedTuple):
    """binning's outputs. M' is the rect pair count (the buffer size).

    entry_ids    [M'] int32 splat ids sorted by (tile, depth); entries past
                 the last range are unused and hold N, the blob's zero row.
    tile_ranges  [tiles_x*tiles_y, 2] int32 (start, end) into entry_ids.
    conics       [N+1, FC], the build_conics rows of the interval test,
                 which composite_tiles takes for its cull.
    inv_slots    [M'] int32: the entry position of each work slot. Slots
                 are the (splat, tile) pairs in splat-major order (a
                 splat's tiles ascending), as the JAX package's inv_slots.
                 Empty where no backward can run (binning's `plan`).
    slot_starts  [N+1] int32: splat s owns slots [slot_starts[s],
                 slot_starts[s+1]); slot_starts[N] is the live pair count.
    slot_tile    [M'] int32: each slot's tile (for the walk-window skip);
                 empty with inv_slots.

    Within a splat, slot order is entry order (one depth, ascending
    tiles), so a sum in slot order adds a splat's rows in entry order."""
    entry_ids: torch.Tensor
    tile_ranges: torch.Tensor
    conics: torch.Tensor
    inv_slots: torch.Tensor
    slot_starts: torch.Tensor
    slot_tile: torch.Tensor


def wants_plan(*tensors) -> bool:
    """Whether a backward can run through the compositor on these inputs:
    grad enabled and one of them requiring it. Only then does binning
    write the reduction plan (inv_slots, slot_tile)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _empty_plan(dev) -> torch.Tensor:
    return torch.empty(0, dtype=torch.int32, device=dev)


def binning_plain(prep: Preprocessed, tiles_x: int, tiles_y: int,
                  conics: Optional[torch.Tensor] = None, plan: bool = True) -> Binned:
    """Plain PyTorch version of K7 (binning): the (splat, tile) pairs of
    the frame sorted by (tile, depth), and the backward's reduction plan
    (Binned; inv_slots and slot_tile empty unless `plan`). `conics` is
    build_conics(prep) where the caller has it already."""
    dev = prep.depth.device
    N = prep.depth.shape[0]
    n_tiles = tiles_x * tiles_y
    if conics is None:
        conics = build_conics(prep)
    cx, cy = prep.center2d[:, 0], prep.center2d[:, 1]
    rx, ry = prep.rx, prep.ry
    valid = prep.valid & (rx > 0) & (ry > 0)

    def tile_span(lo, hi, n):
        a = torch.clamp(torch.floor(lo / TILE), 0, n).to(torch.int64)
        b = torch.clamp(torch.floor(hi / TILE) + 1, 0, n).to(torch.int64)
        return a, b

    tx0, tx1 = tile_span(cx - rx, cx + rx, tiles_x)
    ty0, ty1 = tile_span(cy - ry, cy + ry, tiles_y)
    nx = torch.where(valid, tx1 - tx0, 0)
    ny = torch.where(valid, ty1 - ty0, 0)
    # the frame's one host sync: rect row and (splat, tile) pair counts
    with span("render.binning.sync"):
        n_rows, n_rect = torch.stack([ny.sum(), (nx * ny).sum()]).tolist()
    count("render.rect_pairs", n_rect)
    if n_rect == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return Binned(empty, torch.zeros(n_tiles, 2, dtype=torch.int32, device=dev), conics,
                      empty, torch.zeros(N + 1, dtype=torch.int32, device=dev), empty)

    # splat -> (splat, tile row) over its rect rows
    sid = torch.repeat_interleave(torch.arange(N, device=dev), ny,
                                  output_size=n_rows)
    row0 = torch.cumsum(ny, 0) - ny
    ty = ty0[sid] + (torch.arange(n_rows, device=dev) - row0[sid])
    cx0, cnt = _row_intervals(conics, prep.center2d, sid, ty, tx0[sid], nx[sid])

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
    entry_ids = torch.where(key == torch.iinfo(torch.int64).max, N,
                            pair_sid[perm]).to(torch.int32)
    edges = torch.searchsorted(
        key, torch.arange(n_tiles + 1, device=dev, dtype=torch.int64) << 32)
    tile_ranges = torch.stack([edges[:-1], edges[1:]], dim=1).to(torch.int32)
    # the reduction plan: the pairs were built splat-major, so the sort's
    # permutation maps entry position -> slot and its inverse is one
    # integer scatter; a splat's slots start at its first rect row's
    # exclusive count (a splat with no rows gets an empty range)
    first_row = torch.cat([row0, row0.new_full((1,), n_rows)])
    slot_starts = torch.cat([cum.new_zeros(1), cum])[first_row].to(torch.int32)
    if is_tracing():
        count("render.live_pairs", slot_starts[N])
    if not plan:
        return Binned(entry_ids, tile_ranges.contiguous(), conics, _empty_plan(dev),
                      slot_starts, _empty_plan(dev))
    inv_slots = torch.empty(n_rect, dtype=torch.int32, device=dev).scatter_(
        0, perm, torch.arange(n_rect, dtype=torch.int32, device=dev))
    return Binned(entry_ids, tile_ranges.contiguous(), conics, inv_slots, slot_starts,
                  tile.to(torch.int32))


def binning(prep: Preprocessed, tiles_x: int, tiles_y: int,
            conics: Optional[torch.Tensor] = None, plan: bool = True) -> Binned:
    """K7: the (splat, tile) pairs of the frame sorted by (tile, depth),
    and the backward's reduction plan (Binned), bit-equal to
    binning_plain. `conics` is build_conics(prep) where the caller has it
    already; without `plan` (no backward can run: wants_plan) inv_slots and
    slot_tile are empty.

    CPU tensors take binning_plain. CUDA tensors launch csrc/binning.cu on
    the current stream or raise: bin_count, the scan of its counts, the
    frame's one host sync (render.binning.sync), bin_emit, torch.sort of
    the live keys, bin_finish; the launch counter "binning" adds 1 a
    binning, after bin_count's launch."""
    dev = prep.depth.device
    if dev.type == "cpu":
        return binning_plain(prep, tiles_x, tiles_y, conics, plan)
    if dev.type != "cuda":
        raise ValueError(f"binning runs on CPU or CUDA tensors, not {dev}")
    return _binning_k7(prep, tiles_x, tiles_y,
                       build_conics(prep) if conics is None else conics, plan)


def _binning_k7(prep: Preprocessed, tiles_x: int, tiles_y: int, conics: torch.Tensor,
                plan: bool) -> Binned:
    dev = prep.depth.device
    N = prep.depth.shape[0]
    n_tiles = tiles_x * tiles_y
    center2d, depth = prep.center2d, prep.depth.contiguous()
    rx, ry, valid = prep.rx.contiguous(), prep.ry.contiguous(), prep.valid.contiguous()
    kernels.check_tensors((("depth", depth, torch.float32, 1), ("rx", rx, torch.float32, 1),
                           ("ry", ry, torch.float32, 1), ("valid", valid, torch.bool, 1),
                           ("conics", conics, torch.float32, 2)), dev)
    if (center2d.device != dev or center2d.dtype != torch.float32
            or tuple(center2d.shape) != (N, 2) or center2d.stride(1) != 1
            or any(x.shape[0] != N for x in (rx, ry, valid))
            or tuple(conics.shape) != (N + 1, FC)):
        raise ValueError(f"binning: center2d {tuple(center2d.shape)} must be [{N}, 2] float32 "
                         f"with unit column stride, rx, ry, valid [{N}] and conics "
                         f"{tuple(conics.shape)} [{N + 1}, {FC}]")
    if conics.data_ptr() % 16:
        raise ValueError("conics must start on a 16-byte boundary: binning reads its rows "
                         "with 16-byte loads")
    splats = (center2d.data_ptr(), center2d.stride(0), rx.data_ptr(), ry.data_ptr(),
              valid.data_ptr(), conics.data_ptr(), N, tiles_x, tiles_y)
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty(N, **i32)
    slot_starts = torch.empty(N + 1, **i32)
    totals = torch.empty(3, dtype=torch.int64, device=dev)
    kernels.launch("bin_count", dev, *splats, counts.data_ptr(), slot_starts.data_ptr(),
                   totals.data_ptr())
    count("binning", 1)       # the binning went through K7
    torch.cumsum(counts, 0, dtype=torch.int32, out=slot_starts[1:])
    # the frame's one host sync: rect and live pair counts
    with span("render.binning.sync"):
        n_rect, n_live, _ = totals.tolist()
    count("render.rect_pairs", n_rect)
    if n_rect >= 2 ** 31:
        raise ValueError(f"binning: {n_rect} rectangle pairs overflow the int32 entry "
                         "buffers")
    if n_rect == 0:
        empty = _empty_plan(dev)
        return Binned(empty, torch.zeros(n_tiles, 2, **i32), conics, empty, slot_starts,
                      empty)
    keys = torch.empty(n_live, dtype=torch.int64, device=dev)
    pair_sid = torch.empty(n_live, **i32)
    slot_tile = torch.empty(n_rect, **i32) if plan else _empty_plan(dev)
    tile_ptr = slot_tile.data_ptr() if plan else None
    if n_live:
        kernels.launch("bin_emit", dev, *splats, depth.data_ptr(), slot_starts.data_ptr(),
                       keys.data_ptr(), pair_sid.data_ptr(), tile_ptr)
    keys, perm = torch.sort(keys, stable=True)
    entry_ids = torch.empty(n_rect, **i32)
    tile_ranges = torch.empty(n_tiles, 2, **i32)
    inv_slots = torch.empty(n_rect, **i32) if plan else _empty_plan(dev)
    kernels.launch("bin_finish", dev, keys.data_ptr(), perm.data_ptr(), pair_sid.data_ptr(),
                   totals.data_ptr(), n_live, n_rect, N, n_tiles, entry_ids.data_ptr(),
                   tile_ranges.data_ptr(), inv_slots.data_ptr() if plan else None, tile_ptr)
    if is_tracing():
        count("render.live_pairs", slot_starts[N])
    return Binned(entry_ids, tile_ranges, conics, inv_slots, slot_starts, slot_tile)


def warp_pixels(device=None) -> torch.Tensor:
    """[8, 32]: the tile pixel (row-major index in the 16x16 tile) of each
    lane of each warp of raster_fwd.cu: warp w holds the 4x8 block at rows
    4 (w // 2) and columns 8 (w % 2), lane l its row l // 8, column l % 8."""
    i = torch.arange(TILE * TILE, device=device)
    i = i.reshape(TILE // WARP_ROWS, WARP_ROWS, TILE // WARP_COLS, WARP_COLS)
    return i.permute(0, 2, 1, 3).reshape(TILE * TILE // 32, 32)


def band_mask_plain(blob: torch.Tensor, conics: torch.Tensor, entry_ids: torch.Tensor,
                    tile_ranges: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of raster_fwd.cu's band cull: [M', 8] bool, column w
    of entry slot i (of the tile whose range holds it) True unless the
    splat fails the alpha test at every pixel of warp w's 4x8 block
    (warp_pixels), each pixel shifted by the splat's means2d shift as the
    walk shifts it (_x_extent over the block's rows, the binning's column
    test over its columns); False past the last range."""
    tiles_x = tile_grid(width, 1)[0]
    dev = blob.device
    counts = (tile_ranges[:, 1] - tile_ranges[:, 0]).to(torch.int64)
    used = int(tile_ranges[-1, 1]) if counts.numel() else 0
    tile = torch.repeat_interleave(torch.arange(counts.numel(), device=dev), counts,
                                   output_size=used)[:, None]
    sid = entry_ids[:used].to(torch.int64)
    r = blob[sid]
    corner = warp_pixels(dev)[:, 0]                     # each warp's first pixel
    xl = ((tile % tiles_x) * TILE + corner % TILE).to(torch.float32) - r[:, 11:12]
    b0 = ((tile // tiles_x) * TILE + corner // TILE).to(torch.float32) - r[:, 12:13]
    xlo, xhi = _x_extent(conics[sid, None], r[:, 9:10], r[:, 10:11], b0,
                         b0 + float(WARP_ROWS - 1))
    mask = torch.zeros((entry_ids.shape[0], corner.shape[0]), dtype=torch.bool, device=dev)
    mask[:used] = (xlo < xl + float(WARP_COLS)) & (xhi >= xl)
    return mask


def _to_tiles(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """[C, H_pad, W_pad] -> [C, n_tiles, 256], pixels of a tile row-major."""
    C = x.shape[0]
    x = x.reshape(C, tiles_y, TILE, tiles_x, TILE).permute(0, 1, 3, 2, 4)
    return x.reshape(C, tiles_x * tiles_y, TILE * TILE)


def _to_image(x: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """[C, n_tiles, 256] -> [C, H_pad, W_pad], the inverse of _to_tiles."""
    C = x.shape[0]
    x = x.reshape(C, tiles_y, tiles_x, TILE, TILE).permute(0, 1, 3, 2, 4)
    return x.reshape(C, tiles_y * TILE, tiles_x * TILE).contiguous()


def composite_tiles_plain(blob: torch.Tensor, entry_ids: torch.Tensor,
                          tile_ranges: torch.Tensor, width: int, height: int,
                          init: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (K3 given `init`, the per-pixel seed
    [3, H_pad, W_pad] of T, M1, M2), vectorised over every tile's 256
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

    if init is None:
        T, M1, M2 = zeros() + 1.0, zeros(), zeros()
    else:
        T, M1, M2 = _to_tiles(init, tiles_x, tiles_y).unbind(0)
    mt = zeros() + 2.0
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
        res = _geom_res(r, px, py)
        depth = res["depth"]
        alpha = torch.where(in_range, res["alpha"], 0.0)

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
    return _to_image(fb, tiles_x, tiles_y), _to_image(ints, tiles_x, tiles_y)


def composite_tiles(blob: torch.Tensor, conics: torch.Tensor, entry_ids: torch.Tensor,
                    tile_ranges: torch.Tensor, width: int, height: int,
                    init: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1, or K3 given the seed `init` [3, H_pad, W_pad] f32 (T0, M1_0,
    M2_0): (fb [14, H_pad, W_pad] f32, ints [2, H_pad, W_pad] i32).
    `conics` is binning's (build_conics') [N+1, FC] for the blob's splats.

    CPU tensors take composite_tiles_plain, which walks every entry and
    needs no conics. CUDA tensors launch csrc/raster_fwd.cu (entry
    raster_fwd, or raster_fwd_seeded) on the current stream or raise."""
    if blob.device.type == "cpu":
        return composite_tiles_plain(blob, entry_ids, tile_ranges, width, height, init)
    if blob.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on CPU or CUDA tensors, not {blob.device}")
    tiles_x, tiles_y = tile_grid(width, height)
    h_pad, w_pad = tiles_y * TILE, tiles_x * TILE
    kernels.check_tensors((("blob", blob, torch.float32, 2),
                           ("conics", conics, torch.float32, 2),
                           ("entry_ids", entry_ids, torch.int32, 1),
                           ("tile_ranges", tile_ranges, torch.int32, 2))
                          + ((("init", init, torch.float32, 3),) if init is not None
                             else ()), blob.device)
    if (blob.shape[1] != F or tuple(conics.shape) != (blob.shape[0], FC)
            or tuple(tile_ranges.shape) != (tiles_x * tiles_y, 2)
            or (init is not None and tuple(init.shape) != (3, h_pad, w_pad))):
        raise ValueError(f"blob {tuple(blob.shape)} must be [N+1, {F}], conics "
                         f"{tuple(conics.shape)} [N+1, {FC}], tile_ranges "
                         f"{tuple(tile_ranges.shape)} [{tiles_x * tiles_y}, 2] and "
                         f"init [3, {h_pad}, {w_pad}]")
    if blob.data_ptr() % 16 or conics.data_ptr() % 16:
        raise ValueError("blob and conics must start on a 16-byte boundary: "
                         "raster_fwd stages their rows with 16-byte copies")
    fb = torch.empty((CH, h_pad, w_pad), dtype=torch.float32, device=blob.device)
    ints = torch.empty((2, h_pad, w_pad), dtype=torch.int32, device=blob.device)
    entry = "raster_fwd" if init is None else "raster_fwd_seeded"
    kernels.launch(entry, blob.device, blob.data_ptr(), conics.data_ptr(),
                   entry_ids.data_ptr(), tile_ranges.data_ptr(),
                   *(() if init is None else (init.data_ptr(),)), tiles_x, tiles_y,
                   fb.data_ptr(), ints.data_ptr())
    count(entry, 1)
    return fb, ints


def _geom_res(r, px, py):
    """Forward geometry of one entry per tile (r: the 20 blob columns,
    [n_tiles, 1] each) over every pixel, keeping what the backward reuses
    (the JAX _geom_fwd_res). The expressions are K1's."""
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
    u = p_x * inv_pz
    v = p_y * inv_pz
    rho3d = torch.where(degenerate, torch.inf, u * u + v * v)
    depth3d = u * b[2] + v * b[5] + b[8]
    dxc = r[9] - pxe
    dyc = r[10] - pye
    rho2d = FILTER_INV_SQUARE * (dxc * dxc + dyc * dyc)
    use3d = rho3d <= rho2d
    depth = torch.where(use3d, depth3d, b[8])
    g = torch.exp(-0.5 * torch.minimum(rho3d, rho2d))
    a_raw = r[13] * g
    alpha = torch.clamp_max(a_raw, ALPHA_MAX)
    ok = (alpha >= ALPHA_EPS) & (depth >= NEAR_PLANE)
    return dict(b=b, pxe=pxe, pye=pye, kx=kx, ky=ky, kz=kz, lx=lx, ly=ly,
                lz=lz, inv_pz=inv_pz, u=u, v=v, use3d=use3d, dxc=dxc, dyc=dyc,
                g=g, live=ok & (a_raw < ALPHA_MAX),
                alpha=torch.where(ok, alpha, 0.0), depth=depth)


def _geom_bwd(res, opacity, ca, cd):
    """Cotangents of (alpha, depth) -> the 13 geometry fields and opacity
    (the JAX _geom_manual_bwd, in csrc/raster_bwd.cu's order of
    operations); the cross-product cotangents are kept negated."""
    b = res["b"]
    gop_f = ca * res["g"] * res["live"].to(torch.float32)
    crho = -0.5 * opacity * gop_f
    u3 = res["use3d"].to(torch.float32)
    crho3 = crho * u3
    crho2 = crho - crho3
    cdep3 = cd * u3
    cd_b8 = cd - cdep3
    f4x = 2.0 * FILTER_INV_SQUARE * res["dxc"] * crho2
    f4y = 2.0 * FILTER_INV_SQUARE * res["dyc"] * crho2
    u, v = res["u"], res["v"]
    cu = 2.0 * u * crho3 + b[2] * cdep3
    cv = 2.0 * v * crho3 + b[5] * cdep3
    ninv_pz = -res["inv_pz"]
    ncpx = cu * ninv_pz
    ncpy = cv * ninv_pz
    ncpz = -(u * ncpx + v * ncpy)
    kx, ky, kz = res["kx"], res["ky"], res["kz"]
    lx, ly, lz = res["lx"], res["ly"], res["lz"]
    nckx = ly * ncpz - lz * ncpy
    ncky = lz * ncpx - lx * ncpz
    nckz = lx * ncpy - ly * ncpx
    nclx = ncpy * kz - ncpz * ky
    ncly = ncpz * kx - ncpx * kz
    nclz = ncpx * ky - ncpy * kx
    pxe, pye = res["pxe"], res["pye"]
    gb2 = u * cdep3 - (pxe * nckx + pye * nclx)
    gb5 = v * cdep3 - (pxe * ncky + pye * ncly)
    gb8 = cdep3 + cd_b8 - (pxe * nckz + pye * nclz)
    gsx = f4x + (nckx * b[2] + ncky * b[5] + nckz * b[8])
    gsy = f4y + (nclx * b[2] + ncly * b[5] + nclz * b[8])
    return [nckx, nclx, gb2, ncky, ncly, gb5, nckz, nclz, gb8,
            f4x, f4y, gsx, gsy, gop_f]


def composite_tiles_bwd_plain(blob: torch.Tensor, entry_ids: torch.Tensor,
                              tile_ranges: torch.Tensor, fb: torch.Tensor,
                              ints: torch.Tensor, ct: torch.Tensor,
                              width: int, height: int, need_dist: bool = True,
                              need_med: bool = True,
                              init: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K2: per (splat, tile) entry, the 20 blob
    fields' gradients summed over the tile's 256 pixels, [M', 20] (entries
    no pixel reached stay zero). Vectorised over every tile's pixels, it
    walks entry positions in reverse from the longest walk bound; the
    per-pixel expressions are csrc/raster_bwd.cu's (the JAX backward
    kernel's, raster_pallas.py:608-711).

    fb/ints are K1's outputs, ct the cotangents of the first CT fb
    channels, all in image layout [C, H_pad, W_pad].

    Given the seed `init` [3, H_pad, W_pad] this is K4 (the JAX
    _make_bwd_kernel(with_init=True), raster_pallas.py:505-522, 558-757):
    fb/ints come from K3, ct carries CT_SEEDED channels (raw M1 and M2 as
    well), the distortion terms use A_n + (1 - T0), the moment cotangents
    add m dM1 + m^2 dM2 to dL/dw and (dM1 + 2 m dM2) w dm/dd to dL/dd, and
    it returns (rows, gi), gi [3, H_pad, W_pad] the seed's gradient."""
    tiles_x, tiles_y = tile_grid(width, height)
    n_tiles = tiles_x * tiles_y
    dev = blob.device
    rows_out = torch.zeros((entry_ids.shape[0], F), dtype=torch.float32, device=dev)
    seeded = init is not None

    def to_tiles(x):
        return _to_tiles(x, tiles_x, tiles_y)

    f = to_tiles(fb)
    A_n, T_final, M1_n, M2_n = f[4], f[10], f[11], f[12]
    n_contrib, med_e = to_tiles(ints)
    dC0, dC1, dC2, dD, dA, dN0, dN1, dN2, dMed, dDist, dT = to_tiles(ct)[:CT]
    A_eff = A_n
    if seeded:
        dM1, dM2 = to_tiles(ct)[CT:CT_SEEDED]
        T0, M1_0, M2_0 = to_tiles(init)
        A_eff = A_n + (1.0 - T0)
    starts = tile_ranges[:, 0].to(torch.int64)
    counts = (tile_ranges[:, 1] - tile_ranges[:, 0]).to(torch.int64)
    bound = torch.minimum(n_contrib.amax(dim=1).to(torch.int64), counts)
    t = torch.arange(n_tiles, device=dev)[:, None]
    p = torch.arange(TILE * TILE, device=dev)[None, :]
    px = ((t % tiles_x) * TILE + p % TILE).to(torch.float32)
    py = ((t // tiles_x) * TILE + p // TILE).to(torch.float32)

    T_cur = T_final
    S = torch.zeros_like(T_final)
    TdT = T_final * dT
    max_bound = int(bound.max()) if n_tiles else 0
    for e in range(max_bound - 1, -1, -1):
        walked = e < bound                               # [n_tiles]
        slot = torch.clamp(starts + e, 0, max(entry_ids.shape[0] - 1, 0))
        r = [c[:, None] for c in blob[entry_ids[slot].to(torch.int64)].unbind(1)]
        res = _geom_res(r, px, py)
        depth = res["depth"]
        alpha = torch.where(walked[:, None], res["alpha"], 0.0)

        contrib = (e < n_contrib) & (alpha > 0)
        is_med = med_e == e
        grad_any = (contrib | is_med) if need_med else contrib
        alpha_c = torch.where(contrib, alpha, 0.0)
        inv_oma = 1.0 / (1.0 - alpha_c)
        T_before = T_cur * inv_oma
        w = torch.where(contrib, alpha_c * T_before, 0.0)
        dsafe = torch.where(contrib, depth, 1.0)
        dLdw = (r[14] * dC0 + r[15] * dC1 + r[16] * dC2 + depth * dD + dA
                + r[17] * dN0 + r[18] * dN1 + r[19] * dN2)
        if need_dist or seeded:
            # one reciprocal of the depth for m and dm/dd, as the kernel
            # takes it; m rounds as mapped_depth(dsafe) does
            inv_d = 1.0 / dsafe
            m = torch.where(contrib, MAPPED_SCALE * (1.0 - inv_d * NEAR_PLANE), 0.0)
            dm_dd = (inv_d * inv_d) * FARNEAR
        if need_dist:
            dLdw = dLdw + (m * m * A_eff + M2_n - 2.0 * m * M1_n) * dDist
        if seeded:
            dLdw = dLdw + m * dM1 + m * m * dM2
        dLdalpha = torch.where(contrib, T_before * dLdw - (S + TdT) * inv_oma, 0.0)
        dLdd = w * dD
        if need_dist:
            dLdd = dLdd + dDist * 2.0 * w * (m * A_eff - M1_n) * dm_dd
        if seeded:
            dLdd = dLdd + (dM1 + 2.0 * m * dM2) * w * dm_dd
        if need_med:
            dLdd = dLdd + torch.where(is_med, dMed, 0.0)
        dLdd = torch.where(grad_any, dLdd, 0.0)

        fields = _geom_bwd(res, r[13], dLdalpha, dLdd)
        fields += [w * dC0, w * dC1, w * dC2, w * dN0, w * dN1, w * dN2]
        row = torch.stack([x.sum(dim=1) for x in fields], dim=1)   # [n_tiles, F]
        rows_out[slot[walked]] = row[walked]
        S = S + torch.where(contrib, w * dLdw, 0.0)
        T_cur = T_before
    if not seeded:
        return rows_out
    # the seed's gradient: every output is linear in T0 through its
    # w = T0 * (...) factors, so the w-routed part of dL/dT0 is S/T0; T0 is
    # 0 only for strata past a termination, where S and T_final are 0 too
    gT0 = (S + TdT) / torch.clamp_min(T0, 1e-12)
    gM1, gM2 = dM1, dM2
    if need_dist:
        gT0 = gT0 - dDist * (M2_n - M2_0)
        gM1 = gM1 - 2.0 * dDist * (M1_n - M1_0)
        gM2 = gM2 + dDist * A_n
    return rows_out, _to_image(torch.stack([gT0, gM1, gM2]), tiles_x, tiles_y)


def composite_tiles_bwd(blob: torch.Tensor, entry_ids: torch.Tensor,
                        tile_ranges: torch.Tensor, fb: torch.Tensor,
                        ints: torch.Tensor, ct: torch.Tensor, width: int,
                        height: int, need_dist: bool = True,
                        need_med: bool = True,
                        init: Optional[torch.Tensor] = None):
    """K2: per-entry gradient rows [M', 20] f32; or K4 given the seed
    `init`: (rows, gi [3, H_pad, W_pad]) with ct of CT_SEEDED channels (see
    composite_tiles_bwd_plain). CPU tensors take the plain version. CUDA
    tensors launch csrc/raster_bwd.cu (entry raster_bwd, or
    raster_bwd_seeded) on the current stream into rows zero-filled here,
    or raise."""
    if blob.device.type == "cpu":
        return composite_tiles_bwd_plain(blob, entry_ids, tile_ranges, fb, ints,
                                         ct, width, height, need_dist, need_med, init)
    if blob.device.type != "cuda":
        raise ValueError(f"composite_tiles_bwd runs on CPU or CUDA tensors, not {blob.device}")
    tiles_x, tiles_y = tile_grid(width, height)
    h_pad, w_pad = tiles_y * TILE, tiles_x * TILE
    n_ct = CT if init is None else CT_SEEDED
    kernels.check_tensors((("blob", blob, torch.float32, 2),
                           ("entry_ids", entry_ids, torch.int32, 1),
                           ("tile_ranges", tile_ranges, torch.int32, 2),
                           ("fb", fb, torch.float32, 3), ("ints", ints, torch.int32, 3),
                           ("ct", ct, torch.float32, 3))
                          + ((("init", init, torch.float32, 3),) if init is not None
                             else ()), blob.device)
    if (blob.shape[1] != F or tuple(tile_ranges.shape) != (tiles_x * tiles_y, 2)
            or tuple(fb.shape) != (CH, h_pad, w_pad)
            or tuple(ints.shape) != (2, h_pad, w_pad)
            or tuple(ct.shape) != (n_ct, h_pad, w_pad)
            or (init is not None and tuple(init.shape) != (3, h_pad, w_pad))):
        raise ValueError(f"shapes blob {tuple(blob.shape)}, tile_ranges "
                         f"{tuple(tile_ranges.shape)}, fb {tuple(fb.shape)}, ints "
                         f"{tuple(ints.shape)}, ct {tuple(ct.shape)} (needs {n_ct} "
                         f"channels) do not fit a {width}x{height} frame")
    if blob.data_ptr() % 16:
        raise ValueError("blob must start on a 16-byte boundary: raster_bwd stages "
                         "its rows with 16-byte copies")
    rows = torch.zeros((entry_ids.shape[0], F), dtype=torch.float32, device=blob.device)
    if init is None:
        kernels.launch("raster_bwd", blob.device, blob.data_ptr(), entry_ids.data_ptr(),
                       tile_ranges.data_ptr(), fb.data_ptr(), ints.data_ptr(), ct.data_ptr(),
                       tiles_x, tiles_y, int(need_dist), int(need_med), rows.data_ptr())
        count("raster_bwd", 1)
        return rows
    gi = torch.empty((3, h_pad, w_pad), dtype=torch.float32, device=blob.device)
    kernels.launch("raster_bwd_seeded", blob.device, blob.data_ptr(), entry_ids.data_ptr(),
                   tile_ranges.data_ptr(), fb.data_ptr(), ints.data_ptr(), ct.data_ptr(),
                   init.data_ptr(), tiles_x, tiles_y, int(need_dist), int(need_med),
                   rows.data_ptr(), gi.data_ptr())
    count("raster_bwd_seeded", 1)
    return rows, gi


def walk_limits(ints: torch.Tensor, tile_ranges: torch.Tensor) -> torch.Tensor:
    """[n_tiles] int32: each tile's start + min(the largest n_contrib of
    its 256 pixels, its entry count), the JAX compact route's window
    (raster_pallas.py::_grad_reduce). K2 and K4 write no row at or past it,
    so those rows are exact zeros."""
    h_pad, w_pad = ints.shape[1:]
    n_contrib = ints[0].reshape(h_pad // TILE, TILE, w_pad // TILE, TILE)
    walked = n_contrib.amax(dim=(1, 3)).reshape(-1)
    return torch.minimum(tile_ranges[:, 0] + walked, tile_ranges[:, 1])


def grad_reduce(rows: torch.Tensor, binned: Binned, ints: torch.Tensor) -> torch.Tensor:
    """Per-splat sums [N+1, F] of the per-entry gradient rows, the last
    (dummy) row zero (counterpart of the JAX _grad_reduce's compact route):
    K5 through `binned`'s work-slot map (inv_slots, slot_starts), reading
    only the rows below each tile's walk limit (walk_limits of the
    forward's `ints`); a skipped row is an exact zero and adds 0 in its
    place. Each splat's rows are added in entry order, so the sums are
    deterministic."""
    starts = binned.slot_starts
    return segsum.segment_sum_gathered(rows, binned.inv_slots, starts, starts.shape[0],
                                       binned.slot_tile,
                                       walk_limits(ints, binned.tile_ranges))


class RasterCore(torch.autograd.Function):
    """K1 forward, K2 + grad_reduce backward (the JAX _raster_core custom
    VJP) on binning's `binned`. Returns (fb, ints); only fb channels C0..2,
    D, A, N0..2, med, dist and T carry cotangents, M1, M2 and mt none, as
    in the JAX contract. need_dist/need_med pick a backward that leaves out
    the distortion and median terms (their cotangents must then be zero)."""

    @staticmethod
    def forward(ctx, blob, binned, width, height, need_dist, need_med):
        fb, ints = composite_tiles(blob, binned.conics, binned.entry_ids,
                                   binned.tile_ranges, width, height)
        ctx.save_for_backward(blob, fb, ints)
        ctx.binned = binned
        ctx.meta = (width, height, need_dist, need_med)
        ctx.mark_non_differentiable(ints)
        return fb, ints

    @staticmethod
    def backward(ctx, g_fb, g_ints):
        blob, fb, ints = ctx.saved_tensors
        b = ctx.binned
        width, height, need_dist, need_med = ctx.meta
        if g_fb is None:
            return (None,) * 6
        with span("backward.raster"):
            ct = g_fb[:CT].contiguous()
            rows = composite_tiles_bwd(blob, b.entry_ids, b.tile_ranges, fb, ints, ct,
                                       width, height, need_dist, need_med)
            g_blob = grad_reduce(rows, b, ints)
        return (g_blob,) + (None,) * 5


class RasterCoreSeeded(torch.autograd.Function):
    """K3 forward, K4 + grad_reduce backward (the JAX _raster_core_seeded
    custom VJP), for Gaussian-sharded rendering and training: gradients
    reach the blob and the per-pixel seed `init` [3, H_pad, W_pad] (T0,
    M1_0, M2_0), and fb channels C0..2, D, A, N0..2, med, dist, T, M1 and
    M2 carry cotangents (the raw T/M1/M2 feed the cross-stratum fold); mt
    carries none."""

    @staticmethod
    def forward(ctx, blob, init, binned, width, height, need_dist, need_med):
        fb, ints = composite_tiles(blob, binned.conics, binned.entry_ids,
                                   binned.tile_ranges, width, height, init=init)
        ctx.save_for_backward(blob, init, fb, ints)
        ctx.binned = binned
        ctx.meta = (width, height, need_dist, need_med)
        ctx.mark_non_differentiable(ints)
        return fb, ints

    @staticmethod
    def backward(ctx, g_fb, g_ints):
        blob, init, fb, ints = ctx.saved_tensors
        b = ctx.binned
        width, height, need_dist, need_med = ctx.meta
        if g_fb is None:
            return (None,) * 7
        ct = g_fb[:CT_SEEDED].contiguous()
        rows, gi = composite_tiles_bwd(blob, b.entry_ids, b.tile_ranges, fb, ints, ct,
                                       width, height, need_dist, need_med,
                                       init=init.contiguous())
        return (grad_reduce(rows, b, ints), gi) + (None,) * 5


def rasterize_tiled(prep: Preprocessed, means2d: torch.Tensor, bg: torch.Tensor,
                    width: int, height: int, need_dist_grad: bool = True,
                    need_med_grad: bool = True,
                    init_state: Optional[Dict[str, torch.Tensor]] = None,
                    return_raw: bool = False,
                    binned: Optional[Binned] = None,
                    blob: Optional[torch.Tensor] = None,
                    conics: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Tiled render: image [3,H,W], allmap [7,H,W] (expected depth, alpha,
    normal x3, median depth, distortion) and n_dropped, which is always 0
    because the binning never truncates. Differentiable through
    RasterCore; need_dist_grad/need_med_grad=False leave the distortion /
    median terms out of the backward (valid when the loss reads neither).

    `init_state` (flat [H*W] "T", and optionally "M1", "M2") seeds each
    pixel's walk, so a depth-contiguous stratum of a larger splat set
    composites against the global incoming state: the seeded core
    RasterCoreSeeded (K3/K4), differentiable in the splats and the seed,
    its raw T/M1/M2 outputs too. `return_raw=True` adds "raw": the flat
    per-pixel final state (premultiplied color/normal, depth, alpha,
    median, dist, T, M1, M2, and the detached min test transmittance
    min_test), as in the JAX package. Without init_state the raw M1/M2
    carry no gradient; pass an identity seed to differentiate them.
    `binned` = binning(prep, ...) lets a caller that composites the same
    prep twice bin it once; `blob` and `conics` (build_blob's and
    build_conics' rows of prep, means2d zero) are taken as they are, as the
    no-grad render's fused preprocess (render/preprocess_fused.py) gives
    them."""
    tiles_x, tiles_y = tile_grid(width, height)
    if blob is None:
        with span("render.preprocess"):
            blob = build_blob(prep, means2d, width, height)
    if binned is None:
        plan = wants_plan(blob, *(init_state or {}).values())
        with torch.no_grad(), span("render.binning"):
            binned = binning(prep, tiles_x, tiles_y, conics, plan)
    with span("render.composite"):
        if init_state is None:
            fb, _ = RasterCore.apply(blob, binned, width, height, need_dist_grad,
                                     need_med_grad)
        else:
            h_pad, w_pad = tiles_y * TILE, tiles_x * TILE

            def pad_map(x, fill):   # flat [H*W] -> [1, H_pad, W_pad]
                return torch.nn.functional.pad(x.reshape(1, height, width),
                                               (0, w_pad - width, 0, h_pad - height),
                                               value=fill)
            zeros = blob.new_zeros(height * width)
            init = torch.cat([pad_map(init_state["T"], 1.0),
                              pad_map(init_state.get("M1", zeros), 0.0),
                              pad_map(init_state.get("M2", zeros), 0.0)])
            fb, _ = RasterCoreSeeded.apply(blob, init.contiguous(), binned, width, height,
                                           need_dist_grad, need_med_grad)
        maps = fb[:, :height, :width]
        image = maps[0:3] + maps[10][None] * bg[:, None, None]
        allmap = maps[[3, 4, 5, 6, 7, 8, 9]]
        out = {"image": image, "allmap": allmap,
               "n_dropped": torch.zeros((), dtype=torch.int32, device=fb.device)}
        if return_raw:
            flat = maps.reshape(CH, height * width)
            out["raw"] = {"color": flat[0:3], "normal": flat[5:8], "depth": flat[3],
                          "alpha": flat[4], "median": flat[8], "dist": flat[9],
                          "T": flat[10], "M1": flat[11], "M2": flat[12],
                          "min_test": flat[13].detach()}
    return out
