"""Plain PyTorch 2DGS surfel rasterizer: the benchmark's reference for the
render forward and its gradient.

It follows the 2D Gaussian Splatting surfel model (Huang et al., SIGGRAPH
2024) with the conventions the system under test states for its tiled
path: the 3x3 splat->pixel transform T, the ray-splat intersection of two
planes, a screen-space low-pass of sigma^2 = 0.5 px taken where it is
tighter, alpha = min(o * exp(-rho / 2), 0.99) skipped below 1/255 and in
front of the near plane 0.2, front-to-back compositing that stops where
the transmittance after a splat would fall below 1e-4 (that splat left
out), SH degree 3 colour toward the camera, camera-facing normals, and a
splat composited only into the 16x16 tiles of its footprint rectangle.

It imports nothing of the program. Its own binning lists each splat in
every tile of that rectangle (no finer cull), sorted by the splat's view
depth. Tiles are composited in blocks, a chunk of entries at a time; the
gradient recomputes each block under autograd and pulls the cotangents of
its pixels back (a checkpointed backward), so the whole frame never holds
its (pixel, entry) intermediates at once.

`mm` is the matrix product every projection goes through: torch.matmul,
or a lower-precision stand-in for the control (reference/precision.py).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

NEAR_PLANE = 0.2
FILTER_INV_SQUARE = 2.0
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
TILE = 16
PIX = TILE * TILE
FWD_CHUNK = 32             # entries per step of the forward walk
CHUNK = 64                 # entries per step of the backward's recompute
BLOCK_ELEMS = 1 << 25      # (tile pixel, entry) pairs per block of the backward

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """Row-vector camera matrices (x_view = [x, 1] @ world_view)."""
    world_view: torch.Tensor    # [4,4]
    full_proj: torch.Tensor     # [4,4]
    center: torch.Tensor        # [3]
    width: int
    height: int


def quat_to_rotmat(q):
    ss = torch.sum(q * q, dim=-1, keepdim=True)
    q = q / torch.sqrt(torch.where(ss > 1e-12, ss, torch.ones_like(ss)))
    r, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def sh_colour(shs, dirs):
    """Degree-3 SH [N,16,3] evaluated at unit `dirs` [N,3], + 0.5, >= 0."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    basis = [torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
             SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
             SH_C2[3] * xz, SH_C2[4] * (xx - yy),
             SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
             SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
             SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
             SH_C3[6] * x * (xx - 3 * yy)]
    out = basis[0] * shs[:, 0]
    for k in range(1, 16):
        out = out + basis[k] * shs[:, k]
    return torch.clamp_min(out + 0.5, 0.0)


def _normalize(v):
    ss = torch.sum(v * v, dim=-1, keepdim=True)
    good = ss > 1e-12
    return torch.where(good, v / torch.sqrt(torch.where(good, ss, torch.ones_like(ss))),
                       torch.zeros_like(v))


def preprocess(xyz, scales, quats, opacity, shs, active, cam: Camera,
               mm: Callable = torch.matmul) -> Dict[str, torch.Tensor]:
    """Per-splat compositing inputs from activated parameters (scales
    exp'd, opacity sigmoid'd): T [N,9] (row-major), the projected centre,
    view depth and normal, colour, opacity (0 where culled), and the
    footprint half-extents rx, ry in pixels (0 = no tile)."""
    W, H = cam.width, cam.height
    N = xyz.shape[0]
    dev = xyz.device
    R = quat_to_rotmat(quats)
    axis_u = R[:, :, 0] * scales[:, 0:1]
    axis_v = R[:, :, 1] * scales[:, 1:2]
    normal_world = R[:, :, 2]
    zero = torch.zeros((N, 1), dtype=xyz.dtype, device=dev)
    one = torch.ones((N, 1), dtype=xyz.dtype, device=dev)
    Mh = torch.stack([torch.cat([axis_u, zero], 1), torch.cat([axis_v, zero], 1),
                      torch.cat([xyz, one], 1)], dim=1)                    # [N,3,4]
    ndc2pix = torch.tensor([[W / 2.0, 0.0, 0.0], [0.0, H / 2.0, 0.0], [0.0, 0.0, 0.0],
                            [(W - 1) / 2.0, (H - 1) / 2.0, 1.0]],
                           dtype=torch.float32, device=dev)
    T = mm(Mh, mm(cam.full_proj, ndc2pix))                                  # [N,3,3]
    wv = cam.world_view
    p_view = mm(xyz, wv[:3, :3]) + wv[3, :3]
    depth = p_view[:, 2]
    n_view = mm(normal_world, wv[:3, :3])
    facing = torch.sum(p_view * n_view, dim=-1)
    n_view = n_view * torch.where(facing < 0, 1.0, -1.0)[:, None]

    Tu, Tv, Tw = T[:, :, 0], T[:, :, 1], T[:, :, 2]
    dist = Tw[:, 0] ** 2 + Tw[:, 1] ** 2 - Tw[:, 2] ** 2
    sd = torch.where(torch.abs(dist) < 1e-12, 1.0, dist)
    cx = (Tu[:, 0] * Tw[:, 0] + Tu[:, 1] * Tw[:, 1] - Tu[:, 2] * Tw[:, 2]) / sd
    cy = (Tv[:, 0] * Tw[:, 0] + Tv[:, 1] * Tw[:, 1] - Tv[:, 2] * Tw[:, 2]) / sd
    su = (Tu[:, 0] ** 2 + Tu[:, 1] ** 2 - Tu[:, 2] ** 2) / sd
    sv = (Tv[:, 0] ** 2 + Tv[:, 1] ** 2 - Tv[:, 2] ** 2) / sd
    ext_x = torch.sqrt(torch.clamp_min(cx * cx - su, 1e-4))
    ext_y = torch.sqrt(torch.clamp_min(cy * cy - sv, 1e-4))
    radius = torch.ceil(3.0 * torch.maximum(ext_x, ext_y))
    on_screen = (cx + radius > 0) & (cx - radius < W) & (cy + radius > 0) & (cy - radius < H)
    valid = active & (depth > NEAR_PLANE) & (torch.abs(dist) >= 1e-12) & on_screen
    radius = torch.where(valid, radius, 0.0)

    # the footprint: where alpha = o exp(-rho/2) can reach 1/255, i.e. the
    # rho3d <= c level conic of the surfel and the rho2d <= c filter disc,
    # c = 2 ln(255 o), cut to the 3-sigma square
    c = 2.0 * torch.log(torch.clamp_min(opacity, 1e-12) / ALPHA_EPS)
    ic = 1.0 / torch.clamp_min(c, 1e-12)
    dc = Tw[:, 0] ** 2 + Tw[:, 1] ** 2 - Tw[:, 2] ** 2 * ic
    sdc = torch.where(torch.abs(dc) < 1e-12, 1.0, dc)
    cxc = (Tu[:, 0] * Tw[:, 0] + Tu[:, 1] * Tw[:, 1] - Tu[:, 2] * Tw[:, 2] * ic) / sdc
    cyc = (Tv[:, 0] * Tw[:, 0] + Tv[:, 1] * Tw[:, 1] - Tv[:, 2] * Tw[:, 2] * ic) / sdc
    suc = (Tu[:, 0] ** 2 + Tu[:, 1] ** 2 - Tu[:, 2] ** 2 * ic) / sdc
    svc = (Tv[:, 0] ** 2 + Tv[:, 1] ** 2 - Tv[:, 2] ** 2 * ic) / sdc
    ex2 = cxc * cxc - suc
    ey2 = cyc * cyc - svc
    good = (torch.abs(dc) >= 1e-12) & (dc * sd > 0) & (ex2 >= 0) & (ey2 >= 0)
    r2d = torch.sqrt(torch.clamp_min(c, 0.0) * 0.5)
    tx = torch.maximum(torch.abs(cxc - cx) + torch.sqrt(torch.clamp_min(ex2, 0.0)), r2d)
    ty = torch.maximum(torch.abs(cyc - cy) + torch.sqrt(torch.clamp_min(ey2, 0.0)), r2d)
    rx = torch.minimum(radius, torch.ceil(torch.where(good, tx, radius)))
    ry = torch.minimum(radius, torch.ceil(torch.where(good, ty, radius)))
    keep = valid & (c > 0.0)
    dirs = _normalize(xyz - cam.center[None, :])
    return dict(
        T=T.reshape(N, 9), center=torch.stack([cx, cy], dim=-1), depth=depth,
        normal=n_view, color=sh_colour(shs, dirs),
        opacity=opacity * valid.to(opacity.dtype), valid=valid,
        rx=torch.where(keep, rx, 0.0).detach(), ry=torch.where(keep, ry, 0.0).detach())


class Bins(NamedTuple):
    ids: torch.Tensor      # [M] splat per entry, sorted by (tile, depth)
    starts: torch.Tensor   # [tiles] first entry of each tile
    counts: torch.Tensor   # [tiles] entries of each tile
    tiles_x: int
    tiles_y: int


def bin_tiles(prep, width: int, height: int) -> Bins:
    """Every (splat, tile) pair of each splat's footprint rectangle, sorted
    by tile and then by view depth."""
    dev = prep["depth"].device
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    cx, cy = prep["center"][:, 0].detach(), prep["center"][:, 1].detach()
    rx, ry = prep["rx"], prep["ry"]
    x0 = torch.clamp(torch.floor((cx - rx) / TILE), 0, tiles_x).long()
    x1 = torch.clamp(torch.floor((cx + rx) / TILE) + 1, 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((cy - ry) / TILE), 0, tiles_y).long()
    y1 = torch.clamp(torch.floor((cy + ry) / TILE) + 1, 0, tiles_y).long()
    live = prep["valid"] & (rx > 0) & (ry > 0)
    nx = torch.where(live, x1 - x0, 0)
    ny = torch.where(live, y1 - y0, 0)
    n = nx * ny
    total = int(n.sum())
    sid = torch.repeat_interleave(torch.arange(n.shape[0], device=dev), n,
                                  output_size=total)
    local = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[sid]
    tile = (y0[sid] + local // nx[sid]) * tiles_x + x0[sid] + local % nx[sid]
    depth_bits = prep["depth"].detach().contiguous().view(torch.int32).long()
    order = torch.sort(tile * (1 << 32) + depth_bits[sid], stable=True).indices
    counts = torch.bincount(tile, minlength=tiles_x * tiles_y)
    return Bins(ids=sid[order], starts=torch.cumsum(counts, 0) - counts,
                counts=counts, tiles_x=tiles_x, tiles_y=tiles_y)


FIELDS = ("T", "center", "opacity", "color", "normal")


def _pixels(tiles, tiles_x, dev):
    """[B,256] pixel x and y of the listed tiles."""
    off = torch.arange(PIX, device=dev)
    px = (tiles % tiles_x)[:, None] * TILE + off % TILE
    py = (tiles // tiles_x)[:, None] * TILE + off // TILE
    return px.float(), py.float()


def _walk(carry, g, valid, px, py):
    """Composite entries g [B,K,...] (valid [B,K]) into the carry of B tiles'
    pixels, front to back."""
    T9 = g["T"]
    Tu, Tv, Tw = (T9[:, :, j::3][:, :, :, None] for j in range(3))   # [B,K,3,1]
    pxe, pye = px[:, None, :], py[:, None, :]                           # [B,1,256]
    kx, ky, kz = pxe * Tw[:, :, 0] - Tu[:, :, 0], pxe * Tw[:, :, 1] - Tu[:, :, 1], \
        pxe * Tw[:, :, 2] - Tu[:, :, 2]
    lx, ly, lz = pye * Tw[:, :, 0] - Tv[:, :, 0], pye * Tw[:, :, 1] - Tv[:, :, 1], \
        pye * Tw[:, :, 2] - Tv[:, :, 2]
    p_x = ky * lz - kz * ly
    p_y = kz * lx - kx * lz
    p_z = kx * ly - ky * lx
    degenerate = torch.abs(p_z) < 1e-12
    inv = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, p_z))
    su, sv = p_x * inv, p_y * inv
    rho3d = torch.where(degenerate, torch.inf, su * su + sv * sv)
    depth3d = su * Tw[:, :, 0] + sv * Tw[:, :, 1] + Tw[:, :, 2]
    dx = g["center"][:, :, 0:1] - pxe
    dy = g["center"][:, :, 1:2] - pye
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)
    use3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    depth = torch.where(use3d, depth3d, Tw[:, :, 2])
    alpha = torch.clamp_max(g["opacity"][:, :, None] * torch.exp(-0.5 * rho), ALPHA_MAX)
    alpha = torch.where((alpha >= ALPHA_EPS) & (depth >= NEAR_PLANE) & valid[:, :, None],
                        alpha, 0.0)                                     # [B,K,256]
    one_minus = 1.0 - alpha
    T_before = carry["T"][:, None, :] * torch.cat(
        [torch.ones_like(one_minus[:, :1]), torch.cumprod(one_minus, dim=1)[:, :-1]], dim=1)
    test_T = T_before * one_minus
    bad = ((test_T < T_EPS) & (alpha > 0)) | carry["done"][:, None, :]
    excluded = torch.cumsum(bad.to(torch.int32), dim=1) >= 1
    w = torch.where(excluded, 0.0, alpha * T_before)
    dsafe = torch.where(w > 0, depth, 1.0)
    any_bad = torch.any(bad, dim=1)
    first = torch.argmax(bad.to(torch.int8), dim=1)
    T_cut = torch.gather(T_before, 1, first[:, None, :])[:, 0]
    T_full = carry["T"] * torch.prod(one_minus, dim=1)
    K = alpha.shape[1]
    seen = torch.where(any_bad, first + 1, K)
    return {
        "T": torch.where(any_bad, T_cut, T_full),
        "done": carry["done"] | any_bad,
        "color": carry["color"] + torch.sum(w[:, :, None] * g["color"][:, :, :, None], dim=1),
        "normal": carry["normal"] + torch.sum(w[:, :, None] * g["normal"][:, :, :, None], dim=1),
        "depth": carry["depth"] + torch.sum(w * dsafe, dim=1),
        "alpha": carry["alpha"] + torch.sum(w, dim=1),
        "seen": carry["seen"] + torch.where(carry["done"], 0, seen),
        "blends": carry["blends"] + torch.sum(w > 0, dim=1),
    }


def _gather(fields, bins: Bins, tiles, k0, k1):
    """Entries [k0, k1) of each listed tile: gathered fields [B,K,...] and
    the mask of entries that exist."""
    k = torch.arange(k0, k1, device=tiles.device)
    valid = k[None, :] < bins.counts[tiles][:, None]
    pos = torch.where(valid, bins.starts[tiles][:, None] + k[None, :], 0)
    sid = torch.where(valid, bins.ids[pos], 0)
    return {f: fields[f][sid] for f in FIELDS}, valid, sid


def _init_carry(B, dev):
    z = torch.zeros((B, PIX), dtype=torch.float32, device=dev)
    return {"T": z + 1.0, "done": torch.zeros((B, PIX), dtype=torch.bool, device=dev),
            "color": torch.zeros((B, 3, PIX), dtype=torch.float32, device=dev),
            "normal": torch.zeros((B, 3, PIX), dtype=torch.float32, device=dev),
            "depth": z.clone(), "alpha": z.clone(),
            "seen": torch.zeros((B, PIX), dtype=torch.int64, device=dev),
            "blends": torch.zeros((B, PIX), dtype=torch.int64, device=dev)}


def _blocks(tiles, lengths, elems):
    """Consecutive runs of `tiles` (sorted by `lengths`, longest first) of at
    most `elems` (pixel, entry) pairs each: [(tiles, K)]."""
    order = torch.argsort(lengths, descending=True)
    tiles, lengths = tiles[order].tolist(), lengths[order].tolist()
    out, i = [], 0
    while i < len(tiles):
        K = max(lengths[i], 1)
        B = max(1, min(len(tiles) - i, elems // (PIX * K)))
        out.append((tiles[i:i + B], K))
        i += B
    return out


def _composite_forward(fields, bins: Bins, width, height):
    """The frame's planes [8,H,W] (colour 3, depth, alpha, normal 3), each
    tile's entries walked until every pixel stopped [tiles], and the blend
    count of pixels inside the image. All tiles walk together, a chunk of
    entries at a time; a tile leaves the walk when its entries are spent or
    every pixel of it has stopped."""
    dev = fields["T"].device
    n_tiles = bins.tiles_x * bins.tiles_y
    tiles = torch.argsort(bins.counts, descending=True, stable=True)
    tiles = tiles[:int((bins.counts > 0).sum())]
    carry = _init_carry(len(tiles), dev)
    px, py = _pixels(tiles, bins.tiles_x, dev)
    counts = bins.counts[tiles]
    live = torch.arange(len(tiles), device=dev)
    K = int(counts[0]) if len(tiles) else 0
    for step, k0 in enumerate(range(0, K, FWD_CHUNK)):
        if step % 8 == 7:
            live = live[~carry["done"][live].all(dim=1)]
        live = live[counts[live] > k0]
        if len(live) == 0:
            break
        g, valid, _ = _gather(fields, bins, tiles[live], k0, min(K, k0 + FWD_CHUNK))
        part = _walk({k: v[live] for k, v in carry.items()}, g, valid, px[live], py[live])
        for k, v in part.items():
            carry[k][live] = v
    inside = (px < width) & (py < height)
    planes = torch.zeros((n_tiles, 8, PIX), dtype=torch.float32, device=dev)
    walked = torch.zeros(n_tiles, dtype=torch.int64, device=dev)
    planes[tiles] = torch.cat([carry["color"], carry["depth"][:, None],
                               carry["alpha"][:, None], carry["normal"]], dim=1)
    walked[tiles] = torch.max(torch.where(inside, carry["seen"], 0), dim=1).values
    blends = torch.sum(torch.where(inside, carry["blends"], 0))
    return _to_image(planes, bins, width, height), walked, blends


def _to_image(planes, bins, width, height):
    """[tiles,C,256] -> [C,H,W]."""
    C = planes.shape[1]
    img = planes.reshape(bins.tiles_y, bins.tiles_x, C, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(C, bins.tiles_y * TILE, bins.tiles_x * TILE)
    return img[:, :height, :width]


def _from_image(img, bins):
    """[C,H,W] -> [tiles,C,256], zero past the image."""
    C, H, W = img.shape
    full = torch.zeros((C, bins.tiles_y * TILE, bins.tiles_x * TILE),
                       dtype=img.dtype, device=img.device)
    full[:, :H, :W] = img
    full = full.reshape(C, bins.tiles_y, TILE, bins.tiles_x, TILE)
    return full.permute(1, 3, 0, 2, 4).reshape(bins.tiles_y * bins.tiles_x, C, PIX)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, T, center, opacity, color, normal, bins, width, height, stats):
        fields = dict(T=T, center=center, opacity=opacity, color=color, normal=normal)
        with torch.no_grad():
            image, walked, blends = _composite_forward(fields, bins, width, height)
        ctx.save_for_backward(T, center, opacity, color, normal)
        ctx.bins, ctx.walked, ctx.shape = bins, walked, (width, height)
        stats.update(blends=blends, pairs=len(bins.ids), max_tile=int(bins.counts.max()),
                     walked=int(walked.sum()))
        return image

    @staticmethod
    def backward(ctx, cot):
        T, center, opacity, color, normal = ctx.saved_tensors
        fields = dict(T=T, center=center, opacity=opacity, color=color, normal=normal)
        bins = ctx.bins
        dev = T.device
        grads = {f: torch.zeros_like(v) for f, v in fields.items()}
        cot_t = _from_image(cot.contiguous(), bins)
        busy = torch.nonzero(ctx.walked > 0).flatten()
        for tiles_l, K in _blocks(busy, ctx.walked[busy], BLOCK_ELEMS):
            tiles = torch.tensor(tiles_l, device=dev)
            px, py = _pixels(tiles, bins.tiles_x, dev)
            g, valid, sid = _gather(fields, bins, tiles, 0, K)
            g = {f: v.detach().requires_grad_() for f, v in g.items()}
            with torch.enable_grad():
                carry = _init_carry(len(tiles_l), dev)
                for k0 in range(0, K, CHUNK):
                    part = {f: v[:, k0:k0 + CHUNK] for f, v in g.items()}
                    carry = _walk(carry, part, valid[:, k0:k0 + CHUNK], px, py)
                out = torch.cat([carry["color"], carry["depth"][:, None],
                                 carry["alpha"][:, None], carry["normal"]], dim=1)
                dg = torch.autograd.grad(out, [g[f] for f in FIELDS], cot_t[tiles])
            flat = sid.reshape(-1)
            for f, d in zip(FIELDS, dg):
                grads[f].index_add_(0, flat, d.reshape((flat.shape[0],) + d.shape[2:]))
        return (grads["T"], grads["center"], grads["opacity"], grads["color"],
                grads["normal"], None, None, None, None)


def composite(prep, width: int, height: int, stats=None):
    """[8,H,W] planes of the frame (colour 3, weighted depth, alpha,
    view-space normal 3), differentiable in prep's T, centre, opacity,
    colour and normal. `stats["blends"]` receives the frame's blend count:
    the (pixel, splat) pairs with alpha >= 1/255 composited before the
    pixel's transmittance stops."""
    bins = bin_tiles(prep, width, height)
    return _Composite.apply(prep["T"], prep["center"], prep["opacity"], prep["color"],
                            prep["normal"], bins, width, height,
                            {} if stats is None else stats)


def activated(params, active):
    """Raw parameters as the optimiser holds them (log-scales, opacity
    logits, DC and higher SH bands apart) -> the rasterizer's inputs."""
    return dict(xyz=params["xyz"], scales=torch.exp(params["scaling"]),
                quats=params["rotation"], opacity=torch.sigmoid(params["opacity"][:, 0]),
                shs=torch.cat([params["features_dc"], params["features_rest"]], 1),
                active=active)


def render(params, cam: Camera, mm: Callable = torch.matmul, stats=None):
    """The render package of activated-splat `params` (xyz, scales, quats,
    opacity, shs, active): render [3,H,W] over a black background,
    rend_alpha [1,H,W], rend_normal [3,H,W] (world), surf_depth [1,H,W]
    (the expected depth) and surf_normal [3,H,W]."""
    prep = preprocess(params["xyz"], params["scales"], params["quats"], params["opacity"],
                      params["shs"], params["active"], cam, mm)
    planes = composite(prep, cam.width, cam.height, stats)
    image, depth, alpha, normal = planes[0:3], planes[3:4], planes[4:5], planes[5:8]
    rend_normal = torch.einsum("chw,dc->dhw", normal, cam.world_view[:3, :3])
    has = alpha > 1e-12
    surf_depth = torch.where(has, depth / torch.where(has, alpha, 1.0), 0.0)
    surf_normal = depth_normal(cam, surf_depth, mm) * alpha.detach()
    return dict(render=image, rend_alpha=alpha, rend_normal=rend_normal,
                surf_depth=surf_depth, surf_normal=surf_normal)


def depth_normal(cam: Camera, depth, mm: Callable = torch.matmul):
    """[1,H,W] depth -> [3,H,W] world normals of the unprojected points by
    central differences (zero at the border)."""
    W, H = cam.width, cam.height
    dev = depth.device
    c2w = torch.linalg.inv(cam.world_view.T)
    ndc2pix = torch.tensor([[W / 2.0, 0.0, 0.0, W / 2.0], [0.0, H / 2.0, 0.0, H / 2.0],
                            [0.0, 0.0, 0.0, 1.0]], dtype=torch.float32, device=dev).T
    intrins = mm(mm(c2w.T, cam.full_proj), ndc2pix)[:3, :3].T
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    rays = mm(mm(pix, torch.linalg.inv(intrins).T), c2w[:3, :3].T)
    pts = (depth.reshape(-1, 1) * rays + c2w[:3, 3]).reshape(H, W, 3)
    dx = pts[2:, 1:-1] - pts[:-2, 1:-1]
    dy = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = _normalize(torch.linalg.cross(dx, dy, dim=-1))
    out = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    out[1:-1, 1:-1] = n
    return out.permute(2, 0, 1)


def camera_matrices(R, t, fovx, fovy, width, height, device, znear=0.01, zfar=100.0):
    """A Camera from a camera-to-world rotation R and a world-to-camera
    translation t (COLMAP's convention), built in float64 and stored in
    float32."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    wv = Rt.T
    th, tw = math.tan(fovy / 2), math.tan(fovx / 2)
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / tw
    P[1, 1] = 1.0 / th
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    wv32 = wv.astype(np.float32)
    full = (wv32 @ P.T.astype(np.float32)).astype(np.float32)
    center = np.linalg.inv(wv32)[3, :3].astype(np.float32)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Camera(world_view=t32(wv32), full_proj=t32(full), center=t32(center),
                  width=int(width), height=int(height))
