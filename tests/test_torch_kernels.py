"""The forward compositor K1 (raster_fwd) and the binning that feeds it,
without JAX, so the card-only cases also run where no JAX is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU the wrapper takes the plain version and the card-only cases
skip; on a CUDA card they hold raster_fwd against composite_tiles_plain."""
import numpy as np
import pytest
import torch

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.ops.sh import rgb2sh
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.raster_common import (ALPHA_EPS, ALPHA_MAX,
                                                       NEAR_PLANE, preprocess)

torch.set_num_threads(1)

SCENES = {
    # name: (n, width, height, spread, scale, opacity or None = bimodal)
    "small": (30, 64, 32, 0.6, 0.15, 0.8),
    "overlap": (60, 64, 32, 0.15, 0.4, 0.95),
    "ragged": (400, 72, 40, 0.8, 0.08, None),
    "wide": (3000, 256, 144, 1.0, 0.05, None),
}


def _prep(name, device="cpu", seed=0):
    n, width, height, spread, scale, opacity = SCENES[name]
    rng = np.random.default_rng(seed)
    cam = Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.8 * height / width, width=width, height=height)
    xyz = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n),
                    rng.uniform(2.0, 4.0, n)], axis=1)
    scales = scale * rng.uniform(0.5, 1.5, (n, 2))
    op = (np.full(n, opacity) if opacity is not None else
          np.where(rng.random(n) < 0.6, rng.uniform(0.7, 0.99, n),
                   rng.uniform(0.05, 0.3, n)))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    prep = preprocess(t(xyz), t(scales), t(rng.normal(size=(n, 4))), t(op),
                      t(rgb2sh(rng.random((n, 1, 3)))),
                      torch.ones(n, dtype=torch.bool, device=device),
                      cam.params(device), sh_degree=0)
    return prep, width, height


def _binned(prep, width, height):
    tx, ty = rt.tile_grid(width, height)
    n = prep.depth.shape[0]
    blob = rt.build_blob(prep, torch.zeros(n, 2, device=prep.depth.device),
                         width, height)
    ids, ranges = rt.binning(prep, tx, ty)
    return blob, ids, ranges


def _contributing_pairs(prep, width, height):
    """(splat, tile) pairs where the splat's alpha passes the compositor's
    skip tests at some pixel of the tile inside its footprint rect,
    evaluated densely over every (splat, pixel)."""
    T = prep.T.reshape(-1, 9)
    Tu, Tv, Tw = T[:, 0::3], T[:, 1::3], T[:, 2::3]
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32), indexing="ij")
    px, py = xs.reshape(1, -1), ys.reshape(1, -1)
    k = [px * Tw[:, i:i + 1] - Tu[:, i:i + 1] for i in range(3)]
    l = [py * Tw[:, i:i + 1] - Tv[:, i:i + 1] for i in range(3)]
    p_x = k[1] * l[2] - k[2] * l[1]
    p_y = k[2] * l[0] - k[0] * l[2]
    p_z = k[0] * l[1] - k[1] * l[0]
    deg = p_z.abs() < 1e-12
    inv = torch.where(deg, 0.0, 1.0 / torch.where(deg, 1.0, p_z))
    u, v = p_x * inv, p_y * inv
    rho3d = torch.where(deg, torch.inf, u * u + v * v)
    depth3d = u * Tw[:, 0:1] + v * Tw[:, 1:2] + Tw[:, 2:3]
    cx, cy = prep.center2d[:, 0:1], prep.center2d[:, 1:2]
    rho2d = 2.0 * ((cx - px) ** 2 + (cy - py) ** 2)
    depth = torch.where(rho3d <= rho2d, depth3d, Tw[:, 2:3])
    alpha = torch.clamp_max(prep.opacity[:, None] * torch.exp(
        -0.5 * torch.minimum(rho3d, rho2d)), ALPHA_MAX)
    rx, ry = prep.rx[:, None], prep.ry[:, None]
    tpx, tpy = torch.floor(px / 16), torch.floor(py / 16)
    in_rect = ((rx > 0) & (ry > 0)
               & (tpx >= torch.floor((cx - rx) / 16)) & (tpx <= torch.floor((cx + rx) / 16))
               & (tpy >= torch.floor((cy - ry) / 16)) & (tpy <= torch.floor((cy + ry) / 16)))
    live = (alpha >= ALPHA_EPS) & (depth >= NEAR_PLANE) & in_rect
    tile = (tpy * rt.tile_grid(width, height)[0] + tpx).to(torch.int64)
    s, p = torch.nonzero(live, as_tuple=True)
    return set(zip(s.tolist(), tile[0, p].tolist()))


@pytest.mark.parametrize("scene", ["small", "overlap", "ragged"])
def test_binning_keeps_every_contributing_pair(scene):
    prep, width, height = _prep(scene)
    _, ids, ranges = _binned(prep, width, height)
    binned = set()
    for t, (s, e) in enumerate(ranges.tolist()):
        binned |= {(int(i), t) for i in ids[s:e]}
    wanted = _contributing_pairs(prep, width, height)
    assert wanted and wanted <= binned
    # the rect pairs the conic cut removed composite exactly zero
    assert len(binned) <= int(ranges[-1, 1]) <= ids.shape[0]


def test_composite_tiles_on_cpu_is_the_plain_version():
    prep, width, height = _prep("ragged")
    blob, ids, ranges = _binned(prep, width, height)
    before = rt.launches
    fb, ints = rt.composite_tiles(blob, ids, ranges, width, height)
    assert rt.launches == before
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    tx, ty = rt.tile_grid(width, height)
    assert fb.shape == (rt.CH, 16 * ty, 16 * tx) and ints.dtype == torch.int32
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rt.composite_tiles(blob.to("meta"), ids, ranges, width, height)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
def test_kernel_matches_plain_on_card(scene):
    """raster_fwd against composite_tiles_plain on the same binned lists.
    Both round every operation the same way, so they agree to the bit in
    practice; the limits are chip_smoke.py's (1e-4 on every float channel,
    99.9% of pixels for n_contrib and med_e)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_fwd runs only on the card")
    prep, width, height = _prep(scene, device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    before = rt.launches
    fb, ints = rt.composite_tiles(blob, ids, ranges, width, height)
    assert rt.launches == before + 1
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    torch.cuda.synchronize()
    assert (fb - fb_p).abs().max().item() <= 1e-4
    assert (ints == ints_p).float().mean().item() >= 0.999
    with pytest.raises(ValueError, match="entry_ids"):
        rt.composite_tiles(blob, ids.long(), ranges, width, height)
