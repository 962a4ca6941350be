"""The tile compositor's kernels (K1 raster_fwd, K2 raster_bwd, their
seeded variants K3 and K4, and K5 segsum) and the binning that feeds
them, without JAX, so the card-only cases also run where no JAX is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

On the CPU each wrapper takes its plain version and the card-only cases
skip; on a CUDA card they hold each kernel against its plain version."""
import numpy as np
import pytest
import torch

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.ops.sh import rgb2sh
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render import segsum
from gaussmart_tpu_torch.render.raster_common import (ALPHA_EPS, ALPHA_MAX,
                                                       NEAR_PLANE, Preprocessed,
                                                       preprocess)

torch.set_num_threads(1)

SCENES = {
    # name: (n, width, height, spread, scale, opacity or None = bimodal)
    "small": (30, 64, 32, 0.6, 0.15, 0.8),
    "overlap": (60, 64, 32, 0.15, 0.4, 0.95),
    "ragged": (400, 72, 40, 0.8, 0.08, None),
    "wide": (3000, 256, 144, 1.0, 0.05, None),
    # every tile holds 999-1420 entries and its pixels' n_contrib spreads
    # over 208-1014: many batches of the backward's walk, uneven per warp
    "deep": (1500, 64, 32, 0.4, 0.5, 0.08),
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
    ids, ranges, _ = rt.binning(prep, tx, ty)[:3]
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
    # the rect pairs the conic cut removed composite exactly zero; the
    # unused slots past the last tile hold the blob's zero row
    assert len(binned) <= int(ranges[-1, 1]) <= ids.shape[0]
    assert torch.all(ids[int(ranges[-1, 1]):] == prep.depth.shape[0])


def _warp_hits(blob, ids, ranges, width):
    """[M', 8] bool: whether entry slot i passes the compositor's alpha and
    near tests (its own expressions, _geom_res) at some pixel of each of
    raster_fwd's warps (rt.warp_pixels) in the slot's tile."""
    tiles_x = rt.tile_grid(width, 1)[0]
    used = int(ranges[-1, 1])
    tile = torch.repeat_interleave(torch.arange(ranges.shape[0]),
                                   (ranges[:, 1] - ranges[:, 0]).long())[:, None]
    p = torch.arange(rt.TILE * rt.TILE)[None, :]
    px = ((tile % tiles_x) * rt.TILE + p % rt.TILE).to(torch.float32)
    py = ((tile // tiles_x) * rt.TILE + p // rt.TILE).to(torch.float32)
    r = [c[:, None] for c in blob[ids[:used].long()].unbind(1)]
    hits = torch.zeros((ids.shape[0], 8), dtype=torch.bool)
    hits[:used] = (rt._geom_res(r, px, py)["alpha"] > 0)[:, rt.warp_pixels()].any(dim=2)
    return hits


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("scene", list(SCENES))
def test_band_cull_keeps_every_contributing_warp(scene, shifted):
    """band_mask_plain (the twin of raster_fwd.cu's band cull) clears a
    warp's bit of an entry only where the entry fails the alpha or near
    test at all 32 pixels of the warp, evaluated at every pixel; with a
    means2d shift of up to 2 pixels too, which moves the warp's block as it
    moves the walk's pixels. It clears some bits on every scene."""
    prep, width, height = _prep(scene)
    n = prep.depth.shape[0]
    means2d = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (n, 2)).astype(np.float32)
                           * (2.0 / np.array([width, height], np.float32))) \
        if shifted else torch.zeros(n, 2)
    blob = rt.build_blob(prep, means2d, width, height)
    ids, ranges, conics = rt.binning(prep, *rt.tile_grid(width, height))[:3]
    assert torch.equal(conics, rt.build_conics(prep))
    mask = rt.band_mask_plain(blob, conics, ids, ranges, width)
    hits = _warp_hits(blob, ids, ranges, width)
    used = int(ranges[-1, 1])
    assert mask.shape == (ids.shape[0], 8) and not mask[used:].any()
    assert hits.any() and not (hits & ~mask).any()
    assert (~mask[:used]).any()


def test_composite_tiles_on_cpu_is_the_plain_version():
    prep, width, height = _prep("ragged")
    blob, ids, ranges = _binned(prep, width, height)
    before = counter("raster_fwd")
    conics = rt.build_conics(prep)
    fb, ints = rt.composite_tiles(blob, conics, ids, ranges, width, height)
    assert counter("raster_fwd") == before
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    tx, ty = rt.tile_grid(width, height)
    assert fb.shape == (rt.CH, 16 * ty, 16 * tx) and ints.dtype == torch.int32
    assert conics.shape == (blob.shape[0], rt.FC) and not conics.requires_grad
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rt.composite_tiles(blob.to("meta"), conics, ids, ranges, width, height)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
def test_kernel_matches_plain_on_card(scene):
    """raster_fwd against composite_tiles_plain on the same binned lists:
    both round every operation the same way, and the band cull skips only
    entries that fail the alpha test at every pixel of a warp, so they
    agree to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_fwd runs only on the card")
    prep, width, height = _prep(scene, device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    conics = rt.build_conics(prep)
    before = counter("raster_fwd")
    fb, ints = rt.composite_tiles(blob, conics, ids, ranges, width, height)
    assert counter("raster_fwd") == before + 1
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    torch.cuda.synchronize()
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    with pytest.raises(ValueError, match="entry_ids"):
        rt.composite_tiles(blob, conics, ids.long(), ranges, width, height)
    with pytest.raises(ValueError, match="conics"):
        rt.composite_tiles(blob, conics[:, :5].contiguous(), ids, ranges, width, height)


def _random_cotangent(fb, seed=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(rt.CT,) + tuple(fb.shape[1:])).astype(np.float32),
                        device=fb.device)


def test_backward_and_segsum_on_cpu_are_the_plain_versions():
    prep, width, height = _prep("ragged")
    blob, ids, ranges = _binned(prep, width, height)
    fb, ints = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    ct = _random_cotangent(fb)
    before = (counter("raster_bwd"), counter("segsum"))
    rows = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height)
    assert torch.equal(rows, rt.composite_tiles_bwd_plain(blob, ids, ranges, fb, ints,
                                                          ct, width, height))
    seg, perm = torch.sort(ids, stable=True)
    out = segsum.segment_sum_sorted(rows[perm], seg, blob.shape[0])
    assert torch.equal(out, segsum.segment_sum_sorted_plain(rows[perm], seg, blob.shape[0]))
    b = rt.binning(prep, *rt.tile_grid(width, height))
    walk = (b.slot_tile, rt.walk_limits(ints, b.tile_ranges))
    out = segsum.segment_sum_gathered(rows, b.inv_slots, b.slot_starts, blob.shape[0], *walk)
    assert torch.equal(out, segsum.segment_sum_gathered_plain(
        rows, b.inv_slots, b.slot_starts, blob.shape[0], *walk))
    assert (counter("raster_bwd"), counter("segsum")) == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rt.composite_tiles_bwd(blob.to("meta"), ids, ranges, fb, ints, ct, width, height)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        segsum.segment_sum_sorted(rows.to("meta"), seg, blob.shape[0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        segsum.segment_sum_gathered(rows.to("meta"), b.inv_slots, b.slot_starts)


def _stratum(name, k=3, slots=4):
    """Depth stratum k of `slots` of a scene's splats, cut and padded with
    invalid zero rows as parallel/sharding.render_gaussian_sharded cuts
    them: (prep, width, height)."""
    prep, width, height = _prep(name)
    order = torch.argsort(torch.where(prep.valid, prep.depth, torch.inf), stable=True)
    per = -(-order.shape[0] // slots) + 3
    part = order[k * per:(k + 1) * per]
    return Preprocessed(*(torch.cat([x[part], x.new_zeros((per - part.shape[0],)
                                                          + x.shape[1:])])
                          for x in prep)), width, height


@pytest.mark.parametrize("scene", ["ragged", "deep", "stratum"])
def test_binning_plan_maps_each_splat_to_its_entries(scene):
    """binning's reduction plan: inv_slots[slot_starts[s]:slot_starts[s+1]]
    is exactly the ascending entry positions that hold splat s (splats with
    none, padding rows of a stratum included, get empty ranges),
    slot_starts[N] is the live pair count, inv_slots is a permutation of
    the entry buffer, and each slot's slot_tile is the tile whose range
    holds its entry."""
    prep, width, height = _stratum("ragged") if scene == "stratum" else _prep(scene)
    b = rt.binning(prep, *rt.tile_grid(width, height))
    n = prep.depth.shape[0]
    live = int(b.tile_ranges[-1, 1])
    assert b.slot_starts.shape == (n + 1,) and b.slot_starts.dtype == torch.int32
    assert int(b.slot_starts[0]) == 0 and int(b.slot_starts[n]) == live
    assert torch.equal(torch.sort(b.inv_slots.long())[0], torch.arange(b.entry_ids.shape[0]))
    for s in range(n):
        got = b.inv_slots[b.slot_starts[s]:b.slot_starts[s + 1]].long()
        assert torch.equal(got, torch.nonzero(b.entry_ids == s)[:, 0])
    pos = b.inv_slots[:live].long()
    tile = torch.searchsorted(b.tile_ranges[:, 1].contiguous(), pos.to(torch.int32),
                              right=True)
    assert torch.equal(b.slot_tile[:live].long(), tile)
    if scene == "stratum":
        assert (b.slot_starts[1:] == b.slot_starts[:-1]).any()


@pytest.mark.parametrize("scene", ["ragged", "deep"])
@pytest.mark.parametrize("seeded", [False, True])
def test_plain_backward_writes_no_row_past_the_walk_limit(scene, seeded):
    """Every row of plain K2 / K4 at or past its tile's walk limit
    (walk_limits: start + min(the tile's largest n_contrib, count)) is an
    exact zero, which is what lets the compact route skip it; on the deep
    scene the limit leaves many rows out."""
    case = _bwd_case(scene, seeded, "cpu")
    rows, _ = _bwd(case, (True, True), plain=True)
    ranges = case["ranges"]
    limit = rt.walk_limits(case["ints"], ranges)
    assert limit.dtype == torch.int32
    assert torch.all((ranges[:, 0] <= limit) & (limit <= ranges[:, 1]))
    pos = torch.arange(rows.shape[0])
    live = pos < int(ranges[-1, 1])
    tile = torch.searchsorted(ranges[:, 1].contiguous(), pos.to(torch.int32), right=True)
    past = live & (pos >= limit[tile.clamp(max=limit.shape[0] - 1)])
    assert torch.all(rows[past] == 0.0) and torch.all(rows[~live] == 0.0)
    assert torch.count_nonzero(rows[live & ~past]) > 0
    if scene == "deep":
        assert past.sum() > live.sum() // 4


def _slot_case(seed=0, n=40, max_len=9, n_tiles=7):
    """Random rows [M, 20], a permutation order, slot_starts with empty
    segments, slot_tile and tile_limit that skip about a third of the
    slots."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_len + 1, n)
    counts[[0, 5]] = 0
    w = int(counts.sum())
    rows = rng.standard_normal((w + 6, 20)).astype(np.float32)
    order = rng.permutation(w + 6)[:w].astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    slot_tile = rng.integers(0, n_tiles, w).astype(np.int32)
    tile_limit = rng.integers(0, w + 6, n_tiles).astype(np.int32)
    return [torch.tensor(a) for a in (rows, order, starts, slot_tile, tile_limit)]


def test_gathered_plain_adds_each_segment_in_slot_order():
    """segment_sum_gathered_plain against a float32 loop over each
    segment's slots in order from zero, to the bit: through a permutation,
    with the walk test (a skipped slot adds 0.0), without an order (slot k
    reads row k), and with rows past the segments in the output zero."""
    rows, order, starts, slot_tile, tile_limit = _slot_case()
    n = starts.shape[0] - 1
    for use_order, walk in ((True, False), (True, True), (False, False)):
        ref = np.zeros((n + 2, 20), np.float32)
        for s in range(n):
            for k in range(int(starts[s]), int(starts[s + 1])):
                r = int(order[k]) if use_order else k
                if not walk or r < int(tile_limit[slot_tile[k]]):
                    ref[s] = ref[s] + rows[r].numpy()
                else:
                    ref[s] = ref[s] + np.float32(0.0)
        got = segsum.segment_sum_gathered_plain(
            rows, order if use_order else None, starts, n + 2,
            *((slot_tile, tile_limit) if walk else (None, None)))
        assert np.array_equal(got.numpy(), ref)


def _column_err(got, ref):
    """max over columns of max|got - ref| / max|ref| in that column."""
    scale = ref.abs().amax(dim=0) + 1e-30
    return ((got - ref).abs().amax(dim=0) / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("need", [(True, True), (False, False)])
def test_backward_kernel_matches_plain_on_card(scene, need):
    """raster_bwd against composite_tiles_bwd_plain on the same forward
    outputs and a random cotangent. Per-pixel values round the same way;
    only the order of each entry's 256-pixel sum differs, so every column
    agrees within 1e-4 of its largest value (chip_smoke.py holds its
    frames to 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_bwd runs only on the card")
    prep, width, height = _prep(scene, device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    fb, ints = rt.composite_tiles(blob, rt.build_conics(prep), ids, ranges, width, height)
    ct = _random_cotangent(fb)
    before = counter("raster_bwd")
    rows = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height, *need)
    assert counter("raster_bwd") == before + 1
    ref = rt.composite_tiles_bwd_plain(blob, ids, ranges, fb, ints, ct, width, height,
                                       *need)
    torch.cuda.synchronize()
    assert _column_err(rows, ref) <= 1e-4
    with pytest.raises(ValueError, match="ct"):
        rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct[:3], width, height)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg,max_count", [(1, 3000), (1000, 9), (50_000, 30)])
def test_segsum_kernel_matches_plain_on_card(n_seg, max_count):
    """segsum against its plain version on a CPU copy (each segment's rows
    added in row order): per column within 1e-5 of the column's largest
    value (sums of up to 3000 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: segsum runs only on the card")
    rng = np.random.default_rng(n_seg)
    counts = rng.integers(0, max_count + 1, n_seg)
    ids = torch.tensor(np.repeat(np.arange(n_seg), counts), dtype=torch.int32,
                       device="cuda")
    rows = torch.tensor(rng.standard_normal((ids.shape[0], 20)).astype(np.float32),
                        device="cuda")
    before = counter("segsum")
    out = segsum.segment_sum_sorted(rows, ids, n_seg)
    assert counter("segsum") == before + 1
    ref = segsum.segment_sum_sorted_plain(rows.cpu(), ids.cpu(), n_seg)
    assert out.shape == (n_seg, 20) and _column_err(out.cpu(), ref) <= 1e-5
    with pytest.raises(ValueError, match="seg_ids"):
        segsum.segment_sum_sorted(rows, ids.long(), n_seg)


@pytest.mark.cuda
@pytest.mark.parametrize("walk", [False, True])
@pytest.mark.parametrize("seed,max_len", [(0, 9), (1, 75), (2, 400)])
def test_segsum_gathered_kernel_matches_plain_on_card(walk, seed, max_len):
    """segsum through a permutation `order`, with and without a walk test
    that skips slots, against segment_sum_gathered_plain on CPU copies:
    per column within 1e-5 of its largest value; the output rows past the
    segments are zero, and a second launch is bit-equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: segsum runs only on the card")
    case = _slot_case(seed, n=20_000 if max_len < 100 else 500, max_len=max_len,
                      n_tiles=300)
    rows, order, starts, slot_tile, tile_limit = (x.cuda() for x in case)
    walk_args = (slot_tile, tile_limit) if walk else (None, None)
    n = starts.shape[0] - 1
    before = counter("segsum")
    out = segsum.segment_sum_gathered(rows, order, starts, n + 3, *walk_args)
    again = segsum.segment_sum_gathered(rows, order, starts, n + 3, *walk_args)
    assert counter("segsum") == before + 2
    ref = segsum.segment_sum_gathered_plain(*case[:3], n + 3,
                                            *(case[3:] if walk else (None, None)))
    assert out.shape == (n + 3, 20) and _column_err(out.cpu(), ref) <= 1e-5
    assert torch.equal(out, again) and torch.all(out[n:] == 0.0)
    with pytest.raises(ValueError, match="tile_limit"):
        segsum.segment_sum_gathered(rows, order, starts, n, slot_tile, None)
    with pytest.raises(ValueError, match="16-byte"):
        segsum.segment_sum_gathered(torch.empty(rows.numel() + 1, device="cuda")[1:]
                                    .view_as(rows), order, starts)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["ragged", "wide", "deep"])
@pytest.mark.parametrize("seeded", [False, True])
def test_compact_and_segsum_agree_on_card(scene, seeded):
    """grad_reduce on K2 / K4's rows of a binned frame (K5 over the walked
    rows): one K5 launch a call, two calls bit-equal, within 1e-5 of each
    column's max against its plain route on CPU copies and against an
    index_add_ sum of the rows by entry id."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: segsum runs only on the card")
    case = _bwd_case(scene, seeded, "cuda")
    rows, _ = _bwd(case, (True, True))
    b = case["binned"]
    before = counter("segsum")
    out = rt.grad_reduce(rows, b, case["ints"])
    assert counter("segsum") == before + 1
    assert torch.equal(out, rt.grad_reduce(rows, b, case["ints"]))
    b_cpu = rt.Binned(*(x.cpu() for x in b))
    ref = rt.grad_reduce(rows.cpu(), b_cpu, case["ints"].cpu())
    assert _column_err(out.cpu(), ref) <= 1e-5
    assert _column_err(out.cpu(), _index_add_sums(rows.cpu(), b_cpu.entry_ids,
                                                  case["blob"].shape[0])) <= 1e-5


def _seed_maps(width, height, device, seed=3):
    """A per-pixel seed [3, H_pad, W_pad] (T0, M1_0, M2_0) as a nearer
    stratum leaves it, T0 = 0 on a band of terminated pixels, the identity
    (1, 0, 0) past the image's edge."""
    rng = np.random.default_rng(seed)
    tx, ty = rt.tile_grid(width, height)
    init = torch.zeros((3, 16 * ty, 16 * tx))
    init[0] = 1.0
    for c, (lo, hi) in enumerate(((0.3, 1.0), (0.0, 0.3), (0.0, 0.2))):
        init[c, :height, :width] = torch.tensor(
            rng.uniform(lo, hi, (height, width)).astype(np.float32))
    init[0, :height, :5] = 0.0
    return init.to(device)


def _seeded_cotangent(fb, seed=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(rt.CT_SEEDED,) + tuple(fb.shape[1:]))
                        .astype(np.float32), device=fb.device)


def test_seeded_compositor_on_cpu_is_the_plain_version():
    """K3 and K4 (composite_tiles / composite_tiles_bwd given a seed) on CPU
    tensors are their plain versions and launch nothing."""
    prep, width, height = _prep("ragged")
    blob, ids, ranges = _binned(prep, width, height)
    init = _seed_maps(width, height, "cpu")
    before = (counter("raster_fwd"), counter("raster_bwd"), counter("raster_fwd_seeded"), counter("raster_bwd_seeded"))
    fb, ints = rt.composite_tiles(blob, rt.build_conics(prep), ids, ranges, width, height,
                                  init=init)
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height, init=init)
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    ct = _seeded_cotangent(fb)
    rows, gi = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height,
                                      init=init)
    rows_p, gi_p = rt.composite_tiles_bwd_plain(blob, ids, ranges, fb, ints, ct, width,
                                                height, init=init)
    assert torch.equal(rows, rows_p) and torch.equal(gi, gi_p)
    assert gi.shape == init.shape
    assert (counter("raster_fwd"), counter("raster_bwd"), counter("raster_fwd_seeded"),
            counter("raster_bwd_seeded")) == before


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
def test_seeded_kernel_matches_plain_on_card(scene):
    """raster_fwd_seeded (K3) against composite_tiles_plain with the same
    seed, bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_fwd_seeded runs only on the card")
    prep, width, height = _prep(scene, device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    conics = rt.build_conics(prep)
    init = _seed_maps(width, height, "cuda")
    before = (counter("raster_fwd"), counter("raster_fwd_seeded"))
    fb, ints = rt.composite_tiles(blob, conics, ids, ranges, width, height, init=init)
    assert (counter("raster_fwd"), counter("raster_fwd_seeded")) == (before[0], before[1] + 1)
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height, init=init)
    torch.cuda.synchronize()
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    with pytest.raises(ValueError, match="init"):
        rt.composite_tiles(blob, conics, ids, ranges, width, height,
                           init=init[:2].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("need", [(True, True), (False, False)])
def test_seeded_backward_kernel_matches_plain_on_card(scene, need):
    """raster_bwd_seeded (K4) against composite_tiles_bwd_plain with the
    same seed and a random cotangent on the 13 channels: the rows and the
    seed gradient, each column within 1e-4 of its largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_bwd_seeded runs only on the card")
    prep, width, height = _prep(scene, device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    init = _seed_maps(width, height, "cuda")
    fb, ints = rt.composite_tiles(blob, rt.build_conics(prep), ids, ranges, width, height,
                                  init=init)
    ct = _seeded_cotangent(fb)
    before = (counter("raster_bwd"), counter("raster_bwd_seeded"))
    rows, gi = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height,
                                      *need, init=init)
    assert (counter("raster_bwd"), counter("raster_bwd_seeded")) == (before[0], before[1] + 1)
    ref, gi_p = rt.composite_tiles_bwd_plain(blob, ids, ranges, fb, ints, ct, width,
                                             height, *need, init=init)
    torch.cuda.synchronize()
    assert _column_err(rows, ref) <= 1e-4
    assert _column_err(gi.reshape(3, -1).T, gi_p.reshape(3, -1).T) <= 1e-4
    with pytest.raises(ValueError, match="ct"):
        rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct[:rt.CT].contiguous(),
                               width, height, *need, init=init)


@pytest.mark.cuda
def test_seeded_render_on_card_never_takes_the_plain_versions(monkeypatch):
    """rasterize_tiled(init_state=...) and its backward on CUDA tensors
    launch K3 and K4 once each; the plain versions are never reached."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the seeded kernels run only on the card")

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")
    monkeypatch.setattr(rt, "composite_tiles_plain", refuse)
    monkeypatch.setattr(rt, "composite_tiles_bwd_plain", refuse)
    prep, width, height = _prep("ragged", device="cuda")
    n = prep.depth.shape[0]
    P = width * height
    rng = np.random.default_rng(4)
    init = {k: torch.tensor(rng.uniform(lo, hi, P).astype(np.float32), device="cuda",
                            requires_grad=True)
            for k, lo, hi in (("T", 0.3, 1.0), ("M1", 0.0, 0.3), ("M2", 0.0, 0.2))}
    means2d = torch.zeros(n, 2, device="cuda", requires_grad=True)
    before = (counter("raster_fwd_seeded"), counter("raster_bwd_seeded"))
    out = rt.rasterize_tiled(prep, means2d, torch.zeros(3, device="cuda"), width, height,
                             init_state=init, return_raw=True)
    loss = (out["image"].sum() + out["allmap"].sum() + out["raw"]["T"].sum()
            + out["raw"]["M1"].sum() + out["raw"]["M2"].sum())
    loss.backward()
    torch.cuda.synchronize()
    assert (counter("raster_fwd_seeded"), counter("raster_bwd_seeded")) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(v.grad).all() for v in init.values())
    assert torch.isfinite(means2d.grad).all() and means2d.grad.abs().sum() > 0


def _bwd_case(scene, seeded, device):
    """A binned frame of `scene`, its forward outputs (K3's from a seed
    when `seeded`), and a random cotangent: composite_tiles_bwd's inputs,
    and the binning's reduction plan."""
    prep, width, height = _prep(scene, device=device)
    b = rt.binning(prep, *rt.tile_grid(width, height))
    blob = rt.build_blob(prep, torch.zeros(prep.depth.shape[0], 2, device=device), width,
                         height)
    init = _seed_maps(width, height, device) if seeded else None
    fb, ints = rt.composite_tiles(blob, b.conics, b.entry_ids, b.tile_ranges, width, height,
                                  init=init)
    ct = (_seeded_cotangent if seeded else _random_cotangent)(fb)
    return dict(blob=blob, ids=b.entry_ids, ranges=b.tile_ranges, fb=fb, ints=ints, ct=ct,
                width=width, height=height, init=init, binned=b)


def _index_add_sums(rows, entry_ids, n_rows):
    """The per-splat sums of `rows` by `entry_ids` through index_add_, the
    last (dummy) row zero: grad_reduce's result in another order of
    addition."""
    out = rows.new_zeros((n_rows, rows.shape[1]))
    out.index_add_(0, entry_ids.to(torch.int64), rows)
    out[-1] = 0.0
    return out


def _bwd(case, need, plain=False):
    """(rows, seed gradient or None) of K2 / K4, or of their plain version."""
    fn = rt.composite_tiles_bwd_plain if plain else rt.composite_tiles_bwd
    c = case
    out = fn(c["blob"], c["ids"], c["ranges"], c["fb"], c["ints"], c["ct"], c["width"],
             c["height"], *need, init=c["init"])
    return out if c["init"] is not None else (out, None)


def _hold_bwd(case, need):
    """The kernel against its plain version: rows and seed gradient, each
    column within 1e-4 of its largest value."""
    rows, gi = _bwd(case, need)
    ref, gi_p = _bwd(case, need, plain=True)
    torch.cuda.synchronize()
    assert _column_err(rows, ref) <= 1e-4
    if gi is not None:
        assert _column_err(gi.reshape(3, -1).T, gi_p.reshape(3, -1).T) <= 1e-4
    return rows, gi


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("need", [(True, True), (False, False)])
def test_backward_kernel_with_a_warp_that_ends_at_entry_0(seeded, need):
    """A tile whose lower rows (warps 4-7: pixel rows 8-15) contribute to no
    entry (n_contrib 0, no median) on the deep scene, where the other warps
    walk hundreds of entries: K2 / K4 against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_bwd runs only on the card")
    case = _bwd_case("deep", seeded, "cuda")
    ints = case["ints"].clone()
    ints[0, 8:16, 16:32] = 0
    ints[1, 8:16, 16:32] = -1
    case["ints"] = ints
    rows, _ = _hold_bwd(case, need)
    assert torch.count_nonzero(rows).item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("need", [(True, True), (False, False)])
def test_backward_kernel_zero_cotangent_gives_zero(seeded, need):
    """An all-zero cotangent gives exactly zero rows and seed gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_bwd runs only on the card")
    case = _bwd_case("deep", seeded, "cuda")
    case["ct"] = torch.zeros_like(case["ct"])
    rows, gi = _bwd(case, need)
    torch.cuda.synchronize()
    assert torch.all(rows == 0.0)
    assert gi is None or torch.all(gi == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["deep", "wide"])
@pytest.mark.parametrize("seeded", [False, True])
def test_backward_kernel_is_deterministic(scene, seeded):
    """Two launches on the same inputs give identical rows and seed
    gradient: each entry's sum over the tile's pixels has a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_bwd runs only on the card")
    case = _bwd_case(scene, seeded, "cuda")
    first = _hold_bwd(case, (True, True))
    second = _bwd(case, (True, True))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert first[1] is None or torch.equal(first[1], second[1])


def _with_counts(ids, ranges, count):
    """The tile lists cut to their first `count` entries (tile 0 to none),
    each tile's list kept in order: (entry_ids, tile_ranges)."""
    starts = ranges[:, 0].long()
    keep = torch.clamp(ranges[:, 1].long() - starts, max=count)
    keep[0] = 0
    new_ranges = torch.stack([torch.cumsum(keep, 0) - keep, torch.cumsum(keep, 0)], 1)
    pos = torch.cat([s + torch.arange(int(k), device=ids.device)
                     for s, k in zip(starts.tolist(), keep.tolist())])
    return ids[pos].contiguous(), new_ranges.to(torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("count", [31, 32, 33, 63, 64, 65])
@pytest.mark.parametrize("seeded", [False, True])
def test_forward_kernels_at_batch_edges(count, seeded):
    """K1 / K3 bit-equal to composite_tiles_plain where every tile of the
    deep scene holds exactly `count` entries and tile 0 none: batches of
    64, each read by the warps in two ballots of 32, so one short of, at
    and one past a ballot's and a batch's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_fwd runs only on the card")
    prep, width, height = _prep("deep", device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    ids, ranges = _with_counts(ids, ranges, count)
    assert sorted(set((ranges[:, 1] - ranges[:, 0]).tolist())) == [0, count]
    init = _seed_maps(width, height, "cuda") if seeded else None
    fb, ints = rt.composite_tiles(blob, rt.build_conics(prep), ids, ranges, width, height,
                                  init=init)
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height, init=init)
    torch.cuda.synchronize()
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    assert torch.all(ints[0, :16, :16] == 0) and torch.all(ints[1, :16, :16] == -1)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["deep", "wide"])
def test_seeded_kernel_with_every_pixel_terminated(scene):
    """A seed with T0 = 0 everywhere (a stratum behind terminated pixels):
    each pixel ends at its first considered entry with mt = 0 (2 where no
    entry reaches it) and takes no entry; K3 bit-equal to the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_fwd_seeded runs only on the card")
    prep, width, height = _prep(scene, device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    init = _seed_maps(width, height, "cuda")
    init[0] = 0.0
    fb, ints = rt.composite_tiles(blob, rt.build_conics(prep), ids, ranges, width, height,
                                  init=init)
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height, init=init)
    torch.cuda.synchronize()
    assert torch.equal(fb, fb_p) and torch.equal(ints, ints_p)
    mt = fb[rt.FB_CHANNELS.index("mt")]
    assert torch.all((mt == 0.0) | (mt == 2.0)) and (mt == 0.0).any()
    assert torch.all(ints[0] == 0) and torch.all(fb[rt.FB_CHANNELS.index("T")] == 0.0)


@pytest.mark.cuda
def test_forward_kernel_refuses_unaligned_rows():
    """raster_fwd stages blob and conic rows with 16-byte copies: a blob or
    conics that does not start on a 16-byte boundary raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: raster_fwd runs only on the card")
    prep, width, height = _prep("small", device="cuda")
    blob, ids, ranges = _binned(prep, width, height)
    conics = rt.build_conics(prep)

    def shifted(x):   # the same values, 4 bytes past an aligned start
        return torch.empty(x.numel() + 1, device=x.device)[1:].view_as(x).copy_(x)
    for b, c in ((shifted(blob), conics), (blob, shifted(conics))):
        with pytest.raises(ValueError, match="16-byte"):
            rt.composite_tiles(b, c, ids, ranges, width, height)
