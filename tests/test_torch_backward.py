"""The port's backward compositor K2 (its plain version here; the CUDA
kernel on the card) and the per-splat reduction K5, against autograd of
the port's own forward, the JAX package's tiled backward (interpret mode)
and dense autodiff, and JAX segment_sum_sorted (interpret mode)."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu.render import raster_common as jrc
from gaussmart_tpu.render.raster_dense import rasterize_pixels as j_dense
from gaussmart_tpu.render.raster_pallas import rasterize_tiled as j_tiled
from gaussmart_tpu.render.segsum_pallas import ID_LANE, segment_sum_sorted as j_segsum
from gaussmart_tpu_torch.cameras import Camera as TCamera
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.render import raster_common as trc
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render import segsum

from test_raster import make_camera, make_scene
from test_torch_kernels import _binned, _bwd, _bwd_case, _index_add_sums, _prep

torch.set_num_threads(1)


def _list_plan(ids, ranges, n_rows):
    """The Binned of hand-made tile lists (every entry in a range): the
    work-slot map binning writes, each splat's entries in entry order."""
    seg, perm = torch.sort(ids, stable=True)
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    tile = torch.repeat_interleave(torch.arange(ranges.shape[0]), counts)
    return rt.Binned(ids, ranges, None, perm.to(torch.int32),
                     segsum.sorted_slot_starts(seg, n_rows - 1), tile[perm].to(torch.int32))


def _autograd_rows_check(blob, binned, width, height, seed=1):
    """grad_blob from the plain K2 + reduction through `binned`'s plan
    against autograd through composite_tiles_plain, for a random cotangent
    on the 11 channels that carry one (zero on the padded pixels past the
    image edge)."""
    ids, ranges = binned.entry_ids, binned.tile_ranges
    blob = blob.detach().clone().requires_grad_(True)
    fb, ints = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    ct = torch.zeros((rt.CT,) + fb.shape[1:])
    rng = np.random.default_rng(seed)
    ct[:, :height, :width] = torch.tensor(
        rng.normal(size=(rt.CT, height, width)).astype(np.float32))
    (fb[:rt.CT] * ct).sum().backward()
    ref = blob.grad.clone()
    ref[-1] = 0.0
    before = counter("raster_bwd")
    rows = rt.composite_tiles_bwd(blob.detach(), ids, ranges, fb.detach(), ints, ct,
                                  width, height)
    assert counter("raster_bwd") == before          # CPU tensors never launch K2
    assert rows.shape == (ids.shape[0], rt.F)
    got = rt.grad_reduce(rows, binned, ints)
    # the same per-pixel chain rule in another association order: float32
    # noise relative to each column's scale (measured <= 2.5e-6)
    scale = ref.abs().amax(dim=0, keepdim=True) + 1e-30
    assert ((got - ref).abs() / scale).max().item() <= 2e-5
    return rows, fb, ints


@pytest.mark.parametrize("scene", ["small", "overlap", "ragged", "deep"])
def test_plain_k2_matches_autograd_of_plain_forward(scene):
    prep, width, height = _prep(scene)
    blob, _, _ = _binned(prep, width, height)
    _autograd_rows_check(blob, rt.binning(prep, *rt.tile_grid(width, height)), width, height)


def test_empty_short_and_unwalked_tiles():
    """Tiles holding 0, 1, 3 and 70 entries, a tile whose entries reach no
    pixel (walk bound 0) and a tile cut by the image edge (40x24 frame, 3x2
    tiles): the plain K2 still matches autograd, rows past each tile's
    walk bound stay zero and the padded pixels add nothing."""
    prep, _, _ = _prep("overlap")
    width, height = 40, 24
    blob, ids, _ = _binned(prep, 64, 32)
    n = prep.depth.shape[0]
    order = torch.argsort(prep.depth).to(torch.int32)
    faint = blob[:2].clone()
    faint[:, 13] = 1e-3                         # opacity below ALPHA_EPS
    blob = torch.cat([blob[:-1], faint, blob[-1:]])
    lists = [order[:0], order[:1], order[5:8], order[:70],
             torch.tensor([n, n + 1, n], dtype=torch.int32), order[10:14]]
    ids = torch.cat(lists)
    ends = torch.cumsum(torch.tensor([len(x) for x in lists]), 0)
    ranges = torch.stack([ends - ends.new_tensor([len(x) for x in lists]), ends],
                         dim=1).to(torch.int32)
    rows, fb, ints = _autograd_rows_check(blob, _list_plan(ids, ranges, blob.shape[0]),
                                          width, height)
    tile_nc = ints[0].reshape(2, 16, 3, 16).permute(0, 2, 1, 3).reshape(6, 256)
    bound = torch.minimum(tile_nc.amax(dim=1), ranges[:, 1] - ranges[:, 0])
    assert bound[0] == 0 and bound[4] == 0 and bound[3] > 3
    for t in range(6):
        s = int(ranges[t, 0])
        assert torch.all(rows[s + int(bound[t]):int(ranges[t, 1])] == 0)


def _grad_inputs(seed=0, n=12):
    rng = np.random.default_rng(seed)
    xyz, scales, quats, opac, shs, _ = make_scene(n, rng, scale=0.25)
    target = rng.random((3, 32, 32)).astype(np.float32)
    return [np.asarray(a) for a in (xyz, scales, quats, opac, shs)], target


def _touch_every_channel(img, am, target):
    return (((img - target) ** 2).sum() + 0.05 * am[6].sum() + 0.01 * am[0].sum()
            + 0.01 * (am[2:5] ** 2).sum() + 0.02 * am[5].sum() + 0.01 * am[1].sum())


@functools.lru_cache(maxsize=None)
def _jax_gradients():
    """(dense loss, JAX dense gradients, JAX tiled gradients) of
    _touch_every_channel on _grad_inputs() at 32x32, as numpy arrays."""
    (xyz, scales, quats, opac, shs), target = _grad_inputs()
    n = xyz.shape[0]
    cam = make_camera(width=32, height=32)
    bg = np.array([0.3, 0.3, 0.3], np.float32)

    def jloss(backend, xyz, scales, opac, shs, means2d):
        prep = jrc.preprocess(xyz, scales, jnp.asarray(quats), opac, shs,
                              jnp.ones(n, bool), cam.params(), sh_degree=0)
        if backend == "pallas":
            out = j_tiled(prep, means2d, jnp.asarray(bg), 32, 32, interpret=True)
        else:
            out = j_dense(prep, means2d, jnp.asarray(bg), 32, 32, chunk=8)
        return _touch_every_channel(out["image"], out["allmap"], target)

    jargs = tuple(jnp.asarray(a) for a in (xyz, scales, opac, shs)) + (jnp.zeros((n, 2)),)
    g_dense = jax.grad(lambda *a: jloss("dense", *a), argnums=tuple(range(5)))(*jargs)
    g_tiled = jax.grad(lambda *a: jloss("pallas", *a), argnums=tuple(range(5)))(*jargs)
    return (float(jloss("dense", *jargs)), [np.asarray(g) for g in g_dense],
            [np.asarray(g) for g in g_tiled])


def test_tiled_gradients_match_jax_tiled_and_dense():
    """The port's tiled render differentiated through RasterCore (plain K2
    and K5 on the CPU) against JAX
    rasterize_tiled's custom VJP in interpret mode and JAX dense autodiff,
    with the loss and tolerances of
    tests/test_raster_pallas.py::test_gradients_match_dense (atol
    3e-3 * max|g|, rtol 2e-2: binning truncation against the dense oracle)."""
    (xyz, scales, quats, opac, shs), target = _grad_inputs()
    n = xyz.shape[0]
    cam = make_camera(width=32, height=32)
    bg = np.array([0.3, 0.3, 0.3], np.float32)
    l_ref, g_dense, g_tiled = _jax_gradients()

    tcam = TCamera(uid=0, colmap_id=0, image_name="t", R=cam.R, T=cam.T,
                   fovx=cam.fovx, fovy=cam.fovy, width=32, height=32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (xyz, scales, opac, shs)]
    means2d = torch.zeros(n, 2, requires_grad=True)
    prep = trc.preprocess(leaves[0], leaves[1], torch.tensor(quats), leaves[2], leaves[3],
                          torch.ones(n, dtype=torch.bool), tcam.params("cpu"), sh_degree=0)
    out = rt.rasterize_tiled(prep, means2d, torch.tensor(bg), 32, 32)
    loss = _touch_every_channel(out["image"], out["allmap"], torch.tensor(target))
    loss.backward()
    assert abs(loss.item() - l_ref) < 1e-3 * max(1.0, abs(l_ref))
    ours = [x.grad.numpy() for x in leaves] + [means2d.grad.numpy()]
    for name, mine, gd, gt in zip(["xyz", "scales", "opac", "shs", "means2d"], ours,
                                  g_dense, g_tiled):
        for ref, what in ((gd, "dense"), (gt, "JAX tiled")):
            scale = np.abs(ref).max() + 1e-6
            np.testing.assert_allclose(mine, ref, atol=3e-3 * scale, rtol=2e-2,
                                       err_msg=f"{name} vs {what}")


def test_specialized_backward_matches_full():
    """need_dist_grad/need_med_grad=False give the full backward's
    gradients when the loss reads neither channel (rtol 1e-5, atol 1e-6,
    test_raster_pallas.py's limits; here the terms left out are exact
    zeros, so the two agree to the bit)."""
    prep_args, _ = _grad_inputs(seed=3, n=40)
    xyz, scales, quats, opac, shs = prep_args
    n = xyz.shape[0]
    cam = make_camera(width=64, height=32)
    tcam = TCamera(uid=0, colmap_id=0, image_name="t", R=cam.R, T=cam.T,
                   fovx=cam.fovx, fovy=cam.fovy, width=64, height=32)
    grads = []
    for flags in (True, False):
        leaves = [torch.tensor(a, requires_grad=True) for a in (xyz, scales, opac)]
        means2d = torch.zeros(n, 2, requires_grad=True)
        prep = trc.preprocess(leaves[0], leaves[1], torch.tensor(quats), leaves[2],
                              torch.tensor(shs), torch.ones(n, dtype=torch.bool),
                              tcam.params("cpu"), sh_degree=0)
        out = rt.rasterize_tiled(prep, means2d, torch.zeros(3), 64, 32,
                                 need_dist_grad=flags, need_med_grad=flags)
        am = out["allmap"]
        ((out["image"] ** 2).sum() + 0.1 * am[0].sum() + 0.05 * am[2:5].sum()
         + 0.01 * am[1].sum()).backward()
        grads.append([x.grad.numpy() for x in leaves] + [means2d.grad.numpy()])
    for name, gf, gs in zip(["xyz", "scales", "opac", "means2d"], *grads):
        np.testing.assert_allclose(gs, gf, rtol=1e-5, atol=1e-6, err_msg=name)


def _segsum_case(name, rng):
    """(rows [M, 20], ids [M], n_segments) of tests/test_segsum.py's cases."""
    if name in ("one", "block", "blocks"):
        n_seg, counts = {"one": (1, [5]), "block": (130, None),
                         "blocks": (300, None)}[name]
        if counts is None:
            counts = rng.integers(0, 9, n_seg)
        ids = np.repeat(np.arange(n_seg, dtype=np.int32), counts)
        ids = np.concatenate([ids, np.full(37, n_seg, np.int32)])   # dummies
        rows = rng.standard_normal((ids.size, 20)).astype(np.float32)
        rows[ids >= n_seg] = 0.0
        return rows, ids, n_seg
    if name == "empty":
        ids = np.array([0, 0, 200, 200, 200, 515], np.int32)
        rows = rng.standard_normal((6, 20)).astype(np.float32)
        rows[3] = 0.0
        return rows, ids, 520
    ids = np.zeros(1200, np.int32)                                  # "giant"
    return rng.standard_normal((1200, 20)).astype(np.float32), ids, 1


@pytest.mark.parametrize("case", ["one", "block", "blocks", "empty", "giant"])
def test_plain_segsum_matches_jax(case):
    """segment_sum_sorted on CPU tensors (its plain version, no launch)
    against JAX segment_sum_sorted in interpret mode on
    tests/test_segsum.py's cases: an oracle sweep across block borders with
    trailing dummies, empty segments with zero rows, one giant segment.
    The sums are taken in another order: rtol/atol 1e-5 (1e-4 for the
    1200-row segment), as in tests/test_segsum.py."""
    rng = np.random.default_rng(0)
    rows, ids, n_seg = _segsum_case(case, rng)
    lanes = np.zeros((rows.shape[0], 128), np.float32)
    lanes[:, :20] = rows
    lanes[:, ID_LANE] = ids
    lanes[ids >= n_seg] = 0.0
    ref = np.asarray(j_segsum(jnp.asarray(lanes), jnp.asarray(ids), n_seg,
                              interpret=True))[:n_seg, :20]
    before = counter("segsum")
    out = segsum.segment_sum_sorted(torch.tensor(rows), torch.tensor(ids), n_seg)
    assert counter("segsum") == before and out.shape == (n_seg, 20)
    tol = 1e-4 if case == "giant" else 1e-5
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)


def test_grad_reduce_modes_agree_and_unknown_mode_raises():
    """grad_blob through binning's plan (K5's plain version over the rows
    inside each tile's walk window) against an index_add_ sum of the rows
    by entry id: within 1e-6 of each column's scale (only the order of the
    sums differs), the dummy row zero."""
    prep, width, height = _prep("ragged")
    blob, ids, ranges = _binned(prep, width, height)
    b = rt.binning(prep, *rt.tile_grid(width, height))
    fb, ints = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    ct = torch.tensor(np.random.default_rng(2).normal(
        size=(rt.CT,) + fb.shape[1:]).astype(np.float32))
    rows = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height)
    out = rt.grad_reduce(rows, b, ints)
    assert out.shape == (blob.shape[0], rt.F) and torch.all(out[-1] == 0)
    ref = _index_add_sums(rows, ids, blob.shape[0])
    scale = out.abs().amax(dim=0) + 1e-30
    assert ((ref - out).abs() / scale).max() <= 1e-6


@pytest.mark.parametrize("scene", ["ragged", "deep"])
@pytest.mark.parametrize("seeded", [False, True])
def test_grad_reduce_routes_agree_with_the_plan(scene, seeded):
    """On plain K2 / K4 rows (the deep scene's walk windows leave many rows
    out): grad_reduce through binning's plan within 1e-6 of each column's
    scale of an index_add_ sum of the rows by entry id; its plain K5 reads
    only slots below the walk limit."""
    case = _bwd_case(scene, seeded, "cpu")
    rows, _ = _bwd(case, (True, True), plain=True)
    b, n_rows = case["binned"], case["blob"].shape[0]
    out = rt.grad_reduce(rows, b, case["ints"])
    ref = _index_add_sums(rows, b.entry_ids, n_rows)
    scale = out.abs().amax(dim=0) + 1e-30
    assert ((ref - out).abs() / scale).max() <= 1e-6
    # the same sums with every row past a walk limit poisoned: grad_reduce
    # never reads one
    limit = rt.walk_limits(case["ints"], b.tile_ranges)
    pos = torch.arange(rows.shape[0], dtype=torch.int32)
    tile = torch.searchsorted(b.tile_ranges[:, 1].contiguous(), pos, right=True)
    past = pos >= limit[tile.clamp(max=limit.shape[0] - 1)]
    poisoned = torch.where(past[:, None], torch.nan, rows)
    assert torch.equal(rt.grad_reduce(poisoned, b, case["ints"]), out)
