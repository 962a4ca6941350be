"""The binning kernel K7 (csrc/binning.cu, render/raster_tiled.py::binning)
and its plain twin binning_plain, without JAX, so the card-only cases also
run where no JAX is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_binning_kernel.py

On the CPU a plain PyTorch transcription of K7's stages (count, scan,
emit, a sort of the live pairs alone, finish with the tails filled) is
held bit for bit against binning_plain on every Binned field, the route
(CUDA tensors to the kernel, CPU tensors to the twin) is spied on, and the
reduction plan is written exactly where a backward can run; on a CUDA card
the kernel is held against its twin."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.ops.sh import rgb2sh
from gaussmart_tpu_torch.render import api
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.raster_common import preprocess

from test_torch_kernels import SCENES, _prep, _stratum

torch.set_num_threads(1)


def _adversarial(device="cpu", n=400, seed=1, width=128, height=128):
    """The conic-cull tests' splats (test_conic_cull.py::_adversarial_prep)
    through the port's preprocess: anisotropic scales over three decades,
    random orientations, opacities from below ALPHA_EPS to opaque, a tenth
    behind the camera."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(0.8, 6.0, n)], 1)
    behind = rng.random(n) < 0.1
    xyz[behind, 2] = -np.abs(xyz[behind, 2])
    scales = np.exp(rng.uniform(np.log(5e-3), np.log(1.2), (n, 2)))
    opac = np.concatenate([rng.uniform(0.001, 0.01, n // 4), rng.uniform(0.01, 0.2, n // 4),
                           rng.uniform(0.2, 0.99, n - 2 * (n // 4))])
    rng.shuffle(opac)
    cam = Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3), T=np.zeros(3), fovx=0.8,
                 fovy=0.8, width=width, height=height)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    prep = preprocess(t(xyz), t(scales), t(rng.normal(size=(n, 4))), t(opac),
                      t(rgb2sh(rng.random((n, 1, 3)))),
                      torch.ones(n, dtype=torch.bool, device=device), cam.params(device),
                      sh_degree=0)
    return prep, width, height


def _case(name, device="cpu"):
    """(prep, width, height, conics or None) of a named case."""
    if name in SCENES:
        return (*_prep(name, device), None)
    if name == "stratum":      # the sharded render's padded invalid rows
        prep, width, height = _stratum("ragged")
        return prep._replace(**{k: getattr(prep, k).to(device) for k in prep._fields}), \
            width, height, None
    if name == "adversarial":
        return (*_adversarial(device), None)
    prep, width, height = _prep("overlap" if name == "equal_depth" else "ragged", device)
    n = prep.depth.shape[0]
    if name == "equal_depth":  # every splat at one depth: ties broken by slot order
        return prep._replace(depth=torch.full_like(prep.depth, 3.0)), width, height, None
    if name == "no_pairs":     # no splat valid
        return prep._replace(valid=torch.zeros_like(prep.valid)), width, height, None
    conics = torch.zeros(n + 1, rt.FC, device=device)
    if name == "all_live":     # no usable ellipse: every rectangle pair is live
        return prep, width, height, conics
    # "none_live": an ellipse and a filter disc far off every row, so the
    # rectangles hold pairs and none of them is live
    assert name == "none_live"
    conics[:n] = torch.tensor([1.0, 0.0, 1e6, 1e6, 4.0, 1.0, 0.0, -1.0], device=device)
    return prep, width, height, conics


CASES = list(SCENES) + ["stratum", "adversarial", "equal_depth", "no_pairs", "all_live",
                        "none_live"]


def k7_stages(prep, tiles_x, tiles_y, conics):
    """K7's stages in plain PyTorch, as csrc/binning.cu orders them:
    bin_count (each splat's rectangle and live pair count, the frame's
    totals and the base of the last rectangle row), the scan, bin_emit
    (pairs splat-major, tiles ascending, at slot_starts), a stable sort of
    the live keys alone, bin_finish (entry ids with N past the live
    pairs, tile ranges where the sorted keys change tile, the inverse
    permutation with a fixed tail, the dead slots' tiles)."""
    n = prep.depth.shape[0]
    n_tiles = tiles_x * tiles_y
    sids = torch.arange(n)

    def tile_span(lo, hi, m):
        return (torch.clamp(torch.floor(lo / rt.TILE), 0, m).to(torch.int64),
                torch.clamp(torch.floor(hi / rt.TILE) + 1, 0, m).to(torch.int64))
    cx, cy = prep.center2d[:, 0], prep.center2d[:, 1]
    tx0, tx1 = tile_span(cx - prep.rx, cx + prep.rx, tiles_x)
    ty0, ty1 = tile_span(cy - prep.ry, cy + prep.ry, tiles_y)
    valid = prep.valid & (prep.rx > 0) & (prep.ry > 0)
    nx = torch.where(valid, tx1 - tx0, 0)
    ny = torch.where(valid, ty1 - ty0, 0)

    # bin_count: row r of every splat at once (cnt 0 past a splat's rows)
    rows = []
    for r in range(int(ny.max()) if n else 0):
        ty = ty0 + r
        cx0, cnt = rt._row_intervals(conics, prep.center2d, sids, ty, tx0, nx)
        rows.append((ty, cx0, torch.where(r < ny, cnt, 0)))
    counts = sum((cnt for _, _, cnt in rows), torch.zeros(n, dtype=torch.int64))
    n_rect = int((nx * ny).sum())
    with_rows = torch.nonzero(ny > 0)[:, 0]
    base = 0
    if with_rows.numel():
        s = int(with_rows[-1])
        ty, cx0, cnt = (x[s] for x in rows[int(ny[s]) - 1])
        base = int(ty) * tiles_x + int(cx0) + int(cnt)
    # the scan
    slot_starts = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum(counts, 0)]).to(torch.int32)
    n_live = int(slot_starts[n])
    empty = torch.zeros(0, dtype=torch.int32)
    if n_rect == 0:
        return rt.Binned(empty, torch.zeros(n_tiles, 2, dtype=torch.int32), conics, empty,
                         slot_starts, empty)

    # bin_emit
    keys = torch.empty(n_live, dtype=torch.int64)
    pair_sid = torch.empty(n_live, dtype=torch.int32)
    slot_tile = torch.empty(n_rect, dtype=torch.int32)
    bits = prep.depth.contiguous().view(torch.int32).to(torch.int64)
    k = slot_starts[:n].to(torch.int64)
    for ty, cx0, cnt in rows:
        for c in range(int(cnt.max())):
            m = c < cnt
            tile = ty[m] * tiles_x + cx0[m] + c
            keys[k[m] + c] = (tile << 32) | bits[m]
            pair_sid[k[m] + c] = sids[m].to(torch.int32)
            slot_tile[k[m] + c] = tile.to(torch.int32)
        k = k + cnt

    # the sort of the live pairs alone
    keys, perm = torch.sort(keys, stable=True)

    # bin_finish
    entry_ids = torch.full((n_rect,), n, dtype=torch.int32)
    entry_ids[:n_live] = pair_sid[perm]
    tile_of = keys >> 32
    cur = torch.cat([tile_of, torch.tensor([n_tiles])])
    prev = torch.cat([torch.tensor([-1]), tile_of])
    edges = torch.repeat_interleave(torch.arange(n_live + 1), cur - prev)   # tiles (prev, cur]
    tile_ranges = torch.stack([edges[:-1], edges[1:]], dim=1).to(torch.int32)
    inv_slots = torch.arange(n_rect, dtype=torch.int32)
    inv_slots[perm] = torch.arange(n_live, dtype=torch.int32)
    slot_tile[n_live:] = (base - n_live + torch.arange(n_live, n_rect)).to(torch.int32)
    return rt.Binned(entry_ids, tile_ranges, conics, inv_slots, slot_starts, slot_tile)


def _assert_binned_equal(got, ref, what):
    for field in rt.Binned._fields:
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {field}"
        assert torch.equal(a.cpu(), b.cpu()), f"{what}: {field}"


@pytest.mark.parametrize("case", CASES)
def test_k7_stages_equal_the_plain_binning(case):
    """The transcription of K7's stages against binning_plain on every
    Binned field, bit for bit, padding tails and lengths included; the CPU
    wrapper is the twin; without the plan inv_slots and slot_tile are empty
    and every other field is unchanged."""
    prep, width, height, conics = _case(case)
    tiles = rt.tile_grid(width, height)
    if conics is None:
        conics = rt.build_conics(prep)
    ref = rt.binning_plain(prep, *tiles, conics)
    _assert_binned_equal(k7_stages(prep, *tiles, conics), ref, case)
    _assert_binned_equal(rt.binning(prep, *tiles, conics), ref, f"{case}, wrapper")
    bare = rt.binning(prep, *tiles, conics, plan=False)
    assert bare.inv_slots.numel() == 0 and bare.slot_tile.numel() == 0
    _assert_binned_equal(bare._replace(inv_slots=ref.inv_slots, slot_tile=ref.slot_tile), ref,
                         f"{case}, no plan")

    n_rect, n_live = ref.entry_ids.shape[0], int(ref.slot_starts[-1])
    if case == "no_pairs":
        assert n_rect == 0
    elif case == "all_live":
        assert n_live == n_rect > 0
    elif case == "none_live":
        assert n_rect > 0 and n_live == 0 and not ref.tile_ranges.any()
    else:
        assert 0 < n_live < n_rect
    if case == "equal_depth":   # some tile holds several splats of one depth
        assert (ref.tile_ranges[:, 1] - ref.tile_ranges[:, 0]).max() > 1
    if case == "stratum":
        assert (~prep.valid).any()


def test_binning_routes_cuda_tensors_to_the_kernel(monkeypatch):
    """A stand-in CUDA prep goes to the K7 wrapper and never to the twin; a
    CPU prep goes to the twin; another device raises."""
    calls = []
    monkeypatch.setattr(rt, "_binning_k7", lambda *a: calls.append(("k7", a[4])) or "k7")
    plain = rt.binning_plain
    monkeypatch.setattr(rt, "binning_plain",
                        lambda *a: calls.append(("plain", a[4])) or plain(*a))
    prep, width, height = _prep("small")
    tiles = rt.tile_grid(width, height)
    on_card = prep._replace(depth=SimpleNamespace(device=torch.device("cuda")))
    assert rt.binning(on_card, *tiles, plan=False) == "k7"
    assert isinstance(rt.binning(prep, *tiles), rt.Binned)
    assert calls == [("k7", False), ("plain", True)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rt.binning(prep._replace(depth=prep.depth.to("meta")), *tiles)


def _state(n=120, seed=0):
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy
    rng = np.random.default_rng(seed)
    params = dict(
        xyz=np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(2.0, 4.0, n)], axis=1),
        features_dc=rgb2sh(rng.random((n, 1, 3))), features_rest=np.zeros((n, 3, 3)),
        scaling=np.log(0.06 * rng.uniform(0.3, 1.5, (n, 2))), rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)))
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    return state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32), 1, 1, 1.0,
                            device="cpu")


def _camera():
    return Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3), T=np.zeros(3), fovx=0.9,
                  fovy=0.6, width=48, height=32).params("cpu")


@pytest.mark.parametrize("route", ["train_step", "render_no_grad", "render_means2d",
                                   "sharded_grad", "sharded_no_grad"])
def test_the_plan_is_written_only_where_a_backward_can_run(route, monkeypatch):
    """Training's step and a render with a means2d leaf bin with the plan
    (inv_slots, slot_tile filled, the backward reads them); render()
    without a gradient and a sharded render under no_grad bin without it;
    the Gaussian-sharded render under grad bins each stratum with it."""
    seen = []
    binning = rt.binning

    def spy(prep, tiles_x, tiles_y, conics=None, plan=True):
        out = binning(prep, tiles_x, tiles_y, conics, plan)
        seen.append((plan, out))
        return out
    monkeypatch.setattr(rt, "binning", spy)
    state, cam = _state(), _camera()
    bg = torch.zeros(3)

    def arrays(**kw):
        return api.render_arrays(
            cam, xyz=state.params.xyz, scaling=state.get_scaling,
            rotation=state.params.rotation, opacity=state.get_opacity[:, 0],
            features=state.get_features, active=state.aux.active,
            sh_degree=state.active_sh_degree, bg_color=bg, **kw)
    if route == "train_step":
        from gaussmart_tpu_torch.config import OptimizationParams
        from gaussmart_tpu_torch.optim import init_adam
        from gaussmart_tpu_torch.train_lib import make_train_step
        step = make_train_step(OptimizationParams(), sh_degree=1, white_background=False)
        gt = torch.rand(3, cam.height, cam.width, generator=torch.Generator().manual_seed(0))
        step(state.params, init_adam(state.params), state.aux, cam, gt, 1501)
    elif route == "render_no_grad":
        with torch.no_grad():
            api.render(cam, state, bg)
    elif route == "render_means2d":
        means2d = torch.zeros((state.capacity, 2), requires_grad=True)
        arrays(means2d=means2d)["render"].sum().backward()
        assert means2d.grad.abs().sum() > 0
    else:
        from gaussmart_tpu_torch.parallel.sharding import make_mesh
        with torch.set_grad_enabled(route == "sharded_grad"):
            xyz = state.params.xyz.detach().requires_grad_(route == "sharded_grad")
            out = api.render_arrays(
                cam, xyz=[xyz[:60], xyz[60:]], scaling=[state.get_scaling[:60],
                                                        state.get_scaling[60:]],
                rotation=[state.params.rotation[:60], state.params.rotation[60:]],
                opacity=[state.get_opacity[:60, 0], state.get_opacity[60:, 0]],
                features=[state.get_features[:60], state.get_features[60:]],
                active=[state.aux.active[:60], state.aux.active[60:]],
                sh_degree=1, bg_color=bg, backend="gaussian_sharded_pallas",
                mesh=make_mesh(2, "cpu"))
            if route == "sharded_grad":
                out["render"].sum().backward()
                assert xyz.grad.abs().sum() > 0
    want = route in ("train_step", "render_means2d", "sharded_grad")
    assert seen and all(plan == want for plan, _ in seen)
    for _, b in seen:
        n_rect = b.entry_ids.shape[0]
        assert n_rect > 0
        assert (b.inv_slots.shape[0], b.slot_tile.shape[0]) == ((n_rect,) * 2 if want
                                                                else (0, 0))


# --- the kernel on the card --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case):
    """K7 against binning_plain on the same prep and conic rows: every
    Binned field bit-equal, with and without the plan; the launch counter
    adds one a binning."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: binning's kernels run only on the card")
    prep, width, height, conics = _case(case, "cuda")
    tiles = rt.tile_grid(width, height)
    if conics is None:
        conics = rt.build_conics(prep)
    ref = rt.binning_plain(prep, *tiles, conics)
    before = counter("binning")
    got = rt.binning(prep, *tiles, conics)
    torch.cuda.synchronize()
    assert counter("binning") == before + 1
    _assert_binned_equal(got, ref, case)
    bare = rt.binning(prep, *tiles, conics, plan=False)
    torch.cuda.synchronize()
    assert bare.inv_slots.numel() == 0 and bare.slot_tile.numel() == 0
    _assert_binned_equal(bare._replace(inv_slots=ref.inv_slots, slot_tile=ref.slot_tile), ref,
                         f"{case}, no plan")


@pytest.mark.cuda
def test_kernel_takes_the_fused_rows_on_card():
    """The K6 route's prep: center2d a strided view into the blob's
    columns, no ell, the conic rows given."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prep, width, height = _prep("wide", "cuda")
    n = prep.depth.shape[0]
    blob = rt.build_blob(prep, torch.zeros(n, 2, device="cuda"), width, height)
    conics = rt.build_conics(prep)
    strided = prep._replace(center2d=blob[:n, 9:11], ell=None)
    assert strided.center2d.stride() == (rt.F, 1)
    tiles = rt.tile_grid(width, height)
    _assert_binned_equal(rt.binning(strided, *tiles, conics),
                         rt.binning_plain(prep, *tiles, conics), "strided centre")
    with pytest.raises(ValueError, match="conics"):
        rt.binning(prep, *tiles, conics[:, :4].contiguous())
