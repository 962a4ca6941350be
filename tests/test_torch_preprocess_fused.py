"""The no-grad render's fused preprocess (K6, csrc/preprocess.cu, wrapped
by render/preprocess_fused.py), without JAX, so the card-only cases also
run where no JAX is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_preprocess_fused.py

On the CPU, render() keeps the unfused chain (render_arrays) and the
tests hold the route's condition and what the fused route does with the
rows, taken here from the kernel's plain twin; on a CUDA card the kernel
is held against its plain twin."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.config import OptimizationParams
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.models.gaussians import state_from_numpy
from gaussmart_tpu_torch.ops.sh import rgb2sh
from gaussmart_tpu_torch.optim import init_adam
from gaussmart_tpu_torch.render import api
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.preprocess_fused import (Fused, preprocess_fused,
                                                         preprocess_fused_plain)
from gaussmart_tpu_torch.train_lib import make_train_step

torch.set_num_threads(1)

WIDTH, HEIGHT = 64, 40
INACTIVE, OFF_SCREEN, BEHIND = 0, 1, 2     # splats the preprocess must cull


def _state(n=300, max_deg=3, deg=3, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.7, 0.7, n),
                    rng.uniform(2.0, 4.0, n)], axis=1)
    xyz[OFF_SCREEN] = (60.0, 0.0, 3.0)
    xyz[BEHIND] = (0.0, 0.0, -1.0)
    n_rest = (max_deg + 1) ** 2 - 1
    opacity = np.where(rng.random(n) < 0.6, rng.uniform(0.7, 0.99, n),
                       rng.uniform(0.002, 0.3, n))
    params = dict(
        xyz=xyz, features_dc=rgb2sh(rng.random((n, 1, 3))),
        features_rest=0.2 * rng.normal(size=(n, n_rest, 3)),
        scaling=np.log(0.06 * rng.uniform(0.3, 1.5, (n, 2))),
        rotation=rng.normal(size=(n, 4)),
        opacity=np.log(opacity / (1 - opacity))[:, None])
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    active = np.ones(n, bool)
    active[INACTIVE] = False
    return state_from_numpy(params, active, np.zeros(n, np.int32), max_deg, deg, 1.0,
                            device=device)


def _camera(device="cpu"):
    c, s = np.cos(0.1), np.sin(0.1)
    return Camera(uid=0, colmap_id=0, image_name="t",
                  R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]), T=np.array([0.1, 0.0, 0.2]),
                  fovx=0.9, fovy=0.9 * HEIGHT / WIDTH, width=WIDTH,
                  height=HEIGHT).params(device)


def _assert_same(got, ref, what):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert torch.equal(got, ref), what


def _as_kernel_gives(fused):
    """The plain twin's Fused as the kernel's wrapper returns it: T,
    centre, opacity, colour and normal views into the blob, no ell."""
    rows = fused.blob[:-1]
    prep = fused.prep._replace(T=rows[:, :9].unflatten(1, (3, 3)), center2d=rows[:, 9:11],
                               opacity=rows[:, 13], color=rows[:, 14:17],
                               normal=rows[:, 17:20], ell=None)
    return Fused(prep, fused.blob, fused.conics)


def _render_arrays(cam, state, bg, **kw):
    return api.render_arrays(
        cam, xyz=state.params.xyz, scaling=state.get_scaling,
        rotation=state.params.rotation, opacity=state.get_opacity[:, 0],
        features=state.get_features, active=state.aux.active,
        sh_degree=state.active_sh_degree, bg_color=bg, **kw)


@pytest.mark.parametrize("deg", [0, 3])
@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
def test_fused_rows_composite_as_render_arrays(deg, scale_modifier, monkeypatch):
    """The rows the fused preprocess hands on (the blob, the conic rows and
    a prep with no ell, here from its plain twin) bin, composite and
    package, bit for bit, as render_arrays does, with an inactive, an
    off-screen and a behind-the-camera splat among the splats."""
    state, cam = _state(deg=deg), _camera()
    fused = _as_kernel_gives(preprocess_fused_plain(state, cam, scale_modifier))
    prep = fused.prep
    assert not prep.valid[[INACTIVE, OFF_SCREEN, BEHIND]].any()
    assert prep.valid.sum() > 100 and (prep.rx[prep.valid] > 0).any()

    tx, ty = rt.tile_grid(WIDTH, HEIGHT)
    bg = torch.tensor([0.1, 0.2, 0.3])
    means2d = torch.zeros((state.capacity, 2))
    with torch.inference_mode():
        b_given = rt.binning(prep, tx, ty, fused.conics)
        b_built = rt.binning(preprocess_fused_plain(state, cam, scale_modifier).prep, tx, ty)
        given = rt.rasterize_tiled(prep, means2d, bg, WIDTH, HEIGHT, blob=fused.blob,
                                   conics=fused.conics)
        built = rt.rasterize_tiled(preprocess_fused_plain(state, cam, scale_modifier).prep,
                                   means2d, bg, WIDTH, HEIGHT)
    for field in rt.Binned._fields:
        _assert_same(getattr(b_given, field), getattr(b_built, field), f"binning {field}")
    for k in built:
        _assert_same(given[k], built[k], f"rasterize_tiled()[{k!r}]")

    calls = []

    def spy(*args):
        calls.append(args)
        return fused
    monkeypatch.setattr(api, "preprocess_fused", spy)
    for depth_ratio in (0.0, 1.0):
        with torch.inference_mode():
            out = api._render_fused(cam, state, bg, scale_modifier, depth_ratio)
            ref = _render_arrays(cam, state, bg, scaling_modifier=scale_modifier,
                                 depth_ratio=depth_ratio)
        assert out.keys() == ref.keys()
        for k in ref:
            _assert_same(out[k], ref[k], f"render()[{k!r}], depth_ratio {depth_ratio}")
        assert (out["render"] != bg[:, None, None]).any()
    assert [a[2] for a in calls] == [scale_modifier] * 2


CUDA_STATE = SimpleNamespace(device=torch.device("cuda"))   # fused_route reads .device


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_render_without_grad_takes_the_fused_route(mode, monkeypatch):
    """Without a gradient a state on a CUDA device takes the fused route
    with the tiled backend; with one, or on the CPU, render() keeps
    render_arrays and nothing counts a launch."""
    assert not api.fused_route(CUDA_STATE, "auto", None, None)
    with getattr(torch, mode)():
        assert api.fused_route(CUDA_STATE, "auto", None, None)
        assert api.fused_route(CUDA_STATE, "pallas", None, None)

    def refuse(*a, **k):
        raise AssertionError("the fused preprocess was called")
    monkeypatch.setattr(api, "preprocess_fused", refuse)
    state, cam = _state(n=60), _camera()
    bg = torch.zeros(3)
    before = counter("preprocess_fwd")
    with getattr(torch, mode)():
        assert not api.fused_route(state, "auto", None, None)
        out = api.render(cam, state, bg)
        ref = _render_arrays(cam, state, bg)
    assert counter("preprocess_fwd") == before
    for k in ref:
        _assert_same(out[k], ref[k], f"render()[{k!r}]")


@pytest.mark.parametrize("case", ["means2d_leaf", "dense", "chunked", "override_color",
                                  "means2d_given"])
def test_other_calls_keep_the_unfused_chain(case, monkeypatch):
    """render_arrays with a means2d leaf, the dense backend, a chunked
    (Gaussian-sharded) state, an override colour and a given means2d never
    reach the fused preprocess, on the CPU or (by the route's condition) on
    a CUDA device."""
    def refuse(*a, **k):
        raise AssertionError("the fused preprocess was called")
    monkeypatch.setattr(api, "preprocess_fused", refuse)
    state, cam = _state(n=60), _camera()
    bg = torch.zeros(3)
    before = counter("preprocess_fwd")
    if case == "means2d_leaf":
        means2d = torch.zeros((state.capacity, 2), requires_grad=True)
        assert not api.fused_route(CUDA_STATE, "auto", None, None)
        out = _render_arrays(cam, state, bg, means2d=means2d)
        out["render"].sum().backward()
        assert means2d.grad is not None and means2d.grad.abs().sum() > 0
    else:
        with torch.inference_mode():
            if case == "dense":
                assert not api.fused_route(CUDA_STATE, "dense", None, None)
                out = api.render(cam, state, bg, backend="dense", chunk=16)
            elif case == "chunked":
                from gaussmart_tpu_torch.parallel.sharding import make_mesh
                assert not api.fused_route([CUDA_STATE] * 2, "gaussian_sharded_pallas",
                                           None, None)
                out = api.render(cam, [_state(n=30), _state(n=30, seed=1)], bg,
                                 backend="gaussian_sharded_pallas",
                                 mesh=make_mesh(2, "cpu"))
            elif case == "override_color":
                colors = torch.ones((state.capacity, 3))
                assert not api.fused_route(CUDA_STATE, "auto", colors, None)
                out = api.render(cam, state, bg, override_color=colors)
            else:
                means2d = torch.zeros((state.capacity, 2))
                assert not api.fused_route(CUDA_STATE, "auto", None, means2d)
                out = api.render(cam, state, bg, means2d=means2d)
    assert counter("preprocess_fwd") == before
    assert torch.isfinite(out["render"]).all()


def test_train_step_never_takes_the_fused_route(monkeypatch):
    """A training step from the same state gives the same outputs whether or
    not the fused preprocess can be reached, and never counts it."""
    state = _state(n=80, max_deg=1, deg=1)
    cam = _camera()
    gt = torch.rand(3, HEIGHT, WIDTH, generator=torch.Generator().manual_seed(0))
    step = make_train_step(OptimizationParams(), sh_degree=1, white_background=False)

    def run():
        return step(state.params, init_adam(state.params), state.aux, cam, gt, 1501)
    before = counter("preprocess_fwd")
    first = run()

    def refuse(*a, **k):
        raise AssertionError("the fused preprocess was called")
    monkeypatch.setattr(api, "preprocess_fused", refuse)
    second = run()
    assert counter("preprocess_fwd") == before
    flat = [_leaves(x) for x in (first[:4], second[:4])]
    assert len(flat[0]) == len(flat[1]) > 10
    for a, b in zip(*flat):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return _leaves(list(vars(x).values()))
    return [x]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_fused_preprocess_runs_on_cuda_only(device):
    """The kernel's wrapper refuses other devices and counts nothing."""
    state, cam = _state(n=8), _camera()
    state = state.replace(params=type(state.params)(
        **{k: v.to(device) for k, v in vars(state.params).items()}))
    before = counter("preprocess_fwd")
    with pytest.raises(ValueError, match="CUDA tensors"):
        preprocess_fused(state, cam)
    assert counter("preprocess_fwd") == before


# --- the kernel on the card --------------------------------------------------

# the blob's columns that no matrix product reaches: shift and colour
ELEMENTWISE_BLOB = (11, 12, 14, 15, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("n", [127, 300, 1025])
def test_kernel_matches_plain_on_card(deg, n):
    """K6 against its plain twin on the same state: the blob, the conic rows
    and every per-splat field bit-equal (K6 accumulates the products T =
    Mh @ world2pix, the view-space centre and normal in the order cuBLAS
    takes at these sizes), the zero rows zero, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: preprocess_fwd runs only on the card")
    state = _state(n=n, max_deg=max(deg, 3), deg=deg, device="cuda")
    cam = _camera("cuda")
    before = counter("preprocess_fwd")
    got = preprocess_fused(state, cam, 0.8)
    assert counter("preprocess_fwd") == before + 1
    ref = preprocess_fused_plain(state, cam, 0.8)
    torch.cuda.synchronize()
    assert torch.equal(got.blob[:, ELEMENTWISE_BLOB], ref.blob[:, ELEMENTWISE_BLOB])
    assert torch.equal(got.blob, ref.blob) and torch.equal(got.conics, ref.conics)
    assert not got.blob[-1].any() and not got.conics[-1].any()
    for field in ("T", "center2d", "radius", "depth", "normal", "color", "opacity",
                  "valid", "rx", "ry"):
        assert torch.equal(getattr(got.prep, field), getattr(ref.prep, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 40])
def test_kernel_on_a_few_splats_on_card(n):
    """With a few splats cuBLAS takes another kernel for the plain chain's
    T = Mh @ world2pix (two pairs of fused multiply-adds, as for the
    camera's 4x4 product), whose order K6 does not follow: shift and
    colour stay bit-equal, T agrees within 2 ulps of its largest entry in
    the row (one rounding of a product of the sum), and the splats culled
    or kept are the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: preprocess_fwd runs only on the card")
    state, cam = _state(n=n, device="cuda"), _camera("cuda")
    got = preprocess_fused(state, cam)
    ref = preprocess_fused_plain(state, cam)
    torch.cuda.synchronize()
    assert torch.equal(got.blob[:, ELEMENTWISE_BLOB], ref.blob[:, ELEMENTWISE_BLOB])
    T, T_ref = got.blob[:n, :9], ref.blob[:n, :9]
    scale = T_ref.abs().amax(dim=1, keepdim=True)
    assert ((T - T_ref).abs() <= 2 * 2.0 ** -23 * scale).all()
    assert torch.equal(got.prep.valid, ref.prep.valid)
    assert not got.blob[-1].any() and not got.conics[-1].any()


@pytest.mark.cuda
def test_render_on_card_takes_the_kernel():
    """render() under inference_mode launches K6 once and K1 once and gives
    render_arrays' output dict bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    state, cam = _state(device="cuda"), _camera("cuda")
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    before = (counter("preprocess_fwd"), counter("raster_fwd"))
    with torch.inference_mode():
        out = api.render(cam, state, bg, depth_ratio=1.0)
        ref = _render_arrays(cam, state, bg, depth_ratio=1.0)
    assert (counter("preprocess_fwd"), counter("raster_fwd")) == (before[0] + 1,
                                                                   before[1] + 2)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
