"""The training step's preprocess as one autograd Function (K8,
csrc/preprocess_grad.cu, wrapped by render/preprocess_grad.py), without
JAX, so the card-only cases also run where no JAX is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_preprocess_grad.py

On the CPU the per-splat arithmetic the kernels share
(csrc/preprocess_splat.cuh), built for the host with g++
(tests/torch_data/preprocess_splat_host.cpp), is held against autograd
through the chain it replaces; the Function's plumbing runs on the chain's
plain version; the route (CUDA tensors, one state, the tiled backend, a
gradient) and the wrappers' refusals are checked. On a CUDA card the
kernels are held against the chain.

Tolerance of a gradient: the VJP adds the same terms as autograd in
another order (and the card's chain takes cuBLAS's fused products), so a
leaf's gradient may differ by float32 rounding of its sums; cancellation
makes the gap of one element relative to itself unbounded near zero, so
each leaf is held to GRAD_TOL of its largest |gradient| (the host build
reads at most 1.1e-6 over the cases below)."""
import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gaussmart_tpu_torch import kernels
from gaussmart_tpu_torch.config import OptimizationParams
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.models.gaussians import GaussianParams
from gaussmart_tpu_torch.optim import init_adam
from gaussmart_tpu_torch.render import api
from gaussmart_tpu_torch.render import preprocess_grad as pg
from gaussmart_tpu_torch.render import raster_common
from gaussmart_tpu_torch.train_lib import _loss_and_aux, make_train_step

from test_torch_preprocess_fused import HEIGHT, WIDTH, _camera, _state

torch.set_num_threads(1)

LEAVES = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")
NAMES = LEAVES + ("means2d",)
GRAD_TOL = 1e-5
# splats beside _state's inactive (0), off-screen (1) and behind-the-camera
# (2) ones: an opacity that rounds to zero, a needle (one axis 1e-9 of the
# other: no usable ellipse) and a zero quaternion (R of the identity)
ZERO_OPACITY, NEEDLE, ZERO_QUAT = 3, 4, 5
# the blob's columns by what they reach
GROUPS = {"T": list(range(9)), "centre": [9, 10], "shift": [11, 12], "opacity": [13],
          "colour": [14, 15, 16], "normal": [17, 18, 19]}


def _splats(n=300, max_deg=3, device="cpu", seed=0):
    state = _state(n=n, max_deg=max_deg, deg=max_deg, device=device, seed=seed)
    p = state.params
    with torch.no_grad():
        p.opacity[ZERO_OPACITY] = -40.0
        p.scaling[NEEDLE, 1] = p.scaling[NEEDLE, 0] - 20.0
        p.rotation[ZERO_QUAT] = 0.0
    return state


def _leaves(state):
    p = state.params
    return ([getattr(p, k).detach().clone().requires_grad_() for k in LEAVES]
            + [torch.zeros((state.capacity, 2), device=state.device, requires_grad=True)])


def _cotangent(valid, seed=0, cols=None):
    """A random blob cotangent on the valid splats' rows (grad_reduce gives
    zero rows elsewhere), on the columns `cols` (all by default)."""
    n = valid.shape[0]
    g = torch.randn((n + 1, 20), generator=torch.Generator().manual_seed(seed))
    g = g.to(valid.device) * torch.cat([valid, valid.new_zeros(1)]).float()[:, None]
    if cols is not None:
        keep = torch.zeros(20, device=valid.device)
        keep[cols] = 1.0
        g = g * keep
    return g


def _chain(state, cam, active_degree, scale_modifier=1.0, seed=0, cols=None):
    """The chain's outputs and autograd's gradients for a random cotangent."""
    leaves = _leaves(state)
    out = pg.preprocess_grad_plain(*leaves, state.aux.active, cam, state.max_sh_degree,
                                   active_degree, scale_modifier)
    g = _cotangent(out[3], seed, cols)
    grads = torch.autograd.grad(out[0], leaves, g, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, grads)]
    return [x.detach() for x in out], g, grads


def _hold_grads(got, ref, active_degree, label):
    """Each leaf within GRAD_TOL of its largest |gradient|, means2d's
    bit-equal, the bands above active_degree exact zeros."""
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, name)
        if name == "means2d":
            assert torch.equal(a, b), (label, name)
            continue
        scale = b.abs().max().item() if b.numel() else 0.0
        gap = (a - b).abs().max().item() if b.numel() else 0.0
        assert gap <= GRAD_TOL * scale, (label, name, gap, scale)
        if scale == 0.0:
            assert not a.any(), (label, name)
    masked = (active_degree + 1) ** 2 - 1
    assert not got[5][:, masked:].any(), label


# --- the per-splat arithmetic on the host ------------------------------------

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/preprocess_splat.cuh's forward and VJP built for the host."""
    src = Path(__file__).resolve().parent / "torch_data" / "preprocess_splat_host.cpp"
    out = tmp_path_factory.mktemp("host") / "libpreprocess_splat_host.so"
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the host copy of the kernels' arithmetic"
    proc = subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
                           "-Wno-unknown-pragmas", f"-I{kernels.CSRC}", str(src), "-o",
                           str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    assert proc.returncode == 0, proc.stdout
    lib = ctypes.CDLL(str(out))

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def camera(cam):
        out = torch.empty(27)
        wv, fp = cam.world_view, cam.full_proj
        lib.host_camera(ptr(wv), wv.stride(0), wv.stride(1), ptr(fp), fp.stride(0),
                        fp.stride(1), ptr(cam.camera_center), cam.width, cam.height, ptr(out))
        return out

    def fwd(xyz, scaling, rotation, opacity, features_dc, features_rest, means2d, active,
            cam, sh_degree, active_degree, scale_modifier=1.0):
        leaves = [x.detach().contiguous() for x in (xyz, scaling, rotation, opacity,
                                                    features_dc, features_rest, means2d)]
        n, n_rest = xyz.shape[0], features_rest.shape[1]
        deg = pg.kernel_degree(sh_degree, active_degree, n_rest)
        blob, conics = torch.empty((n + 1, 20)), torch.empty((n + 1, 8))
        aux, valid = torch.empty((4, n)), torch.empty(n, dtype=torch.bool)
        c = camera(cam)
        assert lib.host_fwd(deg, n, n_rest, *map(ptr, leaves[:6]), ptr(active), ptr(leaves[6]),
                            ptr(c), cam.width, cam.height, ctypes.c_float(scale_modifier),
                            ptr(blob), ptr(conics), ptr(aux), ptr(valid)) == 0
        return blob, conics, aux, valid

    def bwd(xyz, scaling, rotation, opacity, features_dc, features_rest, valid, g_blob, cam,
            sh_degree, active_degree, scale_modifier=1.0):
        grads = tuple(x.detach().clone().contiguous() for x in (
            xyz, scaling, rotation, opacity, features_dc, features_rest))
        n, n_rest = xyz.shape[0], features_rest.shape[1]
        deg = pg.kernel_degree(sh_degree, active_degree, n_rest)
        g_means2d = torch.empty((n, 2))
        c = camera(cam)
        opacity, g_blob = opacity.detach().contiguous(), g_blob.contiguous()
        assert lib.host_bwd(deg, n, n_rest, ptr(opacity), ptr(valid), ptr(g_blob), ptr(c),
                            cam.width, cam.height,
                            ctypes.c_float(scale_modifier), *map(ptr, grads),
                            ptr(g_means2d)) == 0
        return grads + (g_means2d,)
    return SimpleNamespace(fwd=fwd, bwd=bwd)


CASES = [(0, 0), (1, 0), (1, 1), (2, 1), (2, 2), (3, 0), (3, 2), (3, 3), (4, 2), (4, 4)]


@pytest.mark.parametrize("scale_modifier", [1.0, 0.8])
@pytest.mark.parametrize("max_deg,active_degree", CASES)
def test_host_vjp_matches_autograd(host, max_deg, active_degree, scale_modifier):
    """The shared arithmetic's forward gives the chain's blob (within
    float32 rounding here: the CPU's products and sigmoid round otherwise
    than the card's, which K8 follows), the same valid and the radii within
    a pixel (a ceil); its VJP
    gives autograd's gradients through the chain for a random cotangent on
    the valid rows, among them the special splats."""
    state, cam = _splats(max_deg=max_deg, seed=10 * max_deg + active_degree), _camera()
    (blob, conics, aux, valid), g, ref = _chain(state, cam, active_degree, scale_modifier)
    assert valid[[ZERO_OPACITY, NEEDLE, ZERO_QUAT]].all()
    assert not valid[:3].any()
    assert conics[NEEDLE, 0] == 0 and aux[2:, ZERO_OPACITY].eq(0).all()
    leaves = _leaves(state)
    got = host.fwd(*leaves, state.aux.active, cam, max_deg, active_degree, scale_modifier)
    assert torch.equal(got[3], valid)
    assert torch.allclose(got[0], blob, rtol=1e-5, atol=1e-5 * blob.abs().max().item())
    assert torch.equal(got[0][:, 11:13], blob[:, 11:13])   # the shift: one multiply
    assert (got[2][0] - aux[0]).abs().max() <= 1.0   # a ceil of the radius
    grads = host.bwd(*leaves[:6], valid, g, cam, max_deg, active_degree, scale_modifier)
    _hold_grads(grads, ref, active_degree, f"degree {max_deg}, active {active_degree}")


@pytest.mark.parametrize("group", list(GROUPS))
def test_host_vjp_by_column_group(host, group):
    """Each path back from the blob alone (T, the centre through T, the
    shift to means2d, the opacity, the colour to the coefficients and the
    view direction, the normal to the quaternion): the VJP's gradients
    within tolerance, and exact zeros where autograd's are."""
    state, cam = _splats(seed=7), _camera()
    (_, _, _, valid), g, ref = _chain(state, cam, 3, cols=GROUPS[group])
    grads = host.bwd(*_leaves(state)[:6], valid, g, cam, 3, 3)
    _hold_grads(grads, ref, 3, group)
    reached = {name for name, r in zip(NAMES, ref) if r.any()}
    assert reached, group


def test_host_vjp_skips_zero_rows(host):
    """A valid splat whose cotangent row is zero, and every splat that is
    not valid whatever its row, gets zero gradients."""
    state, cam = _splats(seed=3), _camera()
    leaves = _leaves(state)
    _, _, _, valid = host.fwd(*leaves, state.aux.active, cam, 3, 3)
    g = torch.randn((state.capacity + 1, 20), generator=torch.Generator().manual_seed(1))
    quiet = torch.nonzero(valid)[:5, 0]
    g[quiet] = 0.0
    g[-1] = 0.0
    grads = host.bwd(*leaves[:6], valid, g, cam, 3, 3)
    off = (~valid).nonzero()[:, 0]
    for name, d in zip(NAMES[:6], grads):
        assert not d[quiet].any() and not d[off].any(), name
    assert grads[0][valid].abs().sum() > 0


# --- the Function and the route, on the CPU ----------------------------------

def _plain_kernels(monkeypatch):
    """The wrappers as the chain: the forward under no_grad, the VJP by
    autograd through it (the Function's plumbing on the CPU)."""
    def fwd(*args):
        with torch.no_grad():
            return pg.preprocess_grad_plain(*args)

    def bwd(xyz, scaling, rotation, opacity, features_dc, features_rest, valid, g_blob, cam,
            sh_degree, active_degree, scale_modifier):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (
                xyz, scaling, rotation, opacity, features_dc, features_rest)]
            leaves.append(torch.zeros((xyz.shape[0], 2), requires_grad=True))
            blob = pg.preprocess_grad_plain(*leaves, valid, cam, sh_degree, active_degree,
                                            scale_modifier)[0]
            return torch.autograd.grad(blob, leaves, g_blob)
    monkeypatch.setattr(pg, "preprocess_grad_fwd", fwd)
    monkeypatch.setattr(pg, "preprocess_bwd", bwd)


def _step_grads(state, cam, gt, iteration, route):
    """_loss_and_aux's loss and the gradients of every leaf and means2d,
    with leaf_route forced to `route`."""
    import gaussmart_tpu_torch.train_lib as tl
    leaves = _leaves(state)
    params = GaussianParams(**dict(zip(LEAVES, leaves[:6])))
    orig = tl.leaf_route
    tl.leaf_route = lambda params, backend: route
    try:
        total, extras = _loss_and_aux(params, leaves[6], state.aux, cam, gt, iteration,
                                      OptimizationParams(), torch.zeros(3, device=state.device),
                                      state.max_sh_degree, 0.0, "auto")
    finally:
        tl.leaf_route = orig
    total.backward()
    return total.detach(), extras, [x.grad for x in leaves]


@pytest.mark.parametrize("iteration", [1500, 3500])
def test_function_plumbing_gives_the_chain_on_cpu(iteration, monkeypatch):
    """render_leaves through PreprocessCore, its kernels stood in for by the
    chain, gives render_arrays' loss, radii and gradients bit for bit: the
    blob, conic and aux rows reach the binning, the compositor and the
    output dict as the chain's do, and the VJP's gradients reach each leaf
    and means2d."""
    _plain_kernels(monkeypatch)
    state, cam = _splats(n=120), _camera()
    gt = torch.rand(3, HEIGHT, WIDTH, generator=torch.Generator().manual_seed(0))
    total, extras, grads = _step_grads(state, cam, gt, iteration, route=True)
    ref_total, ref_extras, ref = _step_grads(state, cam, gt, iteration, route=False)
    assert torch.equal(total, ref_total)
    assert torch.equal(extras["radii"], ref_extras["radii"])
    for name, a, b in zip(NAMES, grads, ref):
        assert torch.equal(a, b), name
    assert grads[0].abs().sum() > 0 and grads[6].abs().sum() > 0


def test_training_step_with_the_kernels_arithmetic_on_cpu(host, monkeypatch):
    """A training step's gradients through render_leaves with the host
    build of K8's arithmetic as its kernels, against the chain's: within
    tolerance (the forwards differ by the CPU's rounding of T), means2d's
    within it too (its cotangent rows come from frames that differ by that
    rounding)."""
    monkeypatch.setattr(pg, "preprocess_grad_fwd", host.fwd)
    monkeypatch.setattr(pg, "preprocess_bwd", host.bwd)
    state, cam = _splats(n=120), _camera()
    gt = torch.rand(3, HEIGHT, WIDTH, generator=torch.Generator().manual_seed(0))
    total, _, grads = _step_grads(state, cam, gt, 3500, route=True)
    ref_total, _, ref = _step_grads(state, cam, gt, 3500, route=False)
    assert torch.allclose(total, ref_total, rtol=1e-5)
    for name, a, b in zip(NAMES, grads, ref):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), name


CUDA_PARAMS = SimpleNamespace(xyz=SimpleNamespace(device=torch.device("cuda")))


def test_leaf_route_conditions():
    """K8 is taken with a gradient, for one state on a CUDA device and the
    tiled backend; not without a gradient, nor for per-slot chunks, CPU
    tensors or the dense and sharded backends."""
    assert api.leaf_route(CUDA_PARAMS, "auto") and api.leaf_route(CUDA_PARAMS, "pallas")
    for backend in ("dense", "row_sharded", "gaussian_sharded", "gaussian_sharded_pallas"):
        assert not api.leaf_route(CUDA_PARAMS, backend), backend
    assert not api.leaf_route([CUDA_PARAMS] * 2, "gaussian_sharded_pallas")
    assert not api.leaf_route(_splats(n=8).params, "auto")
    with torch.no_grad():
        assert not api.leaf_route(CUDA_PARAMS, "auto")


def _refuse_k8(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K8 was launched")
    monkeypatch.setattr(pg, "preprocess_grad_fwd", refuse)
    monkeypatch.setattr(pg, "preprocess_bwd", refuse)


def _spy_preprocess(monkeypatch):
    calls = []
    orig = raster_common.preprocess

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return orig(*a, **k)
    monkeypatch.setattr(raster_common, "preprocess", spy)
    return calls


def test_cpu_training_step_takes_the_chain(monkeypatch):
    """On CPU tensors make_train_step runs raster_common.preprocess once a
    step and never K8."""
    _refuse_k8(monkeypatch)
    calls = _spy_preprocess(monkeypatch)
    state, cam = _splats(n=60, max_deg=1), _camera()
    gt = torch.rand(3, HEIGHT, WIDTH, generator=torch.Generator().manual_seed(0))
    step = make_train_step(OptimizationParams(), sh_degree=1, white_background=False)
    before = (counter("preprocess_grad_fwd"), counter("preprocess_bwd"))
    out = step(state.params, init_adam(state.params), state.aux, cam, gt, 1501)
    assert calls == [60]
    assert (counter("preprocess_grad_fwd"), counter("preprocess_bwd")) == before
    assert torch.isfinite(out[3].total)


def test_mp_step_chunks_take_the_chain(monkeypatch):
    """The Gaussian-sharded step preprocesses each per-slot chunk through
    the chain and never K8."""
    from gaussmart_tpu_torch.parallel.sharding import (make_mesh, make_mp_train_step,
                                                       shard_state)
    _refuse_k8(monkeypatch)
    state, cam = _splats(n=64, max_deg=1), _camera()
    mesh = make_mesh(2, "cpu")
    params, adam, aux = shard_state(state.params, init_adam(state.params), state.aux, mesh)
    calls = _spy_preprocess(monkeypatch)
    gt = torch.rand(3, HEIGHT, WIDTH, generator=torch.Generator().manual_seed(0))
    step = make_mp_train_step(OptimizationParams(), mesh, sh_degree=1, white_background=False,
                              backend="gaussian_sharded_pallas")
    out = step(params, adam, aux, cam, gt, 1501)
    assert calls == [32, 32]
    assert torch.isfinite(out[3].total)


def _args(state, cam, **change):
    p = state.params
    a = dict(xyz=p.xyz, scaling=p.scaling, rotation=p.rotation, opacity=p.opacity,
             features_dc=p.features_dc, features_rest=p.features_rest,
             means2d=torch.zeros((state.capacity, 2)), active=state.aux.active)
    a.update(change)
    return a


@pytest.mark.parametrize("case", ["cpu", "float64", "shape", "g_blob_rows", "degree"])
def test_wrappers_refuse(case, monkeypatch):
    """The wrappers raise on CPU tensors, another dtype, a wrong shape and an
    SH degree beyond the coefficients, before any launch or count."""
    def no_launch(*a, **k):
        raise AssertionError("launched")
    monkeypatch.setattr(kernels, "launch", no_launch)
    state, cam = _splats(n=16, max_deg=1), _camera()
    n = state.capacity
    fwd = _args(state, cam)
    g_blob = torch.zeros((n + 1, 20))
    valid = torch.ones(n, dtype=torch.bool)
    deg = 1
    match = {"cpu": "runs on CUDA tensors", "float64": "xyz must be torch.float32",
             "shape": "rotation must be", "g_blob_rows": "g_blob must be",
             "degree": "SH degree 2 needs 8"}[case]
    if case == "float64":
        fwd["xyz"] = fwd["xyz"].double()
    elif case == "shape":
        fwd["rotation"] = fwd["rotation"][:, :3]
    elif case == "g_blob_rows":
        g_blob = g_blob[:-1]
    elif case == "degree":
        deg = 2
    bwd = {k: v for k, v in fwd.items() if k not in ("means2d", "active")}
    before = (counter("preprocess_grad_fwd"), counter("preprocess_bwd"))
    if case != "g_blob_rows":
        with pytest.raises(ValueError, match=match):
            pg.preprocess_grad_fwd(**fwd, cam=cam, sh_degree=deg, active_degree=deg)
    with pytest.raises(ValueError, match=match):
        pg.preprocess_bwd(**bwd, valid=valid, g_blob=g_blob, cam=cam, sh_degree=deg,
                          active_degree=deg)
    assert (counter("preprocess_grad_fwd"), counter("preprocess_bwd")) == before


# --- the kernels on the card -------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 1025])
@pytest.mark.parametrize("max_deg,active_degree", CASES)
def test_forward_matches_the_chain_on_card(max_deg, active_degree, n):
    """K8's forward against the chain on the same leaves (scale_modifier
    0.8, the special splats among them): the blob, the conic rows, radius,
    depth, rx, ry and valid bit-equal, the zero rows zero, one launch."""
    _need_card()
    state, cam = _splats(n=n, max_deg=max_deg, device="cuda"), _camera("cuda")
    leaves = _leaves(state)
    with torch.no_grad():
        ref = pg.preprocess_grad_plain(*leaves, state.aux.active, cam, max_deg,
                                       active_degree, 0.8)
        before = counter("preprocess_grad_fwd")
        got = pg.preprocess_grad_fwd(*leaves, state.aux.active, cam, max_deg, active_degree,
                                     0.8)
    torch.cuda.synchronize()
    assert counter("preprocess_grad_fwd") == before + 1
    for name, a, b in zip(("blob", "conics", "aux", "valid"), got, ref):
        assert torch.equal(a, b), name
    assert not got[0][-1].any() and not got[1][-1].any()
    assert ref[3][[ZERO_OPACITY, NEEDLE, ZERO_QUAT]].all() and not ref[3][:3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("max_deg,active_degree", CASES)
def test_vjp_matches_autograd_on_card(max_deg, active_degree):
    """K8's VJP against autograd through the chain for a random cotangent
    on the valid rows: each leaf within tolerance, means2d bit-equal, the
    masked bands exact zeros; a second launch bit-equal to the first."""
    _need_card()
    state, cam = _splats(n=1025, max_deg=max_deg, device="cuda"), _camera("cuda")
    (_, _, _, valid), g, ref = _chain(state, cam, active_degree, 0.8)
    leaves = _leaves(state)
    before = counter("preprocess_bwd")
    got = pg.preprocess_bwd(*leaves[:6], valid, g, cam, max_deg, active_degree, 0.8)
    again = pg.preprocess_bwd(*leaves[:6], valid, g, cam, max_deg, active_degree, 0.8)
    torch.cuda.synchronize()
    assert counter("preprocess_bwd") == before + 2
    _hold_grads(got, ref, active_degree, f"degree {max_deg}, active {active_degree}")
    for name, a, b in zip(NAMES, got, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_training_step_on_card_takes_k8():
    """One training step launches K8's forward and VJP once each and K6
    never; its gradients match the chain's route within tolerance,
    means2d's bit-equal; two steps' gradients are bit-equal."""
    _need_card()
    state, cam = _splats(n=2000, device="cuda"), _camera("cuda")
    gt = torch.rand(3, HEIGHT, WIDTH, generator=torch.Generator().manual_seed(0)).cuda()
    step = make_train_step(OptimizationParams(), sh_degree=3, white_background=False)
    names = ("preprocess_grad_fwd", "preprocess_bwd", "preprocess_fwd")
    before = [counter(k) for k in names]
    step(state.params, init_adam(state.params), state.aux, cam, gt, 3500)
    assert [counter(k) - b for k, b in zip(names, before)] == [1, 1, 0]
    total, _, grads = _step_grads(state, cam, gt, 3500, route=True)
    again = _step_grads(state, cam, gt, 3500, route=True)[2]
    ref_total, _, ref = _step_grads(state, cam, gt, 3500, route=False)
    torch.cuda.synchronize()
    assert torch.equal(total, ref_total)
    _hold_grads(grads, ref, 3, "training step")
    for name, a, b in zip(NAMES, grads, again):
        assert torch.equal(a, b), name
