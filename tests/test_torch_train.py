"""The training slice of the port against the JAX package: SSIM, image
metrics, losses, the learning-rate schedule, masked Adam, densify/prune
with the same split noise, init_from_pcd, a 20-step trajectory with one
densify pass on the dense path, a step with the DINO term on both sides
of its gate, checkpoints across the packages, and the port's train CLI on
the CPU (with the DINO term, without weights, and serving the viewer)."""
import csv
import dataclasses
import importlib
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussmart_tpu import losses as jl
from gaussmart_tpu import optim as jo
from gaussmart_tpu import train as jtrain
from gaussmart_tpu import transforms as jt
from gaussmart_tpu.cameras import Camera as JCamera
from gaussmart_tpu.config import OptimizationParams as JOpt
from gaussmart_tpu.io import checkpoint as jck
from gaussmart_tpu.io.ply import store_point_cloud
from gaussmart_tpu.models import densify as jd
from gaussmart_tpu.models import gaussians as jg
from gaussmart_tpu.ops import image as jimg
from gaussmart_tpu.train_lib import make_train_step as j_make_train_step
from gaussmart_tpu_torch import losses as tl
from gaussmart_tpu_torch import optim as to
from gaussmart_tpu_torch import train as ttrain
from gaussmart_tpu_torch import transforms as tt
from gaussmart_tpu_torch.cameras import Camera as TCamera
from gaussmart_tpu_torch.config import OptimizationParams as TOpt
from gaussmart_tpu_torch.io import checkpoint as tck
from gaussmart_tpu_torch.models import densify as td
from gaussmart_tpu_torch.models import gaussians as tg
from gaussmart_tpu_torch.ops import image as timg
from gaussmart_tpu_torch.ops import ssim as tssim
from gaussmart_tpu_torch.semantics import dino as tdino
from gaussmart_tpu_torch.train_lib import make_train_step as t_make_train_step
from gaussmart_tpu_torch.viewer.client import ViewerClient, camera_request
from gaussmart_tpu_torch.viewer.protocol import NetworkGUI

# the package re-exports ssim() under the module's name
jssim = importlib.import_module("gaussmart_tpu.ops.ssim")
torch.set_num_threads(1)
NAMES = [f.name for f in dataclasses.fields(jg.GaussianParams)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_ssim_and_image_metrics_match_jax(rng):
    """SSIM (value and gradient), L1, L2, PSNR and the Sobel gradient map
    against the JAX ops on random 3x29x37 images, to float32 noise (1e-5;
    both take the blur as 11 shifted adds per axis in float32)."""
    a = rng.random((3, 29, 37)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta = torch.tensor(a, requires_grad=True)
    s = tssim.ssim(ta, torch.tensor(b))
    s.backward()
    np.testing.assert_allclose(s.item(), float(jssim.ssim(a, b)), rtol=1e-5)
    g = jax.grad(lambda x: jssim.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(g), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(g)).max())
    np.testing.assert_allclose(_np(tssim.ssim(torch.tensor(a)[None], torch.tensor(b)[None],
                                              size_average=False)),
                               np.asarray(jssim.ssim(a[None], b[None], size_average=False)),
                               rtol=1e-5)
    ta, tb = torch.tensor(a), torch.tensor(b)
    for name in ("l1_loss", "l2_loss"):
        np.testing.assert_allclose(_np(getattr(timg, name)(ta, tb)),
                                   np.asarray(getattr(jimg, name)(a, b)), rtol=1e-6)
    np.testing.assert_allclose(_np(timg.psnr(ta[None], tb[None])),
                               np.asarray(jimg.psnr(a[None], b[None])), rtol=1e-6)
    np.testing.assert_allclose(_np(timg.gradient_map(ta)), np.asarray(jimg.gradient_map(a)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ramp,clip", [(0, 0.0), (400, 0.05)])
def test_losses_gates_ramp_and_clip_match_jax(rng, ramp, clip):
    """photometric_loss and regularization_losses at iterations around the
    3000/7000 gates, with and without the dist ramp and clip, and a zero
    lambda skipping its term: equal to float32 noise (1e-6)."""
    img = rng.random((3, 20, 24)).astype(np.float32)
    gt = rng.random((3, 20, 24)).astype(np.float32)
    pkg = {k: rng.random(shape).astype(np.float32) for k, shape in
           (("rend_normal", (3, 20, 24)), ("surf_normal", (3, 20, 24)),
            ("rend_dist", (1, 20, 24)), ("render", (3, 20, 24)))}
    tpkg = {k: torch.tensor(v) for k, v in pkg.items()}
    for lam in (0.0, 0.2):
        got = tl.photometric_loss(torch.tensor(img), torch.tensor(gt), lam)
        ref = jl.photometric_loss(img, gt, lam)
        np.testing.assert_allclose([_np(x) for x in got], [np.asarray(x) for x in ref],
                                   rtol=1e-6)
    for it in (100, 3000, 3001, 3200, 5000, 7000, 7001):
        for lam_d, lam_n in ((0.0, 0.05), (100.0, 0.0), (100.0, 0.05)):
            got = tl.regularization_losses(tpkg, it, lam_d, lam_n, ramp, clip)
            ref = jl.regularization_losses(pkg, it, lam_d, lam_n, ramp, clip)
            np.testing.assert_allclose([_np(x) for x in got], [np.asarray(x) for x in ref],
                                       rtol=1e-6, err_msg=f"it {it}")
    x = rng.normal(size=(1, 12, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(tl.smooth_loss(torch.tensor(x), torch.tensor(img[:, :12, :16]))),
                               np.asarray(jl.smooth_loss(x, img[:, :12, :16])), rtol=1e-5)
    enc = lambda z: z[:, ::4, ::4] * 2.0
    for mode in ("fixed", "parity"):
        np.testing.assert_allclose(
            _np(tl.dino_term(torch.tensor(img), torch.tensor(gt), enc, 0.05, mode)),
            np.asarray(jl.dino_term(img, gt, enc, 0.05, mode)), rtol=1e-6)


def test_exponential_lr_and_masked_adam_match_jax(rng):
    """The xyz schedule equals JAX's float32 value exactly; three masked
    Adam steps agree to float32 noise (rtol 1e-6 on params, 1e-5 on the
    second moment), inactive slots untouched, and the moment surgery."""
    opt = TOpt()
    for step in (0, 1, 7, 500, 29_999, 30_000, 31_000):
        assert tt.exponential_lr(step, 1.6e-4, 1.6e-6, lr_delay_mult=0.01,
                                 max_steps=30_000) == float(
            jt.exponential_lr(step, 1.6e-4, 1.6e-6, lr_delay_mult=0.01, max_steps=30_000))
        assert tt.exponential_lr(step, 1e-3, 1e-5, lr_delay_steps=100, lr_delay_mult=0.1,
                                 max_steps=1000) == float(
            jt.exponential_lr(step, 1e-3, 1e-5, lr_delay_steps=100, lr_delay_mult=0.1,
                              max_steps=1000))
    C, k = 32, 4
    shapes = dict(xyz=(C, 3), features_dc=(C, 1, 3), features_rest=(C, k - 1, 3),
                  scaling=(C, 2), rotation=(C, 4), opacity=(C, 1))
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    active = rng.random(C) < 0.7
    jp, tp = jg.GaussianParams(**p0), tg.GaussianParams(**{n: torch.tensor(v) for n, v in p0.items()})
    ja, ta = jo.init_adam(jp), to.init_adam(tp)
    for it in (1, 2, 3):
        grads = {n: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1, s)).astype(np.float32)
                 for n, s in shapes.items()}
        jp, ja = jo.adam_step(jp, jg.GaussianParams(**grads), ja,
                              jo.group_lrs(JOpt(), it, 2.0), jnp.asarray(active))
        tp, ta = to.adam_step(tp, tg.GaussianParams(**{n: torch.tensor(v) for n, v in grads.items()}),
                              ta, to.group_lrs(opt, it, 2.0), torch.tensor(active))
    assert int(ta.step) == int(ja.step) == 3
    for n in NAMES:
        np.testing.assert_allclose(_np(getattr(tp, n)), np.asarray(getattr(jp, n)),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        np.testing.assert_array_equal(_np(getattr(tp, n))[~active], p0[n][~active])
        np.testing.assert_allclose(_np(getattr(ta.mu, n)), np.asarray(getattr(ja.mu, n)),
                                   rtol=1e-6, atol=1e-12, err_msg=n)
        np.testing.assert_allclose(_np(getattr(ta.nu, n)), np.asarray(getattr(ja.nu, n)),
                                   rtol=1e-5, atol=1e-20, err_msg=n)
    slots = rng.random(C) < 0.3
    zt = to.zero_moments_at(ta, torch.tensor(slots))
    zj = jo.zero_moments_at(ja, jnp.asarray(slots))
    zt, zj = to.zero_group_moments(zt, "opacity"), jo.zero_group_moments(zj, "opacity")
    for n in NAMES:
        for grp in ("mu", "nu"):
            got, ref = _np(getattr(getattr(zt, grp), n)), np.asarray(getattr(getattr(zj, grp), n))
            np.testing.assert_array_equal(got == 0, ref == 0, err_msg=f"{grp}.{n}")


def _jax_state(rng, n=48, capacity=64, sh_degree=1, spread=1.0):
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    segs = rng.integers(0, 5, n).astype(np.int32)
    return jg.init_from_pcd(pts, cols, segs, max_sh_degree=sh_degree,
                            spatial_lr_scale=1.0, capacity=capacity, seed=3)


def _port_state(js, device="cpu"):
    st = tg.state_from_numpy(vars(jax.tree.map(np.asarray, js.params)),
                             np.asarray(js.aux.active), np.asarray(js.aux.segments),
                             js.max_sh_degree, js.active_sh_degree, js.spatial_lr_scale,
                             device=device)
    aux = tg.GaussianAux(**{k: torch.tensor(np.asarray(v)) for k, v in vars(js.aux).items()})
    return st.replace(aux=aux)


def _port_adam(ja):
    return tg.adam_from_numpy(vars(jax.tree.map(np.asarray, ja.mu)),
                              vars(jax.tree.map(np.asarray, ja.nu)), ja.step, device="cpu")


def _assert_states_equal(ts, ta, js, ja, rtol=0.0, atol=0.0, what=""):
    for n in NAMES:
        for got, ref, grp in ((ts.params, js.params, "params"), (ta.mu, ja.mu, "mu"),
                              (ta.nu, ja.nu, "nu")):
            np.testing.assert_allclose(_np(getattr(got, n)), np.asarray(getattr(ref, n)),
                                       rtol=rtol, atol=atol, err_msg=f"{what} {grp}.{n}")
    for k in ("active", "segments"):
        np.testing.assert_array_equal(_np(getattr(ts.aux, k)), np.asarray(getattr(js.aux, k)),
                                      err_msg=f"{what} aux.{k}")
    for k in ("max_radii2d", "grad_accum", "denom"):
        np.testing.assert_allclose(_np(getattr(ts.aux, k)), np.asarray(getattr(js.aux, k)),
                                   rtol=max(rtol, 1e-6), atol=atol, err_msg=f"{what} aux.{k}")


def test_init_from_pcd_matches_jax_to_the_bit(rng):
    js = _jax_state(rng)
    pts, cols = np.asarray(js.params.xyz)[:48], rng.random((48, 3)).astype(np.float32)
    segs = rng.integers(0, 5, 48)
    ts = tg.init_from_pcd(pts, cols, segs, 2, 1.5, capacity=None, seed=11, device="cpu")
    js = jg.init_from_pcd(pts, cols, segs, 2, 1.5, capacity=None, seed=11)
    assert ts.capacity == js.capacity == 1024 and ts.active_sh_degree == 0
    for n in NAMES:
        np.testing.assert_array_equal(_np(getattr(ts.params, n)), np.asarray(getattr(js.params, n)))
    for k, v in vars(js.aux).items():
        np.testing.assert_array_equal(_np(getattr(ts.aux, k)), np.asarray(v))
    grown = tg.grow_capacity(ts, 1100)
    ref = jg.grow_capacity(js, 1100)
    for n in NAMES:
        np.testing.assert_array_equal(_np(getattr(grown.params, n)), np.asarray(getattr(ref.params, n)))
    packed, ref = tg.compact(ts), jg.compact(js)
    np.testing.assert_array_equal(_np(packed.params.xyz), np.asarray(ref.params.xyz))
    assert ts.oneup_sh_degree().active_sh_degree == 1
    assert ts.oneup_sh_degree().oneup_sh_degree().oneup_sh_degree().active_sh_degree == 2


def test_point_cloud_augmentation_matches_jax(rng):
    """The Scene's point-cloud augmentation (by segment mask areas, and the
    uniform fallback) draws the same points as the JAX package's, to the
    bit: both are numpy on the same seed."""
    from gaussmart_tpu.semantics import augment as jaug
    from gaussmart_tpu_torch.semantics import augment as taug
    pts = rng.normal(size=(90, 3)).astype(np.float32)
    cols = rng.random((90, 3)).astype(np.float32)
    segs = np.repeat(np.arange(-1, 8, dtype=np.int32), 10)
    segs[85:] = 7                                   # segment 6 has 5 points
    areas = {1: 9e4, 2: 100.0, 3: 4e4, 6: 2.5e5, 7: 1.6e5}
    got = taug.augment_by_mask_areas(pts, cols, segs, areas, seed=5, verbose=False)
    ref = jaug.augment_by_mask_areas(pts, cols, segs, areas, seed=5, verbose=False)
    assert len(got[0]) > len(pts)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(taug.augment_uniform(pts, cols, seed=2),
                    jaug.augment_uniform(pts, cols, seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("capacity", [160, 64])
def test_densify_and_prune_matches_jax_with_the_same_noise(rng, capacity):
    """Clone, split (children placed with the JAX package's own normal
    draws, passed to the port as eps), prune, zeroed moments and the stat
    reset, with room for every child (160) and with the arena overflowing
    (64: the count of dropped children must match); then reset_opacity.
    Bit-equal except the split children's xyz (an einsum, float32 noise)
    and the log/exp and logit round trips (1 ulp)."""
    js = _jax_state(rng, capacity=capacity, spread=0.6)
    C, n = js.capacity, 48
    grads = np.where(np.arange(C) < n, rng.random(C) * 2e-3, 0).astype(np.float32)
    opac = np.asarray(js.params.opacity).copy()
    opac[:n:7] = -6.0                                   # some get pruned
    js = js.replace(params=dataclasses.replace(js.params, opacity=jnp.asarray(opac)),
                    aux=dataclasses.replace(js.aux, grad_accum=jnp.asarray(grads),
                                            denom=jnp.ones(C, jnp.float32),
                                            max_radii2d=jnp.full(C, 3.0, jnp.float32)))
    ja = jo.init_adam(js.params)
    ja = dataclasses.replace(ja, mu=jax.tree.map(lambda a: a + 0.5, ja.mu),
                             nu=jax.tree.map(lambda a: a + 0.25, ja.nu))
    ts, ta = _port_state(js), _port_adam(ja)
    max_scale = np.exp(np.asarray(js.params.scaling)[:n]).max(axis=1)
    kw = dict(max_grad=1e-3, min_opacity=0.005, extent=5.0,
              percent_dense=float(np.median(max_scale)) / 5.0, use_size_prune=True)
    key = jax.random.PRNGKey(5)
    eps = [np.asarray(jax.random.normal(k, (C, 2), jnp.float32))
           for k in jax.random.split(key, 2)]
    js2, ja2, jdrop = jd.densify_and_prune(js, ja, key, **kw)
    ts2, ta2, tdrop = td.densify_and_prune(ts, ta, eps=eps, **kw)
    assert tdrop == int(jdrop)
    assert (tdrop > 0) == (capacity == 64)
    assert int(ts2.aux.active.sum()) == int(js2.aux.active.sum()) > 0
    _assert_states_equal(ts2, ta2, js2, ja2, rtol=1e-6, atol=1e-7, what="densify")
    ts3, ta3 = td.reset_opacity(ts2, ta2)
    js3, ja3 = jd.reset_opacity(js2, ja2)
    _assert_states_equal(ts3, ta3, js3, ja3, rtol=1e-6, atol=1e-7, what="reset")


def _cameras(n=4, size=24):
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n * 0.12
        c, s = np.cos(ang), np.sin(ang)
        kw = dict(uid=i, colmap_id=i, image_name=f"c{i}",
                  R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
                  T=np.array([0.2 * i - 0.3, 0.0, 0.0]), fovx=0.9, fovy=0.9,
                  width=size, height=size)
        cams.append((JCamera(**kw), TCamera(**kw)))
    return cams


def test_twenty_steps_and_a_densify_pass_match_jax(rng):
    """20 training steps of make_train_step on the dense path in both
    packages (24x24, 4 cameras, 30 splats, SH degree 1), with the densify
    pass after step 10 fed the same split noise. The loss of every step
    agrees within 1e-4 (relative); after the run params and moments agree
    within 2e-3 of each group's scale, aux exactly or to float32 noise.
    Why 2e-3: Adam divides by sqrt(v) + 1e-15, so a gradient that is float32
    noise in one package and exactly 0 in the other moves an entry by up
    to one full learning-rate step (<= 0.05 for opacity) per iteration;
    the per-step gradients agree to ~1e-5 of their scale, so over 20 steps
    the parameters drift by well under 2e-3 of their scale."""
    n = 30
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2.5, 4.0, n)], axis=1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    js = jg.init_from_pcd(pts, cols, None, max_sh_degree=1, spatial_lr_scale=1.0,
                          capacity=64, seed=2)
    ts = tg.init_from_pcd(pts, cols, None, max_sh_degree=1, spatial_lr_scale=1.0,
                          capacity=64, seed=2, device="cpu")
    cams = _cameras()
    yy, xx = np.mgrid[0:24, 0:24] / 23.0
    gts = [np.stack([xx, yy, np.full_like(xx, 0.25 * i)]).astype(np.float32)
           for i in range(4)]
    kw = dict(densify_from_iter=5, densification_interval=10, densify_until_iter=15)
    jstep = j_make_train_step(JOpt(**kw), sh_degree=1, white_background=False,
                              backend="dense", spatial_lr_scale=1.0, donate=False)
    tstep = t_make_train_step(TOpt(**kw), sh_degree=1, white_background=False,
                              backend="dense", spatial_lr_scale=1.0)
    jp, ja, jx = js.params, jo.init_adam(js.params), js.aux
    tp, ta, tx = ts.params, to.init_adam(ts.params), ts.aux
    for it in range(1, 21):
        jcam, tcam = cams[it % 4]
        jp, ja, jx, jm, _ = jstep(jp, ja, jx, jcam.params(), jnp.asarray(gts[it % 4]),
                                  jnp.asarray(it, jnp.int32))
        tp, ta, tx, tm, _ = tstep(tp, ta, tx, tcam.params("cpu"),
                                  torch.tensor(gts[it % 4]), it)
        np.testing.assert_allclose(tm.total.item(), float(jm.total), rtol=1e-4,
                                   err_msg=f"loss at step {it}")
        assert int(tm.n_active) == int(jm.n_active)
        if it == 10:
            js, ts = js.replace(params=jp, aux=jx), ts.replace(params=tp, aux=tx)
            g = np.asarray(jx.grad_accum) / np.maximum(np.asarray(jx.denom), 1)
            dkw = dict(max_grad=float(np.quantile(g[np.asarray(jx.active)], 0.6)),
                       min_opacity=0.005, extent=1.0, percent_dense=0.03,
                       use_size_prune=False)
            key = jax.random.PRNGKey(it)
            eps = [np.asarray(jax.random.normal(k, (64, 2), jnp.float32))
                   for k in jax.random.split(key, 2)]
            js, ja, _ = jd.densify_and_prune(js, ja, key, **dkw)
            ts, ta, _ = td.densify_and_prune(ts, ta, eps=eps, **dkw)
            assert int(ts.aux.active.sum()) == int(js.aux.active.sum()) > n
            jp, jx, tp, tx = js.params, js.aux, ts.params, ts.aux
    assert int(ta.step) == int(ja.step) == 19           # step 10 dropped its update
    for n_ in NAMES:
        for got, ref, grp in ((tp, jp, "params"), (ta.mu, ja.mu, "mu"), (ta.nu, ja.nu, "nu")):
            r = np.asarray(getattr(ref, n_))
            np.testing.assert_allclose(_np(getattr(got, n_)), r, rtol=0,
                                       atol=2e-3 * (np.abs(r).max() + 1e-30),
                                       err_msg=f"{grp}.{n_}")
    np.testing.assert_array_equal(_np(tx.active), np.asarray(jx.active))
    np.testing.assert_array_equal(_np(tx.denom), np.asarray(jx.denom))
    np.testing.assert_allclose(_np(tx.grad_accum), np.asarray(jx.grad_accum), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jx.grad_accum)).max())


DINO_GATE = 5


@pytest.fixture(scope="module")
def dino_steps():
    """The JAX single-device step with the JAX trainer's DINO term and the
    port's with its own (GAUSSMART_DINO_WEIGHTS=random: the same random
    tower in both, fixed mode, gate at DINO_GATE), on 30 splats at 24x24,
    and the state both start from."""
    rng = np.random.default_rng(6)
    n = 30
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2.5, 4.0, n)], axis=1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    js = jg.init_from_pcd(pts, cols, None, max_sh_degree=1, spatial_lr_scale=1.0,
                          capacity=64, seed=2)
    ts = tg.init_from_pcd(pts, cols, None, max_sh_degree=1, spatial_lr_scale=1.0,
                          capacity=64, seed=2, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tdino.WEIGHT_ENV, "random")
        jfn = jtrain._build_dino_fn(0.05, DINO_GATE, "fixed")
        tfn = ttrain._build_dino_fn(0.05, DINO_GATE, "fixed", "cpu")
    kw = dict(sh_degree=1, white_background=False, backend="dense", spatial_lr_scale=1.0)
    jstep = j_make_train_step(JOpt(), dino_fn=jfn, donate=False, **kw)
    tstep = t_make_train_step(TOpt(), dino_fn=tfn, **kw)
    gt = rng.random((3, 24, 24)).astype(np.float32)
    return js, ts, jstep, tstep, _cameras()[1], gt


@pytest.mark.parametrize("iteration", [DINO_GATE, DINO_GATE + 1])
def test_train_step_with_the_dino_term_matches_jax(dino_steps, iteration):
    """One step of make_train_step with train._build_dino_fn's term against
    the JAX step with the JAX trainer's, at the gate (term 0, the tower not
    run) and past it: the DINO metric and the loss within 1e-4
    (relative), params and Adam moments within 2e-3 of each group's scale
    (the 20-step test's tolerances)."""
    js, ts, jstep, tstep, (jcam, tcam), gt = dino_steps
    jp, ja, jx, jm, _ = jstep(js.params, jo.init_adam(js.params), js.aux, jcam.params(),
                              jnp.asarray(gt), jnp.asarray(iteration, jnp.int32))
    tp, ta, tx, tm, _ = tstep(ts.params, to.init_adam(ts.params), ts.aux,
                              tcam.params("cpu"), torch.tensor(gt), iteration)
    if iteration <= DINO_GATE:
        assert tm.dino.item() == float(jm.dino) == 0.0
    else:
        assert tm.dino.item() > 0 and np.isfinite(tm.dino.item())
        np.testing.assert_allclose(tm.dino.item(), float(jm.dino), rtol=1e-4)
    np.testing.assert_allclose(tm.total.item(), float(jm.total), rtol=1e-4)
    for n_ in NAMES:
        for got, ref, grp in ((tp, jp, "params"), (ta.mu, ja.mu, "mu"), (ta.nu, ja.nu, "nu")):
            r = np.asarray(getattr(ref, n_))
            np.testing.assert_allclose(_np(getattr(got, n_)), r, rtol=0,
                                       atol=2e-3 * (np.abs(r).max() + 1e-30),
                                       err_msg=f"{grp}.{n_}")


def test_checkpoints_resume_across_the_packages(tmp_path, rng):
    """A checkpoint written by the JAX package loads in the port, and one
    written by the port loads in the JAX package, with every array equal."""
    js = _jax_state(rng)
    js = js.replace(aux=dataclasses.replace(js.aux, grad_accum=jnp.arange(64.0),
                                            denom=jnp.full(64, 2.0),
                                            max_radii2d=jnp.full(64, 7.0)),
                    active_sh_degree=1)
    ja = jo.init_adam(js.params)
    ja = dataclasses.replace(ja, mu=jax.tree.map(lambda a: a + 0.5, ja.mu),
                             step=jnp.asarray(17, jnp.int32))
    jck.save_checkpoint(str(tmp_path / "j.npz"), js, ja, 1234)
    ts, ta, it = tck.load_checkpoint(str(tmp_path / "j.npz"), device="cpu")
    assert it == 1234 and int(ta.step) == 17
    assert (ts.max_sh_degree, ts.active_sh_degree, ts.spatial_lr_scale) == (1, 1, 1.0)
    _assert_states_equal(ts, ta, js, ja, what="jax -> port")
    tck.save_checkpoint(str(tmp_path / "t.npz"), ts, ta, 1235)
    js2, ja2, it2 = jck.load_checkpoint(str(tmp_path / "t.npz"))
    assert it2 == 1235 and int(ja2.step) == 17 and js2.active_sh_degree == 1
    _assert_states_equal(ts, ta, js2, ja2, what="port -> jax")
    for f in dataclasses.fields(jg.GaussianAux):
        assert np.asarray(getattr(js2.aux, f.name)).dtype == np.asarray(
            getattr(js.aux, f.name)).dtype


def _blender_scene(src, rng):
    os.makedirs(src / "train")
    frames = []
    for i in range(4):
        img = np.zeros((24, 24, 4), np.uint8)
        img[6:18, 6:18, 0] = 255
        img[:, :, 3] = 255
        Image.fromarray(img, "RGBA").save(src / "train" / f"r_{i}.png")
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        c2w = np.array([[c, 0, s, 0.1 * i], [0, 1, 0, 0], [-s, 0, c, 3.0], [0, 0, 0, 1.0]])
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(src / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    store_point_cloud(str(src / "points3d.ply"), rng.uniform(-0.5, 0.5, (64, 3)),
                      rng.integers(0, 255, (64, 3)).astype(np.float64))


def _dtu_segmentation_scene(src, rng):
    """A DTU-format scan the segmentation pipeline reads (cameras.npz,
    points.ply, PNG views of two colours) with the same 4 views as a
    COLMAP text model for the Scene."""
    from gaussmart_tpu.io.colmap import (ColmapCamera, ColmapImage, rotmat2qvec,
                                         write_cameras_text, write_images_text)
    sparse = src / "sparse" / "0"
    os.makedirs(sparse)
    os.makedirs(src / "images")
    K = np.eye(4)
    K[:3, :3] = [[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]
    mats, imgs = {}, {}
    for i in range(4):
        c, s = np.cos(0.3 * i), np.sin(0.3 * i)
        w2c = np.eye(4)
        w2c[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        w2c[:3, 3] = [0, 0, 3.0]
        mats.update({f"world_mat_{i}": w2c, f"camera_mat_{i}": K, f"scale_mat_{i}": np.eye(4)})
        imgs[i + 1] = ColmapImage(i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, f"{i:03d}.png")
        img = np.zeros((24, 32, 3), np.uint8)
        img[:9] = [220, 40, 40]
        img[9:] = [40, 40, 220]
        Image.fromarray(img).save(src / "images" / f"{i:03d}.png")
    np.savez(src / "cameras.npz", **mats)
    write_cameras_text(str(sparse / "cameras.txt"),
                       {1: ColmapCamera(1, "PINHOLE", 32, 24, np.array([30.0, 30.0, 16, 12]))})
    write_images_text(str(sparse / "images.txt"), imgs)
    pts, cols = rng.normal(scale=0.3, size=(64, 3)), rng.integers(0, 255, (64, 3)).astype(float)
    store_point_cloud(str(src / "points.ply"), pts, cols)
    store_point_cloud(str(sparse / "points3D.ply"), pts, cols)


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


def test_train_cli_on_cpu_writes_the_jax_outputs(tmp_path, rng, monkeypatch):
    """train.main on a tiny Blender scene (--device cpu): the snapshot,
    checkpoint, eval JSON and both CSV logs under the JAX trainer's names
    and columns; then a resume from the checkpoint starts at iteration 31;
    then --run_segmentation on a DTU scan from a temporary working
    directory: the pipeline's artifacts under identification/results, and
    training on the segmented cloud."""
    _blender_scene(tmp_path / "scene", rng)
    out = tmp_path / "out"
    common = ["-s", str(tmp_path / "scene"), "-m", str(out), "-w", "--sh_degree", "1",
              "--densify_from_iter", "5", "--densify_until_iter", "25",
              "--densification_interval", "10", "--opacity_reset_interval", "40",
              "--opacity_cull", "0.005", "--position_lr_max_steps", "30",
              "--capacity", "256", "--device", "cpu", "--no_tensorboard", "--quiet",
              "--dino_mode", "off"]
    state, _ = ttrain.main(common + ["--iterations", "30", "--test_iterations", "30",
                                     "--save_iterations", "30",
                                     "--checkpoint_iterations", "30"])
    for name in ("point_cloud/iteration_30/point_cloud.ply", "chkpnt30.npz",
                 "chkpnt30.npz.json", "eval_30.json", "input.ply", "cameras.json",
                 "cfg_args.json"):
        assert (out / name).exists(), name
    assert _header(out / "dino_loss_log.csv") == ["iteration", "dino_loss", "total_loss",
                                                   "l1_loss", "dist_loss", "normal_loss"]
    assert _header(out / "train_stats.csv") == ["iteration", "n_points", "n_dropped",
                                                "view", "dist_loss"]
    with open(out / "train_stats.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["iteration"]) for r in rows] == [10, 20, 30]
    assert all(r["n_dropped"] == "0" for r in rows)
    with open(out / "eval_30.json") as f:
        ev = json.load(f)
    assert set(ev["train"]) == {"l1", "psnr", "ssim"}
    assert int(state.n_active) > 0
    state2, _ = ttrain.main(common + ["--iterations", "32", "--test_iterations", "99",
                                      "--start_checkpoint", str(out / "chkpnt30.npz")])
    assert (out / "point_cloud" / "iteration_32" / "point_cloud.ply").exists()
    with open(out / "dino_loss_log.csv") as f:
        assert [int(r["iteration"]) for r in csv.DictReader(f)] == [32]
    _dtu_segmentation_scene(tmp_path / "dtu", rng)
    os.makedirs(tmp_path / "work")
    monkeypatch.chdir(tmp_path / "work")
    state3, _ = ttrain.main(["-s", str(tmp_path / "dtu"), "-m", str(tmp_path / "seg"),
                             "--run_segmentation", "--dataset_type", "dtu", "--iterations", "2",
                             "--test_iterations", "99", "--sh_degree", "1", "--capacity", "256",
                             "--device", "cpu", "--no_tensorboard", "--quiet",
                             "--dino_mode", "off"])
    results = tmp_path / "work" / "identification" / "results" / "segments"
    assert len(os.listdir(results / "masks")) >= 1
    segments = np.load(results / "point_cloud" / "segment_indices.npy")
    assert (segments >= 0).any()
    assert int(state3.n_active) >= len(segments)
    assert (tmp_path / "seg" / "point_cloud" / "iteration_2" / "point_cloud.ply").exists()


def _short_run(src, out, *extra):
    return ["-s", str(src), "-m", str(out), "-w", "--sh_degree", "1",
            "--densify_from_iter", "100", "--densify_until_iter", "100",
            "--opacity_reset_interval", "40", "--position_lr_max_steps", "10",
            "--iterations", "10", "--test_iterations", "99", "--capacity", "256",
            "--device", "cpu", "--no_tensorboard", "--quiet", *extra]


def _dino_column(out):
    with open(out / "dino_loss_log.csv") as f:
        return [float(r["dino_loss"]) for r in csv.DictReader(f)]


def test_train_cli_with_the_dino_term(tmp_path, rng, monkeypatch, capsys):
    """The counterpart of test_train_cli.py's DINO run: with
    GAUSSMART_DINO_WEIGHTS=random and --dino_start_iter 0 the dino_loss
    column is non-zero and finite; with no weight file anywhere the CLI
    prints the JAX trainer's message and the column is zeros."""
    _blender_scene(tmp_path / "scene", rng)
    monkeypatch.setenv(tdino.WEIGHT_ENV, "random")
    ttrain.main(_short_run(tmp_path / "scene", tmp_path / "on", "--dino_mode", "fixed",
                           "--dino_start_iter", "0"))
    dino = _dino_column(tmp_path / "on")
    assert dino and all(np.isfinite(d) and d > 0 for d in dino)

    monkeypatch.setenv(tdino.WEIGHT_ENV, str(tmp_path / "none.npz"))
    monkeypatch.setattr(tdino, "DEFAULT_PATHS", [str(tmp_path / "none.npz")])
    capsys.readouterr()
    ttrain.main(_short_run(tmp_path / "scene", tmp_path / "off", "--dino_start_iter", "0"))
    assert "[dino] encoder unavailable (No DINO weights found" in capsys.readouterr().out
    assert _dino_column(tmp_path / "off") == [0.0]


def test_build_dino_fn_raises_on_a_corrupt_weight_file(tmp_path, monkeypatch):
    """Intended: only a missing weight file disables the term (the JAX
    trainer's message); a file that is there but does not load raises,
    where the JAX trainer's bare `except Exception` disables the term."""
    (tmp_path / "bad.npz").write_bytes(b"not an npz")
    monkeypatch.setenv(tdino.WEIGHT_ENV, str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError):
        ttrain._build_dino_fn(0.05, 0, "fixed", "cpu")
    assert jtrain._build_dino_fn(0.05, 0, "fixed") is None


def test_train_cli_serves_the_viewer(tmp_path, rng, monkeypatch):
    """train.main --gui: a viewer connected before the first iteration asks
    for a frame and to train on, three times (RGB, Depth, Normal), then
    leaves; training goes on to its end. Each frame is the scene camera's
    render of that iteration's splats, at the camera's size."""
    _blender_scene(tmp_path / "scene", rng)
    cam = TCamera(uid=0, colmap_id=0, image_name="v", R=np.eye(3), T=np.array([0, 0, 3.0]),
                  fovx=0.8, fovy=0.8, width=24, height=20)
    requests = [camera_request(cam, m, train=True) for m in (0, 3, 2)]
    clients = []

    class ConnectedGUI(NetworkGUI):
        def init(self, host, port):
            super().init(host, port)
            clients.append(ViewerClient(self.listener.getsockname()[1], requests))
            clients[0].start()
            assert clients[0].connected.wait(30) and clients[0].error is None

    monkeypatch.setattr(ttrain, "NetworkGUI", ConnectedGUI)
    state, _ = ttrain.main(_short_run(tmp_path / "scene", tmp_path / "out", "--gui",
                                      "--port", "0", "--dino_mode", "off"))
    client, = clients
    client.join(30)
    assert not client.is_alive() and client.error is None, client.error
    assert client.items == ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]
    assert len(client.frames) == 3
    for image, verify, metrics in client.frames:
        assert len(image) == 24 * 20 * 3 and len(set(image)) > 1
        assert verify == str(tmp_path / "scene") and set(metrics) == {"#", "loss"}
    assert int(state.n_active) > 0 and (tmp_path / "out" / "point_cloud" / "iteration_10"
                                        ).exists()
