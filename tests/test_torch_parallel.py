"""Multi-device rendering and training over D = 4 device slots on the CPU
(gaussmart_tpu_torch/parallel/sharding.py) against the JAX package's
sharding over make_mesh(4) of the 8 virtual CPU devices: the
Gaussian-sharded fold with the dense and the seeded tiled (plain K3/K4)
inner compositor on the scenes of tests/test_parallel.py (32x24; the
overlap and sticky-termination scenes too), row-sharded rendering and the
sharded render() backends at a height that is not a multiple of D. The
training steps and the train driver over slots are in
test_torch_parallel_train.py.

JAX calls that contain a shard_map are jitted: eagerly, each op of the
shard_map body runs alone and a frame takes tens of seconds."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu.cameras import Camera as JCamera
from gaussmart_tpu.models import gaussians as jg
from gaussmart_tpu.parallel import sharding as jsh
from gaussmart_tpu.render import raster_common as jrc
from gaussmart_tpu.render.api import render as j_render
from gaussmart_tpu.render.raster_dense import rasterize_pixels as j_dense
from gaussmart_tpu_torch.cameras import Camera as TCamera
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.models import gaussians as tg
from gaussmart_tpu_torch.parallel import sharding as tsh
from gaussmart_tpu_torch.render import raster_common as trc
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.api import render as t_render
from gaussmart_tpu_torch.render.raster_common import T_EPS
from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels as t_dense

torch.set_num_threads(1)
D = 4
W, H = 32, 24


@pytest.fixture(scope="module")
def meshes():
    return jsh.make_mesh(D), tsh.make_mesh(D, "cpu")


def _np(x):
    return x.detach().cpu().numpy()


def _states(pts, cols, capacity, opacity=None):
    """The same point cloud through both packages' init_from_pcd (bit-equal
    states), with the activated opacity of every splat set to `opacity`."""
    js = jg.init_from_pcd(pts, cols, None, max_sh_degree=0, spatial_lr_scale=1.0,
                          capacity=capacity)
    ts = tg.init_from_pcd(pts, cols, None, max_sh_degree=0, spatial_lr_scale=1.0,
                          capacity=capacity, device="cpu")
    if opacity is not None:
        logit = np.full((capacity, 1), np.log(opacity / (1 - opacity)), np.float32)
        js = js.replace(params=dataclasses.replace(js.params, opacity=jnp.asarray(logit)))
        ts = ts.replace(params=dataclasses.replace(ts.params, opacity=torch.tensor(logit)))
    return js, ts


def _camera(i=0, height=H, look_ahead=False):
    """test_parallel.py's cameras: make_scene's i-th (a 0.05 rad step about
    y), or with look_ahead the identity pose of its overlap scenes."""
    if look_ahead:
        kw = dict(R=np.eye(3), T=np.zeros(3), fovx=0.9, fovy=0.7)
    else:
        c, s = np.cos(0.05 * i), np.sin(0.05 * i)
        kw = dict(R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
                  T=np.array([0.05 * i, 0.0, 0.0]), fovx=0.8, fovy=0.8)
    kw.update(uid=i, colmap_id=i, image_name=f"c{i}", width=W, height=height)
    return JCamera(**kw), TCamera(**kw)


def _scene(kind, seed=0, height=H):
    """(JAX state, port state, JAX camera, port camera) of test_parallel.py:
    "spread" is make_scene (32 splats); "overlap" 48 splats of opacity 0.8
    in a narrow cone (the cross-stratum T_EPS cutoff, medians mid-stratum);
    "sticky" 64 of opacity 0.95 in a narrower one (pixels terminate
    mid-stratum with a frozen T far above T_EPS)."""
    rng = np.random.default_rng(seed)
    n, half, op = {"spread": (32, 0.5, None), "overlap": (48, 0.2, 0.8),
                   "sticky": (64, 0.12, 0.95)}[kind]
    pts = np.stack([rng.uniform(-half, half, n), rng.uniform(-half, half, n),
                    rng.uniform(2.0, 4.0, n)], axis=1).astype(np.float32)
    js, ts = _states(pts, rng.random((n, 3)).astype(np.float32), n, op)
    return (js, ts) + _camera(height=height, look_ahead=kind != "spread")


def _preps(js, ts, jcam, tcam):
    jp = jrc.preprocess(js.params.xyz, js.get_scaling, js.params.rotation,
                        js.get_opacity[:, 0], js.get_features, js.aux.active,
                        jcam.params(), sh_degree=0)
    tp = trc.preprocess(ts.params.xyz, ts.get_scaling, ts.params.rotation,
                        ts.get_opacity[:, 0], ts.get_features, ts.aux.active,
                        tcam.params("cpu"), sh_degree=0)
    return jp, tp


# tolerances of test_parallel.py: (image, allmap) against the dense
# composite, for its fold and its seeded tiled core alike
TOLS = {"spread": (2e-4, 2e-3), "overlap": (5e-4, 5e-3), "sticky": (2e-5, 2e-4)}


@pytest.mark.parametrize("kind", ["spread", "overlap", "sticky"])
def test_gaussian_sharded_render_matches_jax(meshes, kind):
    """render_gaussian_sharded, dense and pallas (plain K3), on 4 slots
    against the JAX render_gaussian_sharded on make_mesh(4), at
    test_parallel.py's tolerances for the scene (allmap without the median
    where it compares medians by their mismatch share: a discrete pick)."""
    jmesh, tmesh = meshes
    js, ts, jcam, tcam = _scene(kind)
    jp, tp = _preps(js, ts, jcam, tcam)
    n = js.capacity
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    ref = jax.jit(functools.partial(jsh.render_gaussian_sharded, jmesh, width=W,
                                    height=H, chunk=8))(jp, jnp.zeros((n, 2)),
                                                        jnp.asarray(bg))
    if kind == "sticky":
        # the regime under test occurs: pixels end with a frozen T >> T_EPS
        raw = t_dense(tp, torch.zeros(n, 2), torch.tensor(bg), W, H, chunk=8,
                      return_raw=True)["raw"]
        frozen = raw["T"][raw["done"]]
        assert frozen.numel() > 0 and frozen.max().item() > 3 * T_EPS
    tol_img, tol_map = TOLS[kind]
    maps = [0, 1, 2, 3, 4, 6] if kind == "overlap" else list(range(7))
    before = (counter("raster_fwd_seeded"), counter("raster_bwd_seeded"))
    for backend in ("dense", "pallas"):
        out = tsh.render_gaussian_sharded(tmesh, tp, torch.zeros(n, 2), torch.tensor(bg),
                                          W, H, chunk=8, backend=backend)
        np.testing.assert_allclose(_np(out["image"]), np.asarray(ref["image"]),
                                   atol=tol_img, err_msg=backend)
        am, am_ref = _np(out["allmap"]), np.asarray(ref["allmap"])
        np.testing.assert_allclose(am[maps], am_ref[maps], atol=tol_map, err_msg=backend)
        if kind == "overlap":
            assert np.mean(np.abs(am[5] - am_ref[5]) > 1e-3) < 0.02, backend
    assert (counter("raster_fwd_seeded"), counter("raster_bwd_seeded")) == before   # CPU: plain


def test_gaussian_sharded_gradients_match_jax(meshes):
    """Gradients through the fold (stratum gathers, factor all-gather, sum)
    of the image loss with respect to the splats' opacity and colour, on 4
    slots with each inner compositor, against jax.grad through the JAX
    fold (test_parallel.py's atol 2e-3 x scale)."""
    jmesh, tmesh = meshes
    js, ts, jcam, tcam = _scene("spread", seed=1)
    jp, tp = _preps(js, ts, jcam, tcam)
    n = js.capacity
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    wts = np.random.default_rng(2).random((3, H, W)).astype(np.float32)

    def jloss(opacity, color):
        out = jsh.render_gaussian_sharded(jmesh, jp._replace(opacity=opacity, color=color),
                                          jnp.zeros((n, 2)), jnp.asarray(bg), W, H,
                                          chunk=8)
        return jnp.sum(out["image"] * wts)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp.opacity, jp.color)
    for backend in ("dense", "pallas"):
        op = tp.opacity.detach().clone().requires_grad_(True)
        col = tp.color.detach().clone().requires_grad_(True)
        out = tsh.render_gaussian_sharded(tmesh, tp._replace(opacity=op, color=col),
                                          torch.zeros(n, 2), torch.tensor(bg), W, H,
                                          chunk=8, backend=backend)
        (out["image"] * torch.tensor(wts)).sum().backward()
        for got, r in zip((op.grad, col.grad), ref):
            r = np.asarray(r)
            np.testing.assert_allclose(_np(got), r, atol=2e-3 * max(1.0, np.abs(r).max()),
                                       err_msg=backend)


def test_row_sharded_and_the_sharded_render_backends(meshes):
    """render() at 32x26 (26 rows: not a multiple of the 4 slots, so the
    rows are padded and cropped): row_sharded against the JAX row_sharded
    render (atol 1e-5), gaussian_sharded and gaussian_sharded_pallas
    against the JAX dense render at test_parallel.py's API tolerances; and
    render_row_sharded itself, which refuses a height the slots do not
    divide."""
    jmesh, tmesh = meshes
    js, ts, jcam, tcam = _scene("spread", seed=3, height=26)
    bg = np.array([0.15, 0.25, 0.35], np.float32)
    ref = j_render(jcam.params(), js, jnp.asarray(bg), backend="dense")
    ref_row = jax.jit(lambda: j_render(jcam.params(), js, jnp.asarray(bg),
                                       backend="row_sharded", mesh=jmesh))()
    outs = {b: t_render(tcam.params("cpu"), ts, torch.tensor(bg), backend=b, mesh=tmesh)
            for b in ("row_sharded", "gaussian_sharded", "gaussian_sharded_pallas")}
    for key, atol_gs in (("render", 5e-4), ("rend_alpha", 5e-4), ("surf_depth", 5e-3),
                         ("rend_normal", 5e-4)):
        assert outs["row_sharded"][key].shape[-2:] == (26, W)
        np.testing.assert_allclose(_np(outs["row_sharded"][key]), np.asarray(ref_row[key]),
                                   atol=1e-5, err_msg=f"row_sharded {key}")
        for b in ("gaussian_sharded", "gaussian_sharded_pallas"):
            np.testing.assert_allclose(_np(outs[b][key]), np.asarray(ref[key]),
                                       atol=atol_gs, err_msg=f"{b} {key}")
    with pytest.raises(ValueError, match="needs mesh"):
        t_render(tcam.params("cpu"), ts, torch.tensor(bg), backend="row_sharded")

    _, tp = _preps(js, ts, jcam, tcam)
    n = js.capacity
    jp, _ = _preps(js, ts, jcam, tcam)
    row = tsh.render_row_sharded(tmesh, tp, torch.zeros(n, 2), torch.tensor(bg), W, 24,
                                 chunk=8)
    dense = j_dense(jp, jnp.zeros((n, 2)), jnp.asarray(bg), W, 24, chunk=8)
    for k in ("image", "allmap"):
        np.testing.assert_allclose(_np(row[k]), np.asarray(dense[k]), atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="multiple"):
        tsh.render_row_sharded(tmesh, tp, torch.zeros(n, 2), torch.tensor(bg), W, 26)
