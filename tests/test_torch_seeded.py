"""The seeded compositor of Gaussian-sharded rendering, K3 forward and K4
backward (their plain versions here; the CUDA kernels on the card),
against the JAX package's seeded tiled forward (interpret mode), its
dense seeded compositor and autodiff, and autograd of the port's own
seeded forward."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu.render import raster_common as jrc
from gaussmart_tpu.render.raster_dense import rasterize_pixels as j_dense
from gaussmart_tpu.render.raster_pallas import rasterize_tiled as j_tiled
from gaussmart_tpu_torch.cameras import Camera as TCamera
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.render import raster_common as trc
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels as t_dense

from test_raster import make_camera, make_scene
from test_raster_pallas import _assert_close_modulo_binning
from test_torch_kernels import _binned, _prep

torch.set_num_threads(1)
RAW = ("color", "normal", "depth", "alpha", "median", "dist", "T", "M1", "M2")


def _seed(width, height, seed=7, t_lo=0.3):
    """A per-pixel seed (T0, M1_0, M2_0) as the JAX seeded test draws it,
    flat [H*W] float32 each."""
    r = np.random.default_rng(seed)
    P = width * height
    return {"T": r.uniform(t_lo, 1.0, P).astype(np.float32),
            "M1": r.uniform(0.0, 0.3, P).astype(np.float32),
            "M2": r.uniform(0.0, 0.2, P).astype(np.float32)}


def _init_maps(seed, width, height):
    """The flat seed in K3's padded image layout [3, H_pad, W_pad]."""
    tx, ty = rt.tile_grid(width, height)
    init = torch.zeros((3, 16 * ty, 16 * tx))
    init[0] = 1.0
    for c, k in enumerate(("T", "M1", "M2")):
        init[c, :height, :width] = torch.tensor(seed[k]).reshape(height, width)
    return init


def _scenes(n, width, height, seed=0, **kw):
    rng = np.random.default_rng(seed)
    cam = make_camera(width=width, height=height)
    arrays = [np.asarray(a) for a in make_scene(n, rng, **kw)[:5]]
    jprep = jrc.preprocess(*arrays, jnp.ones(n, bool), cam.params(), sh_degree=0)
    tcam = TCamera(uid=0, colmap_id=0, image_name="t", R=cam.R, T=cam.T, fovx=cam.fovx,
                   fovy=cam.fovy, width=width, height=height)
    tprep = trc.preprocess(*[torch.tensor(a) for a in arrays],
                           torch.ones(n, dtype=torch.bool), tcam.params("cpu"),
                           sh_degree=0)
    return cam, tcam, jprep, tprep, arrays


def test_plain_k3_matches_jax_seeded_tiled_and_dense():
    """rasterize_tiled(init_state=...) on the CPU (plain K3) against JAX
    rasterize_tiled(init_state=..., interpret=True, return_raw=True) and
    the JAX dense seeded compositor, every raw channel at the
    modulo-binning tolerances."""
    W, H = 64, 32
    _, _, jprep, tprep, _ = _scenes(30, W, H)
    n = tprep.depth.shape[0]
    seed = _seed(W, H)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    before = (counter("raster_fwd"), counter("raster_fwd_seeded"))
    out = rt.rasterize_tiled(tprep, torch.zeros(n, 2), torch.tensor(bg), W, H,
                             init_state={k: torch.tensor(v) for k, v in seed.items()},
                             return_raw=True)
    assert (counter("raster_fwd"), counter("raster_fwd_seeded")) == before     # CPU: no launch
    assert set(out["raw"]) == set(RAW) | {"min_test"}
    assert not out["raw"]["min_test"].requires_grad
    jseed = {k: jnp.asarray(v) for k, v in seed.items()}
    refs = [j_tiled(jprep, jnp.zeros((n, 2)), jnp.asarray(bg), W, H, interpret=True,
                    init_state=jseed, return_raw=True),
            j_dense(jprep, jnp.zeros((n, 2)), jnp.asarray(bg), W, H, chunk=8,
                    init_state=jseed, return_raw=True)]
    for ref in refs:
        _assert_close_modulo_binning({k: out[k].numpy() for k in ("image", "allmap")},
                                     ref)
        for k in ("T", "M1", "M2"):
            np.testing.assert_allclose(out["raw"][k].numpy(), np.asarray(ref["raw"][k]),
                                       atol=3e-2, err_msg=k)
    # the tiled paths agree on the min test transmittance where a pixel
    # was tested at all (the dense path starts no pixel done: T0 >= 0.3)
    mt, jmt = out["raw"]["min_test"].numpy(), np.asarray(refs[0]["raw"]["min_test"])
    tested = (mt < 2.0) & (jmt < 2.0)
    assert tested.mean() > 0.5
    np.testing.assert_allclose(mt[tested], jmt[tested], atol=3e-2)


@pytest.mark.parametrize("scene", ["small", "ragged"])
def test_near_half_then_seeded_far_half_is_the_full_composite(scene):
    """Compositing the far half of the depth-sorted splats from the near
    half's final (T, M1, M2) reproduces the full composite (the JAX
    test_init_state_segment_compositing_matches_full, atol 1e-4), on the
    plain K1/K3 and on the dense compositor. (Where a pixel terminates in
    the near half, its frozen T restarts the far half: the sharded fold's
    min-test carry handles that, tested in test_torch_parallel.py.)"""
    prep, W, H = _prep(scene)
    n = prep.depth.shape[0]
    order = torch.argsort(torch.where(prep.valid, prep.depth, torch.inf), stable=True)
    near = torch.zeros(n, dtype=torch.bool)
    near[order[:n // 2]] = True

    def subset(mask):
        return prep._replace(valid=prep.valid & mask,
                             opacity=prep.opacity * mask.to(torch.float32))

    zeros, bg = torch.zeros(n, 2), torch.zeros(3)
    for raster in (lambda p, init: rt.rasterize_tiled(p, zeros, bg, W, H, init_state=init,
                                                      return_raw=True)["raw"],
                   lambda p, init: t_dense(p, zeros, bg, W, H, chunk=8, init_state=init,
                                           return_raw=True)["raw"]):
        full = raster(prep, None)
        p1 = raster(subset(near), None)
        p2 = raster(subset(~near), {k: p1[k] for k in ("T", "M1", "M2")})
        merged = {k: p1[k] + p2[k] for k in ("color", "normal", "depth", "alpha", "dist")}
        merged["T"] = p2["T"]
        merged["median"] = torch.where(p2["median"] > 0, p2["median"], p1["median"])
        for k, v in merged.items():
            np.testing.assert_allclose(v.numpy(), full[k].numpy(), atol=1e-4, err_msg=k)


def _column_scale_err(got, ref):
    scale = ref.abs().amax(dim=0, keepdim=True) + 1e-30
    return ((got - ref).abs() / scale).max().item()


@pytest.mark.parametrize("scene", ["small", "overlap", "ragged", "deep"])
@pytest.mark.parametrize("need", [(True, True), (False, False)])
def test_plain_k4_matches_autograd_of_plain_k3(scene, need):
    """composite_tiles_bwd(init=...) (plain K4) + the per-splat reduction
    against autograd through composite_tiles_plain(init=...), for random
    cotangents on the 13 channels that carry one (the distortion and median
    cotangents zero when the backward leaves those terms out): blob rows and
    the seed's gradient, within 2e-5 of each column's scale. The seed has
    transmittance 0 on a band of pixels, as strata past a termination do."""
    prep, W, H = _prep(scene)
    blob, ids, ranges = _binned(prep, W, H)
    tx, ty = rt.tile_grid(W, H)
    init = _init_maps(_seed(W, H, seed=3), W, H)
    init[0, :, :5] = 0.0
    blob = blob.detach().clone().requires_grad_(True)
    init = init.requires_grad_(True)
    fb, ints = rt.composite_tiles_plain(blob, ids, ranges, W, H, init=init)
    rng = np.random.default_rng(5)
    ct = torch.zeros((rt.CT_SEEDED,) + fb.shape[1:])
    ct[:, :H, :W] = torch.tensor(rng.normal(size=(rt.CT_SEEDED, H, W)).astype(np.float32))
    need_dist, need_med = need
    if not need_dist:
        ct[rt.FB_CHANNELS.index("dist")] = 0.0
    if not need_med:
        ct[rt.FB_CHANNELS.index("med")] = 0.0
    (fb[:rt.CT_SEEDED] * ct).sum().backward()
    ref_blob, ref_gi = blob.grad.clone(), init.grad.clone()
    ref_blob[-1] = 0.0
    before = counter("raster_bwd_seeded")
    rows, gi = rt.composite_tiles_bwd(blob.detach(), ids, ranges, fb.detach(), ints, ct,
                                      W, H, need_dist, need_med, init=init.detach())
    assert counter("raster_bwd_seeded") == before
    got = rt.grad_reduce(rows, rt.binning(prep, tx, ty), ints)
    assert _column_scale_err(got, ref_blob) <= 2e-5
    # the seed gradient per pixel, against each channel's scale (pixels past
    # the image edge carry no cotangent). Where T0 = 0, K4 gives gT0 = 0 by
    # its guarded division, as the TPU kernel does, while autograd gives dT
    # (the frozen T is T0); the fold masks the seed there, so it is left out
    live = torch.ones((3, H, W), dtype=torch.bool)
    live[0, :, :5] = False
    ref_gi = ref_gi[:, :H, :W]
    scale = torch.where(live, ref_gi.abs(), 0.0).amax(dim=(1, 2), keepdim=True) + 1e-30
    assert ((gi[:, :H, :W] - ref_gi).abs() / scale)[live].max().item() <= 2e-5
    assert torch.all(gi[0, :H, :5] == 0.0)


def test_seeded_gradients_match_jax_dense_autodiff():
    """The port's tiled seeded core (plain K3/K4) against autodiff of the
    JAX dense seeded compositor (the JAX test_seeded_gradients_match_dense,
    32x32, 12 splats): gradients of the splats and of the T0/M1_0/M2_0
    seed, with cotangents on the raw T/M1/M2 outputs, at atol 3e-3 x scale
    and rtol 2e-2."""
    W = H = 32
    n = 12
    cam, tcam, _, _, arrays = _scenes(n, W, H, seed=1, scale=0.25)
    xyz, scales, quats, opac, shs = arrays
    seed = _seed(W, H)
    target = np.random.default_rng(2).random((3, H, W)).astype(np.float32)

    def loss(np_, out, target):
        img, am, raw = out["image"], out["allmap"], out["raw"]
        return (np_.sum((img - target) ** 2) + 0.05 * np_.sum(am[6])
                + 0.01 * np_.sum(am[0]) + 0.01 * np_.sum(am[2:5] ** 2)
                + 0.02 * np_.sum(am[5]) + 0.01 * np_.sum(am[1])
                + 0.03 * np_.sum(raw["T"] ** 2) + 0.02 * np_.sum(raw["M1"] ** 2)
                + 0.01 * np_.sum(raw["M2"]))

    def jloss(xyz, scales, opac, means2d, T0, M1_0, M2_0):
        prep = jrc.preprocess(xyz, scales, quats, opac, shs, jnp.ones(n, bool),
                              cam.params(), sh_degree=0)
        return loss(jnp, j_dense(prep, means2d, jnp.zeros(3), W, H, chunk=8,
                                 init_state={"T": T0, "M1": M1_0, "M2": M2_0},
                                 return_raw=True), jnp.asarray(target))

    jargs = (xyz, scales, opac, np.zeros((n, 2), np.float32), seed["T"], seed["M1"],
             seed["M2"])
    jargs = tuple(jnp.asarray(a) for a in jargs)
    l_ref = float(jloss(*jargs))
    g_ref = jax.grad(jloss, argnums=tuple(range(7)))(*jargs)

    targs = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in jargs]
    t_xyz, t_scales, t_opac, t_m2d, T0, M1_0, M2_0 = targs
    prep = trc.preprocess(t_xyz, t_scales, torch.tensor(quats), t_opac, torch.tensor(shs),
                          torch.ones(n, dtype=torch.bool), tcam.params("cpu"), sh_degree=0)
    out = rt.rasterize_tiled(prep, t_m2d, torch.zeros(3), W, H,
                             init_state={"T": T0, "M1": M1_0, "M2": M2_0},
                             return_raw=True)
    total = loss(torch, out, torch.tensor(target))
    assert abs(total.item() - l_ref) < 1e-3 * max(1.0, abs(l_ref))
    total.backward()
    for name, t, gr in zip(("xyz", "scales", "opac", "means2d", "T0", "M1_0", "M2_0"),
                           targs, g_ref):
        gr = np.asarray(gr)
        np.testing.assert_allclose(t.grad.numpy(), gr, atol=3e-3 * (np.abs(gr).max() + 1e-6),
                                   rtol=2e-2, err_msg=f"seeded grad {name}")
