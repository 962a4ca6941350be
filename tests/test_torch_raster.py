"""gaussmart_tpu_torch rasterizer vs the JAX package at the shapes of
tests/test_raster_pallas.py (64x32, ~30 splats): preprocess fields, the
dense forward, the per-tile entry sets, and the tiled forward (its plain
version here; the CUDA kernel on the card) against JAX rasterize_tiled in
interpret mode and against the dense oracle."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaussmart_tpu.render import raster_common as jrc
from gaussmart_tpu.render import raster_pallas as jrp
from gaussmart_tpu.render.api import render_arrays as j_render_arrays
from gaussmart_tpu.render.raster_dense import rasterize_pixels as j_dense
from gaussmart_tpu_torch.cameras import Camera as TCamera
from gaussmart_tpu_torch.logging_utils import counter
from gaussmart_tpu_torch.render import raster_common as trc
from gaussmart_tpu_torch.render import raster_tiled as rt
from gaussmart_tpu_torch.render.api import render_arrays as t_render_arrays
from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels as t_dense

from test_raster import make_camera, make_scene
from test_raster_pallas import _assert_close_modulo_binning

torch.set_num_threads(1)

SCENES = {
    "base": dict(n=30),
    # heavy overlap: early termination fires
    "overlap": dict(n=60, spread=0.15, scale=0.4, opacity=0.95),
}


def _scene(name, width=64, height=32):
    kw = dict(SCENES[name])
    n = kw.pop("n")
    rng = np.random.default_rng(0)
    cam = make_camera(width=width, height=height)
    xyz, scales, quats, opac, shs, _ = make_scene(n, rng, **kw)
    arrays = [np.asarray(a) for a in (xyz, scales, quats, opac, shs)]
    jprep = jrc.preprocess(xyz, scales, quats, opac, shs, jnp.ones(n, bool),
                           cam.params(), sh_degree=0)
    tcam = TCamera(uid=0, colmap_id=0, image_name="t", R=cam.R, T=cam.T,
                   fovx=cam.fovx, fovy=cam.fovy, width=width, height=height)
    tprep = trc.preprocess(*[torch.tensor(a) for a in arrays],
                           torch.ones(n, dtype=torch.bool), tcam.params("cpu"),
                           sh_degree=0)
    return cam, tcam, jprep, tprep, arrays


def _np(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


@pytest.mark.parametrize("scene", list(SCENES))
def test_preprocess_matches_jax(scene):
    _, _, jprep, tprep, _ = _scene(scene)
    for field in jrc.Preprocessed._fields:
        a, b = np.asarray(getattr(jprep, field)), getattr(tprep, field).numpy()
        assert a.shape == b.shape, field
        if field in ("valid", "rx", "ry"):
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            # relative to the field's scale: entries near zero carry the
            # absolute noise of their larger neighbours
            rel = 1e-4 if field == "ell" else 1e-5
            np.testing.assert_allclose(b, a, rtol=rel, atol=rel * np.abs(a).max(),
                                       err_msg=field)


@pytest.mark.parametrize("scene", list(SCENES))
def test_dense_forward_matches_jax(scene):
    cam, _, jprep, tprep, _ = _scene(scene)
    n = tprep.depth.shape[0]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = _np(j_dense(jprep, jnp.zeros((n, 2)), jnp.asarray(bg), 64, 32, chunk=8))
    out = _np(t_dense(tprep, torch.zeros(n, 2), torch.tensor(bg), 64, 32, chunk=8))
    for k in ("image", "allmap"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("scene", list(SCENES))
def test_binning_entry_sets_match_jax(scene):
    """Per-tile (splat) sets equal JAX _binning's inside the port's grid
    (the JAX grid is padded to 32-px groups), and each tile's list is in
    exact depth order."""
    width, height = 72, 40                      # JAX grid 6x4 tiles, port 5x3
    _, _, jprep, tprep, _ = _scene(scene, width, height)
    tx, ty = rt.tile_grid(width, height)
    jtx, jty = 2 * -(-width // 32), 2 * -(-height // 32)
    pidx, starts, counts, _, n_dropped, _ = jrp._binning(jprep, jtx, jty, 64,
                                                         work_mult=12)
    assert int(n_dropped) == 0
    pidx, starts, counts = map(np.asarray, (pidx, starts, counts))
    ids, ranges, conics = rt.binning(tprep, tx, ty)[:3]
    assert ranges.shape == (tx * ty, 2) and ranges.dtype == torch.int32
    assert conics.shape == (tprep.depth.shape[0] + 1, rt.FC)
    depth = tprep.depth.numpy()
    total = 0
    for y in range(ty):
        for x in range(tx):
            jt, t = y * jtx + x, y * tx + x
            s, e = ranges[t].tolist()
            mine = ids[s:e].numpy()
            assert set(mine.tolist()) == set(pidx[starts[jt]:starts[jt] + counts[jt]].tolist())
            assert len(set(mine.tolist())) == len(mine)
            assert np.all(np.diff(depth[mine]) >= 0)
            total += e - s
    assert total > 0 and int(ranges[-1, 1]) == total


def test_tiled_matches_jax_tiled_and_dense():
    """The port's tiled forward on the CPU (composite_tiles_plain) against
    JAX rasterize_tiled(interpret=True) and JAX rasterize_pixels, with the
    thresholds the JAX tests hold the Pallas kernel to."""
    cam, _, jprep, tprep, _ = _scene("base")
    n = tprep.depth.shape[0]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    before = counter("raster_fwd")
    out = _np(rt.rasterize_tiled(tprep, torch.zeros(n, 2), torch.tensor(bg), 64, 32))
    assert counter("raster_fwd") == before            # CPU tensors never launch K1
    assert out["image"].shape == (3, 32, 64) and out["allmap"].shape == (7, 32, 64)
    assert int(out["n_dropped"]) == 0
    j_tiled = _np(jrp.rasterize_tiled(jprep, jnp.zeros((n, 2)), jnp.asarray(bg),
                                      64, 32, interpret=True))
    _assert_close_modulo_binning(out, j_tiled)
    j_ref = _np(j_dense(jprep, jnp.zeros((n, 2)), jnp.asarray(bg), 64, 32, chunk=8))
    _assert_close_modulo_binning(out, j_ref)


def test_heavy_overlap_terminates_early_and_drops_nothing():
    """Early termination fires on the heavy-overlap scene, the tiled output
    still matches the JAX dense oracle, and nothing is dropped (the port's
    binning is exact, so no duplicate budget exists to escalate)."""
    cam, _, jprep, tprep, _ = _scene("overlap")
    n = tprep.depth.shape[0]
    out = rt.rasterize_tiled(tprep, torch.zeros(n, 2), torch.zeros(3), 64, 32)
    assert int(out["n_dropped"]) == 0
    tx, ty = rt.tile_grid(64, 32)
    blob = rt.build_blob(tprep, torch.zeros(n, 2), 64, 32)
    ids, ranges, _ = rt.binning(tprep, tx, ty)[:3]
    fb, ints = rt.composite_tiles_plain(blob, ids, ranges, 64, 32)
    mt = fb[rt.FB_CHANNELS.index("mt")]
    ended = mt < trc.T_EPS
    assert ended.float().mean() > 0.1
    # a terminated pixel stopped before its tile's list ran out
    counts = (ranges[:, 1] - ranges[:, 0]).reshape(ty, 1, tx, 1).expand(ty, 16, tx, 16)
    assert (ints[0][ended] < counts.reshape(32, 64)[ended]).all()
    ref = _np(j_dense(jprep, jnp.zeros((n, 2)), jnp.zeros(3), 64, 32, chunk=8))
    _assert_close_modulo_binning(_np(out), ref)


def test_render_arrays_matches_jax_and_checks_backend():
    cam, tcam, jprep, tprep, arrays = _scene("base")
    xyz, scales, quats, opac, shs = arrays
    n = xyz.shape[0]
    common = dict(sh_degree=0, depth_ratio=0.3)
    ref = _np(j_render_arrays(cam.params(), xyz=jnp.asarray(xyz), scaling=jnp.asarray(scales),
                              rotation=jnp.asarray(quats), opacity=jnp.asarray(opac),
                              features=jnp.asarray(shs), active=jnp.ones(n, bool),
                              bg_color=jnp.zeros(3), backend="dense", chunk=8, **common))
    kw = dict(xyz=torch.tensor(xyz), scaling=torch.tensor(scales),
              rotation=torch.tensor(quats), opacity=torch.tensor(opac),
              features=torch.tensor(shs), active=torch.ones(n, dtype=torch.bool),
              bg_color=torch.zeros(3), **common)
    dense = _np(t_render_arrays(tcam.params("cpu"), backend="dense", chunk=8, **kw))
    assert set(dense) == set(ref)
    for k in ("render", "rend_alpha", "rend_normal", "rend_dist", "surf_depth",
              "surf_normal", "radii", "visibility_filter"):
        np.testing.assert_allclose(dense[k], ref[k], atol=1e-4, rtol=1e-4, err_msg=k)
    tiled = _np(t_render_arrays(tcam.params("cpu"), backend="auto", **kw))
    np.testing.assert_allclose(tiled["render"], ref["render"], atol=6e-3)
    np.testing.assert_allclose(tiled["rend_alpha"], ref["rend_alpha"], atol=3e-2)
    for backend in ("gaussian_sharded", "gaussian_sharded_pallas", "row_sharded"):
        with pytest.raises(ValueError, match="needs mesh"):
            t_render_arrays(tcam.params("cpu"), backend=backend, **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        t_render_arrays(tcam.params("cpu"), backend="tpu", **kw)
