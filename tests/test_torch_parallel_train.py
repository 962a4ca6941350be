"""Training over D = 4 device slots on the CPU
(gaussmart_tpu_torch/parallel/sharding.py) against the JAX package's
training steps over make_mesh(4) of the 8 virtual CPU devices: one
Gaussian-sharded step with each inner compositor and one camera
data-parallel step, on test_parallel.py's scene at 32x24, each also with
the DINO term (the JAX trainer's against the port's, the same random
tower); and the trainer with --n_devices 4 --parallel_mode mp
through a densify pass."""
import csv
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussmart_tpu.config import OptimizationParams as JOpt
from gaussmart_tpu.optim import init_adam as j_init_adam
from gaussmart_tpu.parallel import sharding as jsh
from gaussmart_tpu.train import _build_dino_fn as j_build_dino_fn
from gaussmart_tpu_torch import train as ttrain
from gaussmart_tpu_torch.config import (ModelParams, OptimizationParams,
                                        PipelineParams)
from gaussmart_tpu_torch.io.ply import store_point_cloud
from gaussmart_tpu_torch.optim import init_adam
from gaussmart_tpu_torch.parallel import sharding as tsh
from gaussmart_tpu_torch.semantics.dino import WEIGHT_ENV

from test_torch_parallel import D, H, W, _camera, _np, _scene, meshes  # noqa: F401

torch.set_num_threads(1)


def _step_inputs(seed=4, views=1):
    js, ts, _, _ = _scene("spread", seed=seed)
    rng = np.random.default_rng(seed)
    gts = rng.random((views, 3, H, W)).astype(np.float32)
    cams = [_camera(i) for i in range(views)]
    return js, ts, cams, gts


def _assert_chunks(chunks, mesh, rows):
    """Per-slot chunks of `rows` rows, chunk i on slot i's device."""
    assert len(chunks) == mesh.size
    for i, c in enumerate(chunks):
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                assert x.shape[0] == rows and x.device == mesh.devices[i], f.name


@pytest.fixture(scope="module")
def jax_mp_step():
    """One JAX Gaussian-sharded step (dense inner compositor) on
    make_mesh(4), from the state and target of _step_inputs()."""
    js, _, cams, gts = _step_inputs()
    jmesh = jsh.make_mesh(D)
    step = jsh.make_mp_train_step(JOpt(), jmesh, sh_degree=0, white_background=False)
    ja = j_init_adam(js.params)
    out = step(*jsh.shard_state(js.params, ja, js.aux, jmesh), cams[0][0].params(),
               jnp.asarray(gts[0]), jnp.asarray(1, jnp.int32))
    return jax.tree.map(np.asarray, out[:4])


# (total, params atol x max(1, scale), mu.xyz (atol, rtol), grad_accum
# (atol, rtol)): test_parallel.py's mp step against the single-chip step,
# and its pallas mp step against the dense one
MP_TOLS = {"gaussian_sharded": (1e-4, 5e-4, (1e-4, 0.0), (1e-4, 0.05)),
           "gaussian_sharded_pallas": (1e-4, 2e-4, (2e-3, 0.05), (1e-4, 0.05))}


@pytest.mark.parametrize("backend", ["gaussian_sharded", "gaussian_sharded_pallas"])
def test_mp_train_step_matches_jax(meshes, jax_mp_step, backend):
    """make_mp_train_step on 4 slots against the JAX step on make_mesh(4):
    the loss, params, Adam moments and densify statistics after one step,
    at test_parallel.py's tolerances. The outputs stay per-slot chunks of
    capacity/4 rows on their slots' devices (the memory-scaling contract)."""
    _, tmesh = meshes
    _, ts, cams, gts = _step_inputs()
    jp, ja, jx, jm = jax_mp_step
    step = tsh.make_mp_train_step(OptimizationParams(), tmesh, sh_degree=0,
                                  white_background=False, backend=backend)
    p, a, x = tsh.shard_state(ts.params, init_adam(ts.params), ts.aux, tmesh)
    p, a, x, m, it = step(p, a, x, cams[0][1].params("cpu"), torch.tensor(gts[0]), 1)
    assert it == 2
    rows = ts.capacity // D
    _assert_chunks(p, tmesh, rows)
    _assert_chunks([c.mu for c in a], tmesh, rows)
    _assert_chunks(x, tmesh, rows)
    p, a, x = tsh.gather_state(p, a, x, "cpu")
    t_tol, p_tol, mu_tol, acc_tol = MP_TOLS[backend]
    np.testing.assert_allclose(m.total.item(), float(jm.total), atol=t_tol)
    for name in ("xyz", "opacity", "scaling", "features_dc"):
        ref = getattr(jp, name)
        np.testing.assert_allclose(_np(getattr(p, name)), ref,
                                   atol=p_tol * max(1.0, np.abs(ref).max()), err_msg=name)
    np.testing.assert_allclose(_np(a.mu.xyz), ja.mu.xyz, atol=mu_tol[0], rtol=mu_tol[1])
    np.testing.assert_allclose(_np(x.grad_accum), jx.grad_accum, atol=acc_tol[0],
                               rtol=acc_tol[1])
    np.testing.assert_array_equal(_np(x.denom), jx.denom)


def test_dp_train_step_matches_jax(meshes):
    """make_dp_train_step on 4 slots, one view each, against the JAX step
    on make_mesh(4) (dense compositor): loss, params, Adam moments and the
    densify statistics summed over the 4 views, at test_parallel.py's
    step tolerances; the outputs are replicas, one per slot."""
    jmesh, tmesh = meshes
    js, ts, cams, gts = _step_inputs(seed=5, views=D)
    jstep = jsh.make_dp_train_step(JOpt(), jmesh, sh_degree=0, white_background=False,
                                   backend="dense", spatial_lr_scale=1.0)
    batched = jsh.BatchedCameras.stack([c[0].params() for c in cams])
    jp, ja, jx, jm, _ = jstep(*jsh.replicate((js.params, j_init_adam(js.params), js.aux),
                                             jmesh),
                              *jsh.shard_batch((batched, jnp.asarray(gts)), jmesh),
                              jnp.asarray(1, jnp.int32))
    tstep = tsh.make_dp_train_step(OptimizationParams(), tmesh, sh_degree=0,
                                   white_background=False, backend="dense",
                                   spatial_lr_scale=1.0)
    tb = tsh.BatchedCameras.stack([c[1].params("cpu") for c in cams])
    p, a, x, m, it = tstep(tsh.replicate(ts.params, tmesh),
                           tsh.replicate(init_adam(ts.params), tmesh),
                           tsh.replicate(ts.aux, tmesh), tsh.shard_batch(tb, tmesh),
                           tsh.shard_batch(torch.tensor(gts), tmesh), 1)
    assert it == 2 and len(p) == len(a) == len(x) == D
    assert all(r.xyz.device == d for r, d in zip(p, tmesh.devices))
    np.testing.assert_allclose(m.total.item(), float(jm.total), atol=1e-4)
    for name in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(_np(getattr(p[0], name)), ref,
                                   atol=5e-4 * max(1.0, np.abs(ref).max()), err_msg=name)
    np.testing.assert_allclose(_np(a[0].mu.xyz), np.asarray(ja.mu.xyz), atol=1e-4)
    np.testing.assert_allclose(_np(x[0].grad_accum), np.asarray(jx.grad_accum),
                               atol=1e-4, rtol=0.05)
    np.testing.assert_array_equal(_np(x[0].denom), np.asarray(jx.denom))
    assert _np(x[0].denom).max() > 1.0          # seen from several of the views
    np.testing.assert_allclose(_np(x[0].max_radii2d), np.asarray(jx.max_radii2d))


@pytest.fixture(scope="module")
def dino_fns():
    """(JAX dino_fn, port dino_fn): each trainer's _build_dino_fn with
    GAUSSMART_DINO_WEIGHTS=random (the same random tower), fixed mode,
    lambda 0.05, open from iteration 1."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(WEIGHT_ENV, "random")
        return (j_build_dino_fn(0.05, 0, "fixed"),
                ttrain._build_dino_fn(0.05, 0, "fixed", "cpu"))


def test_mp_train_step_with_the_dino_term_matches_jax(meshes, dino_fns):
    """make_mp_train_step (dense strata) with the DINO term, taken on slot
    0, against the JAX step with its term on make_mesh(4): the term, the
    loss, params, Adam moments and densify statistics after one step, at
    the dense mp step's tolerances above."""
    jmesh, tmesh = meshes
    js, ts, cams, gts = _step_inputs()
    jfn, tfn = dino_fns
    jstep = jsh.make_mp_train_step(JOpt(), jmesh, sh_degree=0, white_background=False,
                                   dino_fn=jfn)
    jp, ja, jx, jm, _ = jstep(*jsh.shard_state(js.params, j_init_adam(js.params), js.aux,
                                               jmesh),
                              cams[0][0].params(), jnp.asarray(gts[0]),
                              jnp.asarray(1, jnp.int32))
    step = tsh.make_mp_train_step(OptimizationParams(), tmesh, sh_degree=0,
                                  white_background=False, dino_fn=tfn)
    p, a, x = tsh.shard_state(ts.params, init_adam(ts.params), ts.aux, tmesh)
    p, a, x, m, _ = step(p, a, x, cams[0][1].params("cpu"), torch.tensor(gts[0]), 1)
    p, a, x = tsh.gather_state(p, a, x, "cpu")
    t_tol, p_tol, mu_tol, acc_tol = MP_TOLS["gaussian_sharded"]
    assert m.dino.item() > 0
    np.testing.assert_allclose(m.dino.item(), float(jm.dino), rtol=1e-4)
    np.testing.assert_allclose(m.total.item(), float(jm.total), atol=t_tol)
    for name in ("xyz", "opacity", "scaling", "features_dc"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(_np(getattr(p, name)), ref,
                                   atol=p_tol * max(1.0, np.abs(ref).max()), err_msg=name)
    np.testing.assert_allclose(_np(a.mu.xyz), np.asarray(ja.mu.xyz), atol=mu_tol[0],
                               rtol=mu_tol[1])
    np.testing.assert_allclose(_np(x.grad_accum), np.asarray(jx.grad_accum),
                               atol=acc_tol[0], rtol=acc_tol[1])
    np.testing.assert_array_equal(_np(x.denom), np.asarray(jx.denom))


def test_dp_train_step_with_the_dino_term_matches_jax(meshes, dino_fns):
    """make_dp_train_step with the DINO term, one view and one tower call
    per slot, against the JAX step with its term on make_mesh(4): the
    mean term, the loss, params, Adam moments and the summed densify
    statistics, at the dp step's tolerances above."""
    jmesh, tmesh = meshes
    js, ts, cams, gts = _step_inputs(seed=5, views=D)
    jfn, tfn = dino_fns
    jstep = jsh.make_dp_train_step(JOpt(), jmesh, sh_degree=0, white_background=False,
                                   backend="dense", spatial_lr_scale=1.0, dino_fn=jfn)
    batched = jsh.BatchedCameras.stack([c[0].params() for c in cams])
    jp, ja, jx, jm, _ = jstep(*jsh.replicate((js.params, j_init_adam(js.params), js.aux),
                                             jmesh),
                              *jsh.shard_batch((batched, jnp.asarray(gts)), jmesh),
                              jnp.asarray(1, jnp.int32))
    tstep = tsh.make_dp_train_step(OptimizationParams(), tmesh, sh_degree=0,
                                   white_background=False, backend="dense",
                                   spatial_lr_scale=1.0, dino_fn=tfn)
    tb = tsh.BatchedCameras.stack([c[1].params("cpu") for c in cams])
    p, a, x, m, _ = tstep(tsh.replicate(ts.params, tmesh),
                          tsh.replicate(init_adam(ts.params), tmesh),
                          tsh.replicate(ts.aux, tmesh), tsh.shard_batch(tb, tmesh),
                          tsh.shard_batch(torch.tensor(gts), tmesh), 1)
    assert m.dino.item() > 0
    np.testing.assert_allclose(m.dino.item(), float(jm.dino), rtol=1e-4)
    np.testing.assert_allclose(m.total.item(), float(jm.total), atol=1e-4)
    for name in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        ref = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(_np(getattr(p[0], name)), ref,
                                   atol=5e-4 * max(1.0, np.abs(ref).max()), err_msg=name)
    np.testing.assert_allclose(_np(a[0].mu.xyz), np.asarray(ja.mu.xyz), atol=1e-4)
    np.testing.assert_allclose(_np(x[0].grad_accum), np.asarray(jx.grad_accum),
                               atol=1e-4, rtol=0.05)
    np.testing.assert_array_equal(_np(x[0].denom), np.asarray(jx.denom))


def _blender_scene(src, rng):
    """test_parallel.py's driver scene: 8 views of a red square, 24x24."""
    os.makedirs(src / "train")
    frames = []
    for i in range(8):
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


def test_mp_training_with_densify_via_the_driver(tmp_path):
    """training(n_devices=4, parallel_mode="mp", device="cpu") through the
    real driver (test_parallel.py's 25 iterations, densify at 10 and 20),
    the strata composited by the seeded tiled core: an arena of 68 rows
    overflows at the first densify and grows to a multiple of the 4 slots;
    eval renders through the sharded fold; the snapshot and checkpoint
    come from the gathered state."""
    rng = np.random.default_rng(0)
    _blender_scene(tmp_path / "scene", rng)
    out = tmp_path / "out_mp"
    dataset = ModelParams(source_path=str(tmp_path / "scene"), model_path=str(out),
                          white_background=True, sh_degree=1, resolution=1)
    opt = OptimizationParams(iterations=25, densify_from_iter=5, densify_until_iter=22,
                             densification_interval=10, opacity_reset_interval=40,
                             opacity_cull=0.005, position_lr_max_steps=25)
    state, adam = ttrain.training(
        dataset, opt, PipelineParams(), testing_iterations=[25], saving_iterations=[25],
        checkpoint_iterations=[25], use_dino_loss=False, quiet=True, capacity=68,
        tensorboard=False, device="cpu", n_devices=D, parallel_mode="mp")
    assert int(state.n_active) > 0
    assert state.capacity > 68 and state.capacity % D == 0
    assert state.params.xyz.shape[0] == adam.mu.xyz.shape[0] == state.capacity
    for name in ("point_cloud/iteration_25/point_cloud.ply", "chkpnt25.npz",
                 "eval_25.json"):
        assert (out / name).exists(), name
    with open(out / "train_stats.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["iteration"]) for r in rows] == [10, 20, 25]
    with open(out / "eval_25.json") as f:
        ev = json.load(f)
    assert np.isfinite(ev["train"]["psnr"])
