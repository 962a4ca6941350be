"""The serving slice end to end: a seeded trained-model directory rendered by
the JAX GaussianExtractor (dense backend) and by the port's render_cli on
the CPU, compared image by image; the port imports neither jax nor
gaussmart_tpu; the CLI's refusals."""
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussmart_tpu import trajectory as jtraj
from gaussmart_tpu.config import ModelParams as JModelParams
from gaussmart_tpu.io.gaussian_ply import save_gaussian_ply as j_save_ply
from gaussmart_tpu.io.ply import store_point_cloud
from gaussmart_tpu.mesh.extract import GaussianExtractor as JExtractor
from gaussmart_tpu.models import gaussians as jg
from gaussmart_tpu.scene import Scene as JScene
from gaussmart_tpu_torch import render_cli
from gaussmart_tpu_torch import trajectory as ttraj
from gaussmart_tpu_torch.config import ModelParams
from gaussmart_tpu_torch.scene import Scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITER = 7
W, H = 64, 48


def _model_dir(root, seed=0, n=150, capacity=256):
    """Blender scene (3 train views + 1 test view, 64x48 RGBA PNGs) and a
    trained snapshot of n active splats of SH degree 1, written by the JAX
    package, with its cfg_args.json."""
    rng = np.random.default_rng(seed)
    src = os.path.join(root, "scene")
    os.makedirs(os.path.join(src, "train"))
    frames = []
    for i in range(4):
        img = np.zeros((H, W, 4), np.uint8)
        img[10:38, 12:52, 1] = 200
        img[:, :, 0] = 40 * i
        img[:, :, 3] = 255
        Image.fromarray(img, "RGBA").save(os.path.join(src, "train", f"r_{i}.png"))
        ang = 0.15 * i
        c, s = np.cos(ang), np.sin(ang)
        c2w = np.array([[c, 0, s, 0.1 * i], [0, 1, 0, 0],
                        [-s, 0, c, 3.0], [0, 0, 0, 1.0]])
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    for split, fr in (("train", frames[:3]), ("test", frames[3:])):
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": fr}, f)
    store_point_cloud(os.path.join(src, "points3d.ply"),
                      rng.uniform(-0.4, 0.4, (48, 3)),
                      rng.integers(0, 255, (48, 3)).astype(np.float64))

    k = 4
    op = np.where(rng.random(capacity) < 0.6, rng.uniform(0.7, 0.99, capacity),
                  rng.uniform(0.05, 0.3, capacity))
    params = jg.GaussianParams(
        xyz=jnp.asarray(rng.uniform(-0.5, 0.5, (capacity, 3)), jnp.float32),
        features_dc=jnp.asarray(rng.normal(0, 1, (capacity, 1, 3)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(0, 0.2, (capacity, k - 1, 3)), jnp.float32),
        scaling=jnp.asarray(np.log(rng.uniform(0.03, 0.12, (capacity, 2))), jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)), jnp.float32),
        opacity=jnp.asarray(np.log(op / (1 - op))[:, None], jnp.float32))
    aux = jg.GaussianAux(active=jnp.arange(capacity) < n,
                         segments=jnp.zeros(capacity, jnp.int32),
                         max_radii2d=jnp.zeros(capacity), grad_accum=jnp.zeros(capacity),
                         denom=jnp.zeros(capacity))
    state = jg.GaussianState(params=params, aux=aux, max_sh_degree=1,
                             active_sh_degree=1, spatial_lr_scale=1.0)
    model = os.path.join(root, "model")
    j_save_ply(os.path.join(model, "point_cloud", f"iteration_{ITER}",
                            "point_cloud.ply"), state)
    cfg = dict(source_path=src, model_path=model, white_background=True,
               sh_degree=1, resolution=1, eval=True, images="images",
               backend="auto", depth_ratio=0.0)
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump(cfg, f)
    return model, cfg


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int32)


def test_cli_renders_match_jax_extractor(tmp_path):
    model, cfg = _model_dir(str(tmp_path))
    render_cli.main(["-m", model, "--skip_mesh", "--device", "cpu"])

    dataset = JModelParams(**{k: cfg[k] for k in ("source_path", "model_path",
                                                  "white_background", "sh_degree",
                                                  "resolution", "eval", "images")})
    scene = JScene(dataset, load_iteration=-1, shuffle=False)
    ex = JExtractor(scene.gaussians, bg_color=[1, 1, 1], backend="dense")
    jax_root = tmp_path / "jax"
    for split, cams in (("train", scene.get_train_cameras()),
                        ("test", scene.get_test_cameras())):
        ex.reconstruction(cams)
        ex.export_image(str(jax_root / split))
        ours = os.path.join(model, split, f"ours_{ITER}")
        for i in range(len(cams)):
            name = f"{i:05d}"
            ref_img = _png(jax_root / split / "renders" / f"{name}.png")
            img = _png(os.path.join(ours, "renders", f"{name}.png"))
            assert img.shape == ref_img.shape == (H, W, 3)
            assert np.abs(img - ref_img).max() <= 2, (split, name)
            np.testing.assert_array_equal(_png(os.path.join(ours, "gt", f"{name}.png")),
                                          _png(jax_root / split / "gt" / f"{name}.png"))
            with Image.open(jax_root / split / "vis" / f"depth_{name}.tiff") as im:
                ref_d = np.asarray(im)
            with Image.open(os.path.join(ours, "vis", f"depth_{name}.tiff")) as im:
                d = np.asarray(im)
            assert (np.abs(d - ref_d) <= 3e-2).mean() >= 0.995, (split, name)
            assert ref_d.max() > 1.0                      # the splats are in view
            normal = _png(os.path.join(ours, "vis", f"normal_{name}.png"))
            ref_n = _png(jax_root / split / "vis" / f"normal_{name}.png")
            assert (np.abs(normal - ref_n) <= 3).mean() >= 0.99


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port and chip_smoke.py, and running
    the CLI, leaves neither jax nor gaussmart_tpu in sys.modules."""
    model, _ = _model_dir(str(tmp_path), n=40)
    code = f"""
import importlib, pkgutil, sys
import gaussmart_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(gaussmart_tpu_torch.__path__, "gaussmart_tpu_torch."):
    importlib.import_module(m.name)
from gaussmart_tpu_torch import render_cli
render_cli.main(["-m", {model!r}, "--skip_mesh", "--device", "cpu", "--skip_test"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gaussmart_tpu"))
assert not bad, bad
print("CLEAN")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "CLEAN" in res.stdout
    assert os.path.exists(os.path.join(model, "train", f"ours_{ITER}", "renders",
                                       "00002.png"))


def test_cli_refuses_what_this_slice_does_not_serve(tmp_path, monkeypatch):
    model, cfg = _model_dir(str(tmp_path), n=10)
    with pytest.raises(NotImplementedError, match="TSDF"):
        render_cli.main(["-m", model, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-device"):
        render_cli.main(["-m", model, "--skip_mesh", "--device", "cpu",
                         "--n_devices", "2"])
    with pytest.raises(NotImplementedError, match="training slice"):
        Scene(ModelParams(source_path=cfg["source_path"], model_path=model))
    # no --device cpu and no CUDA: an error, never a silent CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_cli.main(["-m", model, "--skip_mesh"])
    assert not os.path.exists(os.path.join(model, "train"))


def test_trajectory_matches_jax(tmp_path):
    model, cfg = _model_dir(str(tmp_path), n=10)
    jcams = JScene(JModelParams(source_path=cfg["source_path"], model_path=model,
                                white_background=True, sh_degree=1),
                   load_iteration=ITER, shuffle=False).get_train_cameras()
    tcams = Scene(ModelParams(source_path=cfg["source_path"], model_path=model,
                              white_background=True, sh_degree=1),
                  load_iteration=ITER, shuffle=False, device="cpu").get_train_cameras()
    c_j, r_j = jtraj.estimate_bounding_sphere(jcams)
    c_t, r_t = ttraj.estimate_bounding_sphere(tcams)
    np.testing.assert_allclose(c_t, c_j, atol=1e-9)
    assert r_t == pytest.approx(r_j, rel=1e-12)
    for pj, pt in zip(jtraj.generate_path(jcams, n_frames=12),
                      ttraj.generate_path(tcams, n_frames=12)):
        np.testing.assert_allclose(pt.world_view, pj.world_view, atol=1e-6)
        assert (pt.width, pt.height) == (pj.width, pj.height)


def test_cli_render_path_writes_the_three_videos(tmp_path):
    """--render_path renders the 240-frame ellipse trajectory and writes
    the colour, depth and normal videos (cv2), as the JAX CLI does."""
    cv2 = pytest.importorskip("cv2")
    model, _ = _model_dir(str(tmp_path), n=10)
    render_cli.main(["-m", model, "--skip_mesh", "--device", "cpu",
                     "--render_path", "--skip_test"])
    traj = os.path.join(model, "traj", f"ours_{ITER}")
    assert os.path.exists(os.path.join(traj, "renders", "00239.png"))
    for name in ("render_traj.mp4", "depth_traj.mp4", "normal_traj.mp4"):
        cap = cv2.VideoCapture(os.path.join(traj, name))
        n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        assert n_frames == 240, (name, n_frames)
