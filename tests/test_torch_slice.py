"""The serving slice end to end: a seeded trained-model directory rendered by
the JAX GaussianExtractor (dense backend) and by the port's render_cli on
the CPU, compared image by image; the port imports neither jax nor
gaussmart_tpu (nor PIL, cv2 or matplotlib); the CLI's refusals."""
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
from gaussmart_tpu.io.colmap import (ColmapCamera, ColmapImage, write_cameras_text,
                                     write_images_text)
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
    """Importing every module of the port (gaussmart_tpu_torch.parallel
    too) and chip_smoke.py, and running the render CLI (with its mesh
    export), the metrics CLI, the train CLI (each also over 2 device slots:
    --shard_mode gaussian; dp and mp, with the DINO term on the random
    tower), the DINO heatmap CLI and the viewer CLI answering a scripted
    client, the segmentation pipeline (classical masks) and convert --help,
    the validation scene's generator and Chamfer evaluator, the NeRF
    driver's chain and the summary, leaves neither jax nor gaussmart_tpu
    nor the repo's scripts package in sys.modules, nor transformers, PIL,
    cv2, sklearn, matplotlib or pandas, which the card's machine lacks; nor
    does loading a COLMAP scene of JPEG photos (their cameras at -r 1 and
    2), convert's resize of them, and the heatmap CLI from a JPEG to a
    JPEG."""
    model, cfg = _model_dir(str(tmp_path), n=40)
    src, out = cfg["source_path"], str(tmp_path / "trained")
    png, heat = str(tmp_path / "in.png"), str(tmp_path / "heat.png")
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((30, 40, 3)) * 255).astype(np.uint8)).save(png)
    # a DTU-format scan for the segmentation pipeline
    scan, seg_out = tmp_path / "scan", str(tmp_path / "seg")
    os.makedirs(scan / "images")
    K = np.eye(4)
    K[:3, :3] = [[30.0, 0, 20], [0, 30.0, 15], [0, 0, 1]]
    mats = {}
    for i in range(5):
        w2c = np.eye(4)
        w2c[:3, 3] = [0.2 * i, 0, 3.0]
        mats.update({f"world_mat_{i}": w2c, f"camera_mat_{i}": K, f"scale_mat_{i}": np.eye(4)})
        Image.fromarray((rng.random((30, 40, 3)) * 255).astype(np.uint8)).save(
            scan / "images" / f"{i:03d}.png")
    np.savez(scan / "cameras.npz", **mats)
    store_point_cloud(str(scan / "points.ply"), rng.normal(scale=0.3, size=(50, 3)),
                      rng.integers(0, 255, (50, 3)).astype(np.float64))
    # a COLMAP scene of JPEG photos, with the images/ convert resizes
    jscene = tmp_path / "jpeg_scene"
    os.makedirs(jscene / "sparse" / "0")
    os.makedirs(jscene / "images")
    write_cameras_text(str(jscene / "sparse" / "0" / "cameras.txt"),
                       {1: ColmapCamera(1, "PINHOLE", 40, 30, np.array([30.0, 30, 20, 15]))})
    write_images_text(str(jscene / "sparse" / "0" / "images.txt"),
                      {i + 1: ColmapImage(i + 1, np.array([1.0, 0, 0, 0]),
                                          np.array([0.1 * i, 0, 3.0]), 1, f"{i:05d}.jpg")
                       for i in range(3)})
    store_point_cloud(str(jscene / "sparse" / "0" / "points3D.ply"),
                      rng.normal(scale=0.3, size=(50, 3)),
                      rng.integers(0, 255, (50, 3)).astype(np.float64))
    for i in range(3):
        Image.fromarray((rng.random((30, 40, 3)) * 255).astype(np.uint8)).save(
            jscene / "images" / f"{i:05d}.jpg")
    jpg_in, jpg_heat = str(jscene / "images" / "00000.jpg"), str(tmp_path / "heat.jpg")
    # the evaluation tools: a validation scene, its Chamfer on the render
    # CLI's mesh, one driver's chain on the Blender scene (as NeRF's lego)
    synth, nerf, drv = str(tmp_path / "synth"), tmp_path / "nerf", str(tmp_path / "drv")
    os.makedirs(nerf)
    os.symlink(src, nerf / "lego")
    nerf = str(nerf)
    code = f"""
import importlib, os, pkgutil, sys
import numpy as np
import gaussmart_tpu_torch, gaussmart_tpu_torch.parallel, chip_smoke
for m in pkgutil.walk_packages(gaussmart_tpu_torch.__path__, "gaussmart_tpu_torch."):
    importlib.import_module(m.name)
from gaussmart_tpu_torch import render_cli, train
render_cli.main(["-m", {model!r}, "--device", "cpu", "--skip_test", "--mesh_res", "64"])
render_cli.main(["-m", {model!r}, "--skip_mesh", "--device", "cpu", "--skip_train",
                 "--n_devices", "2", "--shard_mode", "gaussian"])
from gaussmart_tpu_torch.eval import metrics_cli
metrics_cli.main(["-m", {model!r}, "--device", "cpu"])
args = ["-s", {src!r}, "--sh_degree", "1", "--iterations", "3", "--test_iterations", "3",
        "--device", "cpu", "--no_tensorboard", "--quiet", "--capacity", "256",
        "--dino_mode", "off"]
train.main(args + ["-m", {out!r}])
os.environ["GAUSSMART_DINO_WEIGHTS"] = "random"
dino = ["--dino_mode", "fixed", "--dino_start_iter", "0"]
train.main(args + ["-m", {out + "_dp"!r}, "--n_devices", "2"] + dino)
train.main(args + ["-m", {out + "_mp"!r}, "--n_devices", "2", "--parallel_mode", "mp"] + dino)
from gaussmart_tpu_torch.semantics import visualize
visualize.main(["-i", {png!r}, "-o", {heat!r}, "--random_encoder", "--device", "cpu"])
from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.viewer import client, protocol, serve
clients = []
class ConnectedGUI(protocol.NetworkGUI):
    def init(self, host, port):
        super().init(host, port)
        cam = Camera(uid=0, colmap_id=0, image_name="v", R=np.eye(3),
                     T=np.array([0, 0, 3.0]), fovx=0.9, fovy=0.9, width=32, height=24)
        clients.append(client.ViewerClient(self.listener.getsockname()[1],
                                           [client.camera_request(cam, m) for m in (0, 4)]))
        clients[0].start()
        assert clients[0].connected.wait(30)
serve.NetworkGUI = ConnectedGUI
serve.main(["-m", {model!r}, "--port", "0", "--device", "cpu", "--max_frames", "2"])
clients[0].join(30)
assert clients[0].error is None and [len(f[0]) for f in clients[0].frames] == [32 * 24 * 3] * 2
from gaussmart_tpu_torch.semantics import pipeline
pipeline.main(["-s", {str(scan)!r}, "-o", {seg_out!r}, "-t", "dtu", "--clean",
               "--mask_backend", "classical", "--device", "cpu"])
from gaussmart_tpu_torch import convert
try:
    convert.main(["--help"])
except SystemExit as e:
    assert e.code == 0
from gaussmart_tpu_torch.io import dataset
info = dataset.detect_and_read({str(jscene)!r})
for res in (1, 2):
    cams = [dataset.load_camera(c, resolution=res) for c in info.train_cameras]
    assert [c.image.shape for c in cams] == [(3, 30 // res, 40 // res)] * 3
convert.resize_copies({str(jscene)!r})
visualize.main(["-i", {jpg_in!r}, "-o", {jpg_heat!r}, "--random_encoder", "--device", "cpu"])
from gaussmart_tpu_torch.scripts import (eval_synthetic, make_synthetic_scene, nerf_eval,
                                         summary)
make_synthetic_scene.main(["--out", {synth!r}, "--views", "2", "--width", "16", "--height",
                           "12", "--sfm_points", "200", "--gt_points", "500", "--device", "cpu"])
eval_synthetic.main(["--scene", {synth!r}, "--model", {model!r}, "--iteration", "7",
                     "--downsample", "0.05"])
assert nerf_eval.main(["--nerf", {nerf!r}, "--output_path", {drv!r}, "--scenes", "lego",
                       "--iterations", "3", "--device", "cpu"]) == 0
rows, _ = summary.main(["--root", {drv!r}])
assert [(r["scene"], r["method"]) for r in rows] == [("lego", "ours_3")]
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "gaussmart_tpu", "transformers", "PIL", "cv2", "sklearn",
    "matplotlib", "pandas", "scripts"))
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
    assert os.path.exists(os.path.join(model, "test", f"ours_{ITER}", "renders",
                                       "00000.png"))
    assert os.path.exists(os.path.join(model, "train", f"ours_{ITER}", "fuse_post.ply"))
    assert os.path.exists(os.path.join(model, "results.json"))
    for o in (out, out + "_dp", out + "_mp"):
        assert os.path.exists(os.path.join(o, "point_cloud", "iteration_3", "point_cloud.ply"))
        assert os.path.exists(os.path.join(o, "eval_3.json"))
    assert _png(heat).shape == (30, 40, 3)
    assert Image.open(jpg_heat).format == "JPEG" and Image.open(jpg_heat).size == (40, 30)
    assert Image.open(jscene / "images_4" / "00001.jpg").size == (10, 7)
    assert os.path.exists(os.path.join(seg_out, "segments", "point_cloud", "segment_indices.npy"))
    assert os.path.exists(os.path.join(synth, "gt_surface_points.npy"))
    assert os.path.exists(os.path.join(model, "synthetic_eval.json"))
    assert os.path.exists(os.path.join(drv, "lego", "test", "ours_3", "renders", "00000.png"))


def test_cli_refuses_what_this_slice_does_not_serve(tmp_path, monkeypatch):
    model, cfg = _model_dir(str(tmp_path), n=10)
    # --render_path without OpenCV, the port's one video encoder: refused
    # before any frame is rendered
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no video encoder"):
        render_cli.main(["-m", model, "--device", "cpu", "--skip_mesh", "--skip_train",
                         "--skip_test", "--render_path"])
    monkeypatch.delitem(sys.modules, "cv2")
    # a new model starts from the scene's point cloud as in the JAX package:
    # the same initial params and aux, camera order and extent, and copies
    jdir, tdir = str(tmp_path / "jax_new"), str(tmp_path / "port_new")
    js = JScene(JModelParams(source_path=cfg["source_path"], model_path=jdir,
                             white_background=True, sh_degree=1, eval=True), seed=4)
    ts = Scene(ModelParams(source_path=cfg["source_path"], model_path=tdir,
                           white_background=True, sh_degree=1, eval=True), seed=4,
               device="cpu")
    assert ts.loaded_iter is None and ts.cameras_extent == js.cameras_extent
    for split in ("get_train_cameras", "get_test_cameras"):
        assert ([c.image_name for c in getattr(ts, split)()]
                == [c.image_name for c in getattr(js, split)()])
    for k, v in vars(js.gaussians.params).items():
        np.testing.assert_array_equal(getattr(ts.gaussians.params, k).numpy(), np.asarray(v))
    for k, v in vars(js.gaussians.aux).items():
        np.testing.assert_array_equal(getattr(ts.gaussians.aux, k).numpy(), np.asarray(v))
    for name in ("input.ply", "cameras.json"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
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
