"""The evaluation slice of the port against the JAX package: LPIPS with
random weights (VGG16, AlexNet, SqueezeNet 1.1 at an even and an odd
size) and its weight files, the metrics CLI's JSON with and without
weights, LPIPS(alex) in the in-loop eval, DTU Chamfer and TnT F-score,
and the mask cull with its numpy counterparts of OpenCV's calls."""
import json
import os

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussmart_tpu.eval import chamfer as jch
from gaussmart_tpu.eval import cull as jcull
from gaussmart_tpu.eval import lpips_jax
from gaussmart_tpu.eval import metrics_cli as j_metrics
from gaussmart_tpu.eval import tnt_fscore as jtnt
from gaussmart_tpu.mesh.meshing import TriMesh as JTriMesh
from gaussmart_tpu_torch.eval import chamfer as tch
from gaussmart_tpu_torch.eval import cull as tcull
from gaussmart_tpu_torch.eval import lpips as tlpips
from gaussmart_tpu_torch.eval import metrics_cli as t_metrics
from gaussmart_tpu_torch.eval import tnt_fscore as ttnt
from gaussmart_tpu_torch.mesh.meshing import TriMesh as TTriMesh

torch.set_num_threads(1)


@pytest.fixture
def no_lpips_weights(monkeypatch, tmp_path):
    """No weight file anywhere: the env var names a missing file and the
    default paths are emptied, in both packages."""
    monkeypatch.setenv(tlpips.WEIGHT_ENV, str(tmp_path / "missing_{net}.npz"))
    monkeypatch.setattr(tlpips, "DEFAULT_PATHS", [])
    monkeypatch.setattr(lpips_jax, "DEFAULT_PATHS", [])
    lpips_jax.load_lpips.cache_clear()
    yield
    lpips_jax.load_lpips.cache_clear()


def _write_weights(tmp_path, net, seed=0):
    path = tmp_path / f"lpips_{net}.npz"
    np.savez(path, **lpips_jax.random_params(net, seed))
    return str(tmp_path / "lpips_{net}.npz")


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
@pytest.mark.parametrize("size", [(64, 48), (67, 53)])
def test_lpips_matches_jax(rng, net, size):
    w, h = size
    params = lpips_jax.random_params(net)
    for k, v in tlpips.random_params(net).items():      # the same draws
        np.testing.assert_array_equal(v, params[k])
    a = rng.random((2, 3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = np.asarray(lpips_jax.LPIPS(params, net)(jnp.asarray(a), jnp.asarray(b)))
    got = tlpips.LPIPS(params, net, device="cpu")(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2,) and (ref > 0).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)
    # one image, [3,H,W]; identical images score 0
    one = tlpips.LPIPS(params, net, device="cpu")(a[0], a[0])
    assert one.shape == (1,) and abs(float(one[0])) < 1e-6


def test_squeeze_ceil_pool_matches_jax_padding_rule(rng):
    """max_pool2d(ceil_mode=True) against the JAX package's -inf tail
    padding at odd and even sizes."""
    for n in (5, 6, 7, 30, 31):
        x = rng.normal(size=(1, 2, n, n + 1)).astype(np.float32)
        ref = np.asarray(lpips_jax._maxpool(jnp.asarray(x), k=3, ceil=True))
        np.testing.assert_array_equal(tlpips._maxpool(torch.from_numpy(x), k=3, ceil=True)
                                      .numpy(), ref)


def test_lpips_weight_files_match_jax(tmp_path, monkeypatch, no_lpips_weights):
    assert not tlpips.available("vgg") and tlpips.load_lpips("vgg", "cpu") is None
    monkeypatch.setenv(tlpips.WEIGHT_ENV, _write_weights(tmp_path, "vgg"))
    assert tlpips.available("vgg") and not tlpips.available("alex")
    scorer = tlpips.load_lpips("vgg", "cpu")
    assert scorer.net_type == "vgg" and scorer is tlpips.load_lpips("vgg", "cpu")
    # convert_torch_lpips: torchvision-style state dicts to the same .npz
    for net in ("vgg", "alex", "squeeze"):
        p = lpips_jax.random_params(net)
        if net == "squeeze":
            backbone = {"features.0.weight": p["conv0_w"], "features.0.bias": p["conv0_b"]}
            for idx in lpips_jax.SQUEEZE_FIRE_CH:
                for src, dst in (("squeeze", "squeeze"), ("expand1x1", "e1"),
                                 ("expand3x3", "e3")):
                    backbone[f"features.{idx}.{src}.weight"] = p[f"fire{idx}_{dst}_w"]
                    backbone[f"features.{idx}.{src}.bias"] = p[f"fire{idx}_{dst}_b"]
        else:
            n_conv = sum(k.startswith("conv") and k.endswith("_w") for k in p)
            backbone = {}
            for i in range(n_conv):      # torchvision layer indices, with gaps
                backbone[f"features.{3 * i}.weight"] = p[f"conv{i}_w"]
                backbone[f"features.{3 * i}.bias"] = p[f"conv{i}_b"]
        lins = {f"lin{i}.model.1.weight": p[f"lin{i}_w"]
                for i in range(sum(k.startswith("lin") for k in p))}
        jout = lpips_jax.convert_torch_lpips(backbone, lins, net, str(tmp_path / "j.npz"))
        tout = tlpips.convert_torch_lpips(backbone, lins, net, str(tmp_path / "t.npz"))
        with np.load(jout) as zj, np.load(tout) as zt:
            assert sorted(zj.files) == sorted(zt.files) == sorted(p)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k])


def _metrics_model(root, rng, n=3, size=(40, 30), ext="png"):
    mdir = root / "test" / "ours_30000"
    os.makedirs(mdir / "renders")
    os.makedirs(mdir / "gt")
    w, h = size
    for i in range(n):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(mdir / "renders" / f"{i:05d}.{ext}")
        noisy = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        Image.fromarray(noisy).save(mdir / "gt" / f"{i:05d}.{ext}")
    return str(root)


def _assert_json_close(a, b, where):
    """Equal keys in order, equal nulls, numbers within a 1e-5 ratio."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _assert_json_close(a[k], b[k], f"{where}/{k}")
    elif b is None:
        assert a is None, where
    else:
        assert a == pytest.approx(b, rel=1e-5, abs=0), where


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def test_metrics_cli_json_matches_jax_on_jpeg_images(tmp_path, no_lpips_weights):
    """Renders and ground truth as JPEG photos (4:2:0, Pillow's default
    save): the port's decode equals Pillow's, so both JSON files equal
    the JAX CLI's."""
    ours = _metrics_model(tmp_path / "port", np.random.default_rng(5), size=(61, 45), ext="jpg")
    theirs = _metrics_model(tmp_path / "jax", np.random.default_rng(5), size=(61, 45),
                            ext="jpg")
    t_metrics.main(["-m", ours, "--device", "cpu", "--no_lpips"])
    j_metrics.evaluate([theirs], use_lpips=False)
    for name in ("results.json", "per_view.json"):
        _assert_json_close(_read_json(os.path.join(ours, name)),
                           _read_json(os.path.join(theirs, name)), name)


@pytest.mark.parametrize("with_weights", [False, True])
def test_metrics_cli_json_matches_jax(tmp_path, rng, monkeypatch, no_lpips_weights,
                                      with_weights):
    ours = _metrics_model(tmp_path / "port", np.random.default_rng(3), size=(64, 48))
    theirs = _metrics_model(tmp_path / "jax", np.random.default_rng(3), size=(64, 48))
    if with_weights:
        monkeypatch.setenv(tlpips.WEIGHT_ENV, _write_weights(tmp_path, "vgg"))
    t_metrics.main(["-m", ours, "--device", "cpu"])
    j_metrics.evaluate([theirs])
    for name in ("results.json", "per_view.json"):
        _assert_json_close(_read_json(os.path.join(ours, name)),
                           _read_json(os.path.join(theirs, name)), name)
    with open(os.path.join(ours, "results.json")) as f:
        assert (json.load(f)["ours_30000"]["LPIPS"] is not None) == with_weights


def test_metrics_cli_refuses_to_fall_back_to_the_cpu(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_metrics.main(["-m", _metrics_model(tmp_path, rng)])
    assert not os.path.exists(tmp_path / "results.json")


def test_in_loop_eval_adds_lpips_alex_when_weights_exist(tmp_path, monkeypatch,
                                                         no_lpips_weights):
    """train.report_eval: without weights the JAX keys only; with random
    AlexNet weights an 'lpips' mean equal to the JAX scorer's on the same
    clipped renders."""
    from test_torch_slice import ITER, _model_dir
    from gaussmart_tpu_torch import train as ttrain
    from gaussmart_tpu_torch.config import ModelParams, PipelineParams
    from gaussmart_tpu_torch.render.api import render
    from gaussmart_tpu_torch.scene import Scene

    model, cfg = _model_dir(str(tmp_path), n=60)
    dataset = ModelParams(source_path=cfg["source_path"], model_path=model,
                          white_background=True, sh_degree=1, eval=True)
    scene = Scene(dataset, load_iteration=ITER, shuffle=False, device="cpu")
    pipe = PipelineParams()
    plain = ttrain.report_eval(scene, scene.gaussians, pipe, dataset, ITER, device="cpu")
    assert set(plain["test"]) == {"l1", "psnr", "ssim"}
    monkeypatch.setenv(tlpips.WEIGHT_ENV, _write_weights(tmp_path, "alex"))
    res = ttrain.report_eval(scene, scene.gaussians, pipe, dataset, ITER, device="cpu")
    assert set(res["test"]) == {"l1", "psnr", "ssim", "lpips"}
    for k in ("l1", "psnr", "ssim"):
        assert res["test"][k] == plain["test"][k]
    scorer = lpips_jax.LPIPS(lpips_jax.random_params("alex"), "alex")
    bg = torch.ones(3)
    for name, cams in (("test", scene.get_test_cameras()),
                       ("train", [scene.get_train_cameras()[i % 3] for i in range(5, 30, 5)])):
        ref = np.mean([float(scorer(
            jnp.asarray(torch.clamp(render(c.params("cpu"), scene.gaussians, bg)["render"],
                                    0, 1).numpy()),
            jnp.asarray(np.clip(c.image, 0, 1)))[0]) for c in cams])
        assert res[name]["lpips"] == pytest.approx(ref, rel=1e-5)
    with open(os.path.join(model, f"eval_{ITER}.json")) as f:
        assert json.load(f) == res


def _blob_mesh(rng, n=400):
    v = rng.normal(size=(n, 3)) * [4, 3, 2]
    f = rng.integers(0, n, (2 * n, 3))
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]
    return v, f


def test_chamfer_matches_jax(rng):
    v, f = _blob_mesh(rng)
    ref_s = jch.sample_mesh_surface(JTriMesh(v, f), 0.5)
    got_s = tch.sample_mesh_surface(TTriMesh(v, f), 0.5)
    np.testing.assert_array_equal(got_s, ref_s)
    ref_d = jch.radius_downsample(ref_s, 0.4)
    np.testing.assert_array_equal(tch.radius_downsample(got_s, 0.4), ref_d)
    stl = rng.normal(size=(3000, 3)) * [4, 3, 2]
    obs = rng.random((12, 10, 8)) < 0.8
    bb = np.array([[-8, -6, -4], [8, 6, 4]], np.float32)
    plane = np.array([0.0, 0.0, 1.0, 1.0])
    for args in ((), (obs, bb, 1.5, plane, 2.0, 3.0)):
        assert tch.dtu_chamfer(ref_d, stl, *args) == jch.dtu_chamfer(ref_d, stl, *args)


def test_tnt_fscore_matches_jax(tmp_path, rng):
    gt = rng.random((1500, 3))
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    rec = gt[:1200] @ R.T + [0.01, -0.02, 0.005] + rng.normal(0, 0.002, (1200, 3))
    poses = [np.eye(4) for _ in range(5)]
    for i, p in enumerate(poses):
        p[:3, 3] = rng.random(3) + i
    j_traj = [jtnt.CameraPose([i, i, 0], p) for i, p in enumerate(poses)]
    t_traj = [ttnt.CameraPose([i, i, 0], p) for i, p in enumerate(poses)]
    jtnt.write_trajectory(j_traj, str(tmp_path / "j.log"))
    ttnt.write_trajectory(t_traj, str(tmp_path / "t.log"))
    assert (tmp_path / "j.log").read_bytes() == (tmp_path / "t.log").read_bytes()
    back = ttnt.read_trajectory(str(tmp_path / "j.log"))
    assert [c.metadata for c in back] == [c.metadata for c in j_traj]
    crop = {"orthogonal_axis": "Z", "axis_min": 0.1, "axis_max": 0.9,
            "bounding_polygon": [[0.05, 0.05, 0], [0.95, 0.1, 0], [0.9, 0.95, 0],
                                 [0.1, 0.9, 0]]}
    with open(tmp_path / "crop.json", "w") as f:
        json.dump(crop, f)
    kw = dict(crop_json=str(tmp_path / "crop.json"), tau=0.02)
    ref = jtnt.run_evaluation(rec, gt, "Barn", traj_est=j_traj, traj_gt=j_traj, **kw)
    got = ttnt.run_evaluation(rec, gt, "Barn", traj_est=t_traj, traj_gt=t_traj, **kw)
    assert got == ref and ref["fscore"] > 0
    for fn in ("umeyama", "icp_refine", "voxel_downsample"):
        a = getattr(jtnt, fn)(rec, gt[:1200]) if fn != "voxel_downsample" \
            else jtnt.voxel_downsample(rec, 0.05)
        b = getattr(ttnt, fn)(rec, gt[:1200]) if fn != "voxel_downsample" \
            else ttnt.voxel_downsample(rec, 0.05)
        np.testing.assert_array_equal(b, a)


def test_cull_rq_matches_opencv(rng):
    for _ in range(50):
        P = rng.normal(size=(3, 4))
        K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
        k2, r2, t2 = tcull.decompose_projection_matrix(P)
        np.testing.assert_allclose(k2, K, rtol=0, atol=1e-9)
        np.testing.assert_allclose(r2, R, rtol=0, atol=1e-9)
        np.testing.assert_allclose(t2 / t2[3], t / t[3], rtol=0, atol=1e-9)
    # a DTU-like camera: K [R|t] with a positive focal length
    K = np.array([[2890.0, 0.5, 820], [0, 2880, 590], [0, 0, 1]])
    a = 0.3
    Rw = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    P = K @ np.concatenate([Rw, [[0.1], [-0.2], [3.0]]], axis=1)
    for got, ref in zip(tcull.load_K_Rt_from_P(P), jcull.load_K_Rt_from_P(P)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("radius", [1, 5, 24])
def test_cull_dilation_matches_opencv(rng, radius):
    m = rng.random((120, 160)) < 0.003
    m[0, 5] = m[119, 159] = m[60, 0] = True              # on the borders
    np.testing.assert_array_equal(tcull.dilate_mask(m, radius),
                                  jcull.dilate_mask(m, radius))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_mask_channel_matches_opencv_imread(tmp_path, rng, mode):
    ch = len(mode)
    img = (rng.random((20, 30, ch)) * 255).astype(np.uint8)
    Image.fromarray(img[..., 0] if ch == 1 else img, mode).save(tmp_path / "m.png")
    np.testing.assert_array_equal(tcull.read_mask_channel(str(tmp_path / "m.png")),
                                  cv2.imread(str(tmp_path / "m.png"))[:, :, 0])


@pytest.mark.parametrize("name,mode,orientation", [("m.png", "RGB", 6), ("m.jpg", "RGB", 6),
                                                   ("m.jpg", "L", 3), ("m.png", "L", 1)])
def test_cull_reads_masks_as_cv2_imread(tmp_path, rng, name, mode, orientation):
    """read_mask_channel is cv2.imread(path)[:, :, 0]: EXIF orientation
    applied, the blue channel of colour masks, the level of grey ones."""
    img = (rng.random((30, 50, 3)) * 255).astype(np.uint8)
    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(img).convert(mode).save(tmp_path / name, exif=exif)
    np.testing.assert_array_equal(tcull.read_mask_channel(str(tmp_path / name)),
                                  cv2.imread(str(tmp_path / name))[:, :, 0])


def test_cull_matches_jax(tmp_path, rng):
    """The whole cull on a DTU-style scene: 3 cameras (cameras.npz with
    world and scale matrices) and their masks, a random mesh."""
    n_views = 3
    scale = np.diag([2.0, 2.0, 2.0, 1.0])
    scale[:3, 3] = [0.1, -0.1, 0.2]
    arrays = {}
    for i in range(n_views):
        a = 0.2 * (i - 1)
        w2c = np.eye(4)
        w2c[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        w2c[:3, 3] = [0.0, 0.0, 6.0]
        K = np.array([[1000.0, 0, 800, 0], [0, 1000, 600, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        arrays[f"world_mat_{i}"] = (K @ w2c @ np.linalg.inv(scale)).astype(np.float32)
        arrays[f"scale_mat_{i}"] = scale.astype(np.float32)
        mask = np.zeros((1200, 1600, 3), np.uint8)
        mask[200 + 50 * i:1000, 300:1300 - 60 * i] = 255
        os.makedirs(tmp_path / "mask", exist_ok=True)
        cv2.imwrite(str(tmp_path / "mask" / f"{i:03d}.png"), mask)
    np.savez(tmp_path / "cameras.npz", **arrays)
    v = rng.uniform(-1.5, 1.5, (3000, 3))
    f = rng.integers(0, 3000, (5000, 3))
    cols = rng.random((3000, 3))
    ref = jcull.cull_mesh_by_masks(JTriMesh(v, f, cols), str(tmp_path / "cameras.npz"),
                                   str(tmp_path / "mask"))
    got = tcull.cull_mesh_by_masks(TTriMesh(v, f, cols), str(tmp_path / "cameras.npz"),
                                   str(tmp_path / "mask"))
    assert 0 < len(ref.faces) < len(f)
    for k in ("vertices", "faces", "vertex_colors"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
