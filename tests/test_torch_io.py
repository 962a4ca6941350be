"""gaussmart_tpu_torch IO vs the JAX package and PIL: the PNG/TIFF codec,
Gaussian snapshot PLYs in both directions, the state's activations, COLMAP
and Blender scene reading and camera image loading."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from gaussmart_tpu.io import dataset as jds
from gaussmart_tpu.io import gaussian_ply as jgp
from gaussmart_tpu.io.colmap import ColmapCamera, ColmapImage, rotmat2qvec
from gaussmart_tpu.io.colmap import write_cameras_text, write_images_text
from gaussmart_tpu.io.ply import store_point_cloud
from gaussmart_tpu.models import gaussians as jg
from gaussmart_tpu_torch.io import dataset as tds
from gaussmart_tpu_torch.io import gaussian_ply as tgp
from gaussmart_tpu_torch.io import images
from gaussmart_tpu_torch.models import gaussians as tg

torch.set_num_threads(1)


@pytest.mark.parametrize("mode,shape", [("L", (37, 53)), ("LA", (37, 53, 2)),
                                        ("RGB", (37, 53, 3)), ("RGBA", (37, 53, 4))])
def test_png_codec_matches_pil(tmp_path, rng, mode, shape):
    noisy = (rng.random(shape) * 255).astype(np.uint8)
    # smooth content makes PIL's encoder pick the Sub/Up/Average/Paeth filters
    smooth = (np.cumsum(noisy.astype(np.int64), axis=1) // 9 % 256).astype(np.uint8)
    for img in (noisy, smooth):
        Image.fromarray(img, mode).save(tmp_path / "pil.png")
        decoded = images.read_png(str(tmp_path / "pil.png"))
        assert decoded.dtype == np.uint8
        np.testing.assert_array_equal(decoded, np.asarray(Image.open(tmp_path / "pil.png")))
        images.write_png(str(tmp_path / "ours.png"), img)
        with Image.open(tmp_path / "ours.png") as im:
            assert im.mode == mode
            np.testing.assert_array_equal(np.asarray(im), img)
        assert images.png_size(str(tmp_path / "ours.png")) == (shape[1], shape[0])


def test_tiff_f32_matches_pil(tmp_path, rng):
    depth = (rng.random((29, 41)) * 5).astype(np.float32)
    images.write_tiff_f32(str(tmp_path / "d.tiff"), depth)
    with Image.open(tmp_path / "d.tiff") as im:
        assert im.mode == "F"
        np.testing.assert_array_equal(np.asarray(im), depth)


def _jax_state(rng, n=40, capacity=64, sh_degree=2):
    k = (sh_degree + 1) ** 2
    params = jg.GaussianParams(
        xyz=jnp.asarray(rng.normal(size=(capacity, 3)), jnp.float32),
        features_dc=jnp.asarray(rng.normal(size=(capacity, 1, 3)), jnp.float32),
        features_rest=jnp.asarray(rng.normal(size=(capacity, k - 1, 3)), jnp.float32),
        scaling=jnp.asarray(rng.normal(size=(capacity, 2)) - 3, jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(size=(capacity, 1)), jnp.float32))
    active = np.arange(capacity) < n
    rng.shuffle(active)
    segments = rng.integers(0, 9, capacity).astype(np.int32)
    aux = jg.GaussianAux(active=jnp.asarray(active), segments=jnp.asarray(segments),
                         max_radii2d=jnp.zeros(capacity), grad_accum=jnp.zeros(capacity),
                         denom=jnp.zeros(capacity))
    return jg.GaussianState(params=params, aux=aux, max_sh_degree=sh_degree,
                            active_sh_degree=1, spatial_lr_scale=2.5)


def _port_state(js):
    return tg.state_from_numpy(vars(jax.tree.map(np.asarray, js.params)),
                               np.asarray(js.aux.active), np.asarray(js.aux.segments),
                               js.max_sh_degree, js.active_sh_degree,
                               js.spatial_lr_scale, device="cpu")


def test_state_from_numpy_reproduces_jax_activations(rng):
    js = _jax_state(rng)
    ts = _port_state(js)
    assert ts.capacity == js.capacity and int(ts.n_active) == int(js.n_active)
    for name in ("get_scaling", "get_rotation", "get_opacity", "get_features"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(ts.aux.segments.numpy(), np.asarray(js.aux.segments))
    empty_t = vars(tg.empty_params(8, 2, device="cpu"))
    for k, v in vars(jg.empty_params(8, 2)).items():
        np.testing.assert_array_equal(empty_t[k].numpy(), np.asarray(v))


def test_gaussian_ply_interop_both_ways(tmp_path, rng):
    js = _jax_state(rng)
    jgp.save_gaussian_ply(str(tmp_path / "jax.ply"), js)
    tgp.save_gaussian_ply(str(tmp_path / "port.ply"), _port_state(js))
    # the same state writes the same bytes from either package
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()

    from_jax = tgp.load_gaussian_ply(str(tmp_path / "jax.ply"), 2, 2.5, device="cpu")
    ref = jgp.load_gaussian_ply(str(tmp_path / "jax.ply"), 2, 2.5)
    tgp.save_gaussian_ply(str(tmp_path / "port2.ply"), from_jax)
    from_port = jgp.load_gaussian_ply(str(tmp_path / "port2.ply"), 2, 2.5)
    for k, v in vars(ref.params).items():
        np.testing.assert_array_equal(getattr(from_jax.params, k).numpy(), np.asarray(v))
        np.testing.assert_array_equal(np.asarray(getattr(from_port.params, k)),
                                      np.asarray(v))
    for k in ("active", "segments"):
        np.testing.assert_array_equal(getattr(from_jax.aux, k).numpy(),
                                      np.asarray(getattr(ref.aux, k)))
    assert (from_jax.active_sh_degree, from_jax.capacity) == (2, ref.capacity)
    with pytest.raises(ValueError, match="f_rest"):
        tgp.load_gaussian_ply(str(tmp_path / "jax.ply"), 3, device="cpu")


def _colmap_scene(root, rng, n_views=3, size=(40, 30), rgba=False):
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    os.makedirs(root / "images")
    w, h = size
    write_cameras_text(str(sparse / "cameras.txt"),
                       {1: ColmapCamera(1, "PINHOLE", w, h, np.array([50.0, 45.0, w / 2, h / 2]))})
    imgs = {}
    for i in range(n_views):
        q = rng.normal(size=4)
        from gaussmart_tpu.io.colmap import qvec2rotmat
        R = qvec2rotmat(q / np.linalg.norm(q))
        imgs[i + 1] = ColmapImage(i + 1, rotmat2qvec(R), rng.normal(size=3), 1, f"v{i}.png")
        ch = 4 if rgba else 3
        img = (rng.random((h, w, ch)) * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA" if rgba else "RGB").save(root / "images" / f"v{i}.png")
    write_images_text(str(sparse / "images.txt"), imgs)
    store_point_cloud(str(sparse / "points3D.ply"), rng.normal(size=(20, 3)),
                      rng.integers(0, 255, (20, 3)).astype(np.float64))


@pytest.mark.parametrize("rgba", [False, True])
def test_colmap_scene_and_cameras_match_jax(tmp_path, rng, rgba):
    _colmap_scene(tmp_path, rng, rgba=rgba)
    j = jds.detect_and_read(str(tmp_path), eval_split=True)
    t = tds.detect_and_read(str(tmp_path), eval_split=True)
    assert len(j.train_cameras) == len(t.train_cameras) == 2
    np.testing.assert_allclose(t.nerf_normalization["radius"], j.nerf_normalization["radius"])
    np.testing.assert_array_equal(t.point_cloud.points, j.point_cloud.points)
    for cj, ct in zip(j.train_cameras + j.test_cameras, t.train_cameras + t.test_cameras):
        np.testing.assert_array_equal(ct.R, cj.R)
        assert (ct.fovx, ct.fovy, ct.image_name) == (cj.fovx, cj.fovy, cj.image_name)
        assert tds.camera_to_json(0, ct) == jds.camera_to_json(0, cj)
        cam_j, cam_t = jds.load_camera(cj), tds.load_camera(ct)
        np.testing.assert_array_equal(cam_t.image, cam_j.image)
        if rgba:
            np.testing.assert_array_equal(cam_t.alpha_mask, cam_j.alpha_mask)
        np.testing.assert_array_equal(cam_t.full_proj, cam_j.full_proj)


def test_blender_scene_and_resize_match_jax(tmp_path, rng):
    frames = []
    os.makedirs(tmp_path / "train")
    for i in range(2):
        img = (rng.random((24, 32, 4)) * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(tmp_path / "train" / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.0, 3.0]
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(tmp_path / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    store_point_cloud(str(tmp_path / "points3d.ply"), rng.normal(size=(10, 3)),
                      rng.integers(0, 255, (10, 3)).astype(np.float64))
    j = jds.detect_and_read(str(tmp_path), white_background=True)
    t = tds.detect_and_read(str(tmp_path), white_background=True)
    assert len(t.train_cameras) == len(j.train_cameras) == 4
    for cj, ct in zip(j.train_cameras, t.train_cameras):
        assert (ct.width, ct.height, ct.fovy) == (cj.width, cj.height, cj.fovy)
        # full resolution: white-background composite, bit-identical
        np.testing.assert_array_equal(tds.load_camera(ct, resolution=1).image,
                                      jds.load_camera(cj, resolution=1).image)
        # half resolution: torch bicubic vs PIL bicubic, close but not equal
        half_t = tds.load_camera(ct, resolution=2).image
        half_j = jds.load_camera(cj, resolution=2).image
        assert half_t.shape == half_j.shape == (3, 12, 16)
        assert np.abs(half_t - half_j).mean() < 0.05
