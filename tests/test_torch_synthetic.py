"""The ray-traced validation scene and its Chamfer evaluator on the port
against the repo's JAX-side scripts: scripts/make_synthetic_scene.py (run
as a subprocess, with PIL) and the port's twin (--device cpu) at a small
size, over the layouts; scripts/eval_synthetic.py and the twin on the same
mesh and GT samples."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from gaussmart_tpu_torch.mesh.meshing import TriMesh, save_mesh_ply
from gaussmart_tpu_torch.scripts import eval_synthetic, make_synthetic_scene

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--views", "4", "--width", "97", "--height", "73", "--sfm_points", "2000",
         "--gt_points", "5000"]
PIXEL_AGREE = 0.9999      # image and mask pixels equal, share of each
BYTE_EQUAL = ["sparse/0/cameras.txt", "sparse/0/images.txt", "sparse/0/points3D.txt",
              "sparse/0/points3D.ply", "poses_bounds.npy", "gt_surface_points.npy"]


def _jax_script(name, args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", name), *args],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("flags", [[], ["--unbounded"], ["--float_sphere", "--write_masks"],
                                   ["--sparsify_sphere", "0.5"]],
                         ids=["default", "unbounded", "float_sphere_masks", "sparsify"])
def test_scene_matches_the_jax_script(tmp_path, flags):
    ref, got = tmp_path / "jax", tmp_path / "port"
    _jax_script("make_synthetic_scene.py", ["--out", str(ref), *SMALL, *flags], tmp_path)
    make_synthetic_scene.main(["--out", str(got), *SMALL, *flags, "--device", "cpu"])

    for name in BYTE_EQUAL:
        assert (got / name).read_bytes() == (ref / name).read_bytes(), name
    pixels = differ = 0
    for name in sorted(os.listdir(ref / "images")):
        with Image.open(ref / "images" / name) as im:
            a = np.asarray(im).astype(np.int32)
        with Image.open(got / "images" / name) as im:
            b = np.asarray(im).astype(np.int32)
        assert a.shape == b.shape == (73, 97, 3)
        assert np.abs(a - b).max() <= 1, name
        pixels += a.shape[0] * a.shape[1]
        differ += int((a != b).any(axis=-1).sum())
    print(f"images: {differ} of {pixels} pixels differ (at most 1 level)")
    assert differ <= (1 - PIXEL_AGREE) * pixels

    if "--write_masks" not in flags:
        assert not (got / "masks_gt").exists()
        return
    names = sorted(os.listdir(ref / "masks_gt"))
    assert names == sorted(os.listdir(got / "masks_gt")) and len(names) == 4
    seg_pixels = seg_differ = 0
    for name in names:
        a, b = np.load(ref / "masks_gt" / name), np.load(got / "masks_gt" / name)
        assert a["masks"].shape == b["masks"].shape
        # one pixel's worth of boundary rounding: a bbox edge moves by 1,
        # an area by the pixels that changed material
        changed = int((a["masks"] != b["masks"]).any(axis=0).sum())
        assert np.abs(a["boxes"] - b["boxes"]).max() <= 1
        assert np.abs(a["areas"] - b["areas"]).max() <= changed
        seg_pixels += a["masks"][0].size
        seg_differ += changed
    print(f"masks: {len(names)} views, segmentation differs on {seg_differ} of "
          f"{seg_pixels} pixels")
    assert seg_differ <= (1 - PIXEL_AGREE) * seg_pixels


def _sphere_mesh(rng, centre, radius, n_lat=24, n_lon=48):
    """A noisy UV sphere, plus a far triangle outside any crop radius."""
    lat = np.linspace(0.05, np.pi - 0.05, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(la) * np.cos(lo), np.cos(la), np.sin(la) * np.sin(lo)], -1)
    v = centre + radius * v.reshape(-1, 3) + rng.normal(0, 0.01, (n_lat * n_lon, 3))
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = a + n_lon, b + n_lon
            faces += [[a, b, c], [b, d, c]]
    far = len(v)
    v = np.concatenate([v, [[3.0, 0, 0], [3.2, 0, 0], [3.0, 0.2, 0]]])
    faces.append([far, far + 1, far + 2])
    return TriMesh(v, np.asarray(faces, np.int64), rng.random((len(v), 3)))


@pytest.mark.parametrize("crop", ["0.0", "2.0"])
def test_eval_synthetic_matches_the_jax_script(tmp_path, rng, crop):
    scene, model = tmp_path / "scene", tmp_path / "model"
    make_synthetic_scene.main(["--out", str(scene), "--views", "1", "--width", "8",
                               "--height", "6", "--sfm_points", "300", "--gt_points",
                               "4000", "--device", "cpu"])
    mesh_dir = model / "train" / "ours_7"
    mesh = _sphere_mesh(rng, make_synthetic_scene.Layout().sphere_c,
                        make_synthetic_scene.SPHERE_R)
    save_mesh_ply(str(mesh_dir / "fuse.ply"), mesh)
    save_mesh_ply(str(mesh_dir / "fuse_post.ply"),
                  TriMesh(mesh.vertices, mesh.faces[:-1], mesh.vertex_colors))
    with open(model / "results.json", "w") as f:
        json.dump({"ours_7": {"SSIM": 0.5, "PSNR": 20.0, "LPIPS": None}}, f)
    args = ["--scene", str(scene), "--model", str(model), "--iteration", "7",
            "--downsample", "0.02", "--crop_radius", crop]

    ref = json.loads(_jax_script("eval_synthetic.py", args, tmp_path).strip().splitlines()[-1])
    with open(model / "synthetic_eval.json") as f:
        assert json.load(f) == ref
    got = eval_synthetic.main(args)
    with open(model / "synthetic_eval.json") as f:
        assert json.load(f) == got
    assert got.keys() == ref.keys() == {"gt_points", "fuse.ply", "fuse_post.ply",
                                        "image_metrics"}
    assert got["gt_points"] == ref["gt_points"] and got["image_metrics"] == ref["image_metrics"]
    for name in ("fuse.ply", "fuse_post.ply"):
        assert got[name]["n_mesh_samples"] == ref[name]["n_mesh_samples"] > 0
        for k in ("mean_d2s", "mean_s2d", "overall"):
            assert abs(got[name][k] - ref[name][k]) <= 1e-9, (name, k)
    print(f"crop {crop}: {got['fuse.ply']}")
