"""Semantic preprocessing of the port against the JAX package, on the CPU:
camera formats, view clustering (the port's numpy k-means against
sklearn's), hull removal, projection, the mask backends (the cv2-exact
resize and component numbering, the colour k-means), the pipeline's
artifacts in both directions, train --run_segmentation and the convert
CLI. cv2, sklearn and PIL are references here only."""
import os
import shutil
import stat
import struct
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from gaussmart_tpu import convert as jconvert
from gaussmart_tpu.config import ModelParams as JModelParams
from gaussmart_tpu.io.colmap import (ColmapCamera, ColmapImage, rotmat2qvec,
                                     write_cameras_text, write_images_text)
from gaussmart_tpu.io.ply import store_point_cloud
from gaussmart_tpu.scene import Scene as JScene
from gaussmart_tpu.semantics import camera_formats as jcf
from gaussmart_tpu.semantics import clustering as jcl
from gaussmart_tpu.semantics import hull as jhull
from gaussmart_tpu.semantics import pipeline as jpipe
from gaussmart_tpu.semantics import projection as jproj
from gaussmart_tpu.semantics import sam_backend as jsam
from gaussmart_tpu_torch import convert as tconvert
from gaussmart_tpu_torch import train as ttrain
from gaussmart_tpu_torch.config import ModelParams as TModelParams
from gaussmart_tpu_torch.io.images import read_png, resize_linear_u8, write_png
from gaussmart_tpu_torch.scene import Scene as TScene
from gaussmart_tpu_torch.semantics import camera_formats as tcf
from gaussmart_tpu_torch.semantics import clustering as tcl
from gaussmart_tpu_torch.semantics import hull as thull
from gaussmart_tpu_torch.semantics import kmeans as tkm
from gaussmart_tpu_torch.semantics import pipeline as tpipe
from gaussmart_tpu_torch.semantics import projection as tproj
from gaussmart_tpu_torch.semantics import sam_backend as tsam

cv2 = pytest.importorskip("cv2")
sk_cluster = pytest.importorskip("sklearn.cluster")
torch.set_num_threads(1)


def _assert_tree_equal(a, b, rtol=0.0):
    """Equal nested dicts/lists/arrays; floats within rtol."""
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k], rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y, rtol)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float):
        assert abs(a - b) <= rtol * abs(b), (a, b)
    else:
        assert a == b


# -- camera formats -------------------------------------------------------------

def _ring_c2w(ang, radius, y=0.0):
    c, s = np.cos(ang), np.sin(ang)
    c2w = np.eye(4)
    c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    c2w[:3, 3] = [radius * np.sin(ang), y, -radius * np.cos(ang)]
    return c2w


def _camera_file(tmp_path, rng, fmt):
    if fmt == "dtu":
        mats = {}
        for i in range(7):
            mats[f"world_mat_{i}"] = np.linalg.inv(_ring_c2w(0.4 * i, 3.0, rng.normal()))
            K = np.eye(4)
            K[:3, :3] = [[300.0 + i, 0, 80], [0, 305.0, 60], [0, 0, 1]]
            mats[f"camera_mat_{i}"] = K
            mats[f"scale_mat_{i}"] = np.diag([1.5, 1.5, 1.5, 1.0])
        mats["misc"] = np.zeros(2)
        path = tmp_path / "cameras.npz"
        np.savez(path, **mats)
    elif fmt == "nerf":
        rows = [np.concatenate([_ring_c2w(0.3 * i, 2.5).reshape(-1), [120.0 + i],
                                rng.uniform(0.5, 4.0, 2)]) for i in range(6)]
        path = tmp_path / "poses_bounds.npy"
        np.save(path, np.stack(rows))
    else:
        rows = [np.concatenate([_ring_c2w(0.2 * i, 4.0, 0.1 * i)[:3].reshape(-1),
                                rng.uniform(0.5, 4.0, 2)]) for i in range(10)]
        path = tmp_path / "poses.npy"
        np.save(path, np.stack(rows))
    return str(path)


@pytest.mark.parametrize("fmt", ["dtu", "nerf", "tyt"])
def test_camera_formats_match_jax(tmp_path, rng, fmt):
    path = _camera_file(tmp_path, rng, fmt)
    assert tcf.detect_format(path) == jcf.detect_format(path) == fmt
    views, got_fmt = tcf.load_cameras(path)
    ref, ref_fmt = jcf.load_cameras(path)
    assert got_fmt == ref_fmt
    _assert_tree_equal(views, ref)
    _assert_tree_equal(tcf.CameraAnalysis(path).analyze(), jcf.CameraAnalysis(path).analyze())
    with pytest.raises(ValueError, match="Unrecognized"):
        tcf.detect_format(str(tmp_path / "x.txt"))


# -- clustering -------------------------------------------------------------------

def _camera_groups(rng):
    """Cameras in 3-6 groups on a sphere of radius 3, 4-9 per group."""
    pts = []
    for _ in range(int(rng.integers(3, 7))):
        az, el, m = rng.uniform(0, 2 * np.pi), rng.uniform(-0.5, 0.8), int(rng.integers(4, 10))
        a, e = az + rng.normal(0, 0.08, m), el + rng.normal(0, 0.05, m)
        pts.append(3 * np.stack([np.cos(a) * np.cos(e), np.sin(e), np.sin(a) * np.cos(e)], 1))
    return np.concatenate(pts)


def test_kmeans_gives_sklearns_partition_on_separated_clusters(rng):
    centres = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [0, 0, 10.0]])
    X = np.concatenate([c + rng.normal(0, 0.3, (12, 3)) for c in centres])
    ref = sk_cluster.KMeans(n_clusters=4, n_init=10, random_state=42).fit(X)
    km = tkm.KMeans(n_clusters=4, n_init=10, random_state=42)
    labels = km.fit_predict(X)
    # one partition: a bijection between the two labelings
    pairs = set(zip(labels.tolist(), ref.labels_.tolist()))
    assert len(pairs) == 4 and len({a for a, _ in pairs}) == 4
    # and, drawing as sklearn draws, the same label numbers and centres
    np.testing.assert_array_equal(labels, ref.labels_)
    np.testing.assert_allclose(km.cluster_centers_, ref.cluster_centers_, atol=1e-12)
    with pytest.raises(ValueError, match="n_clusters"):
        tkm.KMeans(n_clusters=5).fit(X[:4])


def test_kmeans_inertia_matches_sklearn_on_random_layouts(rng):
    """20 seeded layouts (grouped cameras and unstructured blobs), k in
    [3, 8]: inertia within 1% of sklearn's (it is equal: the same draws)."""
    for t in range(20):
        X = _camera_groups(rng) if t % 2 else rng.normal(size=(int(rng.integers(20, 60)), 3))
        k = int(rng.integers(3, 9))
        ref = sk_cluster.KMeans(n_clusters=k, n_init=10, random_state=42).fit(X)
        km = tkm.KMeans(n_clusters=k, n_init=10, random_state=42).fit(X)
        assert abs(km.inertia_ / ref.inertia_ - 1) <= 0.01, (t, k)
        np.testing.assert_array_equal(km.labels_, ref.labels_)


def _ring_npz(path):
    """test_semantics.py's three-cluster ring: 18 cameras."""
    mats, n = {}, 0
    for base in (0.0, 2.1, 4.2):
        for j in range(6):
            ang = base + 0.05 * j
            c, s = np.cos(ang), np.sin(ang)
            c2w = np.eye(4)
            c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            c2w[:3, 3] = [5 * np.cos(ang), 0, 5 * np.sin(ang)]
            mats[f"world_mat_{n}"] = np.linalg.inv(c2w)
            mats[f"camera_mat_{n}"] = np.eye(4)
            mats[f"scale_mat_{n}"] = np.eye(4)
            n += 1
    np.savez(path, **mats)
    return str(path)


def test_view_selector_matches_jax_on_the_ring(tmp_path):
    path = _ring_npz(tmp_path / "cameras.npz")
    got = tcl.ViewSelector(tcf.CameraAnalysis(path)).select()
    ref = jcl.ViewSelector(jcf.CameraAnalysis(path)).select()
    # the scores within float64 noise: sklearn sums its centres in
    # another order
    _assert_tree_equal(got, ref, rtol=1e-12)
    assert len(got["selected_indices"]) == 3


def test_selection_with_the_ports_kmeans_in_jax(tmp_path, rng, monkeypatch):
    """The rest of ViewSelector, given one k-means: JAX's with sklearn's
    KMeans replaced by the port's gives the port's optimal_k and
    selection on random layouts."""
    monkeypatch.setattr(sk_cluster, "KMeans", tkm.KMeans)
    for t in range(4):
        mats = {}
        for i, p in enumerate(_camera_groups(rng)):
            c2w = _ring_c2w(rng.uniform(0, 2 * np.pi), 1.0)
            c2w[:3, 3] = p
            mats.update({f"world_mat_{i}": np.linalg.inv(c2w), f"camera_mat_{i}": np.eye(4),
                         f"scale_mat_{i}": np.eye(4)})
        path = str(tmp_path / f"cams{t}.npz")
        np.savez(path, **mats)
        port = tcl.ViewSelector(tcf.CameraAnalysis(path))
        ref = jcl.ViewSelector(jcf.CameraAnalysis(path))
        assert port.optimal_k() == ref.optimal_k()
        _assert_tree_equal(port.select(), ref.select())


def test_path_helpers_match_jax(tmp_path):
    for name in ("00003.jpg", "000012.jpg", "b.png", "a.png", ".hidden", "._x"):
        (tmp_path / name).write_bytes(b"")
    files = tcl.list_image_files(str(tmp_path))
    assert files == jcl.list_image_files(str(tmp_path))
    for dtype in ("dtu", "nerf", "tyt", "TYT"):
        for idx in (0, 3, 7, 12, 24, 25):
            i = tcl.map_camera_to_image_index(idx, dtype)
            assert i == jcl.map_camera_to_image_index(idx, dtype)
            assert (tcl.resolve_image_path(str(tmp_path), i, files, dtype)
                    == jcl.resolve_image_path(str(tmp_path), i, files, dtype))


# -- hull --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 1, 97, 512])
def test_hull_removal_matches_jax(rng, chunk):
    inner = rng.normal(scale=0.3, size=(500, 3))
    pts = np.concatenate([inner, rng.normal(scale=6.0, size=(10, 3))])
    keep, hull = thull.hull_removal(pts, device="cpu", chunk=chunk)
    ref_keep, ref_hull = jhull.hull_removal(pts)
    np.testing.assert_array_equal(keep, ref_keep)
    assert keep.sum() < len(pts)
    d = thull.hull_distances(pts, hull, device="cpu", chunk=chunk)
    np.testing.assert_allclose(d, jhull.hull_distances(pts, ref_hull), atol=1e-12, rtol=0)
    cols, normals = rng.random((510, 3)), rng.normal(size=(510, 3))
    got = thull.filter_point_cloud(pts, cols, normals, device="cpu")
    for a, b in zip(got, jhull.filter_point_cloud(pts, cols, normals)):
        np.testing.assert_array_equal(a, b)


# -- projection ------------------------------------------------------------------

def _dtu_camera(fx, w2c=None):
    K = np.eye(4)
    K[:3, :3] = [[fx, 0, 777.0], [0, fx, 581.0], [0, 0, 1]]
    return {"world_mat": np.eye(4) if w2c is None else w2c, "camera_mat": K,
            "scale_mat": np.diag([1.2, 1.2, 1.2, 1.0])}


def _projection_case(kind, rng):
    pts = np.column_stack([rng.uniform(-1, 1, 300), rng.uniform(-1, 1, 300),
                           rng.uniform(2, 5, 300)])
    w2c = np.linalg.inv(_ring_c2w(0.2, 0.3))
    if kind == "dtu":                   # most points in DTU's 1554x1162 frame
        return pts, _dtu_camera(400.0, w2c), "dtu"
    if kind == "dtu_fallback":          # <10% in bounds: invented intrinsics
        return pts, _dtu_camera(5000.0, w2c), "dtu"
    if kind == "nerf":
        K = np.eye(4)
        K[:3, :3] = [[90.0, 0, 32], [0, 90.0, 24], [0, 0, 1]]
        return pts, {"world_mat": w2c, "camera_mat": K, "scale_mat": np.eye(4)}, "nerf"
    pts[5] = np.nan
    return pts, {"world_mat": w2c, "img_size": np.array([979, 543])}, "tyt"


@pytest.mark.parametrize("kind", ["dtu", "dtu_fallback", "nerf", "tyt"])
def test_project_points_to_view_matches_jax(rng, kind):
    pts, cam, dtype = _projection_case(kind, rng)
    p2d, z = tproj.project_points_to_view(pts, cam, dtype, device="cpu")
    ref2d, refz = jproj.project_points_to_view(pts, cam, dtype)
    np.testing.assert_allclose(p2d.numpy(), ref2d, atol=1e-9, rtol=0)
    np.testing.assert_allclose(z.numpy(), refz, atol=1e-12, rtol=0)
    if kind.startswith("dtu"):          # the fallback's frame is its own
        K = cam["camera_mat"]
        cam_pts = (cam["world_mat"] @ cam["scale_mat"] @ np.c_[pts, np.ones(len(pts))].T).T
        direct = cam_pts[:, :2] * [K[0, 0], K[1, 1]] + K[:2, 2]
        inside = ((direct >= 0) & (direct < tproj.DTU_WH)).all(axis=1).mean()
        assert (inside < 0.1) == (kind == "dtu_fallback")


def _overlapping_masks(rng, n, h=48, w=64):
    out = []
    for _ in range(n):
        m = np.zeros((h, w), bool)
        y0, x0 = rng.integers(0, h - 10), rng.integers(0, w - 10)
        m[y0:y0 + rng.integers(8, 30), x0:x0 + rng.integers(8, 40)] = True
        out.append({"segmentation": m, "bbox": [0, 0, 1, 1], "area": int(m.sum())})
    return out


def test_assign_segment_indices_matches_jax(rng):
    masks = [m["segmentation"] for m in _overlapping_masks(rng, 6)]
    p2d = np.column_stack([rng.uniform(-3, 66, 400), rng.uniform(-3, 50, 400)])
    p2d[:8] = [[0.5, 0.5], [1.5, 2.5], [63.5, 47.5], [2.5, 0.5], [10.5, 10.5],
               [20.5, 3.5], [-0.5, 4.0], [64.4, 3.0]]     # ties round half to even
    got = tproj.assign_segment_indices_simple(p2d, masks)
    np.testing.assert_array_equal(got.numpy(), jproj.assign_segment_indices_simple(p2d, masks))
    assert tproj.assign_segment_indices_simple(p2d, []).eq(-1).all()


@pytest.mark.parametrize("z_cull", [False, True])
def test_project_segments_matches_jax(rng, z_cull):
    """Three nerf views with overlapping masks (first view wins, later
    masks overwrite earlier ones, areas merged by max), a view without
    masks, and the occluded cloud of test_semantics.py for the z-cull."""
    K = np.eye(4)
    K[:3, :3] = [[64.0, 0, 32], [0, 64.0, 24], [0, 0, 1]]
    front = np.column_stack([rng.uniform(-0.6, 0.6, 150), rng.uniform(-0.4, 0.4, 150),
                             np.full(150, 2.0)])
    pts = np.concatenate([front, front * 5.0, rng.uniform(-1, 1, (100, 3)) + [0, 0, 3]])
    cams = {f"camera_{i:03d}": {"world_mat": np.linalg.inv(_ring_c2w(0.15 * i, 0.2)),
                                "camera_mat": K} for i in range(4)}
    all_masks = [_overlapping_masks(rng, 5), [], _overlapping_masks(rng, 7),
                 _overlapping_masks(rng, 3)]
    seg, areas = tproj.project_segments(pts, all_masks, cams, "nerf", z_cull=z_cull,
                                        device="cpu")
    ref_seg, ref_areas = jproj.project_segments(pts, all_masks, cams, "nerf", z_cull=z_cull)
    assert seg.dtype == ref_seg.dtype
    np.testing.assert_array_equal(seg, ref_seg)
    assert list(areas.items()) == list(ref_areas.items())
    assert (seg >= 0).sum() > 50 and (seg == -1).sum() > 0


def test_the_1024px_mask_cap_quirk_is_kept(tmp_path, rng):
    """The reference's quirk, kept: DTU images of 1600x1200 are segmented
    at 1024x768, and the image's pixel coordinates are looked up in those
    masks, so points projecting beyond column 1023 (or row 767) keep -1
    in both packages even where the mask covers the whole image."""
    img = np.zeros((1200, 1600, 3), np.uint8)
    path = str(tmp_path / "v.png")
    write_png(path, img, level=1)
    assert tsam._load_image_rgb(path).shape == (768, 1024, 3)
    mask = np.ones((768, 1024), bool)
    masks = [[{"segmentation": mask, "bbox": [0, 0, 1024, 768], "area": mask.size}]]
    K = np.eye(4)
    K[:3, :3] = [[400.0, 0, 800], [0, 400.0, 600], [0, 0, 1]]
    cams = {"camera_000": {"world_mat": np.eye(4), "camera_mat": K, "scale_mat": np.eye(4)}}
    pts = np.column_stack([rng.uniform(-1.9, 1.9, 400), rng.uniform(-1.4, 1.4, 400),
                           np.ones(400)])
    seg, _ = tproj.project_segments(pts, masks, cams, "dtu", device="cpu")
    ref, _ = jproj.project_segments(pts, masks, cams, "dtu")
    np.testing.assert_array_equal(seg, ref)
    x = 400.0 * 1.0 * pts[:, 0] + 800
    y = 400.0 * 1.0 * pts[:, 1] + 600
    inside_image = (x >= 0) & (x < 1600) & (y >= 0) & (y < 1200)
    beyond = inside_image & ((x >= 1024) | (y >= 768))
    assert beyond.sum() > 50 and (seg[beyond] == -1).all()
    assert (seg[inside_image & ~beyond] == 0).all()


# -- mask backends -----------------------------------------------------------------

def test_resize_equals_opencv_at_the_dtu_size(rng):
    img = (rng.random((1200, 1600, 3)) * 256).astype(np.uint8)
    np.testing.assert_array_equal(resize_linear_u8(img, 1024, 768), cv2.resize(img, (1024, 768)))
    for h, w, H, W in ((1080, 1920, 576, 1024), (300, 2000, 153, 1024), (31, 20, 15, 10),
                       (17, 9, 40, 33)):
        a = (rng.random((h, w)) * 256).astype(np.uint8)
        np.testing.assert_array_equal(resize_linear_u8(a, W, H), cv2.resize(a, (W, H)))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "JPEG", "JPEG-L", "JPEG-orient6"])
def test_load_image_rgb_matches_jax(tmp_path, rng, mode):
    """PNGs of three modes, and JPEGs (RGB at the DTU size, grey, and an
    EXIF orientation-6 photo that cv2 turns upright before the cap)."""
    shape = {"RGB": (1200, 1600, 3), "RGBA": (600, 1100, 4), "L": (500, 700),
             "JPEG": (1200, 1600, 3), "JPEG-L": (500, 700), "JPEG-orient6": (700, 1300, 3)}[mode]
    img = (rng.random(shape) * 256).astype(np.uint8)
    if mode.startswith("JPEG"):
        path = str(tmp_path / "img.jpg")
        exif = Image.Exif()
        if mode == "JPEG-orient6":
            exif[0x0112] = 6
        Image.fromarray(img).save(path, quality=90, exif=exif)
    else:
        path = str(tmp_path / "img.png")
        Image.fromarray(img, mode).save(path, compress_level=1)
    np.testing.assert_array_equal(tsam._load_image_rgb(path), jsam._load_image_rgb(path))


def test_components_are_numbered_as_opencv(rng):
    for t in range(12):
        h, w = (int(v) for v in rng.integers(1, 120, 2))
        b = rng.random((h, w)) < rng.uniform(0.2, 0.8)
        n, ref = cv2.connectedComponents(b.astype(np.uint8))
        m, got = tsam.connected_components(b)
        assert m == n
        np.testing.assert_array_equal(got, ref)
    n, ref = cv2.connectedComponents(np.zeros((5, 7), np.uint8))
    m, got = tsam.connected_components(np.zeros((5, 7), bool))
    assert m == n == 1 and not got.any()


def _blocky_image(rng, h=96, w=128):
    """A few colour regions with noise: components of many sizes."""
    palette = rng.integers(0, 256, (6, 3))
    regions = rng.integers(0, 6, (h // 8, w // 12 + 1)).repeat(8, 0).repeat(12, 1)[:h, :w]
    img = palette[regions] + rng.integers(-12, 13, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_classical_segmenter_matches_jax_given_the_same_labels(tmp_path, rng, monkeypatch):
    img = _blocky_image(rng)
    path = str(tmp_path / "img.png")
    Image.fromarray(img).save(path)
    seg = tsam.ClassicalSegmenter(device="cpu", seed=3)
    labels = seg.labels(tsam._load_image_rgb(path))

    def port_labels(pixels, k, best, criteria, attempts, flags):
        assert (k, criteria[1:], attempts, flags) == (8, (10, 1.0), 3, cv2.KMEANS_PP_CENTERS)
        return 0.0, labels.reshape(-1, 1), None
    monkeypatch.setattr(cv2, "kmeans", port_labels)
    got = seg.process_image(path)
    ref = jsam.ClassicalSegmenter().process_image(path)
    assert len(got) > 5
    _assert_tree_equal(got, ref)


def test_colour_kmeans_is_seeded_and_close_to_opencv(rng):
    img = _blocky_image(rng, 120, 160).reshape(-1, 3)
    x = torch.as_tensor(img)
    a, ca = tkm.quantize_colors(x, 8, torch.Generator().manual_seed(0))
    b, cb = tkm.quantize_colors(x, 8, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and ca == cb
    c, _ = tkm.quantize_colors(x, 8, torch.Generator().manual_seed(1))
    assert a.shape == (len(img),) and a.min() >= 0 and a.max() < 8
    crit = (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 10, 1.0)
    ref, _, _ = cv2.kmeans(img.astype(np.float32), 8, None, crit, 3, cv2.KMEANS_PP_CENTERS)
    assert ca <= 1.05 * ref
    # its compactness is the labels' distance to their means (cv2's
    # definition: the last labels against the centres moved to them)
    means = torch.stack([x[a == k].double().mean(0) for k in range(8)])
    assert abs(((x.double() - means[a]) ** 2).sum().item() - ca) <= 1e-6 * ca


def test_empty_cluster_takes_the_farthest_point_of_the_largest():
    """cv2's rule: a cluster left empty takes the point of the largest
    cluster farthest from that cluster's mean."""
    x = torch.tensor([[0.0], [1.0], [2.0], [50.0], [51.0]], dtype=torch.float64)
    labels = torch.tensor([0, 0, 0, 0, 2])
    centres = tkm._update(x, labels, 3)
    assert labels.tolist() == [0, 0, 0, 1, 2]
    assert centres[:, 0].tolist() == [1.0, 50.0, 51.0]


def test_masks_npz_roundtrip_across_packages(tmp_path, rng):
    masks = [{"segmentation": rng.random((8, 9)) > 0.5, "bbox": [1, 2, 3, 4], "area": 12},
             {"segmentation": rng.random((8, 9)) > 0.3, "bbox": [0, 0, 9, 8], "area": 40}]
    for save, load in ((tsam.save_masks_npz, jsam.load_masks_npz),
                       (jsam.save_masks_npz, tsam.load_masks_npz)):
        p = str(tmp_path / f"{save.__module__}.npz")
        save(masks, p)
        back = load(p)
        ref = jsam.load_masks_npz(p)
        _assert_tree_equal(back, ref)
        np.testing.assert_array_equal(back[1]["segmentation"], masks[1]["segmentation"])
        assert [m["bbox"] for m in back] == [[1, 2, 3, 4], [0, 0, 9, 8]]
    pre = tsam.PrecomputedMasks(str(tmp_path))
    os.rename(p, tmp_path / "segments_000.npz")
    _assert_tree_equal(pre.process_image("any"), jsam.PrecomputedMasks(str(tmp_path))
                       .process_image("any"))


def test_make_segmenter_chooses_as_jax(tmp_path, capsys):
    assert not tsam.sam_available() and not jsam.sam_available()
    for kw in ({}, {"mask_dir": str(tmp_path)}, {"mask_dir": str(tmp_path / "none")},
               {"backend": "classical"}, {"backend": "precomputed", "mask_dir": "x"}):
        got = tsam.make_segmenter(device="cpu", **kw)
        ref = jsam.make_segmenter(**kw)
        assert type(got).__name__ == type(ref).__name__
    out = capsys.readouterr().out
    assert out.count("[sam] segment_anything / checkpoint unavailable; using "
                     "built-in classical segmenter") == 4


# -- the pipeline ---------------------------------------------------------------------

def _nerf_scan(root, rng, n_views=6, size=64, two_colour=False):
    """test_semantics.py's nerf scan (random images with a red band; or a
    two-colour split of unequal areas, which any k-means partitions alike
    and the area sort orders alike)."""
    os.makedirs(root / "images")
    os.makedirs(root / "sparse" / "0")
    rows = []
    for i in range(n_views):
        rows.append(np.concatenate([_ring_c2w(i * 1.0, 3.0).reshape(-1), [100.0]]))
        if two_colour:
            img = np.zeros((size, size, 3), np.uint8)
            img[:size // 3] = [220, 40, 40]
            img[size // 3:] = [40, 40, 220]
        else:
            img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
            img[:size // 2] = [200, 30, 30]
        Image.fromarray(img).save(root / "images" / f"{i:03d}.png")
    np.save(root / "poses_bounds.npy", np.stack(rows))
    pts = rng.normal(scale=0.5, size=(300, 3)).astype(np.float32)
    store_point_cloud(str(root / "sparse" / "0" / "points3D.ply"), pts,
                      rng.integers(0, 255, (300, 3)).astype(np.float64))


ARTIFACTS = ("point_cloud/raw_pc.ply", "point_cloud/segmented_point_cloud.ply",
             "point_cloud/segment_indices.npy", "point_cloud/mask_areas.npy",
             "cameras/selected_cameras.npz")


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _assert_artifacts_equal(a, b):
    for sub in ("masks", "images"):
        assert sorted(os.listdir(os.path.join(a, sub))) == sorted(
            os.listdir(os.path.join(b, sub)))
    names = list(ARTIFACTS) + [f"masks/{f}" for f in os.listdir(os.path.join(a, "masks"))]
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):       # the zip's entries carry their write time
            assert _npz_members(pa) == _npz_members(pb), name
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name


def _dtu_scan(root, rng, n_views=8, w=64, h=48):
    """A DTU-format scan (cameras.npz with the w2c world_mat, K and an
    identity scale_mat; points.ply; PNG views of colour blocks) plus the
    same cameras as a COLMAP text model, so the Scene loads it. fx = 60
    keeps the reference's projection (no division by depth) inside the
    views."""
    os.makedirs(root / "images")
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    mats, imgs = {}, {}
    K = np.eye(4)
    K[:3, :3] = [[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]]
    for i in range(n_views):
        w2c = np.linalg.inv(_ring_c2w(0.35 * i, 3.0))
        mats.update({f"world_mat_{i}": w2c, f"camera_mat_{i}": K,
                     f"scale_mat_{i}": np.eye(4)})
        imgs[i + 1] = ColmapImage(i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1,
                                  f"{i:03d}.png")
        Image.fromarray(_blocky_image(rng, h, w)).save(root / "images" / f"{i:03d}.png")
    np.savez(root / "cameras.npz", **mats)
    write_cameras_text(str(sparse / "cameras.txt"),
                       {1: ColmapCamera(1, "PINHOLE", w, h, np.array([60.0, 60.0, w / 2, h / 2]))})
    write_images_text(str(sparse / "images.txt"), imgs)
    pts = rng.normal(scale=0.4, size=(300, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (300, 3)).astype(np.float64)
    store_point_cloud(str(root / "points.ply"), pts, cols)
    store_point_cloud(str(sparse / "points3D.ply"), pts, cols)


def _tyt_scan(root, rng, n_views=4, w=979, h=543):
    """A TYT scan: NNNNN.jpg photos (JPEG, as the format ships; at the
    loader's default 979x543, so that its bounding-box projection lands
    the points inside the masks), poses_bounds.npy with 14 columns whose
    second half the loader drops, and the same cameras as a COLMAP text
    model for the Scene."""
    os.makedirs(root / "images")
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    rows, imgs = [], {}
    palette = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    for i in range(2 * n_views):
        c2w = _ring_c2w(0.3 * i, 3.0)
        rows.append(np.concatenate([c2w[:3].reshape(-1), rng.uniform(0.5, 4.0, 2)]))
        if i < n_views:
            w2c = np.linalg.inv(c2w)
            imgs[i + 1] = ColmapImage(i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1,
                                      f"{i:05d}.jpg")
            # 8 flat colour blocks: the classical backend's 8-colour
            # k-means settles at once on photos this size
            blocks = rng.permutation(palette).reshape(2, 4, 3)
            img = blocks.repeat(-(-h // 2), 0).repeat(-(-w // 4), 1)[:h, :w]
            Image.fromarray(img).save(root / "images" / f"{i:05d}.jpg", quality=95)
    np.save(root / "poses_bounds.npy", np.stack(rows))
    write_cameras_text(str(sparse / "cameras.txt"),
                       {1: ColmapCamera(1, "PINHOLE", w, h, np.array([501.0, 277.0, w / 2, h / 2]))})
    write_images_text(str(sparse / "images.txt"), imgs)
    pts = rng.normal(scale=0.4, size=(300, 3)).astype(np.float32)
    store_point_cloud(str(sparse / "points3D.ply"), pts,
                      rng.integers(0, 255, (300, 3)).astype(np.float64))


SCANS = {"nerf": lambda root, rng: _nerf_scan(root, rng), "dtu": _dtu_scan, "tyt": _tyt_scan}


@pytest.mark.parametrize("kind", ["nerf", "dtu", "tyt"])
def test_pipeline_artifacts_equal_jax_with_precomputed_masks(tmp_path, rng, capsys, kind):
    """test_semantics.py's nerf scan (its views are 64 px where the nerf
    loader puts the principal point at 512: no point lands in a mask, in
    both packages), a DTU scan and a TYT scan of NNNNN.jpg photos: the
    port's classical masks, then both pipelines on them as precomputed
    masks (--clean): byte-equal artifacts and the same prints."""
    scan = tmp_path / "scan"
    SCANS[kind](scan, rng)
    made = tpipe.Pipeline(str(scan), str(tmp_path / "made"), kind,
                          mask_backend="classical", device="cpu")
    made.run(clean_pc=True)
    mask_dir = str(tmp_path / "made" / "segments" / "masks")
    assert len(os.listdir(mask_dir)) >= 3
    capsys.readouterr()
    got = tpipe.main(["-s", str(scan), "-o", str(tmp_path / "port"), "-t", kind, "--clean",
                      "--mask_backend", "precomputed", "--mask_dir", mask_dir,
                      "--device", "cpu"])
    port_out = capsys.readouterr().out
    jpipe.main(["-s", str(scan), "-o", str(tmp_path / "jax"), "-t", kind, "--clean",
                "--mask_backend", "precomputed", "--mask_dir", mask_dir])
    assert port_out == capsys.readouterr().out
    _assert_artifacts_equal(str(tmp_path / "port" / "segments"),
                            str(tmp_path / "jax" / "segments"))
    assert (got[0] >= 0).any() == (kind != "nerf")


def test_pipeline_artifacts_equal_jax_on_a_two_colour_scan(tmp_path, rng):
    """The classical backend in both packages (cv2.kmeans in JAX's) on a
    two-colour scan, which every k-means splits alike; no cleaning."""
    scan = tmp_path / "scan"
    _nerf_scan(scan, rng, n_views=5, size=48, two_colour=True)
    tpipe.Pipeline(str(scan), str(tmp_path / "port"), "nerf", mask_backend="classical",
                   device="cpu").run(clean_pc=False)
    jpipe.Pipeline(str(scan), str(tmp_path / "jax"), "nerf",
                   mask_backend="classical").run(clean_pc=False)
    _assert_artifacts_equal(str(tmp_path / "port" / "segments"),
                            str(tmp_path / "jax" / "segments"))


def _interop_scan(scan, rng):
    """test_pipeline_interop.py's scan: 5 nerf views of two colours, 200
    points, and a binary COLMAP model of 2 of the images for the Scene."""
    os.makedirs(scan / "images")
    sparse = scan / "sparse" / "0"
    os.makedirs(sparse)
    rows = []
    for i in range(5):
        rows.append(np.concatenate([_ring_c2w(i * 1.2, 2.0).reshape(-1), [80.0]]))
        img = np.zeros((48, 48, 3), np.uint8)
        img[:24] = [220, 40, 40]
        img[24:] = [40, 40, 220]
        Image.fromarray(img).save(scan / "images" / f"{i:03d}.png")
    np.save(scan / "poses_bounds.npy", np.stack(rows))
    pts = rng.normal(scale=0.4, size=(200, 3)).astype(np.float32)
    store_point_cloud(str(sparse / "points3D.ply"), pts,
                      rng.integers(0, 255, (200, 3)).astype(np.float64))
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, 48, 48))
        f.write(struct.pack("<dddd", 40.0, 40.0, 24.0, 24.0))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for i in range(2):
            f.write(struct.pack("<idddddddi", i + 1, 1.0, 0, 0, 0, 0.05 * i, 0, 2.0, 1))
            f.write(f"{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    return pts


def _scene_counts(scene):
    info = scene.info
    return (info.ply_path, len(info.point_cloud.points), int(scene.gaussians.n_active),
            info.point_cloud.segments.tolist(), sorted(info.point_cloud.mask_areas.items()))


def test_each_scene_loads_the_other_packages_artifacts(tmp_path, rng, monkeypatch):
    """The DTU scan's classical artifacts of each package, read by both
    packages' Scenes: the same cloud, segments, mask areas and augmented
    point count from either reader."""
    scan = tmp_path / "scan"
    _dtu_scan(scan, rng)
    for name, Pipe, kw in (("port", tpipe.Pipeline, {"device": "cpu"}),
                           ("jax", jpipe.Pipeline, {})):
        work = tmp_path / name
        os.makedirs(work)
        monkeypatch.chdir(work)
        Pipe(str(scan), str(work / "identification" / "results"), "dtu",
             mask_backend="classical", **kw).run(clean_pc=False)
        port = TScene(TModelParams(source_path=str(scan), model_path=str(tmp_path / "o1"),
                                   sh_degree=1, resolution=1), capacity=4096, seed=0,
                      device="cpu")
        ref = JScene(JModelParams(source_path=str(scan), model_path=str(tmp_path / "o2"),
                                  sh_degree=1, resolution=1), capacity=4096, seed=0)
        got, want = _scene_counts(port), _scene_counts(ref)
        assert got == want, name
        assert "segmented_point_cloud" in got[0]
        assert got[2] > 300, name           # the mask-area augmentation added points


@pytest.mark.parametrize("kind", ["nerf", "dtu", "tyt"])
def test_train_run_segmentation_on_the_cpu(tmp_path, rng, monkeypatch, kind):
    """train --run_segmentation --device cpu from a temporary working
    directory, on test_pipeline_interop.py's nerf scan (no point lands in a
    mask: the reference's nerf principal point), on the DTU scan and on the
    TYT scan of JPEG photos (the augmentation adds points): the pipeline's
    artifacts under identification/results, the Scene's point count and
    segments those of the JAX Scene on them, and 3 iterations on that
    cloud."""
    scan = tmp_path / "scan"
    {"nerf": _interop_scan, "dtu": _dtu_scan, "tyt": _tyt_scan}[kind](scan, rng)
    work = tmp_path / "work"
    os.makedirs(work)
    monkeypatch.chdir(work)
    # the TYT photos train at -r 8 (the port's copy of Pillow's resize of a JPEG)
    res = "8" if kind == "tyt" else "1"
    state, _ = ttrain.main(["-s", str(scan), "-m", str(tmp_path / "out"), "--run_segmentation",
                            "--dataset_type", kind, "--device", "cpu", "--iterations", "3",
                            "--sh_degree", "1", "--resolution", res, "--test_iterations", "3",
                            "--capacity", "4096", "--no_tensorboard", "--quiet",
                            "--dino_mode", "off"])
    pc = work / "identification" / "results" / "segments" / "point_cloud"
    for name in ("segmented_point_cloud.ply", "segment_indices.npy", "mask_areas.npy"):
        assert (pc / name).exists(), name
    ref = JScene(JModelParams(source_path=str(scan), model_path=str(tmp_path / "jax"),
                              sh_degree=1, resolution=1), capacity=4096, seed=0)
    assert "segmented_point_cloud" in ref.info.ply_path
    n = int(state.n_active)
    assert n == int(ref.gaussians.n_active)
    assert (n > 300) == (kind != "nerf")
    np.testing.assert_array_equal(state.aux.segments[:n].numpy(),
                                  np.asarray(ref.gaussians.aux.segments)[:n])
    assert (tmp_path / "out" / "point_cloud" / "iteration_3" / "point_cloud.ply").exists()


# -- convert ---------------------------------------------------------------------------

FAKE_COLMAP = """#!{python}
import os, sys
with open(os.environ["COLMAP_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
args = dict(zip(sys.argv[2::2], sys.argv[3::2]))
if sys.argv[1] == "image_undistorter":
    out = args["--output_path"]
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        open(os.path.join(out, "sparse", name), "w").close()
    for name in sorted(os.listdir(args["--image_path"])):
        with open(os.path.join(args["--image_path"], name), "rb") as src:
            data = src.read()
        with open(os.path.join(out, "images", name), "wb") as dst:
            dst.write(data)
sys.exit(int(os.environ.get("COLMAP_FAIL_" + sys.argv[1], "0")))
"""


def _convert_source(root, rng):
    os.makedirs(root / "input")
    for i, (mode, shape) in enumerate((("RGB", (45, 61, 3)), ("RGBA", (33, 50, 4)),
                                       ("L", (40, 40)))):
        Image.fromarray((rng.random(shape) * 256).astype(np.uint8), mode).save(
            root / "input" / f"{i:03d}.png")


@pytest.fixture
def fake_colmap(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    os.makedirs(bindir)
    exe = bindir / "colmap"
    exe.write_text(FAKE_COLMAP.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("COLMAP_LOG", str(tmp_path / "colmap.log"))
    return tmp_path / "colmap.log"


def test_convert_matches_jax_with_a_fake_colmap(tmp_path, rng, fake_colmap, capsys):
    """The same colmap command lines in the same order, the sparse/0 moves,
    and --resize copies equal to PIL's resize (decoded)."""
    _convert_source(tmp_path / "port", rng)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    for name, mod in (("port", tconvert), ("jax", jconvert)):
        src = tmp_path / name
        mod.main(["-s", str(src), "--resize", "--no_gpu"])
        assert sorted(os.listdir(src / "sparse" / "0")) == ["cameras.bin", "images.bin",
                                                           "points3D.bin"]
    log = fake_colmap.read_text().splitlines()
    assert len(log) == 8
    assert [line.replace("/port", "/jax") for line in log[:4]] == log[4:]
    assert [line.split()[0] for line in log[:4]] == ["feature_extractor", "exhaustive_matcher",
                                                     "mapper", "image_undistorter"]
    for factor in (2, 4, 8):
        names = sorted(os.listdir(tmp_path / "jax" / f"images_{factor}"))
        assert names == sorted(os.listdir(tmp_path / "port" / f"images_{factor}"))
        for name in names:
            with Image.open(tmp_path / "jax" / f"images_{factor}" / name) as im:
                ref = np.asarray(im)
            np.testing.assert_array_equal(read_png(str(tmp_path / "port" / f"images_{factor}"
                                                       / name)), ref)


def test_convert_resize_of_jpeg_photos_equals_jax_byte_for_byte(tmp_path, rng, fake_colmap):
    """--resize on JPEG inputs (4:2:0 RGB from Pillow, a grey JPEG, a
    progressive one, an EXIF orientation-6 photo with a comment and an
    ICC profile, a 4:4:4 file from cv2): images_2/4/8 equal the JAX CLI's
    files byte for byte (Pillow's default save of the resized copy, which
    keeps the comment and drops EXIF and ICC)."""
    for name in ("port", "jax"):
        os.makedirs(tmp_path / name / "input")
    img = _blocky_image(rng, 88, 131)
    exif = Image.Exif()
    exif[0x0112] = 6
    saves = {"a.jpg": dict(quality=90), "b.jpg": dict(progressive=True),
             "c.jpeg": dict(exif=exif, comment=b"scan 7", icc_profile=b"\x00" * 128)}
    for fname, kw in saves.items():
        Image.fromarray(img).save(tmp_path / "port" / "input" / fname, **kw)
    Image.fromarray(img[..., 1]).save(tmp_path / "port" / "input" / "d.jpg")
    cv2.imwrite(str(tmp_path / "port" / "input" / "e.jpg"), img[..., ::-1],
                [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    for fname in os.listdir(tmp_path / "port" / "input"):
        shutil.copy(tmp_path / "port" / "input" / fname, tmp_path / "jax" / "input" / fname)
    tconvert.main(["-s", str(tmp_path / "port"), "--resize", "--no_gpu"])
    jconvert.main(["-s", str(tmp_path / "jax"), "--resize", "--no_gpu"])
    for factor in (2, 4, 8):
        names = sorted(os.listdir(tmp_path / "jax" / f"images_{factor}"))
        assert names == sorted(os.listdir(tmp_path / "port" / f"images_{factor}")) \
            == ["a.jpg", "b.jpg", "c.jpeg", "d.jpg", "e.jpg"]
        for name in names:
            got = (tmp_path / "port" / f"images_{factor}" / name).read_bytes()
            assert got == (tmp_path / "jax" / f"images_{factor}" / name).read_bytes(), name
    assert b"scan 7" in (tmp_path / "port" / "images_2" / "c.jpeg").read_bytes()


def test_convert_refuses_what_it_cannot_do(tmp_path, rng, fake_colmap, monkeypatch, capsys):
    """A failing colmap step exits with its code as JAX's does; with
    --resize a BMP input (which Pillow reads and the port does not) is
    refused before colmap runs or anything is written; without colmap on
    PATH both exit 1 with the same message."""
    src = tmp_path / "src"
    _convert_source(src, rng)
    monkeypatch.setenv("COLMAP_FAIL_mapper", "3")
    for mod in (tconvert, jconvert):
        with pytest.raises(SystemExit) as e:
            mod.main(["-s", str(src)])
        assert e.value.code == 3
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src / "input" / "photo.bmp")
    before = fake_colmap.read_text()
    shutil.rmtree(src / "distorted")
    with pytest.raises(ValueError, match="no BMP decoder"):
        tconvert.main(["-s", str(src), "--resize"])
    assert fake_colmap.read_text() == before and not (src / "distorted").exists()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    capsys.readouterr()
    for mod in (tconvert, jconvert):
        with pytest.raises(SystemExit) as e:
            mod.main(["-s", str(src)])
        assert e.value.code == 1
        assert capsys.readouterr().err == "error: colmap binary not found on PATH\n"
