"""Scene/dataset readers: COLMAP and Blender (NeRF-synthetic) formats
(counterpart of gaussmart_tpu/io/dataset.py).

Same rules as the JAX package: nerf++ normalization radius, llffhold-8
eval split, segment-artifact loading, the 1600px auto-downscale rule and
RGBA->mask splitting. Images are decoded by io/images.py (PNG only) to
numpy float32 CHW on the host; a resize, where the resolution rule asks
for one, is a bicubic antialiased torch resample, which is close to but
not bit-equal with the PIL resize the JAX package uses.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from gaussmart_tpu_torch.cameras import Camera, focal2fov, fov2focal, world_to_view
from gaussmart_tpu_torch.io import colmap
from gaussmart_tpu_torch.io.images import png_size, read_png
from gaussmart_tpu_torch.io.ply import fetch_point_cloud, store_point_cloud
from gaussmart_tpu_torch.ops.sh import sh2rgb

# identification-pipeline artifact locations (working-directory relative,
# plus a source-dir-relative variant)
SEGMENT_ARTIFACT_DIRS = [
    os.path.join("identification", "results", "segments", "point_cloud"),
    os.path.join("segmentation", "results", "point_cloud"),
]


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovy: float
    fovx: float
    image_path: str
    image_name: str
    width: int
    height: int
    # Blender images need alpha compositing at load time
    white_background: Optional[bool] = None


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    segments: np.ndarray
    mask_areas: Dict[int, float]


@dataclasses.dataclass
class SceneInfo:
    point_cloud: PointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: Dict
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]) -> Dict:
    """Camera-bounding-sphere normalization."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T).T  # column-vector
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers, axis=0)
    center = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return {"translate": -center, "radius": diagonal * 1.1}


def load_segment_artifacts(n_points: int, extra_dirs: List[str] = ()):
    """Segment indices + mask areas from the identification pipeline."""
    segments = None
    mask_areas: Dict[int, float] = {}
    dirs = list(extra_dirs) + SEGMENT_ARTIFACT_DIRS
    for d in dirs:
        p = os.path.join(d, "segment_indices.npy")
        if segments is None and os.path.exists(p):
            segments = np.load(p)
    for d in dirs:
        p = os.path.join(d, "mask_areas.npy")
        if not mask_areas and os.path.exists(p):
            mask_areas = np.load(p, allow_pickle=True).item()
    if segments is None:
        segments = np.zeros(n_points, np.int32)
    return segments, mask_areas


def fetch_pcd(path: str, extra_artifact_dirs: List[str] = ()) -> PointCloud:
    pts, cols, normals = fetch_point_cloud(path)
    segments, mask_areas = load_segment_artifacts(len(pts), extra_artifact_dirs)
    # length reconciliation, as in the JAX package
    if len(segments) != len(pts):
        m = min(len(segments), len(pts))
        pts, cols, normals, segments = pts[:m], cols[:m], normals[:m], segments[:m]
    return PointCloud(pts, cols, normals, segments.astype(np.int32), mask_areas)


def read_colmap_scene(path: str, images: str = "images", eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cam_infos = []
    for key in extr:
        e = extr[key]
        i = intr[e.camera_id]
        R = colmap.qvec2rotmat(e.qvec).T
        if i.model == "SIMPLE_PINHOLE":
            fovx = focal2fov(i.params[0], i.width)
            fovy = focal2fov(i.params[0], i.height)
        elif i.model == "PINHOLE":
            fovx = focal2fov(i.params[0], i.width)
            fovy = focal2fov(i.params[1], i.height)
        else:
            raise ValueError(
                f"Unsupported COLMAP camera model {i.model}: undistort first "
                "(PINHOLE / SIMPLE_PINHOLE only)")
        image_path = os.path.join(path, images, os.path.basename(e.name))
        cam_infos.append(CameraInfo(
            uid=i.id, R=R, T=np.array(e.tvec), fovx=fovx, fovy=fovy,
            image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=i.width, height=i.height))
    cam_infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = nerfpp_norm(train)

    # prefer the identification pipeline's cleaned+segmented cloud
    ply_path = None
    for d in SEGMENT_ARTIFACT_DIRS:
        p = os.path.join(d, "segmented_point_cloud.ply")
        if os.path.exists(p):
            ply_path = p
            break
    if ply_path is None:
        ply_path = os.path.join(sparse, "points3D.ply")
        if not os.path.exists(ply_path):
            try:
                xyz, rgb, _ = colmap.read_points3d_binary(
                    os.path.join(sparse, "points3D.bin"))
            except FileNotFoundError:
                xyz, rgb, _ = colmap.read_points3d_text(
                    os.path.join(sparse, "points3D.txt"))
            store_point_cloud(ply_path, xyz, rgb)

    pcd = fetch_pcd(ply_path)
    return SceneInfo(pcd, train, test, norm, ply_path)


def read_blender_scene(path: str, white_background: bool,
                       eval_split: bool = False, extension: str = ".png",
                       rng: Optional[np.random.Generator] = None) -> SceneInfo:
    """NeRF-synthetic reader."""
    def read_transforms(fname, uid0):
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            img_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1          # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = w2c[:3, :3].T
            T = w2c[:3, 3]
            width, height = png_size(img_path)
            fovy = focal2fov(fov2focal(fovx, width), height)
            infos.append(CameraInfo(
                uid=uid0 + idx, R=R, T=T, fovx=fovx, fovy=fovy,
                image_path=img_path, image_name=Path(img_path).stem,
                width=width, height=height, white_background=white_background))
        return infos

    train = read_transforms("transforms_train.json", 0)
    test = read_transforms("transforms_test.json", len(train))
    if not eval_split:
        train = train + test
        test = []
    norm = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = rng or np.random.default_rng(0)
        num_pts = 100_000
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        store_point_cloud(ply_path, xyz, sh2rgb(shs) * 255)
    pcd = fetch_pcd(ply_path)
    return SceneInfo(pcd, train, test, norm, ply_path)


def detect_and_read(source_path: str, images: str = "images",
                    white_background: bool = False,
                    eval_split: bool = False) -> SceneInfo:
    """Scene-type autodetect."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, images, eval_split)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        return read_blender_scene(source_path, white_background, eval_split)
    raise ValueError(f"Could not recognize scene type at {source_path}")


# -- image loading with the resolution rules --------------------------------

AUTO_CAP_WIDTH = 1600


def compute_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0):
    """Divisors {1,2,4,8}; -1 means auto-cap at 1600px width; other values
    are an explicit target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / AUTO_CAP_WIDTH if orig_w > AUTO_CAP_WIDTH else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _resize_u8(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H,W(,C)] -> uint8 [h,w(,C)]; identity when the size matches."""
    if img.shape[1] == w and img.shape[0] == h:
        return img
    x = torch.from_numpy(img.astype(np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(x, size=(h, w), mode="bicubic",
                                        align_corners=False, antialias=True)
    y = y[0, 0] if img.ndim == 2 else y[0].permute(1, 2, 0)
    return y.round().clamp(0, 255).to(torch.uint8).numpy()


def load_camera(info: CameraInfo, resolution: int = -1,
                resolution_scale: float = 1.0) -> Camera:
    """Decode + resize the image, build the Camera."""
    raw = read_png(info.image_path)
    w, h = compute_resolution(raw.shape[1], raw.shape[0], resolution,
                              resolution_scale)
    if info.white_background is not None and raw.ndim == 3 and raw.shape[2] == 4:
        # Blender/NeRF-synthetic: composite onto the background at FULL
        # resolution BEFORE resizing (resizing straight alpha first bleeds
        # the RGB of fully transparent pixels into object edges)
        full = raw.astype(np.float32) / 255.0
        bg = 1.0 if info.white_background else 0.0
        rgb = full[..., :3] * full[..., 3:4] + bg * (1 - full[..., 3:4])
        comp = (np.clip(rgb, 0, 1) * 255.0).astype(np.uint8)
        arr = _resize_u8(comp, w, h).astype(np.float32) / 255.0
    else:
        arr = _resize_u8(raw, w, h).astype(np.float32) / 255.0

    alpha_mask = None
    if arr.ndim == 3 and arr.shape[2] == 4:
        if info.white_background is not None:
            bg = 1.0 if info.white_background else 0.0
            rgb = arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])
        else:
            # COLMAP RGBA: raw RGB + a SEPARATE alpha mask (the training
            # target is the raw RGB; only mesh extraction reads the mask)
            rgb = arr[..., :3]
            alpha_mask = arr[..., 3:4].transpose(2, 0, 1)
        arr = rgb
    elif arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    image = np.clip(arr.transpose(2, 0, 1), 0.0, 1.0)

    return Camera(uid=info.uid, colmap_id=info.uid, image_name=info.image_name,
                  R=info.R, T=info.T, fovx=info.fovx, fovy=info.fovy,
                  width=image.shape[2], height=image.shape[1],
                  image=image, alpha_mask=alpha_mask)


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    """cameras.json entry."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
