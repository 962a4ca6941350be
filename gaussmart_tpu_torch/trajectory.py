"""Camera-path utilities for novel-view rendering & bounding estimation
(counterpart of gaussmart_tpu/trajectory.py).

viewmatrix/focus_point_fn/transform_poses_pca/generate_ellipse_path follow
the published Mip-NeRF 360 ellipse-path algorithm (Google's multinerf,
Apache-2.0), the same third-party-derived math as the JAX package's copy.
Images are saved through io/images.py; videos through cv2, imported only
when a video is written.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from gaussmart_tpu_torch.cameras import Camera
from gaussmart_tpu_torch.io.images import write_png, write_tiff_f32


def normalize(x):
    return x / np.linalg.norm(x)


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def viewmatrix(lookdir, up, position):
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Nearest point to all camera focal axes."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses: np.ndarray):
    """Align principal axes of camera positions to XYZ."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eig(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1, 1, -1]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag([1, -1, -1]) @ poses_recentered
        transform = np.diag([1, -1, -1, 1]) @ transform
    return np.real(poses_recentered), np.real(transform)


def generate_ellipse_path(poses: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0):
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2]
                           * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ], -1)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)[:-1]
    avg_up = normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack([viewmatrix(p - center, up, p) for p in positions])


def cameras_c2w(cameras: List[Camera]) -> np.ndarray:
    """Column-vector camera-to-world matrices for a camera list."""
    return np.array([c.c2w() for c in cameras])


def generate_path(viewpoint_cameras: List[Camera], n_frames: int = 480
                  ) -> List[Camera]:
    """Elliptical novel-view trajectory through the capture
    (render_utils.py:173-194)."""
    c2ws = cameras_c2w(viewpoint_cameras)
    pose = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    pose_recenter, colmap_to_world = transform_poses_pca(pose)
    new_poses = generate_ellipse_path(pose_recenter, n_frames=n_frames)
    new_poses = np.linalg.inv(colmap_to_world) @ pad_poses(new_poses)

    ref = viewpoint_cameras[0]
    traj = []
    for c2w in new_poses:
        c2w = c2w @ np.diag([1, -1, -1, 1.0])
        w2c = np.linalg.inv(c2w)
        cam = Camera(uid=ref.uid, colmap_id=ref.colmap_id,
                     image_name="traj", R=w2c[:3, :3].T, T=w2c[:3, 3],
                     fovx=ref.fovx, fovy=ref.fovy,
                     width=int(ref.width / 2) * 2,
                     height=int(ref.height / 2) * 2)
        traj.append(cam)
    return traj


def estimate_bounding_sphere(cameras: List[Camera]):
    """(center, radius) from camera focal axes (mesh_utils.py:125-137)."""
    c2ws = cameras_c2w(cameras)
    poses = c2ws[:, :3, :] @ np.diag([1, -1, -1, 1])
    center = focus_point_fn(poses)
    radius = np.linalg.norm(c2ws[:, :3, 3] - center, axis=-1).min()
    return center, float(radius)


def save_img_u8(img: np.ndarray, path: str):
    write_png(path, np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8))


def save_img_f32(depth: np.ndarray, path: str):
    write_tiff_f32(path, np.asarray(depth).astype(np.float32))


def create_video(frames: List[np.ndarray], path: str, fps: int = 30):
    """Video export via cv2: H.264 (avc1) where the build provides an
    encoder, else MPEG-4 part 2 (mp4v)."""
    import cv2
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = None
    for codec in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps,
                                 (w, h))
        if writer.isOpened():
            break
        writer.release()
        writer = None
    if writer is None:
        raise RuntimeError(f"no usable mp4 encoder for {path}")
    for f in frames:
        u8 = np.clip(np.asarray(f) * 255, 0, 255).astype(np.uint8)
        writer.write(cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
    writer.release()
