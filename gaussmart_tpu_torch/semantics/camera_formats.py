"""Benchmark-dataset camera formats for the segmentation pipeline (the
port's own numpy copy of gaussmart_tpu/semantics/camera_formats.py).

Parity with reference identification/camera_loader.py + analyze_cameras.py:
autodetect dtu (.npz world/camera/scale mats) / nerf (.npy 17|19 cols) /
tyt (.npy 14|16 cols, half-split, hardcoded intrinsics fx=501 fy=277
W,H=979,543), plus position/Euler-angle statistics.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

TYT_DEFAULT_WH = (979, 543)
TYT_DEFAULT_INTRINSICS = dict(fx=501.0, fy=277.0)


def detect_format(camera_path: str) -> str:
    ext = os.path.splitext(camera_path)[1].lower()
    if ext == ".npz":
        try:
            keys = set(np.load(camera_path).files)
            if (any(k.startswith("world_mat_") for k in keys)
                    and any(k.startswith("camera_mat_") for k in keys)):
                return "dtu"
        except Exception:
            pass
    elif ext == ".npy":
        try:
            data = np.load(camera_path)
            if data.ndim == 2:
                if data.shape[1] in (17, 19):
                    return "nerf"
                if data.shape[1] in (14, 16):
                    return "tyt"
        except Exception:
            pass
    raise ValueError(f"Unrecognized camera data format: {camera_path}")


def load_dtu(camera_path: str) -> Dict[int, Dict[str, Any]]:
    npz = np.load(camera_path)
    views: Dict[int, Dict[str, Any]] = {}
    for key in npz.files:
        if "_" not in key:
            continue
        mat_type, view_str = key.rsplit("_", 1)
        if view_str.isdigit():
            views.setdefault(int(view_str), {})[mat_type] = npz[key]
    for vid, cam in views.items():
        for req in ("world_mat", "camera_mat", "scale_mat"):
            if req not in cam:
                raise AssertionError(f"DTU view {vid} missing {req}")
    return views


def load_nerf(camera_path: str, img_wh: Tuple[int, int] = (1024, 1024)
              ) -> Dict[int, Dict[str, Any]]:
    data = np.load(camera_path)
    W, H = img_wh
    views = {}
    for i, row in enumerate(data):
        c2w = row[:16].reshape(4, 4)
        focal = float(row[16])
        cam_mat = np.array([[focal, 0, W / 2, 0], [0, focal, H / 2, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]], float)
        entry = {"world_mat": np.linalg.inv(c2w), "camera_mat": cam_mat,
                 "scale_mat": np.eye(4)}
        if row.size >= 19:
            entry["bounds"] = row[17:19].astype(float)
        views[i] = entry
    return views


def load_tyt(camera_path: str, img_wh: Optional[Tuple[int, int]] = None,
             intrinsics: Optional[Dict[str, float]] = None
             ) -> Dict[int, Dict[str, Any]]:
    data = np.load(camera_path)
    data = data[:data.shape[0] // 2]       # half-split quirk (SURVEY.md §7.9)
    if img_wh is None:
        img_wh = TYT_DEFAULT_WH
    W, H = img_wh
    if intrinsics is None:
        intrinsics = dict(TYT_DEFAULT_INTRINSICS, cx=W / 2.0, cy=H / 2.0)

    positions = data[:, [3, 7, 11]]
    center = positions.mean(axis=0)
    scale = 1.0 / np.max(np.abs(positions - center))

    cam_mat = np.array([[intrinsics["fx"], 0, intrinsics["cx"], 0],
                        [0, intrinsics["fy"], intrinsics["cy"], 0],
                        [0, 0, 1, 0], [0, 0, 0, 1]], float)
    views = {}
    for i, pose in enumerate(data):
        c2w = np.eye(4)
        c2w[:3, :4] = pose[:12].reshape(3, 4)
        entry = {"world_mat": np.linalg.inv(c2w), "camera_mat": cam_mat,
                 "scale_mat": np.eye(4),
                 "img_size": np.array([W, H], int)}
        if pose.size >= 14:
            entry["bounds"] = pose[12:14].astype(float) * scale
        views[i] = entry
    return views


def load_cameras(camera_path: str, **kw) -> Tuple[Dict[int, Dict], str]:
    fmt = detect_format(camera_path)
    views = {"dtu": load_dtu, "nerf": load_nerf, "tyt": load_tyt}[fmt](
        camera_path, **kw)
    return views, fmt


class CameraAnalysis:
    """Loads views + basic statistics (identification/analyze_cameras.py)."""

    def __init__(self, camera_path: str, images_dir: str = ""):
        self.camera_path = camera_path
        self.images_dir = images_dir
        self.views, self.format_type = load_cameras(camera_path)
        print(f"Loaded {len(self.views)} views in {self.format_type} format")

    def analyze(self) -> Dict:
        positions, rotations = [], []
        for m in self.views.values():
            w = m["world_mat"]
            positions.append(w[:3, 3])
            rotations.append(w[:3, :3])
        P = np.array(positions)
        stats = {
            "format_type": self.format_type,
            "num_cameras": len(P),
            "position_range": {ax: (float(P[:, i].min()), float(P[:, i].max()))
                               for i, ax in enumerate("xyz")},
            "position_mean": P.mean(axis=0).tolist(),
            "position_std": P.std(axis=0).tolist(),
        }
        if rotations:
            angles = np.degrees(np.array([_euler(R) for R in rotations]))
            stats["angle_distribution"] = {
                "mean": angles.mean(axis=0).tolist(),
                "std": angles.std(axis=0).tolist()}
        return stats


def _euler(R: np.ndarray):
    roll = np.arctan2(R[2, 1], R[2, 2])
    pitch = np.arctan2(-R[2, 0], np.sqrt(R[2, 1] ** 2 + R[2, 2] ** 2))
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return roll, pitch, yaw
