"""Tanks & Temples F-score evaluation; counterpart of
gaussmart_tpu/eval/tnt_fscore.py, the same numpy/scipy code.

Metric parity with reference scripts/eval_tnt/ (vendored TnT toolbox):
per-scene tau thresholds (config.py:33-41), trajectory alignment from .log
camera files + Umeyama/ICP refinement (registration.py:65-199, run.py:146-
161), crop-volume filtering, voxel downsample, and the EvaluateHisto
precision/recall/F-score from bidirectional nearest-neighbor distances
(evaluation.py:60-120). Implemented on scipy cKDTree — no open3d.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

# per-scene distance thresholds tau (scripts/eval_tnt/config.py:33-41)
SCENE_TAU = {
    "Barn": 0.01, "Caterpillar": 0.005, "Church": 0.025,
    "Courthouse": 0.025, "Ignatius": 0.003, "Meetingroom": 0.01,
    "Truck": 0.005,
}


# --- trajectory (.log) IO ---------------------------------------------------

class CameraPose:
    def __init__(self, meta, mat):
        self.metadata = meta
        self.pose = mat


def read_trajectory(filename: str) -> List[CameraPose]:
    traj = []
    with open(filename) as f:
        metastr = f.readline()
        while metastr:
            metadata = list(map(int, metastr.split()))
            mat = np.zeros((4, 4))
            for i in range(4):
                mat[i] = np.array(f.readline().split(), dtype=float)
            traj.append(CameraPose(metadata, mat))
            metastr = f.readline()
    return traj


def write_trajectory(traj: List[CameraPose], filename: str):
    with open(filename, "w") as f:
        for c in traj:
            f.write(" ".join(map(str, c.metadata)) + "\n")
            for row in c.pose:
                f.write(" ".join(repr(float(v)) for v in row) + "\n")


# --- rigid alignment ---------------------------------------------------------

def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True
            ) -> np.ndarray:
    """Least-squares similarity transform dst ~= s*R*src + t -> 4x4."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var = (sc**2).sum() / len(src)
        s = np.trace(np.diag(S) @ D) / var
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def trajectory_alignment(traj_est: List[CameraPose],
                         traj_gt: List[CameraPose]) -> np.ndarray:
    """Similarity transform from estimated camera centers to GT centers."""
    n = min(len(traj_est), len(traj_gt))
    src = np.stack([c.pose[:3, 3] for c in traj_est[:n]])
    dst = np.stack([c.pose[:3, 3] for c in traj_gt[:n]])
    return umeyama(src, dst, with_scale=True)


def icp_refine(source: np.ndarray, target: np.ndarray,
               init: Optional[np.ndarray] = None, threshold: float = 0.05,
               iters: int = 20) -> np.ndarray:
    """Point-to-point ICP (the reference runs 3 stages of o3d ICP)."""
    from scipy.spatial import cKDTree

    T = np.eye(4) if init is None else init.copy()
    src = source @ T[:3, :3].T + T[:3, 3]
    tree = cKDTree(target)
    prev_err = np.inf
    for _ in range(iters):
        d, idx = tree.query(src, k=1, workers=-1)
        keep = d < threshold
        if keep.sum() < 10:
            break
        Td = umeyama(src[keep], target[idx[keep]], with_scale=False)
        src = src @ Td[:3, :3].T + Td[:3, 3]
        T = Td @ T
        err = d[keep].mean()
        if abs(prev_err - err) < 1e-9:
            break
        prev_err = err
    return T


# --- crop volumes ------------------------------------------------------------

def load_crop_volume(json_path: str):
    """open3d SelectionPolygonVolume json: orthogonal-axis polygon crop."""
    with open(json_path) as f:
        d = json.load(f)
    axis = d["orthogonal_axis"].lower()
    poly = np.array(d["bounding_polygon"])
    return {"axis": axis, "polygon": poly,
            "min": d["axis_min"], "max": d["axis_max"]}


def crop_points(points: np.ndarray, vol) -> np.ndarray:
    axis_idx = {"x": 0, "y": 1, "z": 2}[vol["axis"]]
    other = [i for i in range(3) if i != axis_idx]
    mask = ((points[:, axis_idx] >= vol["min"])
            & (points[:, axis_idx] <= vol["max"]))
    poly2d = vol["polygon"][:, other]
    mask &= _points_in_polygon(points[:, other], poly2d)
    return mask


def _points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd rule."""
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), bool)
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        cond = ((yi > y) != (yj > y)) & (
            x < (xj - xi) * (y - yi) / (yj - yi + 1e-30) + xi)
        inside ^= cond
        j = i
    return inside


# --- core metric -------------------------------------------------------------

def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]


def evaluate_histogram(source: np.ndarray, target: np.ndarray, tau: float
                       ) -> Dict[str, float]:
    """Precision/recall/F at tau from bidirectional NN distances
    (evaluation.py:60-120)."""
    from scipy.spatial import cKDTree

    d1, _ = cKDTree(target).query(source, k=1, workers=-1)  # precision dists
    d2, _ = cKDTree(source).query(target, k=1, workers=-1)  # recall dists
    precision = float((d1 < tau).mean()) * 100
    recall = float((d2 < tau).mean()) * 100
    fscore = (2 * precision * recall / (precision + recall)
              if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "fscore": fscore,
            "tau": tau}


def run_evaluation(
    reconstruction: np.ndarray,
    gt_points: np.ndarray,
    scene: str,
    *,
    traj_est: Optional[List[CameraPose]] = None,
    traj_gt: Optional[List[CameraPose]] = None,
    crop_json: Optional[str] = None,
    out_dir: Optional[str] = None,
    tau: Optional[float] = None,
) -> Dict[str, float]:
    """Full TnT protocol: align -> crop -> downsample -> ICP refine -> F."""
    tau = tau if tau is not None else SCENE_TAU.get(scene, 0.01)

    T = np.eye(4)
    if traj_est is not None and traj_gt is not None:
        T = trajectory_alignment(traj_est, traj_gt)
    rec = reconstruction @ T[:3, :3].T + T[:3, 3]

    if crop_json:
        vol = load_crop_volume(crop_json)
        rec = rec[crop_points(rec, vol)]
        gt_points = gt_points[crop_points(gt_points, vol)]

    rec = voxel_downsample(rec, tau)
    gt_d = voxel_downsample(gt_points, tau)

    # 3-stage ICP refinement with shrinking thresholds (run.py:156-160)
    for mult in (5.0, 2.5, 1.0):
        Ti = icp_refine(rec, gt_d, threshold=tau * 10 * mult, iters=10)
        rec = rec @ Ti[:3, :3].T + Ti[:3, 3]

    results = evaluate_histogram(rec, gt_d, tau)
    results["scene"] = scene
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{scene}_results.json"), "w") as f:
            json.dump(results, f, indent=True)
    print(f"[{scene}] precision={results['precision']:.2f} "
          f"recall={results['recall']:.2f} F={results['fscore']:.2f} @tau={tau}")
    return results


def main(argv=None):
    import argparse
    from gaussmart_tpu_torch.io.ply import fetch_point_cloud
    from gaussmart_tpu_torch.mesh.meshing import load_mesh_ply

    p = argparse.ArgumentParser()
    p.add_argument("--dataset-dir", required=True,
                   help="dir with <scene>.ply GT, <scene>.json crop, "
                        "<scene>_COLMAP_SfM.log / <scene>_trans.txt")
    p.add_argument("--traj-path", required=True)
    p.add_argument("--ply-path", required=True)
    p.add_argument("--out-dir", default=".")
    a = p.parse_args(argv)

    scene = os.path.basename(os.path.normpath(a.dataset_dir))
    mesh = load_mesh_ply(a.ply_path)
    # surface sample the reconstruction mesh at tau/2 density
    from gaussmart_tpu_torch.eval.chamfer import sample_mesh_surface
    tau = SCENE_TAU.get(scene, 0.01)
    rec = sample_mesh_surface(mesh, tau / 2)

    gt, _, _ = fetch_point_cloud(os.path.join(a.dataset_dir, f"{scene}.ply"))
    traj_est = read_trajectory(a.traj_path)
    gt_log = os.path.join(a.dataset_dir, f"{scene}_COLMAP_SfM.log")
    traj_gt = read_trajectory(gt_log) if os.path.exists(gt_log) else None
    crop = os.path.join(a.dataset_dir, f"{scene}.json")
    run_evaluation(rec, gt.astype(np.float64), scene,
                   traj_est=traj_est, traj_gt=traj_gt,
                   crop_json=crop if os.path.exists(crop) else None,
                   out_dir=a.out_dir, tau=tau)


if __name__ == "__main__":
    main()
