"""DTU Chamfer-distance evaluation (DTUeval-python protocol); counterpart
of gaussmart_tpu/eval/chamfer.py, the same numpy/scipy code.

Metric parity with reference scripts/eval_dtu/eval.py:10-166: mesh-surface
stratified sampling at `downsample_density` spacing, greedy radius
deduplication, ObsMask bounding + visibility filtering, ground-plane
filtering of the GT, bidirectional 1-NN distances clipped at `max_dist`,
overall = mean(d2s, s2d). Vectorized numpy/scipy (the reference shells out
to a multiprocessing loop); no open3d.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from gaussmart_tpu_torch.mesh.meshing import TriMesh


def sample_mesh_surface(mesh: TriMesh, thresh: float) -> np.ndarray:
    """Stratified surface samples at ~`thresh` spacing + original vertices
    (eval.py:10-72 scheme, batched by unique grid sizes)."""
    v = np.asarray(mesh.vertices, np.float64)
    tri = v[mesh.faces]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    l1 = np.linalg.norm(v1, axis=-1)
    l2 = np.linalg.norm(v2, axis=-1)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1)
    ok = area2 > 0
    v0, v1, v2, l1, l2, area2 = tri[ok, 0], v1[ok], v2[ok], l1[ok], l2[ok], area2[ok]
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1 / thr).astype(np.int64)
    n2 = np.floor(l2 / thr).astype(np.int64)

    out = [v]
    pairs = np.stack([n1, n2], axis=1)
    for (a, b) in np.unique(pairs, axis=0):
        if a == 0 and b == 0:
            continue
        sel = (n1 == a) & (n2 == b)
        c = np.mgrid[:a + 1, :b + 1].astype(np.float64) + 0.5
        c[0] /= max(a, 1e-7)
        c[1] /= max(b, 1e-7)
        c = c.transpose(1, 2, 0).reshape(-1, 2)
        k = c[c.sum(axis=-1) < 1]                     # [m,2] barycentric
        if len(k) == 0:
            continue
        # [S,1,3]*[m,1] broadcast -> [S,m,3]
        q = (v1[sel][:, None, :] * k[None, :, 0:1]
             + v2[sel][:, None, :] * k[None, :, 1:2]
             + v0[sel][:, None, :])
        out.append(q.reshape(-1, 3))
    return np.concatenate(out, axis=0)


def radius_downsample(points: np.ndarray, thresh: float,
                      seed: int = 0) -> np.ndarray:
    """Greedy poisson-disk-like dedup: keep a point, drop all others within
    `thresh` (eval.py:85-98)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(points))
    pts = points[order]
    tree = cKDTree(pts)
    mask = np.ones(len(pts), bool)
    neighbor_lists = tree.query_ball_point(pts, thresh, workers=-1)
    for i, idxs in enumerate(neighbor_lists):
        if mask[i]:
            mask[idxs] = False
            mask[i] = True
    return pts[mask]


def load_obsmask(dataset_dir: str, scan: int):
    from scipy.io import loadmat

    m = loadmat(os.path.join(dataset_dir, "ObsMask", f"ObsMask{scan}_10.mat"))
    return m["ObsMask"], m["BB"].astype(np.float32), m["Res"]


def load_ground_plane(dataset_dir: str, scan: int) -> np.ndarray:
    from scipy.io import loadmat

    return loadmat(os.path.join(dataset_dir, "ObsMask",
                                f"Plane{scan}.mat"))["P"]


def nn_distances(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    from scipy.spatial import cKDTree

    d, _ = cKDTree(ref).query(query, k=1, workers=-1)
    return d


def dtu_chamfer(
    data_points: np.ndarray,          # sampled + downsampled reconstruction
    stl_points: np.ndarray,           # GT structured-light scan
    obs_mask=None, bb=None, res=None,
    ground_plane: Optional[np.ndarray] = None,
    patch_size: float = 60.0,
    max_dist: float = 20.0,
) -> Dict[str, float]:
    data_in = data_points
    if bb is not None:
        inbound = ((data_points >= bb[:1] - patch_size)
                   & (data_points < bb[1:] + patch_size * 2)).sum(-1) == 3
        data_in = data_points[inbound]
    data_in_obs = data_in
    if obs_mask is not None:
        grid = np.around((data_in - bb[:1]) / res).astype(np.int32)
        gin = ((grid >= 0) & (grid < np.expand_dims(obs_mask.shape, 0))
               ).sum(-1) == 3
        gi = grid[gin]
        in_obs = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
        data_in_obs = data_in[gin][in_obs]

    d2s = nn_distances(data_in_obs, stl_points)
    mean_d2s = float(d2s[d2s < max_dist].mean())

    stl_above = stl_points
    if ground_plane is not None:
        hom = np.concatenate([stl_points, np.ones_like(stl_points[:, :1])], -1)
        stl_above = stl_points[(ground_plane.reshape(1, 4) * hom).sum(-1) > 0]

    s2d = nn_distances(stl_above, data_in)
    mean_s2d = float(s2d[s2d < max_dist].mean())

    return {"mean_d2s": mean_d2s, "mean_s2d": mean_s2d,
            "overall": (mean_d2s + mean_s2d) / 2}


def evaluate_dtu_mesh(mesh_path: str, scan: int, dataset_dir: str,
                      out_dir: str, downsample_density: float = 0.2,
                      patch_size: float = 60.0, max_dist: float = 20.0
                      ) -> Dict[str, float]:
    """Full scan evaluation against the official DTU GT layout."""
    from gaussmart_tpu_torch.mesh.meshing import load_mesh_ply
    from gaussmart_tpu_torch.io.ply import fetch_point_cloud

    mesh = load_mesh_ply(mesh_path)
    samples = sample_mesh_surface(mesh, downsample_density)
    data_down = radius_downsample(samples, downsample_density)

    obs_mask, bb, res = load_obsmask(dataset_dir, scan)
    plane = load_ground_plane(dataset_dir, scan)
    stl, _, _ = fetch_point_cloud(os.path.join(
        dataset_dir, "Points", "stl", f"stl{scan:03d}_total.ply"))

    results = dtu_chamfer(data_down, stl.astype(np.float64), obs_mask, bb,
                          res, plane, patch_size, max_dist)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=True)
    print(results["mean_d2s"], results["mean_s2d"], results["overall"])
    return results


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--scan", type=int, default=1)
    p.add_argument("--dataset_dir", type=str, default=".")
    p.add_argument("--vis_out_dir", type=str, default=".")
    p.add_argument("--downsample_density", type=float, default=0.2)
    p.add_argument("--patch_size", type=float, default=60)
    p.add_argument("--max_dist", type=float, default=20)
    a = p.parse_args(argv)
    evaluate_dtu_mesh(a.data, a.scan, a.dataset_dir, a.vis_out_dir,
                      a.downsample_density, a.patch_size, a.max_dist)


if __name__ == "__main__":
    main()
