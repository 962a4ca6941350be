#!/usr/bin/env python3
"""Geometry + image evaluation for the ray-traced synthetic scene
(counterpart of scripts/eval_synthetic.py, on the port's eval.chamfer and
mesh.meshing).

Closes the loop the DTU driver closes with real scans
(reference scripts/dtu_eval_mesh.py:39-50): sample the extracted TSDF mesh,
compute the bidirectional Chamfer distance against the analytic GT surface
samples the scene generator wrote (`gt_surface_points.npy`), and merge the
result with the metrics CLI's results.json. numpy/scipy on the host.

    python -m gaussmart_tpu_torch.scripts.eval_synthetic --scene <scene> \
        --model <trained model> --iteration 30000 [--crop_radius 2.0]

Prints one JSON line with chamfer (d2s, s2d, overall) per mesh found and
writes it to <model>/synthetic_eval.json.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

from gaussmart_tpu_torch.eval.chamfer import (nn_distances, radius_downsample,
                                              sample_mesh_surface)
from gaussmart_tpu_torch.mesh.meshing import load_mesh_ply


def chamfer_vs_gt(mesh_path: str, gt_pts: np.ndarray, downsample: float,
                  crop_radius: float = 0.0):
    """crop_radius > 0 restricts BOTH clouds to a sphere around the origin —
    the unbounded (M360-style) scene's foreground region, mirroring how DTU
    scores inside the ObsMask bounds (reference scripts/eval_dtu/eval.py)."""
    mesh = load_mesh_ply(mesh_path)
    if crop_radius > 0:
        # drop background faces BEFORE sampling — an unbounded mesh is
        # dominated by distant geometry that sampling at foreground density
        # would take hours over
        r = np.linalg.norm(mesh.vertices, axis=1)
        keep = (r[mesh.faces] < crop_radius * 1.1).all(axis=1)
        mesh = type(mesh)(mesh.vertices, mesh.faces[keep],
                          mesh.vertex_colors)
    samples = sample_mesh_surface(mesh, downsample)
    samples = radius_downsample(samples, downsample)
    if crop_radius > 0:
        samples = samples[np.linalg.norm(samples, axis=1) < crop_radius]
        gt_pts = gt_pts[np.linalg.norm(gt_pts, axis=1) < crop_radius]
    d2s = nn_distances(samples, gt_pts).mean()
    s2d = nn_distances(gt_pts, samples).mean()
    return {"mean_d2s": float(d2s), "mean_s2d": float(s2d),
            "overall": float((d2s + s2d) / 2.0),
            "n_mesh_samples": int(len(samples))}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", required=True)
    p.add_argument("--model", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--downsample", type=float, default=0.002,
                   help="sample spacing in world units (scene is ~4 units)")
    p.add_argument("--crop_radius", type=float, default=0.0,
                   help="score only inside this radius (unbounded scenes)")
    args = p.parse_args(argv)

    gt_pts = np.load(os.path.join(args.scene, "gt_surface_points.npy"))
    out = {"gt_points": int(len(gt_pts))}

    mesh_dir = os.path.join(args.model, "train", f"ours_{args.iteration}")
    meshes = sorted(glob.glob(os.path.join(mesh_dir, "fuse*.ply")))
    if not meshes:
        meshes = sorted(glob.glob(os.path.join(args.model, "fuse*.ply")))
    if not meshes:
        print(f"no fuse*.ply meshes under {mesh_dir}", file=sys.stderr)
    for m in meshes:
        out[os.path.basename(m)] = chamfer_vs_gt(m, gt_pts, args.downsample,
                                                 args.crop_radius)

    res = os.path.join(args.model, "results.json")
    if os.path.exists(res):
        with open(res) as f:
            out["image_metrics"] = json.load(f)

    print(json.dumps(out))
    with open(os.path.join(args.model, "synthetic_eval.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
