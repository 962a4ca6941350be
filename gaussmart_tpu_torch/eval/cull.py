"""Mask-based mesh culling before DTU Chamfer evaluation (counterpart of
gaussmart_tpu/eval/cull.py).

Behavior parity with reference scripts/eval_dtu/evaluate_single_scene.py:
19-101: project mesh vertices into every view with P = world_mat@scale_mat
decomposed into K[R|t], sample the 24px-dilated object masks, keep only
vertices visible inside a mask in EVERY view, then rescale vertices to
world via scale_mat. numpy only: the three OpenCV calls of the JAX
package (decomposeProjectionMatrix, the elliptical dilation, imread's
blue channel) have numpy counterparts here, held against OpenCV by the
tests.
"""
from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

from gaussmart_tpu_torch.io.images import read_image
from gaussmart_tpu_torch.mesh.meshing import TriMesh

DTU_WH = (1600, 1200)


def _givens_rq(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RQ decomposition of a 3x3 matrix, M = K @ Q with K upper triangular
    and Q a rotation, by three Givens rotations with OpenCV's sign rule
    (cv::RQDecomp3x3): K's first two diagonal entries are made positive by
    a 180-degree turn about z, y or x."""
    eps = np.finfo(np.float64).eps

    def cs(c, s):
        z = 1.0 / np.sqrt(c * c + s * s + eps)
        return c * z, s * z

    c, s = cs(M[2, 2], M[2, 1])
    qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    R = M @ qx
    R[2, 1] = 0.0
    c, s = cs(R[2, 2], -R[2, 0])
    qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    M2 = R @ qy
    M2[2, 0] = 0.0
    c, s = cs(M2[1, 1], M2[1, 0])
    qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    R = M2 @ qz
    R[1, 0] = 0.0
    flip = None
    if R[0, 0] < 0:
        flip = np.diag([-1.0, -1.0, 1.0]) if R[1, 1] < 0 else np.diag([-1.0, 1.0, -1.0])
    elif R[1, 1] < 0:
        flip = np.diag([1.0, -1.0, -1.0])
    if flip is not None:
        R = R @ flip
        qz = qz @ flip
    return R, qz.T @ qy.T @ qx.T


def decompose_projection_matrix(P: np.ndarray):
    """(K, R, t) of cv2.decomposeProjectionMatrix: P[:, :3] = K @ R by RQ
    decomposition, t the homogeneous camera centre (P's null vector)."""
    P = np.asarray(P, np.float64)
    K, R = _givens_rq(P[:, :3])
    t = np.linalg.svd(P)[2][3][:, None]
    return K, R, t


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decompose a 3x4 projection into intrinsics K (4x4) and pose c2w (4x4)
    via RQ decomposition (the IDR/DTU convention)."""
    K, R, t = decompose_projection_matrix(P)
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    return intrinsics, pose


def ellipse_half_widths(radius: int) -> np.ndarray:
    """Half-width of each row of cv2.getStructuringElement(MORPH_ELLIPSE,
    (2r+1, 2r+1)): row r+dy spans columns r-dx .. r+dx."""
    dy = np.arange(-radius, radius + 1)
    inv_r2 = 1.0 / (radius * radius) if radius else 0.0
    return np.rint(radius * np.sqrt((radius * radius - dy * dy) * inv_r2)).astype(np.int64)


def dilate_mask(mask: np.ndarray, radius: int = 24) -> np.ndarray:
    """cv2.dilate of a boolean mask by the elliptical structuring element
    of `radius` (pixels outside the image count as unset): each row of the
    ellipse is a horizontal run, found from a prefix count, shifted by its
    row offset."""
    m = np.asarray(mask, bool)
    H, W = m.shape
    csum = np.concatenate([np.zeros((H, 1), np.int64), np.cumsum(m, axis=1)], axis=1)
    x = np.arange(W)
    out = np.zeros_like(m)
    for dy, dx in zip(range(-radius, radius + 1), ellipse_half_widths(radius)):
        lo = np.clip(x - dx, 0, W)
        hi = np.clip(x + dx + 1, 0, W)
        run = (csum[:, hi] - csum[:, lo]) > 0       # any set pixel within dx
        # out[y] |= run[y + dy]
        if dy >= 0:
            out[:H - dy] |= run[dy:]
        else:
            out[-dy:] |= run[:H + dy]
    return out


def read_mask_channel(path: str) -> np.ndarray:
    """cv2.imread(path)[:, :, 0]: the blue channel of the image read as BGR
    and turned upright by its EXIF orientation (grey images give their
    grey level)."""
    img = read_image(path, exif_orientation=True)
    if img.ndim == 2:
        return img
    return img[..., 2] if img.shape[2] >= 3 else img[..., 0]


def cull_mesh_by_masks(mesh: TriMesh, cameras_npz: str, mask_dir: str,
                       image_wh: Tuple[int, int] = DTU_WH,
                       dilation: int = 24) -> TriMesh:
    cam = np.load(cameras_npz)
    n_images = sum(1 for k in cam.files if k.startswith("world_mat_")
                   and not k.startswith("world_mat_inv"))
    W, H = image_wh

    mask_paths = sorted(glob.glob(os.path.join(mask_dir, "*.png")))
    verts = np.asarray(mesh.vertices, np.float64)
    hom = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)

    keep = np.ones(len(verts), bool)
    scale_mat0 = cam["scale_mat_0"].astype(np.float64)
    for i in range(n_images):
        world_mat = cam[f"world_mat_{i}"].astype(np.float64)
        scale_mat = cam[f"scale_mat_{i}"].astype(np.float64)
        P = (world_mat @ scale_mat)[:3, :4]
        intr, pose = load_K_Rt_from_P(P)
        w2c = np.linalg.inv(pose)
        cp = (intr[:3, :3] @ (w2c[:3] @ hom.T))
        pix = cp[:2] / (cp[2:3] + 1e-6)
        u = pix[0]
        v = pix[1]
        valid = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1)
        if i < len(mask_paths):
            m = read_mask_channel(mask_paths[i]) > 127
            m = dilate_mask(m, dilation)
            mh, mw = m.shape
            ui = np.clip(np.round(u * (mw - 1) / (W - 1)).astype(int), 0, mw - 1)
            vi = np.clip(np.round(v * (mh - 1) / (H - 1)).astype(int), 0, mh - 1)
            inside = m[vi, ui]
        else:
            inside = np.ones(len(verts), bool)
        # outside the image counts as kept (1-valid term in the reference)
        keep &= inside | ~valid

    face_keep = keep[mesh.faces].all(axis=1)
    out = TriMesh(verts.copy(), mesh.faces[face_keep],
                  mesh.vertex_colors.copy() if mesh.vertex_colors is not None
                  else None)
    out = out.remove_unreferenced()
    # rescale to world (evaluate_single_scene.py:98-100)
    out.vertices = out.vertices * scale_mat0[0, 0] + scale_mat0[:3, 3][None]
    return out


def main(argv=None):
    import argparse
    from gaussmart_tpu_torch.mesh.meshing import load_mesh_ply, save_mesh_ply
    from gaussmart_tpu_torch.eval.chamfer import evaluate_dtu_mesh

    p = argparse.ArgumentParser("DTU single-scene culled evaluation")
    p.add_argument("--input_mesh", required=True)
    p.add_argument("--scan_id", type=int, required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--mask_dir", required=True,
                   help="dataset root containing scanN/{cameras.npz,mask}")
    p.add_argument("--DTU", required=True, help="official GT root")
    a = p.parse_args(argv)

    os.makedirs(a.output_dir, exist_ok=True)
    mesh = load_mesh_ply(a.input_mesh)
    instance = os.path.join(a.mask_dir, f"scan{a.scan_id}")
    culled = cull_mesh_by_masks(mesh,
                                os.path.join(instance, "cameras.npz"),
                                os.path.join(instance, "mask"))
    culled_path = os.path.join(a.output_dir, "culled_mesh.ply")
    save_mesh_ply(culled_path, culled)
    evaluate_dtu_mesh(culled_path, a.scan_id, a.DTU, a.output_dir)


if __name__ == "__main__":
    main()
