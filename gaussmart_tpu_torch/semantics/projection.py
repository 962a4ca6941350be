"""Point-cloud -> view projection + segment assignment (the port's
counterpart of gaussmart_tpu/semantics/projection.py).

Parity with reference identification/pc_projection.py, including the
documented quirks (SURVEY.md §7.8-9): the DTU <10%-inbounds fallback with
invented intrinsics, the TYT bbox-normalized pseudo-projection, rounded-
pixel mask lookup with later-masks-overwrite, first-view-wins assignment
and max-merged mask areas. Masks are looked up at the size they were made
(capped at 1024 px by the segmenter) with the image's pixel coordinates,
as in the reference.

Float64 torch on the requested device. Every matrix product is written
out as elementwise multiply-adds in a fixed order (`_apply`), so the card
and the CPU round each coordinate alike; rounding to pixels is half to
even, as np.round; the per-bin nearest depth is scatter_reduce's amin,
which is order-free.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

DTU_WH = (1554, 1162)
TYT_FALLBACK_WH = (982, 543)


def _apply(M, pts: torch.Tensor) -> torch.Tensor:
    """[N, m] rows of M (an [m, k] numpy matrix) dotted with the [N, k]
    points, summed column 0 first."""
    M = torch.as_tensor(np.asarray(M, np.float64), device=pts.device)
    out = pts[:, 0:1] * M[:, 0]
    for j in range(1, M.shape[1]):
        out = out + pts[:, j:j + 1] * M[:, j]
    return out


def _as_points(points, device) -> torch.Tensor:
    if torch.is_tensor(points):
        return points.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(points, np.float64), device=device)


def _in_bounds(pts2d: torch.Tensor, w, h) -> torch.Tensor:
    return ((pts2d[:, 0] >= 0) & (pts2d[:, 1] >= 0)
            & (pts2d[:, 0] < w) & (pts2d[:, 1] < h))


def project_points_to_view(points, camera: Dict, dataset_type: str,
                           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(pts2d [N, 2], depth [N]) float64 on `device` (points: [N, 3] numpy
    or a tensor on the device)."""
    dataset_type = dataset_type.lower()
    pts = _as_points(points, device)
    if dataset_type == "dtu":
        world_mat = np.asarray(camera["world_mat"], np.float64)
        cam_mat = camera["camera_mat"]
        homo = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
        cam_pts = _apply(world_mat, _apply(camera["scale_mat"], homo))
        z = cam_pts[:, 2].clone()
        fx, fy = float(cam_mat[0, 0]), float(cam_mat[1, 1])
        cx, cy = float(cam_mat[0, 2]), float(cam_mat[1, 2])
        x = cam_pts[:, 0] / cam_pts[:, 3]
        y = cam_pts[:, 1] / cam_pts[:, 3]
        pts2d = torch.stack([fx * x + cx, fy * y + cy], dim=1)

        w, h = DTU_WH
        if int(_in_bounds(pts2d, w, h).sum()) < 0.1 * len(pts):
            # fallback heuristic with invented intrinsics (quirk §7.9)
            cam_pos = -np.linalg.inv(world_mat[:3, :3]) @ world_mat[:3, 3]
            vec = pts - torch.as_tensor(cam_pos, device=pts.device)
            norm = torch.sqrt(vec[:, 0] ** 2 + vec[:, 1] ** 2 + vec[:, 2] ** 2)
            nrm = vec / norm[:, None]
            pts2d = nrm[:, :2] / (nrm[:, 2:3] + 1e-10)
            pts2d = torch.stack([pts2d[:, 0] * (w / 3) + w / 2,
                                 pts2d[:, 1] * (h / 3) + h / 2], dim=1)
        return pts2d, z

    if dataset_type == "nerf":
        K = np.asarray(camera["camera_mat"], np.float64)[:3, :3]
        R = np.asarray(camera["world_mat"], np.float64)[:3, :3]
        t = torch.as_tensor(np.asarray(camera["world_mat"], np.float64)[:3, 3],
                            device=pts.device)
        cam_pts = _apply(R, pts) + t
        proj = _apply(K, cam_pts)
        return proj[:, :2] / proj[:, 2:], cam_pts[:, 2]

    if dataset_type == "tyt":
        w, h = camera.get("img_size", TYT_FALLBACK_WH)
        w, h = float(w), float(h)
        valid = ~torch.isnan(pts).any(dim=1)
        if not bool(valid.any()):
            return (torch.zeros((len(pts), 2), dtype=torch.float64, device=pts.device),
                    torch.zeros(len(pts), dtype=torch.float64, device=pts.device))
        lo = pts[valid].min(dim=0).values
        hi = pts[valid].max(dim=0).values
        pad = 0.1
        nx = pad + (1 - 2 * pad) * (pts[:, 0] - lo[0]) / (hi[0] - lo[0] + 1e-10)
        ny = pad + (1 - 2 * pad) * (pts[:, 1] - lo[1]) / (hi[1] - lo[1] + 1e-10)
        pts2d = torch.nan_to_num(torch.stack([nx * w, ny * h], dim=1))
        world_mat = np.asarray(camera["world_mat"], np.float64)
        R = world_mat[:3, :3]
        C = torch.as_tensor(-R.T @ world_mat[:3, 3], device=pts.device)
        z = _apply(R[2:3, :], pts - C)[:, 0]
        return pts2d, z

    raise ValueError(f"Dataset type {dataset_type} not projectable")


def _mask_stack(masks: List[np.ndarray], device) -> torch.Tensor:
    return torch.as_tensor(np.stack([np.asarray(m) > 0 for m in masks]), device=device)


def assign_segment_indices_simple(points_2d, masks) -> torch.Tensor:
    """Sequential mask-index assignment by rounded pixel; later masks
    overwrite earlier within a view (pc_projection.py:111-135).

    points_2d: [N, 2] tensor (or numpy); masks: list of [h, w] arrays or a
    [M, h, w] bool tensor on points_2d's device. Returns [N] int64."""
    p = torch.as_tensor(points_2d, dtype=torch.float64)
    if len(masks) == 0:
        return torch.full((len(p),), -1, dtype=torch.int64, device=p.device)
    if not torch.is_tensor(masks):
        masks = _mask_stack(masks, p.device)
    # one label image: the last mask holding each pixel
    label = torch.full(masks.shape[1:], -1, dtype=torch.int64, device=p.device)
    for mask_idx in range(len(masks)):
        label[masks[mask_idx]] = mask_idx
    ys = torch.round(p[:, 1]).long()
    xs = torch.round(p[:, 0]).long()
    h, w = label.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    seg = torch.full((len(p),), -1, dtype=torch.int64, device=p.device)
    seg[ok] = label[ys[ok], xs[ok]]
    return seg


def _occlusion_mask(pts2d: torch.Tensor, depths: torch.Tensor, visible: torch.Tensor,
                    w: int, h: int, bin_px: int = 8,
                    rel_tol: float = 0.05) -> torch.Tensor:
    """Points within (1+rel_tol) of their pixel-bin's nearest depth.

    The reference projection is occlusion-blind (pc_projection.py:111-135
    looks masks up by rounded pixel with no z-test), which floods an
    object's segment with every point BEHIND it along the view. This
    opt-in z-cull keeps, per coarse pixel bin, only the depth-nearest
    surface (as the JAX package's)."""
    bx = torch.clamp(pts2d[:, 0].long() // bin_px, 0, (w - 1) // bin_px)
    by = torch.clamp(pts2d[:, 1].long() // bin_px, 0, (h - 1) // bin_px)
    flat = by * ((w + bin_px - 1) // bin_px) + bx
    nbins = ((h + bin_px - 1) // bin_px) * ((w + bin_px - 1) // bin_px)
    near = torch.full((nbins,), float("inf"), dtype=torch.float64, device=pts2d.device)
    near.scatter_reduce_(0, flat[visible], depths[visible], "amin")
    return depths <= near[flat] * (1.0 + rel_tol)


def project_segments(points, all_masks: List[List[Dict]], cameras_dict: Dict,
                     dataset_type: str, z_cull: bool = False, device="cuda"
                     ) -> Tuple[np.ndarray, Dict[int, int]]:
    """First-view-wins segment assignment + max-merged mask areas
    (identification/main.py:114-148). `z_cull=False` is reference parity
    (occlusion-blind); True enables the per-pixel-bin depth test above.
    Returns ([N] int64 numpy, {mask index: area}) as the JAX function."""
    pts = _as_points(points, device)
    segment_indices = torch.full((len(pts),), -1, dtype=torch.int64, device=pts.device)
    mask_areas: Dict[int, int] = {}
    for view_idx, masks_list in enumerate(all_masks):
        if not masks_list:
            continue
        camera = cameras_dict[f"camera_{view_idx:03d}"]
        seg_masks = _mask_stack([m["segmentation"] for m in masks_list], pts.device)
        areas = seg_masks.flatten(1).sum(dim=1).tolist()
        for mask_idx, area in enumerate(areas):
            mask_areas[mask_idx] = max(mask_areas.get(mask_idx, 0), int(area))

        h, w = seg_masks.shape[1:]
        pts2d, depths = project_points_to_view(pts, camera, dataset_type, pts.device)
        in_bounds = _in_bounds(pts2d, w, h)
        visible = in_bounds & (depths > 0) & (segment_indices == -1)
        if z_cull:
            front = _occlusion_mask(pts2d, depths, in_bounds & (depths > 0), w, h)
            visible = visible & front
        if not bool(visible.any()):
            continue
        vis = pts2d[visible]
        clipped = torch.stack([torch.clamp(vis[:, 0], 0, w - 1),
                               torch.clamp(vis[:, 1], 0, h - 1)], dim=1)
        segment_indices[visible] = assign_segment_indices_simple(clipped, seg_masks)
    return segment_indices.cpu().numpy(), mask_areas
