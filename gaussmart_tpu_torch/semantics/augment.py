"""Segment-aware point-cloud densification (the port's own copy of
gaussmart_tpu/semantics/augment.py, numpy only).

For each segment whose point count is below a mask-area-derived target
(sqrt(area)*0.1, min 10), sample extra points from a regularized full-
covariance Gaussian fit to the segment, carrying the segment's mean color.
Host-side, at initialisation only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def segment_covariance(seg_points: np.ndarray, alpha: float = 0.5,
                       min_eigenval: float = 1e-6):
    mean = seg_points.mean(axis=0)
    cov = np.cov(seg_points.T)
    vals, vecs = np.linalg.eigh(cov)
    vals = np.maximum(vals, min_eigenval)
    cov = (vecs * vals) @ vecs.T
    return mean, (alpha**2) * cov


def sample_segment_points(seg_points: np.ndarray, seg_colors: np.ndarray,
                          n_new: int, rng: np.random.Generator):
    try:
        mean, cov = segment_covariance(seg_points)
        new_pts = rng.multivariate_normal(mean, cov, size=n_new,
                                          method="cholesky")
    except np.linalg.LinAlgError:
        mean = seg_points.mean(axis=0)
        std = seg_points.std(axis=0) * 0.5
        new_pts = mean[None] + rng.normal(size=(n_new, 3)) * std[None]
    avg_color = seg_colors.mean(axis=0)
    return new_pts.astype(np.float32), np.tile(avg_color, (n_new, 1))


def augment_by_mask_areas(
    points: np.ndarray,
    colors: np.ndarray,
    segments: np.ndarray,
    mask_areas: Dict[int, float],
    seed: int = 0,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mask-area-based augmentation."""
    if not mask_areas:
        return points, colors, segments
    rng = np.random.default_rng(seed)
    median_area = float(np.median(list(mask_areas.values())))

    new_p, new_c, new_s = [], [], []
    uniq, counts = np.unique(segments, return_counts=True)
    for seg_id, count in zip(uniq, counts):
        seg_id = int(seg_id)
        if seg_id == -1 or count < 5:
            continue
        area = mask_areas.get(seg_id, median_area)
        target = max(int(np.sqrt(area) * 0.1), 10)
        n_add = target - int(count)
        if n_add <= 0:
            continue
        mask = segments == seg_id
        pts, cols = sample_segment_points(points[mask], colors[mask], n_add, rng)
        new_p.append(pts)
        new_c.append(cols)
        new_s.append(np.full(n_add, seg_id, segments.dtype))
        if verbose:
            print(f"Segment {seg_id}: added {n_add} points")

    if not new_p:
        return points, colors, segments
    points = np.concatenate([points] + new_p)
    colors = np.concatenate([colors] + new_c)
    segments = np.concatenate([segments] + new_s)
    if verbose:
        print(f"Total augmented points: {sum(len(p) for p in new_p)}")
    return points, colors, segments


def augment_uniform(points: np.ndarray, colors: np.ndarray,
                    fraction: float = 0.1, seed: int = 0):
    """The `uniform_upsampling` fallback."""
    rng = np.random.default_rng(seed)
    n_add = max(int(len(points) * fraction), 10)
    pts, cols = sample_segment_points(points, colors, n_add, rng)
    return (np.concatenate([points, pts]),
            np.concatenate([colors, cols]))
