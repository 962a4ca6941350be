"""Convex-hull outlier removal (GauSSmart idea #1; the port's counterpart
of gaussmart_tpu/semantics/hull.py).

Behavior parity with reference filter/hull_removal.py:10-47: per-point
minimum distance to the hull facets, z-score filter keeping z >= -theta
(theta=1.96). The hull is scipy's qhull on the host, as in the JAX
package, so the facets are the same. The points x facets distances run in
float64 torch on the requested device, in chunks of points: the JAX
package builds the whole N x F product, 24 GB at 1M points and ~3k facets.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy.spatial import ConvexHull

# float64 elements of one chunk's [points, facets] product
CHUNK_ELEMENTS = 1 << 24


def hull_distances(points: np.ndarray, hull: ConvexHull, device="cuda",
                   chunk: Optional[int] = None) -> np.ndarray:
    """[N] float64 distance of each point to its nearest facet plane.

    Each dot product is summed x, y, z, offset in that order, one
    elementwise op at a time, so every device rounds it alike."""
    eq = torch.as_tensor(hull.equations, dtype=torch.float64, device=device)
    norms = torch.sqrt(eq[:, 0] ** 2 + eq[:, 1] ** 2 + eq[:, 2] ** 2)
    pts = torch.as_tensor(np.asarray(points, np.float64), device=device)
    chunk = chunk or max(1, CHUNK_ELEMENTS // len(eq))
    out = []
    for p in torch.split(pts, chunk):
        dots = (p[:, 0:1] * eq[:, 0] + p[:, 1:2] * eq[:, 1]
                + p[:, 2:3] * eq[:, 2] + eq[:, 3])
        out.append(torch.min(torch.abs(dots) / norms, dim=1).values)
    return torch.cat(out).cpu().numpy()


def hull_removal(points: np.ndarray, theta: float = 1.96, device="cuda",
                 chunk: Optional[int] = None) -> Tuple[np.ndarray, ConvexHull]:
    """Returns (keep_mask, hull). Points whose hull-distance z-score is
    below -theta (i.e. unusually close to the hull = outliers) are dropped.
    The z-score is numpy's on the host, from the device's distances."""
    hull = ConvexHull(points)
    d = hull_distances(points, hull, device, chunk)
    z = (d - d.mean()) / max(d.std(), 1e-12)
    return z >= -theta, hull


def filter_point_cloud(points: np.ndarray,
                       colors: Optional[np.ndarray] = None,
                       normals: Optional[np.ndarray] = None,
                       theta: float = 1.96, device="cuda"):
    keep, _ = hull_removal(points, theta, device)
    return (points[keep],
            colors[keep] if colors is not None else None,
            normals[keep] if normals is not None else None,
            keep)
