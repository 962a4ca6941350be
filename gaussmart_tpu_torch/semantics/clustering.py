"""Representative-view selection by camera clustering (the port's copy of
gaussmart_tpu/semantics/clustering.py; its k-means is semantics/kmeans.py's
numpy copy of sklearn's, with the same draws).

Parity with reference identification/clustering_cameras.py: optimal k in
[3,15] maximizing 0.4*coverage(spatial spread + angular diversity) +
0.6*compactness(-inertia/||X||), then one camera per cluster by
0.5*center-proximity + 0.5*angular uniqueness.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from gaussmart_tpu_torch.semantics.camera_formats import CameraAnalysis
from gaussmart_tpu_torch.semantics.kmeans import KMeans


def _c2w_from_view(mats: Dict) -> Optional[np.ndarray]:
    if "c2w" in mats:
        return mats["c2w"]
    if "world_mat" in mats:
        return np.linalg.inv(mats["world_mat"])
    return None


def _angles_deg(dirs: np.ndarray) -> np.ndarray:
    d = dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-8)
    cos = np.clip(d @ d.T, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


class ViewSelector:
    def __init__(self, analyzer: CameraAnalysis):
        self.analyzer = analyzer
        pos, dirs = [], []
        for mats in analyzer.views.values():
            c2w = _c2w_from_view(mats)
            if c2w is None:
                continue
            pos.append(c2w[:3, 3])
            dirs.append(c2w[:3, 2])
        self.positions = np.vstack(pos) if pos else np.empty((0, 3))
        self.view_directions = np.vstack(dirs) if dirs else np.empty((0, 3))

    def _normalized(self):
        center = self.positions.mean(axis=0)
        centered = self.positions - center
        scale = np.std(centered, axis=0)
        scale = np.where(scale < 1e-6, 1.0, scale)
        return centered / scale, center, scale

    def optimal_k(self, min_k: int = 3, max_k: Optional[int] = None) -> int:
        n = len(self.positions)
        max_k = max_k or min(15, max(min_k + 1, n // 2))
        # KMeans needs n_samples >= n_clusters; tiny scenes (n <= min_k)
        # just use every camera as its own cluster
        max_k = min(max_k, n)
        min_k = min(min_k, n)
        X, _, _ = self._normalized()
        best_k, best_score = min_k, -np.inf
        for k in range(min_k, max_k + 1):
            km = KMeans(n_clusters=k, n_init=10, random_state=42)
            labels = km.fit_predict(X)
            cov = 0.0
            for c in range(k):
                idxs = np.where(labels == c)[0]
                if len(idxs) < 1:
                    continue
                pts = self.positions[idxs]
                spread = float(np.mean(np.std(pts, axis=0))) if len(idxs) > 1 else 0.0
                if len(idxs) > 1:
                    angs = _angles_deg(self.view_directions[idxs])
                    iu = np.triu_indices(len(idxs), k=1)
                    ang_div = float(np.mean(angs[iu]))
                else:
                    ang_div = 90.0
                cov += spread + ang_div / 180.0
            cov /= k
            compact = -km.inertia_ / (np.linalg.norm(X) + 1e-8)
            score = 0.4 * cov + 0.6 * compact
            if score > best_score:
                best_score, best_k = score, k
        return best_k

    def select(self, min_cameras: int = 3,
               max_cameras: Optional[int] = None) -> Dict[str, Any]:
        k = self.optimal_k(min_cameras, max_cameras)
        X, center, scale = self._normalized()
        km = KMeans(n_clusters=k, n_init=10, random_state=42)
        labels = km.fit_predict(X)

        selected: List[int] = []
        cluster_info: Dict[int, Any] = {}
        for c in range(k):
            idxs = np.where(labels == c)[0]
            dirs = self.view_directions[idxs]
            center_world = km.cluster_centers_[c] * scale + center
            scores = []
            for pos_in_cluster, i in enumerate(idxs):
                dist_score = 1.0 / (1.0 + np.linalg.norm(
                    self.positions[i] - center_world))
                others = np.delete(dirs, pos_in_cluster, axis=0)
                if len(others) > 0:
                    combined = np.vstack([self.view_directions[i][None], others])
                    uniq = float(np.mean(_angles_deg(combined)[0, 1:])) / 180.0
                else:
                    uniq = 1.0
                scores.append(0.5 * dist_score + 0.5 * uniq)
            best = idxs[int(np.argmax(scores))]
            selected.append(int(best))
            cluster_info[c] = {"members": idxs.tolist(), "selected": int(best),
                               "score": float(np.max(scores))}
        return {"selected_indices": selected, "cluster_info": cluster_info}


def map_camera_to_image_index(idx: int, dataset_type: str) -> int:
    """TYT halves the camera list; image index = camera index // 2
    (process_selected_views.py:37-42)."""
    return idx // 2 if dataset_type.lower() == "tyt" else idx


def resolve_image_path(images_dir: str, img_idx: int, image_files: List[str],
                       dataset_type: str) -> Optional[str]:
    """Image-path resolution incl. the TYT 5/6-digit filename probing."""
    if dataset_type.lower() == "tyt":
        for fname in (f"{img_idx:05d}.jpg", f"{img_idx:06d}.jpg"):
            p = os.path.join(images_dir, fname)
            if os.path.exists(p):
                return p
        return None
    if img_idx < len(image_files):
        return os.path.join(images_dir, image_files[img_idx])
    return None


def list_image_files(images_dir: str) -> List[str]:
    files = sorted(os.listdir(images_dir))
    return [f for f in files if not f.startswith(".") and not f.startswith("._")]
