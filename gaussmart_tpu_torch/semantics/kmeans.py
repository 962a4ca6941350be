"""The two k-means of the segmentation pipeline, without sklearn or OpenCV.

``KMeans`` (numpy, on the host) keeps the contract of
``sklearn.cluster.KMeans`` that camera clustering uses: k-means++ seeding
with ``2 + int(ln k)`` local trials, ``n_init`` Lloyd runs of up to 300
iterations, a tolerance of 1e-4 times the mean per-feature variance, the run of least inertia kept, ``fit_predict``, ``inertia_`` and
``cluster_centers_``. Its draws are sklearn's own: numpy's
``RandomState(random_state)``, the first centre by ``choice`` with uniform
weights and the candidates by ``uniform``. A ``Generator`` would give the
same partitions where the data decide them but other label numbers, and
camera selection lists one camera per label in label order.

``quantize_colors`` (torch, on the pixels' device) keeps the algorithm of
the classical segmenter's ``cv2.kmeans(pixels, k, None, (EPS + MAX_ITER,
10, 1.0), 3, KMEANS_PP_CENTERS)``: 3 runs of k-means++ (3 candidates per
centre), Lloyd iterations that stop at the 10th or when no centre moves
by more than 1, the run of least compactness kept, and an empty cluster taking the
point farthest from the centre of the largest one. Its draws come from a
CPU ``torch.Generator``, so the card and the CPU start from the same
centres; cv2's global RNG is not reproduced (two identical ``cv2.kmeans``
calls in one process differ).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# sklearn's defaults: Lloyd iterations per run and the tolerance's factor
MAX_ITER, TOL = 300, 1e-4
# the classical segmenter's cv2.kmeans call: attempts, (EPS + MAX_ITER)
# criteria and generateCentersPP's candidates per centre
CV_ATTEMPTS, CV_MAX_ITER, CV_EPS, CV_PP_TRIALS = 3, 10, 1.0, 3

# -- sklearn's KMeans (host) --------------------------------------------------


def _sq_dists(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """[n, k] squared distances, elementwise."""
    return ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


def _kmeans_plusplus(X: np.ndarray, k: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn's greedy k-means++: each new centre is the best (least
    potential) of 2 + int(ln k) candidates drawn in proportion to the
    squared distance to the centres so far."""
    n = len(X)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]))
    weights = np.ones(n)
    first = int(rng.choice(n, p=weights / weights.sum()))
    centers[0] = X[first]
    closest = _sq_dists(X, centers[:1])[:, 0]
    pot = closest.sum()
    for c in range(1, k):
        ids = np.searchsorted(np.cumsum(closest), rng.uniform(size=trials) * pot)
        ids = np.minimum(ids, n - 1)
        d = np.minimum(closest[None, :], _sq_dists(X, X[ids]).T)
        pots = d.sum(axis=1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], d[best]
        centers[c] = X[ids[best]]
    return centers


def _lloyd(X: np.ndarray, centers: np.ndarray, max_iter: int, tol: float):
    """sklearn's Lloyd loop: assign, move each centre to its cluster's mean
    (an empty cluster takes the points farthest from their centres), stop
    when the labels repeat or the squared centre shift is at most tol; a
    last assignment to the final centres unless the labels repeated."""
    n, k = len(X), len(centers)
    labels_old = np.full(n, -1)
    strict = False
    for it in range(max_iter):
        d = _sq_dists(X, centers)
        labels = np.argmin(d, axis=1)
        counts = np.bincount(labels, minlength=k).astype(float)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, X)
        empty = np.flatnonzero(counts == 0)
        if len(empty):
            own = d[np.arange(n), labels]
            far = np.argsort(-own, kind="stable")[:len(empty)]
            for i, c in zip(far, empty):
                sums[labels[i]] -= X[i]
                counts[labels[i]] -= 1
                sums[c], counts[c] = X[i], 1
        new = sums / counts[:, None]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    d = _sq_dists(X, centers)
    if not strict:
        labels = np.argmin(d, axis=1)
    return labels, float(d[np.arange(n), labels].sum()), centers, it + 1


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Whether two labelings are one partition under a relabelling."""
    mapping = np.full(k, -1)
    for x, y in zip(a, b):
        if mapping[x] == -1:
            mapping[x] = y
        elif mapping[x] != y:
            return False
    return True


class KMeans:
    """``sklearn.cluster.KMeans`` (k-means++, Lloyd) in numpy."""

    def __init__(self, n_clusters: int = 8, n_init: int = 10,
                 random_state: Optional[int] = None):
        self.n_clusters = n_clusters
        self.n_init = n_init
        self.random_state = random_state

    def fit(self, X) -> "KMeans":
        X = np.asarray(X, dtype=np.float64)
        k = self.n_clusters
        if len(X) < k:
            raise ValueError(f"n_samples={len(X)} should be >= n_clusters={k}.")
        rng = np.random.RandomState(self.random_state)
        mean = X.mean(axis=0)
        Xc = X - mean
        tol = float(np.mean(np.var(X, axis=0))) * TOL
        best = None
        for _ in range(self.n_init):
            run = _lloyd(Xc, _kmeans_plusplus(Xc, k, rng), MAX_ITER, tol)
            if best is None or (run[1] < best[1]
                                and not _same_clustering(run[0], best[0], k)):
                best = run
        self.labels_, self.inertia_, centers, self.n_iter_ = best
        self.cluster_centers_ = centers + mean
        return self

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).labels_


# -- cv2.kmeans with KMEANS_PP_CENTERS (device) -------------------------------


def _sq_dist_to(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n] squared distances of the rows of x to one centre [c] (or to one
    centre per row, [n, c]), one channel after another: elementwise, so
    every device rounds them alike."""
    d = (x[:, 0] - c[..., 0]) ** 2
    for j in range(1, x.shape[1]):
        d = d + (x[:, j] - c[..., j]) ** 2
    return d


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d = torch.stack([_sq_dist_to(x, c) for c in centers], dim=1)
    return torch.argmin(d, dim=1)


def _centers_pp(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """cv2's generateCentersPP: a first centre drawn uniformly, then per
    centre CV_PP_TRIALS candidates drawn in proportion to the squared distance
    to the centres so far, the one of least summed distance kept."""
    n = x.shape[0]
    first = int(torch.randint(n, (1,), generator=generator))
    ids = [first]
    dist = _sq_dist_to(x, x[first])
    total = dist.sum()
    for _ in range(1, k):
        cum = torch.cumsum(dist, 0)
        best_sum, best_id, best_dist = None, -1, None
        for _ in range(CV_PP_TRIALS):
            p = torch.rand((), generator=generator, dtype=torch.float64).to(x.device) * total
            ci = min(int(torch.searchsorted(cum, p.reshape(1))), n - 1)
            cand = torch.minimum(_sq_dist_to(x, x[ci]), dist)
            s = cand.sum()
            if best_sum is None or bool(s < best_sum):
                best_sum, best_id, best_dist = s, ci, cand
        ids.append(best_id)
        total, dist = best_sum, best_dist
    return x[torch.tensor(ids, device=x.device)]


def _update(x: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """cv2's centre update: per-cluster sums and counts, each empty cluster
    (in order) taking the point of the largest cluster farthest from that
    cluster's mean (the last of equals), then the means. The sums are a
    float64 one-hot product: no atomics, and exact for 8-bit pixels."""
    sums = torch.nn.functional.one_hot(labels, k).to(torch.float64).T @ x
    counts = torch.bincount(labels, minlength=k)
    for c in range(k):
        if int(counts[c]) != 0:
            continue
        big = int(torch.argmax(counts))
        d = _sq_dist_to(x, sums[big] / counts[big])
        d = torch.where(labels == big, d, torch.full_like(d, -1.0))
        far = int(torch.nonzero(d == d.max())[-1, 0])
        labels[far] = c
        counts[big] -= 1
        counts[c] += 1
        sums[big] -= x[far]
        sums[c] += x[far]
    return sums / counts[:, None].to(torch.float64)


def quantize_colors(pixels: torch.Tensor, k: int,
                    generator: torch.Generator) -> Tuple[torch.Tensor, float]:
    """cv2.kmeans(pixels, k, None, (EPS + MAX_ITER, 10, 1.0), 3,
    KMEANS_PP_CENTERS) on [n, c] pixels (float64 on their device): (labels
    [n] int64, the best attempt's compactness). As cv2: the labels of the
    last iteration are not reassigned to its centres."""
    x = pixels.to(torch.float64)
    best, best_labels = None, None
    for _ in range(CV_ATTEMPTS):
        centers = _centers_pp(x, k, generator)
        labels = _assign(x, centers)
        for it in range(1, CV_MAX_ITER):
            old, centers = centers, _update(x, labels, k)
            shift = float(((centers - old) ** 2).sum(dim=1).max())
            if it + 1 == CV_MAX_ITER or shift <= CV_EPS ** 2:
                break
            labels = _assign(x, centers)
        compactness = float(_sq_dist_to(x, centers[labels]).sum())
        if best is None or compactness < best:
            best, best_labels = compactness, labels
    return best_labels, best
