"""bench.py's cameras: view k turned about y by 0.1 k rad and moved by
0.1 k along x, k = 0, 1, 2, 3 (then -1, -2, ... for views past 4)."""
import numpy as np


def make(spec: dict, views: int, seed: int):
    cams = []
    for i in range(views):
        k = i if i < 4 else -(i - 3)
        c, s = np.cos(0.1 * k), np.sin(0.1 * k)
        cams.append(dict(R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
                         t=np.array([0.1 * k, 0.0, 0.0]),
                         fovx=spec["fovx"], fovy=spec["fovy"]))
    return cams
