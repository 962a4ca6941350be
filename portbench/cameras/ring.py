"""Cameras on a ring around a centre, each looking at it, as in the
Mip-NeRF 360 captures (the operator walks around the object): world z up,
evenly spaced yaw with a seeded jitter of radius, height, yaw and aim."""
import numpy as np


def look_at(pos, target):
    """(camera-to-world rotation, world-to-camera translation) of a camera
    at `pos` looking at `target` (x right, y down, z forward)."""
    z = target - pos
    z = z / np.linalg.norm(z)
    x = np.cross(z, np.array([0.0, 0.0, 1.0]))
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    return R, -R.T @ pos


def make(spec: dict, views: int, seed: int):
    rng = np.random.default_rng(seed)
    n = views
    j = spec["jitter"]
    yaw = 2 * np.pi * (np.arange(n) + rng.uniform(-j, j, n)) / n
    radius = spec["radius"] * (1 + rng.uniform(-j, j, n))
    height = spec["height"] * (1 + rng.uniform(-j, j, n))
    aim = np.asarray(spec["target"], np.float64)
    cams = []
    for i in range(n):
        pos = np.array([radius[i] * np.cos(yaw[i]), radius[i] * np.sin(yaw[i]), height[i]])
        R, t = look_at(pos, aim + rng.uniform(-j, j, 3) * spec["radius"] * 0.05)
        cams.append(dict(R=R, t=t, fovx=spec["fovx"], fovy=spec["fovy"]))
    return cams
