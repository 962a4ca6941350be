"""Gaussian model snapshot PLY (save/load), channel-exact with
gaussmart_tpu/io/gaussian_ply.py so a snapshot written by either package
loads in the other: x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..R*3-1, opacity,
scale_0..1, rot_0..3, segment — all float32. f_dc/f_rest are flattened in
(channel, coeff) order.
"""
from __future__ import annotations

import numpy as np

from gaussmart_tpu_torch.io.ply import read_ply, write_ply
from gaussmart_tpu_torch.models.gaussians import GaussianState, state_from_numpy


def save_gaussian_ply(path: str, state: GaussianState):
    active = state.aux.active.cpu().numpy()
    p = {k: v.detach().cpu().numpy()[active] for k, v in vars(state.params).items()}
    segments = state.aux.segments.cpu().numpy()[active]

    n = p["xyz"].shape[0]
    cols = {}
    for i, k in enumerate("xyz"):
        cols[k] = p["xyz"][:, i]
    for k in ("nx", "ny", "nz"):
        cols[k] = np.zeros(n, np.float32)
    # features_dc: [n,1,3] -> channel-major flatten
    f_dc = p["features_dc"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i]
    f_rest = p["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i]
    cols["opacity"] = p["opacity"][:, 0]
    for i in range(p["scaling"].shape[1]):
        cols[f"scale_{i}"] = p["scaling"][:, i]
    for i in range(p["rotation"].shape[1]):
        cols[f"rot_{i}"] = p["rotation"][:, i]
    cols["segment"] = segments.astype(np.float32)
    write_ply(path, {k: np.asarray(v, np.float32) for k, v in cols.items()})


def load_gaussian_ply(path: str, max_sh_degree: int,
                      spatial_lr_scale: float = 1.0,
                      capacity: int | None = None,
                      device="cuda") -> GaussianState:
    v = read_ply(path)
    n = len(v["x"])

    def stack(prefix):
        names = sorted((k for k in v if k.startswith(prefix)),
                       key=lambda s: int(s.split("_")[-1]))
        return np.stack([v[k] for k in names], axis=1).astype(np.float32), len(names)

    n_rest_total = 3 * ((max_sh_degree + 1) ** 2 - 1)
    f_rest, n_rest = stack("f_rest_")
    if n_rest != n_rest_total:
        raise ValueError(f"{path}: {n_rest} f_rest channels, expected "
                         f"{n_rest_total} for SH degree {max_sh_degree}")
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1)
    fields = {
        "xyz": np.stack([v["x"], v["y"], v["z"]], axis=1),
        "features_dc": f_dc[:, None, :],
        "features_rest": f_rest.reshape(n, 3, -1).transpose(0, 2, 1),
        "scaling": stack("scale_")[0],
        "rotation": stack("rot_")[0],
        "opacity": v["opacity"][:, None],
    }
    segments = v.get("segment", np.zeros(n, np.float32)).astype(np.int32)

    if capacity is None:
        capacity = max(1024, ((int(n * 2) + 255) // 256) * 256)
    capacity = max(capacity, n)

    # empty slots hold the same filler as the JAX package's empty_params
    filler = {"xyz": 0.0, "features_dc": 0.0, "features_rest": 0.0,
              "scaling": -10.0, "rotation": 0.0, "opacity": -10.0}
    params = {}
    for k, a in fields.items():
        full = np.full((capacity,) + a.shape[1:], filler[k], np.float32)
        full[:n] = a
        params[k] = full
    params["rotation"][n:, 0] = 1.0
    seg = np.zeros(capacity, np.int32)
    seg[:n] = segments
    # a snapshot restores at full SH degree
    return state_from_numpy(params, np.arange(capacity) < n, seg,
                            max_sh_degree=max_sh_degree,
                            active_sh_degree=max_sh_degree,
                            spatial_lr_scale=spatial_lr_scale, device=device)

