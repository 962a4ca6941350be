"""Training checkpoints (counterpart of gaussmart_tpu/io/checkpoint.py):
the same ``.npz`` of params, Adam moments, aux and step plus a ``.json``
sidecar of static metadata, so a checkpoint written by either package
resumes in the other."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np
import torch

from gaussmart_tpu_torch.models.gaussians import GaussianAux, GaussianParams, GaussianState
from gaussmart_tpu_torch.optim import AdamState


def save_checkpoint(path: str, state: GaussianState, adam: AdamState,
                    iteration: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def host(t):
        return t.detach().cpu().numpy()
    arrays = {}
    for f in dataclasses.fields(GaussianParams):
        arrays[f"params.{f.name}"] = host(getattr(state.params, f.name))
        arrays[f"mu.{f.name}"] = host(getattr(adam.mu, f.name))
        arrays[f"nu.{f.name}"] = host(getattr(adam.nu, f.name))
    for f in dataclasses.fields(GaussianAux):
        arrays[f"aux.{f.name}"] = host(getattr(state.aux, f.name))
    arrays["adam.step"] = host(adam.step)
    np.savez(path, **arrays)
    meta = dict(iteration=iteration, max_sh_degree=state.max_sh_degree,
                active_sh_degree=state.active_sh_degree,
                spatial_lr_scale=state.spatial_lr_scale)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device="cuda") -> Tuple[GaussianState, AdamState, int]:
    npz = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    meta_path = npz + ".json"
    if not os.path.exists(meta_path):
        meta_path = path + ".json"
    with open(meta_path) as f:
        meta = json.load(f)

    def group(prefix, cls):
        return cls(**{f.name: torch.as_tensor(arrays[f"{prefix}.{f.name}"], device=device)
                      for f in dataclasses.fields(cls)})

    adam = AdamState(mu=group("mu", GaussianParams), nu=group("nu", GaussianParams),
                     step=torch.as_tensor(arrays["adam.step"], device=device))
    state = GaussianState(params=group("params", GaussianParams),
                          aux=group("aux", GaussianAux),
                          max_sh_degree=meta["max_sh_degree"],
                          active_sh_degree=meta["active_sh_degree"],
                          spatial_lr_scale=meta["spatial_lr_scale"])
    return state, adam, meta["iteration"]
