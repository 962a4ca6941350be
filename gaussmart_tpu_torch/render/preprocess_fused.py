"""The no-grad render's preprocess in one pass: K6 (csrc/preprocess.cu).

From a GaussianState's raw parameters to what the binning and the forward
compositor K1 read: the blob (build_blob's [N+1, 20] rows, means2d zero),
the conic rows (build_conics' [N+1, 8]) and the per-splat fields that the
binning and render()'s output dict read. render() takes this route when
no gradient is wanted (see render/api.py); the training step takes K8
(render/preprocess_grad.py), the same kernel with means2d's shift and a
hand-written VJP.

preprocess_fused launches the kernel on the current stream and adds 1 to
the launch counter "preprocess_fwd"; it takes CUDA tensors only.
preprocess_fused_plain is its plain twin: the unfused chain itself (the
activations of GaussianState, raster_common.preprocess,
raster_tiled.build_blob and build_conics), which every other render runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gaussmart_tpu_torch import kernels
from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.logging_utils import count
from gaussmart_tpu_torch.models.gaussians import GaussianState
from gaussmart_tpu_torch.render import raster_common
from gaussmart_tpu_torch.render.raster_common import Preprocessed
from gaussmart_tpu_torch.render.raster_tiled import F, FC, build_blob, build_conics

MAX_SH_DEGREE = 4


class Fused(NamedTuple):
    """prep: the Preprocessed fields. From the kernel, T, center2d,
    opacity, color and normal are views into the blob's columns and ell is
    None (its terms are the conic rows)."""
    prep: Preprocessed
    blob: torch.Tensor      # [N+1, F]
    conics: torch.Tensor    # [N+1, FC]


def preprocess_fused_plain(state: GaussianState, cam: CameraParams,
                           scale_modifier: float = 1.0) -> Fused:
    """The unfused chain that K6 computes in one pass."""
    xyz = state.params.xyz
    prep = raster_common.preprocess(
        xyz, state.get_scaling, state.params.rotation, state.get_opacity[:, 0],
        state.get_features, state.aux.active, cam, sh_degree=state.active_sh_degree,
        scale_modifier=scale_modifier)
    means2d = torch.zeros((xyz.shape[0], 2), dtype=torch.float32, device=xyz.device)
    return Fused(prep, build_blob(prep, means2d, cam.width, cam.height), build_conics(prep))


def preprocess_fused(state: GaussianState, cam: CameraParams,
                     scale_modifier: float = 1.0) -> Fused:
    """K6 on a state and camera on one CUDA device; other devices raise
    (preprocess_fused_plain computes the same rows there)."""
    dev = state.params.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"preprocess_fused runs on CUDA tensors, not {dev}")
    p = type(state.params)(**{k: v.contiguous() for k, v in vars(state.params).items()})
    n = p.xyz.shape[0]
    n_rest = p.features_rest.shape[1]
    deg = state.active_sh_degree
    if not 0 <= deg <= MAX_SH_DEGREE or (deg + 1) ** 2 - 1 > n_rest:
        raise ValueError(f"SH degree {deg} needs {(deg + 1) ** 2 - 1} features_rest "
                         f"coefficients (at most degree {MAX_SH_DEGREE}), got {n_rest}")
    kernels.check_tensors((("xyz", p.xyz, torch.float32, 2),
                           ("scaling", p.scaling, torch.float32, 2),
                           ("rotation", p.rotation, torch.float32, 2),
                           ("opacity", p.opacity, torch.float32, 2),
                           ("features_dc", p.features_dc, torch.float32, 3),
                           ("features_rest", p.features_rest, torch.float32, 3),
                           ("active", state.aux.active, torch.bool, 1),
                           ("camera_center", cam.camera_center, torch.float32, 1)), dev)
    shapes = ((p.xyz, (n, 3)), (p.scaling, (n, 2)), (p.rotation, (n, 4)),
              (p.opacity, (n, 1)), (p.features_dc, (n, 1, 3)),
              (p.features_rest, (n, n_rest, 3)), (state.aux.active, (n,)),
              (cam.world_view, (4, 4)), (cam.full_proj, (4, 4)), (cam.camera_center, (3,)))
    if any(tuple(x.shape) != s for x, s in shapes):
        raise ValueError("preprocess_fused: shapes " + ", ".join(
            f"{tuple(x.shape)} (need {s})" for x, s in shapes))
    wv, fp = cam.world_view, cam.full_proj
    if any(m.device != dev or m.dtype != torch.float32 for m in (wv, fp)):
        raise ValueError("preprocess_fused: the camera's matrices must be float32 on "
                         f"{dev}")
    blob = torch.empty((n + 1, F), dtype=torch.float32, device=dev)
    conics = torch.empty((n + 1, FC), dtype=torch.float32, device=dev)
    aux = torch.empty((4, n), dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch("preprocess_fwd", dev, deg, p.xyz.data_ptr(), p.scaling.data_ptr(),
                   p.rotation.data_ptr(), p.opacity.data_ptr(), p.features_dc.data_ptr(),
                   p.features_rest.data_ptr(), state.aux.active.data_ptr(), wv.data_ptr(),
                   wv.stride(0), wv.stride(1), fp.data_ptr(), fp.stride(0), fp.stride(1),
                   cam.camera_center.data_ptr(), n, n_rest, cam.width, cam.height,
                   scale_modifier, blob.data_ptr(), conics.data_ptr(), aux.data_ptr(),
                   valid.data_ptr())
    count("preprocess_fwd", 1)
    return Fused(rows_prep(blob, aux, valid), blob, conics)


def rows_prep(blob: torch.Tensor, aux: torch.Tensor, valid: torch.Tensor) -> Preprocessed:
    """The Preprocessed fields of a kernel's rows: T, center2d, opacity,
    color and normal are views into the blob's columns, radius, depth, rx
    and ry aux's rows; ell is None (its terms are the conic rows)."""
    rows = blob[:-1]
    radius, depth, rx, ry = aux.unbind(0)
    return Preprocessed(T=rows[:, :9].unflatten(1, (3, 3)), center2d=rows[:, 9:11],
                        radius=radius, depth=depth, normal=rows[:, 17:20],
                        color=rows[:, 14:17], opacity=rows[:, 13], valid=valid, rx=rx, ry=ry,
                        ell=None)
