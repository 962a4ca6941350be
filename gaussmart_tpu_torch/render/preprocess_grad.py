"""The training step's preprocess as one autograd Function of two kernels,
K8 (csrc/preprocess_grad.cu).

PreprocessCore (a torch.autograd.Function, as raster_tiled.RasterCore is
for the compositor) takes one state's raw parameters, the leaves that the
training step differentiates (xyz, log-scales, quaternions, logit
opacities, the SH coefficients), and means2d, and gives what the binning
and the compositor read: the blob [N+1, 20] (build_blob's rows, with
means2d's shift), the conic rows [N+1, 8] (build_conics'), aux [4, N]
(radius, depth, rx, ry) and valid [N]. Only the blob carries a gradient.
Its forward launches preprocess_grad_fwd, its backward preprocess_bwd on
the blob's cotangent, in the span backward.preprocess; each wrapper adds
1 to its launch counter after the launch. The wrappers take CUDA tensors
only.

preprocess_grad_plain is their plain version: the chain itself (the
activations, raster_common.preprocess, build_blob, build_conics), which
autograd differentiates. render_arrays runs it for every render the
Function does not take (api.leaf_route).
"""
from __future__ import annotations

from typing import Tuple

import torch

from gaussmart_tpu_torch import kernels
from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.logging_utils import count, span
from gaussmart_tpu_torch.render import raster_common
from gaussmart_tpu_torch.render.preprocess_fused import MAX_SH_DEGREE
from gaussmart_tpu_torch.render.raster_tiled import F, FC, build_blob, build_conics

_f32 = torch.float32


def kernel_degree(sh_degree: int, active_degree: int, n_rest: int) -> int:
    """The SH degree K8 evaluates: min(active_degree, sh_degree), the bands
    above it being masked to zero in the chain. Raises where the chain
    would (sh_degree beyond the coefficients, or beyond 4)."""
    if not 0 <= sh_degree <= MAX_SH_DEGREE or (sh_degree + 1) ** 2 - 1 > n_rest:
        raise ValueError(f"SH degree {sh_degree} needs {(sh_degree + 1) ** 2 - 1} "
                         f"features_rest coefficients (at most degree {MAX_SH_DEGREE}), "
                         f"got {n_rest}")
    if active_degree < 0:
        raise ValueError(f"active_degree {active_degree} < 0")
    return min(active_degree, sh_degree)


def _check_shapes(entry: str, named) -> None:
    """Raise unless each (name, tensor, dtype, shape) has that type and
    shape."""
    for name, x, dtype, shape in named:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{entry}: {name} must be {dtype} of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")


def _check_device(entry: str, named, cam: CameraParams) -> torch.device:
    """Raise unless the tensors (contiguous) and the camera lie on one CUDA
    device. Returns the device."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors, not {dev}")
    kernels.check_tensors([(name, x, dtype, len(shape)) for name, x, dtype, shape in named]
                          + [("camera_center", cam.camera_center, _f32, 1)], dev)
    for name, m in (("world_view", cam.world_view), ("full_proj", cam.full_proj)):
        if m.device != dev or m.dtype != _f32 or tuple(m.shape) != (4, 4):
            raise ValueError(f"{entry}: the camera's {name} must be float32 [4, 4] on {dev}")
    if tuple(cam.camera_center.shape) != (3,):
        raise ValueError(f"{entry}: the camera's centre must be [3]")
    return dev


def _leaf_specs(xyz, scaling, rotation, opacity, features_dc, features_rest):
    n, n_rest = xyz.shape[0], features_rest.shape[1] if features_rest.dim() == 3 else -1
    return [("xyz", xyz, _f32, (n, 3)), ("scaling", scaling, _f32, (n, 2)),
            ("rotation", rotation, _f32, (n, 4)), ("opacity", opacity, _f32, (n, 1)),
            ("features_dc", features_dc, _f32, (n, 1, 3)),
            ("features_rest", features_rest, _f32, (n, n_rest, 3))]


def _camera_args(cam: CameraParams):
    wv, fp = cam.world_view, cam.full_proj
    return (wv.data_ptr(), wv.stride(0), wv.stride(1), fp.data_ptr(), fp.stride(0),
            fp.stride(1), cam.camera_center.data_ptr())


def preprocess_grad_fwd(xyz, scaling, rotation, opacity, features_dc, features_rest,
                        means2d, active, cam: CameraParams, sh_degree: int,
                        active_degree: int, scale_modifier: float = 1.0):
    """K8's forward on one CUDA device: (blob, conics, aux, valid), each
    bit-equal to preprocess_grad_plain's."""
    specs = _leaf_specs(xyz, scaling, rotation, opacity, features_dc, features_rest)
    n, n_rest = xyz.shape[0], specs[-1][3][1]
    specs += [("means2d", means2d, _f32, (n, 2)), ("active", active, torch.bool, (n,))]
    _check_shapes("preprocess_grad_fwd", specs)
    deg = kernel_degree(sh_degree, active_degree, n_rest)
    dev = _check_device("preprocess_grad_fwd", specs, cam)
    blob = torch.empty((n + 1, F), dtype=_f32, device=dev)
    conics = torch.empty((n + 1, FC), dtype=_f32, device=dev)
    aux = torch.empty((4, n), dtype=_f32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    kernels.launch("preprocess_grad_fwd", dev, deg, xyz.data_ptr(), scaling.data_ptr(),
                   rotation.data_ptr(), opacity.data_ptr(), features_dc.data_ptr(),
                   features_rest.data_ptr(), active.data_ptr(), means2d.data_ptr(),
                   *_camera_args(cam), n, n_rest, cam.width, cam.height, scale_modifier,
                   blob.data_ptr(), conics.data_ptr(), aux.data_ptr(), valid.data_ptr())
    count("preprocess_grad_fwd", 1)
    return blob, conics, aux, valid


def preprocess_bwd(xyz, scaling, rotation, opacity, features_dc, features_rest, valid,
                   g_blob, cam: CameraParams, sh_degree: int, active_degree: int,
                   scale_modifier: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """K8's VJP on one CUDA device: the gradients of xyz, scaling,
    rotation, opacity, features_dc, features_rest and means2d, each in its
    tensor's layout, from the blob's cotangent g_blob [N+1, 20] and the
    forward's valid."""
    specs = _leaf_specs(xyz, scaling, rotation, opacity, features_dc, features_rest)
    n, n_rest = xyz.shape[0], specs[-1][3][1]
    specs += [("valid", valid, torch.bool, (n,)), ("g_blob", g_blob, _f32, (n + 1, F))]
    _check_shapes("preprocess_bwd", specs)
    deg = kernel_degree(sh_degree, active_degree, n_rest)
    dev = _check_device("preprocess_bwd", specs, cam)
    if g_blob.data_ptr() % 16:
        raise ValueError("preprocess_bwd: g_blob must start on a 16-byte boundary (its rows "
                         "are read with 16-byte loads)")
    grads = tuple(torch.empty_like(x) for x in (xyz, scaling, rotation, opacity, features_dc,
                                                features_rest))
    g_means2d = torch.empty((n, 2), dtype=_f32, device=dev)
    kernels.launch("preprocess_bwd", dev, deg, xyz.data_ptr(), scaling.data_ptr(),
                   rotation.data_ptr(), opacity.data_ptr(), features_dc.data_ptr(),
                   features_rest.data_ptr(), valid.data_ptr(), *_camera_args(cam),
                   g_blob.data_ptr(), n, n_rest, cam.width, cam.height, scale_modifier,
                   *(g.data_ptr() for g in grads), g_means2d.data_ptr())
    count("preprocess_bwd", 1)
    return grads + (g_means2d,)


def preprocess_grad_plain(xyz, scaling, rotation, opacity, features_dc, features_rest,
                          means2d, active, cam: CameraParams, sh_degree: int,
                          active_degree: int, scale_modifier: float = 1.0):
    """The chain K8 replaces, differentiable by autograd: the training
    step's activations, raster_common.preprocess, build_blob and
    build_conics. Returns (blob, conics, aux, valid) as K8's forward does."""
    prep = raster_common.preprocess(
        xyz, torch.exp(scaling), rotation, torch.sigmoid(opacity[:, 0]),
        torch.cat([features_dc, features_rest], dim=1), active, cam, sh_degree=sh_degree,
        scale_modifier=scale_modifier, active_degree=active_degree)
    aux = torch.stack([prep.radius, prep.depth, prep.rx, prep.ry]).detach()
    return (build_blob(prep, means2d, cam.width, cam.height), build_conics(prep), aux,
            prep.valid)


class PreprocessCore(torch.autograd.Function):
    """K8 forward, K8 VJP: (blob, conics, aux, valid) from the raw
    parameters and means2d; only the blob carries a cotangent, and the
    backward keeps nothing from the forward but the parameters and
    valid."""

    @staticmethod
    def forward(ctx, xyz, scaling, rotation, opacity, features_dc, features_rest, means2d,
                active, cam, sh_degree, active_degree, scale_modifier):
        leaves = tuple(x.contiguous() for x in (xyz, scaling, rotation, opacity, features_dc,
                                                features_rest))
        blob, conics, aux, valid = preprocess_grad_fwd(
            *leaves, means2d.contiguous(), active.contiguous(), cam, sh_degree,
            active_degree, scale_modifier)
        ctx.save_for_backward(*leaves, valid)
        ctx.meta = (cam, sh_degree, active_degree, scale_modifier)
        ctx.mark_non_differentiable(conics, aux, valid)
        return blob, conics, aux, valid

    @staticmethod
    def backward(ctx, g_blob, g_conics, g_aux, g_valid):
        if g_blob is None:
            return (None,) * 12
        with span("backward.preprocess"):
            grads = preprocess_bwd(*ctx.saved_tensors, g_blob.contiguous(), *ctx.meta)
        return grads + (None,) * 5
