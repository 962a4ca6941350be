"""Sorted segment sum, K5 (counterpart of
gaussmart_tpu/render/segsum_pallas.py::segment_sum_sorted).

Per-segment sums of the rows of a [M, F] float32 matrix grouped by
non-decreasing int32 segment ids. The backward compositor's per-entry
gradient rows, sorted by splat id, reduce to per-splat gradients this way
when GMT_GRAD_REDUCE=segsum (render/raster_tiled.py::grad_reduce). The
ids travel as their own tensor: the TPU kernel carried them inside the
rows at lane 20 only because Mosaic could not deliver a separate id
stream.

CPU tensors take segment_sum_sorted_plain; CUDA tensors launch
csrc/segsum.cu on the current stream or raise.
"""
from __future__ import annotations

import ctypes

import torch

from gaussmart_tpu_torch import kernels

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2

# K5 launches in this process; chip_smoke.py zeroes it before driving the
# main path and reads it after
launches = 0


def segment_sum_sorted_plain(rows: torch.Tensor, seg_ids: torch.Tensor,
                             n_segments: int) -> torch.Tensor:
    """Plain version: [n_segments, F]; rows whose id is n_segments or more
    are trailing dummies and add nothing."""
    keep = seg_ids < n_segments
    return rows.new_zeros((n_segments, rows.shape[1])).index_add_(
        0, seg_ids[keep].to(torch.int64), rows[keep])


def segment_sum_sorted(rows: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """K5: per-segment sums [n_segments, F] of `rows` [M, F] f32 grouped by
    non-decreasing `seg_ids` [M] i32 (ids >= n_segments are ignored;
    empty segments are zero). Each segment's rows are added in order."""
    if rows.device.type == "cpu":
        return segment_sum_sorted_plain(rows, seg_ids, n_segments)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted runs on CPU or CUDA tensors, not {rows.device}")
    kernels.check_tensors((("rows", rows, torch.float32, 2),
                           ("seg_ids", seg_ids, torch.int32, 1)), rows.device)
    if seg_ids.shape[0] != rows.shape[0] or n_segments < 0:
        raise ValueError(f"rows {tuple(rows.shape)} and seg_ids "
                         f"{tuple(seg_ids.shape)} need one id per row, "
                         f"n_segments {n_segments} >= 0")
    fn = kernels.load("segsum", "segsum", _ARGTYPES)
    out = torch.empty((n_segments, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), seg_ids.data_ptr(), rows.shape[0], rows.shape[1],
                 n_segments, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segsum launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
