"""Segment sum through a slot map, K5 (counterpart of
gaussmart_tpu/render/segsum_pallas.py::segment_sum_sorted).

Per-segment sums of [M, 20] float32 rows. Segment s owns the work slots
[slot_starts[s], slot_starts[s+1]) and slot k reads row order[k]: the
backward compositor's per-entry gradient rows, in sorted-entry order,
reduce to per-splat gradients through binning's work-slot map (inv_slots,
slot_starts; render/raster_tiled.py::grad_reduce) without a reordered
copy. An optional walk test reads a slot only if its row lies below its
tile's walk limit; a skipped slot adds zero in its place. Each segment's
rows are added in slot order, so the result depends on nothing but the
inputs. segment_sum_sorted is the JAX package's form: rows grouped by
non-decreasing segment ids, in row order.

CPU tensors take the plain versions; CUDA tensors launch csrc/segsum.cu
on the current stream or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from gaussmart_tpu_torch import kernels
from gaussmart_tpu_torch.logging_utils import count

F = 20


def sorted_slot_starts(seg_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """[n_segments + 1] int32 slot_starts of rows grouped by non-decreasing
    `seg_ids`; rows with an id of n_segments or more fall past the last."""
    edges = torch.arange(n_segments + 1, dtype=seg_ids.dtype, device=seg_ids.device)
    return torch.searchsorted(seg_ids, edges).to(torch.int32)


def segment_sum_gathered_plain(rows: torch.Tensor, order: Optional[torch.Tensor],
                               slot_starts: torch.Tensor, n_out: Optional[int] = None,
                               slot_tile: Optional[torch.Tensor] = None,
                               tile_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of segment_sum_gathered: the rows taken through
    `order` (zero where the walk test skips a slot), then each segment's
    added in slot order from zero, one slot position at a time."""
    n = slot_starts.shape[0] - 1
    n_out = n if n_out is None else n_out
    out = rows.new_zeros((n_out, rows.shape[1]))
    if n == 0:
        return out
    starts = slot_starts[:-1].to(torch.int64)
    counts = slot_starts[1:].to(torch.int64) - starts
    for j in range(int(counts.max())):
        seg = torch.nonzero(counts > j)[:, 0]
        k = starts[seg] + j
        r = order[k].to(torch.int64) if order is not None else k
        taken = rows[r]
        if slot_tile is not None:
            keep = r < tile_limit[slot_tile[k].to(torch.int64)]
            taken = torch.where(keep[:, None], taken, 0.0)
        out[seg] = out[seg] + taken
    return out


def segment_sum_gathered(rows: torch.Tensor, order: Optional[torch.Tensor],
                         slot_starts: torch.Tensor, n_out: Optional[int] = None,
                         slot_tile: Optional[torch.Tensor] = None,
                         tile_limit: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: [n_out, F] f32 (n_out defaults to the n segments of
    `slot_starts` [n + 1] i32; rows past n are zero). Segment s sums rows
    order[k] ([W] i32; None reads row k) of `rows` [M, F] f32 over its slots
    k in [slot_starts[s], slot_starts[s+1]), in slot order. Given
    `slot_tile` [W] i32 and `tile_limit` [tiles] i32 a slot adds zero
    unless its row < tile_limit[slot_tile[k]]."""
    if rows.device.type == "cpu":
        return segment_sum_gathered_plain(rows, order, slot_starts, n_out, slot_tile,
                                          tile_limit)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_sum_gathered runs on CPU or CUDA tensors, not "
                         f"{rows.device}")
    n = slot_starts.shape[0] - 1
    n_out = n if n_out is None else n_out
    walk = slot_tile is not None
    if rows.shape[1] != F or n < 0 or n_out < n or (walk != (tile_limit is not None)):
        raise ValueError(f"rows {tuple(rows.shape)} must be [M, {F}], n_out {n_out} at "
                         f"least the {n} segments, slot_tile and tile_limit both given "
                         f"or neither")
    kernels.check_tensors((("rows", rows, torch.float32, 2),
                           ("slot_starts", slot_starts, torch.int32, 1))
                          + ((("order", order, torch.int32, 1),) if order is not None
                             else ())
                          + ((("slot_tile", slot_tile, torch.int32, 1),
                              ("tile_limit", tile_limit, torch.int32, 1)) if walk else ()),
                          rows.device)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary: segsum reads them "
                         "with 16-byte loads")
    out = torch.empty((n_out, F), dtype=torch.float32, device=rows.device)

    def ptr(x):
        return None if x is None else x.data_ptr()
    kernels.launch("segsum", rows.device, rows.data_ptr(), ptr(order), slot_starts.data_ptr(),
                   ptr(slot_tile), ptr(tile_limit), n, n_out, out.data_ptr())
    count("segsum", 1)
    return out


def segment_sum_sorted_plain(rows: torch.Tensor, seg_ids: torch.Tensor,
                             n_segments: int) -> torch.Tensor:
    """Plain version of segment_sum_sorted: each segment's rows added in
    row order."""
    return segment_sum_gathered_plain(rows, None, sorted_slot_starts(seg_ids, n_segments))


def segment_sum_sorted(rows: torch.Tensor, seg_ids: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """K5 on rows grouped by non-decreasing `seg_ids` [M] i32: per-segment
    sums [n_segments, F] of `rows` [M, F] f32, each in row order (ids >=
    n_segments are ignored; empty segments are zero)."""
    if rows.device.type == "cpu":
        return segment_sum_sorted_plain(rows, seg_ids, n_segments)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_sum_sorted runs on CPU or CUDA tensors, not {rows.device}")
    kernels.check_tensors((("seg_ids", seg_ids, torch.int32, 1),), rows.device)
    if seg_ids.shape[0] != rows.shape[0] or n_segments < 0:
        raise ValueError(f"rows {tuple(rows.shape)} and seg_ids "
                         f"{tuple(seg_ids.shape)} need one id per row, "
                         f"n_segments {n_segments} >= 0")
    return segment_sum_gathered(rows, None, sorted_slot_starts(seg_ids, n_segments))
