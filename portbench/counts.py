"""The work a frame or a step needs, counted from the cell's inputs by the
reference and from the configuration's widths, never from the program's
binning: (pixel, splat) blends, visible splats, the DINO tower's
products, and the bounds of the compositor kernels at the published
peaks.

A blend is a (pixel, splat) pair with alpha >= 1/255 that the pixel
composites before its transmittance stops. The operations are frozen
here as the reference performs them, each element of an arithmetic, test
or select counted once, a reduction once per element it reads, a matrix
product 2 per multiply-add, data movement not at all (the counter in
tests/test_portbench_counts.py recounts every constant):

- reference/raster.py's `_walk`, per (pixel, entry) pair: 89 forward (34
  products, 11 differences, 4 sums, 7 selects, 11 tests and masks, 9
  sums over the entries, exp, reciprocal, minimum, clamp, abs, 1 - alpha,
  cumprod, cumsum, any, argmax, prod). Its backward recomputes the walk
  and pulls the cotangents back through it: 89 + 160 = 249. (It also
  reduces 59 operations per (tile, entry) over the pixels; the bound,
  which counts blends only, leaves them out.)
- `activated` and `preprocess`, per splat at SH degree 3: 494 forward,
  1,388 backward.
- reference/train.py's `adam_step`: 17 per parameter."""
from __future__ import annotations

from typing import Dict

import torch

from portbench import common
from portbench.common import PEAK_BYTES_PER_S, PEAK_F32_FLOPS
from portbench.reference import raster

FWD_OPS_PER_BLEND = 89
BWD_OPS_PER_BLEND = 89 + 160
PREP_FWD_OPS_PER_SPLAT = 494
PREP_BWD_OPS_PER_SPLAT = 1388
ADAM_OPS_PER_PARAM = 17
SPLAT_FLOATS = 18        # what a compositor reads of a splat: T 9, centre 2, opacity, colour 3, normal 3
OUT_PLANES = 10          # K1 writes colour 3, depth, alpha, normal 3, median, distortion
COT_PLANES = 8           # K2 reads the cotangents of colour 3, depth, alpha, normal 3


@torch.no_grad()
def frame_work(params: Dict[str, torch.Tensor], active, cam) -> Dict[str, int]:
    """Blends and visible (binned) splats of one frame, by the reference."""
    act = raster.activated(params, active)
    prep = raster.preprocess(act["xyz"], act["scales"], act["quats"], act["opacity"],
                             act["shs"], active, cam)
    stats = {}
    raster.composite(prep, cam.width, cam.height, stats)
    visible = int((prep["valid"] & (prep["rx"] > 0) & (prep["ry"] > 0)).sum())
    return {"blends": int(stats["blends"]), "visible": visible}


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k1_bound_s(work, pixels: int) -> float:
    """K1: the blends' operations; each visible splat read once, the output
    planes written once."""
    return bound_s(FWD_OPS_PER_BLEND * work["blends"],
                   4 * (SPLAT_FLOATS * work["visible"] + OUT_PLANES * pixels))


def k2_bound_s(work, pixels: int) -> float:
    """K2: the blends' gradient; the visible splats and the cotangent planes
    read once, a gradient row per visible splat written once."""
    return bound_s(BWD_OPS_PER_BLEND * work["blends"],
                   4 * (2 * SPLAT_FLOATS * work["visible"] + COT_PLANES * pixels))


def dino_term_flops(dino: dict, height: int, width: int) -> float:
    """Float32 operations of the DINO term on a height x width render (the
    render's and the target's forwards and the backward to the render), as
    the tower kind that the configuration's `dino` names counts them."""
    return common.tower(dino).term_flops(dino, height, width)


def step_flops(work, dino, height: int, width: int, n_active: int,
               params_per_splat: int) -> float:
    """A training step's float32 operations: the compositor's blends forward
    and backward, the DINO term, and per splat its preprocess and Adam."""
    ops = (FWD_OPS_PER_BLEND + BWD_OPS_PER_BLEND) * work["blends"]
    if dino:
        ops += dino_term_flops(dino, height, width)
    return ops + n_active * (PREP_FWD_OPS_PER_SPLAT + PREP_BWD_OPS_PER_SPLAT
                             + ADAM_OPS_PER_PARAM * params_per_splat)
