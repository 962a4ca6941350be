#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, mesh-export, eval,
semantic-preprocessing, benchmark-evaluation and trajectory-video paths,
on one device and over device slots, on one CUDA card; check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build every kernel from csrc/ with nvcc (sm_90a), one nvcc process per
     source, and the host image codec (csrc/imagecodec.cpp) with g++, all
     started together, each timed; registers, shared memory
     and spill bytes of every kernel variant from ptxas (a variant that
     spills fails);
  3. each kernel against its plain PyTorch version on the same inputs:
     raster_fwd (K1), raster_bwd (K2) with a fixed-seed cotangent, segsum
     (K5) on K2's rows through the binning's work-slot map (the walked rows
     only, as grad_reduce reads them) against its plain version on a CPU
     copy, at the tests' small scene and at full width;
     raster_fwd_seeded (K3) and raster_bwd_seeded (K4, and K5 on its rows)
     on the second of N_SLOTS depth strata of each frame, seeded as the
     Gaussian-sharded fold seeds it, and on the training frame's first
     from the identity seed (pass 1); K2, K4 and K5 launched twice, the
     two bit-equal; the tiled render and its gradients against the dense
     oracle on the small scene; the whole backward's determinism: two
     training steps (single-device, Gaussian-sharded and data-parallel)
     from the same state give bit-equal gradients on every parameter and
     on means2d;
  4. the serving path: a trained-model directory (100k splats, SH degree 3,
     8 views at 776x584, made from --seed) rendered by
     gaussmart_tpu_torch.render_cli, its saved renders held against
     in-memory renders of the same splats; then rendered again with
     --n_devices N_SLOTS --shard_mode gaussian (N_SLOTS slots on the one
     card: depth strata through K3), held against the single-device
     renders; and a row-sharded render of the small scene;
  5. the training path: a COLMAP scene (4 views at 776x584 with random
     targets, bench.py's 100k-point cloud) trained by
     gaussmart_tpu_torch.train.main for TRAIN_ITERS iterations (densify,
     eval, save and checkpoint on the way), resumed from its checkpoint
     for RESUME_ITERS more; then the same schedule Gaussian-sharded
     (--n_devices N_SLOTS --parallel_mode mp: K3/K4) with its resume, and
     DP_ITERS camera data-parallel iterations (--n_devices N_SLOTS);
  6. timings with CUDA events (median over FRAMES calls after warm-up):
     the serving frame, single-device and Gaussian-sharded, the training
     step on bench.py's mid-training state, single-device and
     Gaussian-sharded over N_SLOTS slots (iterations/s, per-stage
     breakdown, device busy share from torch.profiler), and each kernel,
     its plain version and the library call that computes the same
     function; K5 kernel only and grad_reduce whole, beside
     torch.segment_reduce; each kernel's bound from this run's
     inputs, and K1's and
     K3's (entry, warp) pairs: walked, with no pixel passing the alpha
     test, skipped by the band cull (failing if it would skip a pair that
     a pixel takes); K2 and K4 also
     with the distortion and median terms; K3 and K4 on each of the 8
     launches of one Gaussian-sharded step (recorded from the step
     itself), with their sums per step;
  7. the mesh export and evaluation paths: a sphere model (MESH_SPLATS surfels tangent to the unit sphere, one
     grey, SH degree 3; MESH_VIEWS views at 776x584 on a ring, 2 of them
     test views) exported by render_cli without --skip_mesh, bounded at
     the default --mesh_res 1024 (K1: 2 renders per train view + 1 per
     test view) and --unbounded at UNBOUNDED_RES, each mesh and its _post
     loaded and held to the sphere and the bounded one to the grey; the
     card's TSDF grid after 4 views against a CPU copy; metrics_cli
     without LPIPS weights (LPIPS null) and with random VGG weights (its
     LPIPS against the CPU); then the stages' times: TSDF integrate per
     view (on the bounded run's grid and at the 200M-voxel cap, with its
     byte bound), the int8 pull, marching, welding and colour lookup,
     fuse_samples per 128^3 block, LPIPS(vgg) per pair and the CLIs' wall
     times;
  8. the DINO term and the viewer: a DINOv3 ViT-B/16 npz at the
     checkpoint's published widths (12 layers, width 768, 12 heads, MLP
     3072, 4 registers, RoPE theta 100, input 224; random weights from
     --seed, LayerScale drawn in [0.5, 1.5]) loaded by create() through
     GAUSSMART_DINO_WEIGHTS: its tokens of a 776x584 render and the fixed
     term's image gradient on the card against a CPU copy; the heatmap
     CLI (semantics.visualize) on that render; two backwards
     of the training step with the term past its gate bit-equal; the
     phase-5 scene trained DINO_ITERS iterations with the term gated at
     DINO_GATE (dino_loss 0 up to the gate, non-zero after), then
     DINO_SLOT_ITERS iterations Gaussian-sharded and data-parallel with the
     term; viewer.serve on the phase-4 model answering a loopback client
     (VIEWER_ROUNDS requests of each of the six render items at 776x584,
     each frame held against an in-memory render, one K1 per frame), and
     train.main --gui serving a client connected beforehand; then the
     training step with and without the term, the tower's forward and its
     forward plus backward against their float32 FLOP bounds, and the
     viewer's round trip per render item;
  9. semantic preprocessing: a scan at DTU's published size (SEM_VIEWS views
     at SEM_WIDTH x SEM_HEIGHT in DTU's IDR format, cameras.npz with the
     w2c world_mat_i, camera_mat_i and scale_mat_i; bench.py's cloud as
     points.ply, coloured by octant; the views K1 renders of it; the same
     cameras as COLMAP sparse/0) through python -m
     gaussmart_tpu_torch.semantics.pipeline -t dtu --clean (classical
     masks) on the card and with --device cpu, held stage by stage (the
     hull's distances and keep mask, the pixel k-means labels, the
     projection given the CPU's masks); then train.main --run_segmentation
     --dataset_type dtu for SEM_ITERS iterations in a temporary working
     directory (its pipeline subprocess's artifacts bit-equal to the first
     card run's, the Scene on segmented_point_cloud.ply, the augmentation
     adding what its rule asks, K1/K2/K5 SEM_ITERS launches each, finite
     losses), with each stage's time and the CLIs' wall times;
 10. JPEG photos: each committed fixture of tests/torch_data/jpeg decoded
     to the sha256 Pillow gave, sized as Pillow sizes it, its sources
     encoded to the sha256 of Pillow's files, the orientation-6 photo
     turned as cv2 turns it, the CMYK one refused, textured_photo at
     5187x3361 encoded (quality 95) and decoded to Pillow's digests; then
     a scene in Mip-NeRF 360's outdoor layout: JPEG_VIEWS K1 renders of
     bench.py's cloud at garden's 5187x3361 written by write_jpeg
     (quality 75, each decoded within JPEG_MIN_PSNR of its render),
     convert.resize_copies' images_2/4/8, train.main -i images_4
     (1296x840) for JPEG_ITERS iterations (K1/K2/K5 counted, finite
     losses, each loaded camera equal to read_jpeg + _resize_u8 of its
     file), one load of the full-size photos under the 1600-px cap
     (1600x1036); the host codec's times (decode per view and megapixel
     and encode, on the renders and on high-entropy copies of them at
     quality 95; resize, the scene's loads, read_png on the NeRF-size PNG);
 11. the paper's evaluation path (scripts/bench_synthetic.py runs it alone):
     the ray-traced validation scene of BASELINE.md's bounded photometric
     recipe (SYNTH_VIEWS views at 776x584, SYNTH_SFM SfM points, SYNTH_GT
     GT samples) generated on the card by
     gaussmart_tpu_torch.scripts.make_synthetic_scene; train -s <scene>
     --eval -r 2 --white_background --iterations SYNTH_ITERS with the
     default schedule (K1/K2/K5
     counted; densify passes, opacity resets, SH raises, capacity growths
     and the in-loop eval checked against the schedule; finite losses;
     iterations/s per 1000); render_cli with the bounded mesh at the default
     --mesh_res 1024 (its grid within the 200M-voxel cap), metrics_cli (test
     PSNR and SSIM held to SYNTH_FLOORS) and the Chamfer of fuse.ply at crop
     radius SYNTH_CROP (printed); beside it, started first, every benchmark
     driver (gaussmart_tpu_torch.scripts.{dtu_eval, dtu_eval_mesh,
     m360_eval, nerf_eval, tnt_eval}) at once, each --iterations
     DRIVER_ITERS on a tiny scene of its dataset's layout (rc 0, no failed
     job, its output files, each one's peak memory; all killed if the
     host's free memory falls under DRIVER_MEM_FLOOR_GIB), and the summary
     over their results.
 12. the trajectory videos (scripts/bench_video.py runs it alone):
     render_cli --render_path --skip_train --skip_test --skip_mesh on the
     phase-4 model (TRAJ_FRAMES frames of the ellipse path at 776x584
     through K1, counted; its stages by the host clock, each K1 call
     between CUDA events); its three videos, written by the port's MPEG-4
     Part 2 encoder (io/video.py, csrc/imagecodec.cpp), read back by
     io/video.read_mp4_info as TRAJ_FRAMES I-VOPs at 776x584 and TRAJ_FPS;
     each re-encoded from the files export_image wrote (renders/*.png,
     vis/normal_*.png, vis/depth_*.tiff through render_cli's turbo
     mapping) equal to it to the byte, the encoder timed there; the
     integer-only fixtures of tests/torch_data/video encoded to their
     committed sha256 (the bits of the build whose files cv2 decoded).
 13. the no-grad render's fused preprocess (scripts/bench_preprocess.py runs
     it alone): preprocess_fwd (K6) against its plain twin, the unfused
     chain, on the phase-4 model's 8 views and on a GARDEN_SPLATS-splat
     state at GARDEN_WIDTH x GARDEN_HEIGHT (SH 3, 5% of its rows inactive):
     the blob, the conic rows and radius, depth, rx, ry and valid bit-equal
     (the largest gap in ulps of each column group printed), and render()
     against render_arrays every output bit-equal; one K6 and one K1 launch
     a render(); K6's device time beside its byte bound, the plain chain's
     device time and launches, and both frames'.
 14. the binning kernel (scripts/bench_binning.py runs it alone): K7
     (csrc/binning.cu) against binning_plain, every Binned field bit-equal
     with and without the reduction plan, the card synchronised after each
     of its three kernels, on the phase-4 model's 8 views (the training
     chain's prep and K6's) and on the GARDEN_SPLATS-splat state's; render()
     and a training step through K7 against the same calls through
     binning_plain (the parent path), every output bit-equal; K7's device
     time beside its byte bound, the whole binning's (its torch.sort) and
     the plain chain's.
N_SLOTS slots on one card measure the cost of the two-pass fold, not
scaling across cards.
Each path's kernel launch counts are set to 0 just before it runs and read
just after. The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
gaussmart_tpu_torch package beside it, it fails before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import hashlib
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# The full-width configuration: the DTU-scale scene of bench.py
WIDTH, HEIGHT, N_SPLATS, SH_DEGREE, N_VIEWS = 776, 584, 100_000, 3, 8
FOVX, FOVY = 1.2, 0.9
ITERATION = 30000
TRAIN_VIEWS = 4           # bench.py's 4 cameras
TRAIN_ITERS, RESUME_ITERS, DP_ITERS = 30, 2, 3
N_SLOTS = 4               # device slots of the multi-device paths, all on the card
EVAL_RENDERS = 5          # train.report_eval: 5 train views, no test split
FRAMES = 20               # timed calls per measurement (median)
PLAIN_FRAMES = 1          # the plain versions take seconds per call
# kernel -> (its source csrc/<source>.cu, the TPU kernel it replaces); the
# seeded kernels K3 and K4 are the with_init=True variants of the Pallas
# kernels that K1 and K2 replace, and share their sources
KERNELS = {"raster_fwd": ("raster_fwd", "gaussmart_tpu/render/raster_pallas.py:327"),
           "raster_bwd": ("raster_bwd", "gaussmart_tpu/render/raster_pallas.py:499"),
           "segsum": ("segsum", "gaussmart_tpu/render/segsum_pallas.py:59"),
           "raster_fwd_seeded": ("raster_fwd", "gaussmart_tpu/render/raster_pallas.py:327"),
           "raster_bwd_seeded": ("raster_bwd", "gaussmart_tpu/render/raster_pallas.py:499"),
           # XLA fused this chain on the TPU: no Pallas kernel
           "preprocess_fwd": ("preprocess", "none (raster_common.preprocess, fused by XLA)"),
           "binning": ("binning", "none (raster_pallas.py::_binning is XLA)")}
SOURCES = ("raster_fwd", "raster_bwd", "segsum", "preprocess", "binning")
# the template parameters of the kernels' variants, for the ptxas report
TEMPLATE_PARAMS = {"raster_fwd_kernel": ("seeded",),
                   "raster_bwd_kernel": ("need_dist", "need_med", "seeded"),
                   "segsum_kernel": ("order", "walk")}
# the fused preprocess's garden-scale state (the m360-garden cell's splat
# count, image size and SH degree). Phase 13 holds K6 bit-equal to its
# plain twin at 100k and 3M splats: the plain chain's matrix products are
# cuBLAS's, and at these row counts cuBLAS on the H100 takes a fused
# multiply-add chain in k order, which K6 follows (below about 100 rows
# cuBLAS takes another kernel: tests/test_torch_preprocess_fused.py holds
# T within 2 ulps there)
GARDEN_SPLATS, GARDEN_WIDTH, GARDEN_HEIGHT = 3_000_000, 1296, 840
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations counted from the kernels' sources: one evaluation of
# an entry at a pixel up to the alpha test (raster_fwd.cu, raster_bwd.cu),
# one forward blend, and one backward step of raster_bwd.cu without the
# distortion and median terms (the training default) before its per-field
# sum over the tile's pixels (one add per field)
OPS_PER_EVAL = 50
OPS_PER_BLEND = 39
# raster_fwd.cu's band test of one (entry, warp) pair (band_hit), with 4 eA,
# -eB and the squared distances computed once
OPS_PER_BAND_TEST = 70
OPS_PER_BWD_STEP = 103
# K4's step adds the mapped depth m (4 operations) and dm/dd (3), m dM1 +
# m^2 dM2 into dL/dw (5) and (dM1 + 2 m dM2) w dm/dd into dL/dd (6); each
# pixel then takes its seed gradient (S + T dT) / max(T0, 1e-12) (3)
OPS_PER_SEEDED_BWD_STEP = OPS_PER_BWD_STEP + 18
OPS_PER_SEED_GRAD = 3
FLOAT_TOL = 1e-4          # K1 vs plain, every float channel
INT_AGREE = 0.999         # K1 vs plain, n_contrib / med_e pixel share
BWD_TOL = 1e-5            # K2 vs plain, per column, of the column's max |value|
SEGSUM_TOL = 1e-5         # K5 vs plain, likewise
GRAD_ATOL, GRAD_RTOL = 3e-3, 2e-2   # tiled vs dense gradients (x max |g|)
PNG_TOL = 1               # saved render vs in-memory render, 8-bit levels
SHARDED_TOL = 5e-4        # Gaussian-sharded vs single-device renders (test_parallel.py)
ROW_TOL = 1e-5            # row-sharded vs single-device dense render
# the mesh phase: a sphere of MESH_SPLATS surfels of one grey seen by
# MESH_VIEWS cameras on a ring; the unbounded run's resolution is cut from
# render_cli's default 1024 to keep the script within its time limit (512
# took 79 s of host time on the H100's machine; 256 holds the same checks,
# which scale with the voxel)
MESH_SPLATS, MESH_VIEWS, MESH_RING, MESH_GREY = 100_000, 16, 4.0, 0.6
UNBOUNDED_RES = 256
# the median depth (2DGS's setting for bounded objects, as DTU): the mean
# depth of a pixel on a silhouette blends the surfels along its grazing
# ray, which floats surface fragments up to ~0.07 inside the sphere
MESH_DEPTH_RATIO = 1.0
CAP_MESH_RES = 4096       # a bounded grid past the 200M-voxel cap, for its times
TSDF_TOL = 1e-5           # the card's TSDF grid vs a CPU copy, absolute
COLOUR_TOL = 0.02         # mean vertex colour vs the splats' colour
LPIPS_RTOL = 1e-4         # metrics_cli's LPIPS on the card vs the CPU, relative
# phase 8: the DINO tower at the published DINOv3 ViT-B/16 widths, its term
# (train.py's --lambda_dino default) gated at DINO_GATE, and the viewer
DINO_DEPTH, DINO_DIM, DINO_HEADS, DINO_SIZE, DINO_REGISTERS = 12, 768, 12, 224, 4
DINO_LAMBDA = 0.05
DINO_GATE, DINO_ITERS, DINO_SLOT_ITERS = 10, 20, 3
DINO_TOKEN_TOL = 1e-4     # the card's tokens (and heatmap) vs the CPU copy's, absolute
DINO_GRAD_TOL = 1e-4      # the term's image gradient, card vs CPU, of its max |value|
VIEWER_ROUNDS = 5         # viewer requests of each render item (the first warms up)
GUI_ITERS, GUI_FRAMES = 5, 3   # train --gui: iterations, frames asked on the way
# phase 9: a scan at DTU's published size (49 views at 1600x1200, the IDR
# camera format) of bench.py's cloud, coloured by region so that its K1
# renders hold regions for the segmenter; the pipeline on the card against
# the CPU, then train --run_segmentation on it for SEM_ITERS iterations
SEM_VIEWS, SEM_WIDTH, SEM_HEIGHT, SEM_FOVX = 49, 1600, 1200, 1.2
SEM_ITERS = 10
SEM_LABEL_AGREE = 0.9999  # the card's pixel k-means labels vs the CPU's, pixel share
SEM_HULL_TOL = 1e-12      # the card's hull distances vs the CPU's, absolute
SEM_ARTIFACTS = ("point_cloud/raw_pc.ply", "point_cloud/segmented_point_cloud.ply",
                 "point_cloud/segment_indices.npy", "point_cloud/mask_areas.npy",
                 "cameras/selected_cameras.npz")


# phase 10: JPEG photos. The committed fixtures against the digests Pillow
# gave (tests/torch_data/jpeg/digests.json); then a scene in Mip-NeRF 360's
# outdoor layout: JPEG_VIEWS photos at garden's 5187x3361 (K1 renders of
# bench.py's cloud, written by write_jpeg at quality 75), convert's
# images_2/4/8, train -i images_4 (1296x840, as the 3DGS and 2DGS scripts
# train the outdoor scenes) for JPEG_ITERS iterations, and one load of the
# full-size photos under the 1600-px cap
JPEG_VIEWS, JPEG_WIDTH, JPEG_HEIGHT, JPEG_FACTOR, JPEG_ITERS = 6, 5187, 3361, 4, 10
JPEG_CAPPED = (1600, 1036)     # compute_resolution(5187, 3361, -1)
JPEG_MIN_PSNR = 45.0           # a q75 photo decoded vs the render it was encoded from, dB
JPEG_TEXTURED_QUALITY = 95     # the high-entropy case: noise_texture added, quality 95
JPEG_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data",
                         "jpeg")
# phase 11: the paper's evaluation path. The validation scene of BASELINE.md's
# "bounded, photometric recipe" (33 ray-traced views at 776x584, focal 700,
# 30,000 SfM points, 200,000 GT surface samples), trained with the default
# schedule and lambdas at -r 2 (no DINO weights: the term is off, as in the
# record) over the scene's own white background (--white_background: the
# tracer's misses are white, as NeRF-synthetic's transparent pixels, whose
# driver passes it; over black, the held-out views go under a white fog
# after the first opacity reset, in the JAX package too: ROADMAP.md Queue 3),
# rendered with the bounded mesh at --mesh_res 1024, scored by metrics_cli
# and eval_synthetic; then every benchmark driver once on a tiny scene.
SYNTH_VIEWS, SYNTH_WIDTH, SYNTH_HEIGHT, SYNTH_FOCAL = 33, 776, 584, 700.0
SYNTH_SFM, SYNTH_GT = 30_000, 200_000
SYNTH_ITERS = 7000        # scripts/bench_synthetic.py --iterations 30000 runs the rest
SYNTH_CROP = 2.0          # eval_synthetic --crop_radius: the foreground, as the record
SYNTH_TEST, SYNTH_TRAIN = 5, 28   # --eval holds out every 8th view
TSDF_CAP = 200_000_000    # mesh/tsdf.py's voxel cap
# floors on metrics_cli's test PSNR (dB) and SSIM, the JAX package's record
# (28.66 / 0.973 at 7k, 22.86 / 0.916 at 30k) less 1.0 dB / 0.01 at 7k and
# 2.0 dB / 0.02 at 30k (the record notes view spikes late in training)
SYNTH_FLOORS = {7000: (27.66, 0.963), 30000: (20.86, 0.896)}
SYNTH_SPLATS_30K = (62_000, 248_000)   # 0.5-2x the record's 124k splats
SYNTH_CHAMFER_30K = 0.0209             # 1.5x the record's 0.0139 (fuse.ply)
DRIVER_ITERS = 30         # each driver's chain: --iterations 30 on a tiny scene
DRIVER_POINTS = 20_000
DRIVER_DTU_VIEWS = 9      # a 3x3 grid of the phase-9 layout at DTU's 1600x1200
DRIVER_DTU_BALL = ((0.0, 0.0, 3.5), 0.6)   # the mesh chain's sphere, where the grid looks
DTU_MM_PER_UNIT = 200.0    # the mesh scan's scale_mat: DTU's normalised sphere to mm
DRIVER_MEM_FLOOR_GIB = 8.0  # the drivers are killed if the host's free memory falls below it
DRIVER_RING_VIEWS = 16    # ring_cameras around a sphere of surfels: M360, NeRF, TnT
DRIVER_NERF_SIZE, DRIVER_TNT_SIZE = (800, 800), (960, 540)
# phase 12: render_cli --render_path on the phase-4 model: render_cli's
# 240-frame ellipse trajectory through K1 and its three videos, written by
# the port's MPEG-4 Part 2 encoder (io/video.py); each re-encoded from the
# files export_image wrote must equal it to the byte, and the integer-only
# fixtures must encode to the digests of tests/torch_data/video, which this
# encoder gave where cv2 decoded the files (scripts/make_video_digests.py)
TRAJ_FRAMES, TRAJ_FPS = 240, 30
VIDEO_NAMES = ("render_traj.mp4", "depth_traj.mp4", "normal_traj.mp4")
VIDEO_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data",
                          "video")


def noise_texture(h: int, w: int) -> np.ndarray:
    """int32 [h, w, 3] noise of standard deviation ~6.5 from an integer
    hash of each pixel: the same values from any numpy on any machine (no
    random generator, no floating point)."""
    v = np.arange(h * w, dtype=np.uint32).reshape(h, w)
    chans = []
    for salt in (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D):
        u = v ^ np.uint32(salt)
        u *= np.uint32(0x2C1B3C6D)
        u ^= u >> np.uint32(15)
        u *= np.uint32(0x297A2D39)
        u ^= u >> np.uint32(13)
        tri = (u & np.uint32(0xFF)).astype(np.int32) + (u >> np.uint32(24)).astype(np.int32)
        chans.append((tri - 255) // 16)
    return np.stack(chans, -1)


def textured_photo(h: int, w: int) -> np.ndarray:
    """uint8 [h, w, 3]: colour ramps, a darker disc and noise_texture, in
    integer arithmetic. At JPEG_WIDTH x JPEG_HEIGHT it is the large
    fixture whose Pillow digests (q95 file, decode) digests.json holds."""
    y = np.arange(h, dtype=np.int32)[:, None]
    x = np.arange(w, dtype=np.int32)[None, :]
    base = np.stack(np.broadcast_arrays(40 + 175 * x // w, 40 + 175 * y // h,
                                        40 + 175 * (x + y) // (w + h)), -1)
    disc = (2 * x - w) ** 2 + (2 * y - h) ** 2 < (2 * min(h, w) // 3) ** 2
    base = np.where(disc[..., None], base // 2, base)
    return np.clip(base + noise_texture(h, w), 0, 255).astype(np.uint8)


def video_fixture(n: int, h: int, w: int) -> np.ndarray:
    """uint8 [n, h, w, 3]: a window sliding 2 columns per frame across
    textured_photo(h, w + 2 n), in integer arithmetic: the frames of the
    video fixtures whose mp4v digests tests/torch_data/video holds."""
    photo = textured_photo(h, w + 2 * n)
    return np.stack([photo[:, 2 * i:2 * i + w] for i in range(n)])


def phase_wall(label, t0):
    """Print a phase's wall seconds since t0; the time it ends."""
    now = time.perf_counter()
    print(f"[phase] {label}: {now - t0:.1f} s")
    return now


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card_state() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "power.limit,temperature.gpu", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def fail(msg):
    raise SystemExit(msg)


def build_all():
    """Unlink and rebuild every kernel from the checkout's sources, one nvcc
    process per source, and the host image codec with g++, all at once."""
    from gaussmart_tpu_torch import kernels
    from gaussmart_tpu_torch.io import jpeg

    def one(name):
        kernels.library_path(name).unlink(missing_ok=True)
        t0 = time.perf_counter()
        log = kernels.build(name)
        return name, time.perf_counter() - t0, log

    def codec():
        kernels.cxx_library_path(jpeg.SRC, "imagecodec").unlink(missing_ok=True)
        t0 = time.perf_counter()
        kernels.build_cxx(jpeg.SRC, "imagecodec")
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        host = pool.submit(codec)
        for name, dt, log in pool.map(one, SOURCES):
            print(f"[build] {name} built with nvcc {' '.join(kernels.NVCC_FLAGS)} "
                  f"in {dt:.2f} s")
            for kernel, regs, smem, spills in ptxas_report(log):
                print(f"[build] {name}: {kernel}: {regs} registers, {smem} bytes "
                      f"shared memory, spill stores + loads {spills} bytes")
                if spills:
                    fail(f"[build] {kernel} spills registers")
        print(f"[build] imagecodec (the host image codec, csrc/imagecodec.cpp) built with "
              f"g++ {' '.join(kernels.CXX_FLAGS)} in {host.result():.2f} s")


def ptxas_report(log):
    """[(kernel with its template arguments, registers, shared-memory bytes,
    spill store + load bytes)] per entry function of an `nvcc -Xptxas -v`
    report."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"([a-z_]+_kernel)(?:I((?:Lb[01]E)+)E)?", block)
        flags = re.findall(r"Lb([01])E", m.group(2) or "")
        names = TEMPLATE_PARAMS.get(m.group(1), ())
        kernel = m.group(1) + (
            "<" + ", ".join(f"{n}={f}" for n, f in zip(names, flags)) + ">" if flags else "")
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", block))
        smem = re.search(r"(\d+) bytes smem", block)
        out.append((kernel, int(re.search(r"Used (\d+) registers", block).group(1)),
                    int(smem.group(1)) if smem else 0, spills))
    return out


# --- scenes ---------------------------------------------------------------

def bench_cameras(n_views, width, height, fovy=FOVY):
    """bench.py's camera poses (rotation about y by 0.1 rad steps, 0.1
    translation steps), mirrored to the other side for views 4..7."""
    from gaussmart_tpu_torch.cameras import Camera
    cams = []
    for i in range(n_views):
        k = i if i < 4 else -(i - 3)
        c, s = np.cos(0.1 * k), np.sin(0.1 * k)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        cams.append(Camera(uid=i, colmap_id=i, image_name=f"c{i:03d}", R=R,
                           T=np.array([0.1 * k, 0.0, 0.0]), fovx=FOVX,
                           fovy=fovy, width=width, height=height))
    return cams


def bimodal_opacity(rng, n):
    """bench.py's mid-training opacity: 60% in [0.7, 0.99], the rest in
    [0.05, 0.3]."""
    return np.where(rng.random(n) < 0.6, rng.uniform(0.7, 0.99, n),
                    rng.uniform(0.05, 0.3, n))


def bench_points(rng, n):
    """bench.py's point cloud: centres uniform in [-1,1]^2 x [2,5] and
    random colours in [0, 1]."""
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2.0, 5.0, n)], axis=1).astype(np.float32)
    return pts, rng.random((n, 3)).astype(np.float32)


def scene_params(seed, n, sh_degree):
    """A trained model's splats: bench.py's centres, 3-NN log-scales,
    random unit quaternions, bimodal opacity, random colours and f_rest of
    scale 0.1 so every SH band is exercised."""
    from gaussmart_tpu_torch.models.gaussians import mean_sq_dist_to_3nn
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2.0, 5.0, n)], axis=1).astype(np.float32)
    dist2 = np.maximum(mean_sq_dist_to_3nn(xyz), 1e-7)
    scaling = np.log(np.sqrt(dist2))[:, None].repeat(2, axis=1)
    q = rng.normal(size=(n, 4))
    op = bimodal_opacity(rng, n)
    k = (sh_degree + 1) ** 2
    return {
        "xyz": xyz,
        "features_dc": rgb2sh(rng.random((n, 1, 3))),
        "features_rest": rng.normal(0.0, 0.1, (n, k - 1, 3)),
        "scaling": scaling,
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "opacity": np.log(op / (1 - op))[:, None],
    }


def write_colmap_source(src, cams, images, pts, rgb, level=6, suffix=".png"):
    """A COLMAP text scene: one PINHOLE camera (fovx/fovy), the cameras'
    poses (their images named <image_name><suffix>), their uint8 images as
    PNG (zlib `level`), and the point cloud as sparse/0/points3D.ply."""
    from gaussmart_tpu_torch.cameras import fov2focal
    from gaussmart_tpu_torch.io import colmap
    from gaussmart_tpu_torch.io.images import write_png
    from gaussmart_tpu_torch.io.ply import store_point_cloud
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    width, height = cams[0].width, cams[0].height
    colmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), {
        1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array([
            fov2focal(cams[0].fovx, width), fov2focal(cams[0].fovy, height),
            width / 2, height / 2]))})
    colmap.write_images_text(os.path.join(sparse, "images.txt"), {
        c.uid + 1: colmap.ColmapImage(c.uid + 1, colmap.rotmat2qvec(c.R.T),
                                      np.asarray(c.T), 1, f"{c.image_name}{suffix}")
        for c in cams})
    store_point_cloud(os.path.join(sparse, "points3D.ply"), pts, rgb)
    for c, img in zip(cams, images):
        write_png(os.path.join(src, "images", f"{c.image_name}.png"), img, level=level)


def write_model_dir(root, seed, n, width, height, n_views):
    """A trained-model directory: COLMAP source with GT PNGs, the snapshot
    at point_cloud/iteration_30000, and cfg_args.json."""
    from gaussmart_tpu_torch.io.gaussian_ply import save_gaussian_ply
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy

    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    params = scene_params(seed, n, SH_DEGREE)
    state = state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32),
                             SH_DEGREE, SH_DEGREE, 1.0, device="cpu")
    save_gaussian_ply(os.path.join(model, "point_cloud", f"iteration_{ITERATION}",
                                   "point_cloud.ply"), state)
    cams = bench_cameras(n_views, width, height)
    yy, xx = np.mgrid[0:height, 0:width]
    gts = [np.stack([xx * 255 // width, yy * 255 // height,
                     np.full_like(xx, 32 * i)], axis=-1).astype(np.uint8)
           for i in range(n_views)]
    pts = params["xyz"][:1000]
    write_colmap_source(src, cams, gts, pts, np.full((len(pts), 3), 128.0))
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump({"source_path": src, "model_path": model,
                   "sh_degree": SH_DEGREE, "images": "images",
                   "resolution": -1, "white_background": False,
                   "eval": False, "backend": "auto"}, f, indent=2)
    return model, cams, params


def write_train_scene(src, seed, n, width, height):
    """The training scene: bench.py's 4 cameras, random uint8 targets and
    its 100k-point cloud (colours as 8-bit RGB)."""
    rng = np.random.default_rng(seed)
    pts, cols = bench_points(rng, n)
    cams = bench_cameras(TRAIN_VIEWS, width, height)
    targets = [(rng.random((height, width, 3)) * 256).astype(np.uint8) for _ in cams]
    write_colmap_source(src, cams, targets, pts, np.round(cols * 255.0))


def bench_state(seed, n, width, height, device):
    """bench.py's training state (main, lines 56-83): init_from_pcd on its
    points, the bimodal mid-training opacity, its 4 cameras and random
    float targets."""
    import torch
    from gaussmart_tpu_torch.models.gaussians import init_from_pcd
    from gaussmart_tpu_torch.transforms import inverse_sigmoid
    rng = np.random.default_rng(seed)
    pts, cols = bench_points(rng, n)
    state = init_from_pcd(pts, cols, None, max_sh_degree=SH_DEGREE,
                          spatial_lr_scale=1.0, capacity=-(-n // 256) * 256,
                          device=device)
    op = torch.tensor(bimodal_opacity(rng, n), dtype=torch.float32, device=device)
    state.params.opacity[:n, 0] = inverse_sigmoid(op)
    cams = bench_cameras(TRAIN_VIEWS, width, height)
    gts = [torch.tensor(rng.random((3, height, width)), dtype=torch.float32,
                        device=device) for _ in cams]
    return state, [c.params(device) for c in cams], gts


def small_scene(device):
    """The tests' scene: 30 splats at 64x32 seen from the origin; returns
    the camera and its raw arrays (scales, opacity, SH degree 0)."""
    import torch
    from gaussmart_tpu_torch.cameras import Camera
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(0)
    n = 30
    cam = Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                 T=np.zeros(3), fovx=0.8, fovy=0.8, width=64, height=32)
    xyz = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(2.0, 4.0, n)], axis=1)
    arrays = dict(xyz=xyz, scales=0.15 * rng.uniform(0.5, 1.5, (n, 2)),
                  quats=rng.normal(size=(n, 4)), opacity=np.full(n, 0.8),
                  shs=rgb2sh(rng.random((n, 1, 3))))
    return cam, {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                 for k, v in arrays.items()}


def small_prep(cam, a, device):
    import torch
    from gaussmart_tpu_torch.render.raster_common import preprocess
    n = a["xyz"].shape[0]
    return preprocess(a["xyz"], a["scales"], a["quats"], a["opacity"], a["shs"],
                      torch.ones(n, dtype=torch.bool, device=device),
                      cam.params(device), sh_degree=0)


def frame_prep(state, cam, sh_degree, active_degree=None):
    from gaussmart_tpu_torch.render.raster_common import preprocess
    return preprocess(state.params.xyz, state.get_scaling, state.params.rotation,
                      state.get_opacity[:, 0], state.get_features, state.aux.active,
                      cam, sh_degree=sh_degree, active_degree=active_degree)


# --- kernels against their plain versions ----------------------------------

def hold(label, got, ref, tol, per_column=False):
    """Exit unless `got` matches `ref` within `tol`: absolute, or, with
    per_column, relative to each column's largest |ref| (rows of per-entry
    or per-splat gradients, whose columns differ in scale by orders of
    magnitude). Returns max |got - ref|."""
    import torch
    if got.is_cuda:
        torch.cuda.synchronize()
    diff = (got - ref).abs()
    abs_err = diff.max().item() if diff.numel() else 0.0
    scaled = diff / (ref.abs().amax(dim=0, keepdim=True) + 1e-30) if per_column else diff
    worst = scaled.max().item() if scaled.numel() else 0.0
    finite = bool(torch.isfinite(got).all())
    print(f"[compare] {label}: max|err| {abs_err:.3g}"
          + (f", per column of its max {worst:.3g}" if per_column else "")
          + f" (limit {tol}), finite {finite}")
    if not (finite and worst <= tol):
        fail(f"[compare] {label}: disagrees with its reference")
    return abs_err


def bit_equal(label, first, second):
    """Exit unless a second launch's outputs equal the first's bit for bit."""
    import torch
    second = second if isinstance(second, tuple) else (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"[compare] {label}: a second launch bit-equal {same}")
    if not same:
        fail(f"[compare] {label}: two launches on the same inputs differ")


def hold_forward(label, kernel, got, ref):
    """K1 or K3's (fb, ints) against its plain version's: every float
    channel within FLOAT_TOL, n_contrib and med_e equal on INT_AGREE of the
    pixels; prints whether the two are bit-equal. Returns max |err| of fb."""
    import torch
    err = hold(f"{label} {kernel}, 14 float channels", got[0], ref[0], FLOAT_TOL)
    agree = [(got[1][i] == ref[1][i]).float().mean().item() for i in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    print(f"[compare] {label} {kernel}: n_contrib equal {agree[0]:.6f}, med_e equal "
          f"{agree[1]:.6f}; fb and ints bit-equal {same}")
    if min(agree) < INT_AGREE:
        fail(f"[compare] {label}: {kernel} integer planes disagree")
    return err


def worst(*errs):
    """{kernel: the largest max abs err} over dicts of some of KERNELS."""
    return {k: max(e.get(k, 0.0) for e in errs) for k in KERNELS}


def random_cotangent(fb, width, height, channels, seed=1):
    """A fixed-seed normal cotangent on the image's pixels of the first
    `channels` channels (those that carry one: CT, or CT_SEEDED for the
    seeded core), zero on the padded pixels past its edge."""
    import torch
    ct = torch.zeros((channels,) + tuple(fb.shape[1:]), device=fb.device)
    rng = np.random.default_rng(seed)
    ct[:, :height, :width] = torch.tensor(
        rng.normal(size=(channels, height, width)).astype(np.float32), device=fb.device)
    return ct


def hold_reduction(label, rows, binned, ints):
    """K5 on `rows` (K2's or K4's) through the binning's work-slot map with
    the walk test, as grad_reduce launches it, against its plain version on
    a CPU copy and launched twice. Returns (max abs err of K5, the walk
    limits)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render import segsum
    b = binned
    n_rows = b.slot_starts.shape[0]
    limits = rt.walk_limits(ints, b.tile_ranges)
    walked = int((limits - b.tile_ranges[:, 0]).sum())
    print(f"[compare] {label} segsum: {int(b.slot_starts[-1])} live (splat, tile) slots, "
          f"{walked} of them below their tile's walk limit")
    args = (rows, b.inv_slots, b.slot_starts, n_rows, b.slot_tile, limits)
    out = segsum.segment_sum_gathered(*args).cpu()
    ref = segsum.segment_sum_gathered_plain(
        *(x.cpu() if isinstance(x, torch.Tensor) else x for x in args))
    err = hold(f"{label} segsum vs its plain version on a CPU copy", out, ref, SEGSUM_TOL,
               per_column=True)
    print(f"[compare] {label} segsum: bit-equal to the plain version {torch.equal(out, ref)}")
    bit_equal(f"{label} segsum", (out,), segsum.segment_sum_gathered(*args).cpu())
    return err, limits


def compare_kernels(prep, width, height, label, variants):
    """raster_fwd, raster_bwd (each (need_dist, need_med) of `variants`)
    and segsum (hold_reduction, on the last variant's rows) against their
    plain versions on one binned frame. Returns ({kernel: max abs err},
    the frame's tensors for timing)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    n = prep.depth.shape[0]
    tx, ty = rt.tile_grid(width, height)
    blob = rt.build_blob(prep, torch.zeros(n, 2, device=prep.depth.device),
                         width, height)
    binned = rt.binning(prep, tx, ty)
    ids, ranges, conics = binned[:3]
    print(f"[compare] {label}:{int(ranges[-1, 1])} (splat, tile) pairs")
    errs = {}
    fb, ints = rt.composite_tiles(blob, conics, ids, ranges, width, height)
    errs["raster_fwd"] = hold_forward(
        label, "raster_fwd", (fb, ints),
        rt.composite_tiles_plain(blob, ids, ranges, width, height))

    ct = random_cotangent(fb, width, height, rt.CT)
    errs["raster_bwd"] = 0.0
    for need in variants:
        rows = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height,
                                      *need)
        ref = rt.composite_tiles_bwd_plain(blob, ids, ranges, fb, ints, ct, width,
                                           height, *need)
        errs["raster_bwd"] = max(errs["raster_bwd"], hold(
            f"{label} raster_bwd need_dist/need_med {need}, rows", rows, ref,
            BWD_TOL, per_column=True))
        bit_equal(f"{label} raster_bwd need_dist/need_med {need}", (rows,),
                  rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height,
                                         *need))
    errs["segsum"], limits = hold_reduction(label, rows, binned, ints)
    return errs, dict(blob=blob, conics=conics, ids=ids, ranges=ranges, fb=fb, ints=ints,
                      ct=ct, need=variants[-1], rows=rows, binned=binned, limits=limits)


def seeded_stratum(prep, width, height, k):
    """Stratum k of N_SLOTS depth strata of `prep`, cut as
    render_gaussian_sharded cuts them (a stable depth sort), and its seed
    as pass 2 gets it from pass 1 and the fold: the nearer strata
    composited from the identity seed (K1), T zeroed where that walk
    terminated, the identity past the image's edge (for k = 0, the
    identity: every stratum's seed in pass 1). Returns (the stratum's
    prep, init [3, H_pad, W_pad])."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.raster_common import T_EPS, Preprocessed
    order = torch.argsort(torch.where(prep.valid, prep.depth, torch.inf), stable=True)
    per = -(-order.shape[0] // N_SLOTS)

    def rows(lo, hi):
        return Preprocessed(*(x[order[lo:hi]] for x in prep))
    near, stratum = rows(0, k * per), rows(k * per, (k + 1) * per)
    tx, ty = rt.tile_grid(width, height)
    if k == 0:
        init = torch.zeros((3, ty * rt.TILE, tx * rt.TILE), device=prep.depth.device)
        init[0] = 1.0
        return stratum, init
    zeros = torch.zeros(near.depth.shape[0], 2, device=prep.depth.device)
    blob = rt.build_blob(near, zeros, width, height)
    ids, ranges, conics = rt.binning(near, tx, ty)[:3]
    fb, _ = rt.composite_tiles(blob, conics, ids, ranges, width, height)
    ch = rt.FB_CHANNELS.index
    init = torch.stack([torch.where(fb[ch("mt")] < T_EPS, 0.0, fb[ch("T")]),
                        fb[ch("M1")], fb[ch("M2")]])
    init[:, height:] = 0.0
    init[:, :, width:] = 0.0
    init[0, height:] = 1.0
    init[0, :, width:] = 1.0
    return stratum, init.contiguous()


def compare_seeded(prep, width, height, label, variants, k=1):
    """raster_fwd_seeded (K3) and raster_bwd_seeded (K4, each (need_dist,
    need_med) of `variants`, rows and seed gradient) against their plain
    versions on depth stratum k of N_SLOTS of a frame, seeded as
    seeded_stratum says: k = 1 is pass 2's stratum seeded by the nearest,
    k = 0 pass 1's from the identity seed. (On the full-width frames the
    nearest quarter of the splats already ends most covered pixels, so
    pass 2 past stratum 1 blends almost nothing.) Returns ({kernel: max
    abs err}, the stratum's tensors for timing)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    stratum, init = seeded_stratum(prep, width, height, k)
    n = stratum.depth.shape[0]
    blob = rt.build_blob(stratum, torch.zeros(n, 2, device=prep.depth.device),
                         width, height)
    binned = rt.binning(stratum, *rt.tile_grid(width, height))
    ids, ranges, conics = binned[:3]
    t0 = init[0, :height, :width]
    label = f"{label}, stratum {k + 1} of {N_SLOTS}"
    print(f"[compare] {label}: {n} splats, "
          f"{int(ranges[-1, 1])} (splat, tile) pairs; seed T0 mean "
          f"{t0.mean().item():.4f}, zero (terminated nearer) at "
          f"{(t0 == 0).float().mean().item():.4f} of the pixels")
    fb, ints = rt.composite_tiles(blob, conics, ids, ranges, width, height, init=init)
    errs = {"raster_fwd_seeded": hold_forward(
        label, "raster_fwd_seeded", (fb, ints),
        rt.composite_tiles_plain(blob, ids, ranges, width, height, init=init))}

    ct = random_cotangent(fb, width, height, rt.CT_SEEDED)
    errs["raster_bwd_seeded"] = 0.0
    for need in variants:
        rows, gi = rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height,
                                          *need, init=init)
        ref, gi_p = rt.composite_tiles_bwd_plain(blob, ids, ranges, fb, ints, ct, width,
                                                 height, *need, init=init)
        errs["raster_bwd_seeded"] = max(
            errs["raster_bwd_seeded"],
            hold(f"{label} raster_bwd_seeded need_dist/need_med {need}, rows", rows, ref,
                 BWD_TOL, per_column=True),
            # one column per seed channel: T0, M1_0, M2_0
            hold(f"{label} raster_bwd_seeded need_dist/need_med {need}, seed gradient",
                 gi.reshape(3, -1).T, gi_p.reshape(3, -1).T, BWD_TOL, per_column=True))
        bit_equal(f"{label} raster_bwd_seeded need_dist/need_med {need}", (rows, gi),
                  rt.composite_tiles_bwd(blob, ids, ranges, fb, ints, ct, width, height,
                                         *need, init=init))
    errs["segsum"] = hold_reduction(f"{label} raster_bwd_seeded rows", rows, binned,
                                    ints)[0]
    return errs, dict(blob=blob, conics=conics, ids=ids, ranges=ranges, fb=fb, ints=ints,
                      ct=ct, init=init, need=variants[-1])


def touch_every_channel(img, am, target):
    """tests/test_torch_backward.py's loss: every image and allmap channel."""
    return (((img - target) ** 2).sum() + 0.05 * am[6].sum() + 0.01 * am[0].sum()
            + 0.01 * (am[2:5] ** 2).sum() + 0.02 * am[5].sum() + 0.01 * am[1].sum())


def tiled_vs_dense(device):
    """The small scene's tiled render (K1) and its gradients (K2 + the
    reduction) against the dense oracle's forward and autograd."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels
    cam, arrays = small_scene(device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    target = torch.tensor(np.random.default_rng(3).random(
        (3, cam.height, cam.width)).astype(np.float32), device=device)
    out = {}
    for name in ("tiled", "dense"):
        leaves = {k: v.clone().requires_grad_(k != "quats") for k, v in arrays.items()}
        means2d = torch.zeros(arrays["xyz"].shape[0], 2, device=device,
                              requires_grad=True)
        prep = small_prep(cam, leaves, device)
        if name == "tiled":
            r = rt.rasterize_tiled(prep, means2d, bg, cam.width, cam.height)
        else:
            r = rasterize_pixels(prep, means2d, bg, cam.width, cam.height, chunk=8)
        touch_every_channel(r["image"], r["allmap"], target).backward()
        out[name] = (r["image"].detach(), {k: v.grad for k, v in leaves.items()
                                           if k != "quats"} | {"means2d": means2d.grad})
    d_img = hold("small tiled vs dense oracle, image", out["tiled"][0],
                 out["dense"][0], 6e-3)
    worst = 0.0
    for k, g in out["tiled"][1].items():
        ref = out["dense"][1][k]
        slack = GRAD_ATOL * ref.abs().max().item() + GRAD_RTOL * ref.abs()
        worst = max(worst, ((g - ref).abs() / slack).max().item())
    print(f"[compare] small tiled vs dense oracle, gradients of xyz, scales, "
          f"opacity, shs, means2d: worst |err| / (atol {GRAD_ATOL} x max|g| + "
          f"rtol {GRAD_RTOL} x |g|) = {worst:.3g} (limit 1)")
    if not worst <= 1.0:
        fail("[compare] tiled gradients disagree with the dense oracle")
    return d_img


def step_gradients(step, args):
    """One training step `step(*args)`, recording the autograd leaves that
    each view's _loss_and_aux differentiates: {name: .grad} of every
    parameter group and of means2d, for each view and each slot's chunk."""
    from gaussmart_tpu_torch import train_lib
    from gaussmart_tpu_torch.optim import NAMES
    from gaussmart_tpu_torch.parallel import sharding
    calls = []
    original = train_lib._loss_and_aux

    def recording(params, means2d, *a, **kw):
        calls.append((params, means2d))
        return original(params, means2d, *a, **kw)
    train_lib._loss_and_aux = sharding._loss_and_aux = recording
    try:
        step(*args)
    finally:
        train_lib._loss_and_aux = sharding._loss_and_aux = original
    grads = {}
    for v, (params, means2d) in enumerate(calls):
        chunks = params if isinstance(params, list) else [params]
        m2d = means2d if isinstance(means2d, list) else [means2d]
        for c, (p, m) in enumerate(zip(chunks, m2d)):
            grads.update({f"view {v} chunk {c} {n}": getattr(p, n).grad for n in NAMES})
            grads[f"view {v} chunk {c} means2d"] = m.grad
    return grads


def backward_determinism(state, cams, gts, device):
    """Two backwards of each training step (make_train_step; the
    Gaussian-sharded make_mp_train_step and the data-parallel
    make_dp_train_step over N_SLOTS slots) from the same state, cameras and
    targets: the gradients of every parameter and of means2d must be
    bit-equal."""
    import torch
    from gaussmart_tpu_torch.config import OptimizationParams
    from gaussmart_tpu_torch.optim import init_adam
    from gaussmart_tpu_torch.parallel.sharding import (BatchedCameras, make_dp_train_step,
                                                       make_mesh, make_mp_train_step,
                                                       replicate, shard_batch,
                                                       shard_state)
    from gaussmart_tpu_torch.train_lib import make_train_step
    opt = OptimizationParams()
    kw = dict(sh_degree=SH_DEGREE, white_background=False, spatial_lr_scale=1.0)
    mesh = make_mesh(N_SLOTS, device)
    adam = init_adam(state.params)
    batched = BatchedCameras.stack([cams[i % len(cams)] for i in range(N_SLOTS)])
    targets = torch.stack([gts[i % len(gts)] for i in range(N_SLOTS)])
    hold_determinism({
        "training step": (make_train_step(opt, backend="auto", **kw),
                          (state.params, adam, state.aux, cams[1], gts[1], 1)),
        f"Gaussian-sharded step over {N_SLOTS} slots": (
            make_mp_train_step(opt, mesh, backend="gaussian_sharded_pallas", **kw),
            shard_state(state.params, adam, state.aux, mesh) + (cams[1], gts[1], 1)),
        f"data-parallel step over {N_SLOTS} slots": (
            make_dp_train_step(opt, mesh, backend="auto", **kw),
            (replicate(state.params, mesh), replicate(adam, mesh),
             replicate(state.aux, mesh), shard_batch(batched, mesh),
             shard_batch(targets, mesh), 1)),
    })


def hold_determinism(steps):
    """{label: (step, args)}: two backwards of each step from the same
    arguments, their gradients held bit-equal."""
    import torch
    for label, (step, args) in steps.items():
        first, second = step_gradients(step, args), step_gradients(step, args)
        differ = [k for k in first if not (
            first[k] is second[k] is None
            or (first[k] is not None and second[k] is not None
                and torch.equal(first[k], second[k])))]
        print(f"[determinism] {label}: two backwards from the same state, {len(first)} "
              f"gradients (every parameter group and means2d, per view and chunk) "
              f"bit-equal {not differ}"
              + (f"; differing: {', '.join(differ)}" if differ else ""))
        if differ:
            fail(f"[determinism] {label}: the gradients differ between two backwards")


# --- the main paths ----------------------------------------------------------

def zero_counts():
    from gaussmart_tpu_torch import logging_utils
    logging_utils.collect()


def read_counts():
    import torch
    from gaussmart_tpu_torch import logging_utils
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: logging_utils.counter(k) for k in logging_utils.LAUNCHES}


def only(counts, **want):
    """Whether the kernels named in `want` launched that often and every
    other kernel not at all. Unless `want` names it, K7 (binning, counted
    once a binning) is expected once per K1 launch and once per depth
    stratum of a Gaussian-sharded frame (two K3 launches)."""
    want.setdefault("binning", want.get("raster_fwd", 0) + want.get("raster_fwd_seeded", 0) // 2)
    return all(n == want.get(k, 0) for k, n in counts.items())


def serve(model, state, device):
    """render_cli on the trained-model directory, counted; its saved
    renders against in-memory renders of the same splats."""
    import torch
    from gaussmart_tpu_torch import render_cli
    from gaussmart_tpu_torch.io.images import read_png
    from gaussmart_tpu_torch.render.api import render
    zero_counts()
    t0 = time.perf_counter()
    ex = render_cli.main(["-m", model, "--skip_mesh", "--device", str(device)])
    counts = read_counts()
    cli_s = time.perf_counter() - t0
    out_dir = os.path.join(model, "train", f"ours_{ITERATION}")
    renders = [read_png(os.path.join(out_dir, "renders", f"{i:05d}.png"))
               for i in range(len(ex.viewpoint_stack))]
    finite = all(bool(torch.isfinite(m).all())
                 for m in ex.rgbmaps + ex.depthmaps + ex.normalmaps)
    # what render_cli wrote, against the same cameras rendered from the
    # splats held in memory (never through the PLY); and the mean alpha of
    # the splats render_cli loaded back from point_cloud.ply
    png_err, alpha = [], []
    with torch.inference_mode():
        for cam, png in zip(ex.viewpoint_stack, renders):
            ref = render(cam.params(device), state, ex.bg)["render"]
            ref = np.clip(ref.permute(1, 2, 0).cpu().numpy() * 255, 0, 255)
            png_err.append(int(np.abs(png.astype(np.int16)
                                      - ref.astype(np.uint8)).max()))
            alpha.append(render(cam.params(device), ex.state, ex.bg)
                         ["rend_alpha"].mean().item())
    print(f"[serve] render_cli rendered {len(renders)} views in {cli_s:.2f} s; "
          f"launches {counts}; renders {renders[0].shape}; finite {finite}; saved "
          f"render vs in-memory render max|diff| (8-bit levels) {max(png_err)}; "
          "mean rend_alpha of the loaded splats " + " ".join(f"{a:.3f}" for a in alpha))
    n_views = len(ex.viewpoint_stack)
    if not (only(counts, raster_fwd=n_views, preprocess_fwd=n_views)
            and n_views == len(renders) and finite
            and all(r.shape == renders[0].shape for r in renders)
            and max(png_err) <= PNG_TOL and float(np.mean(alpha)) > 0.5):
        fail("[serve] check failed")
    return counts, ex


def serve_sharded(model, ex_single, device):
    """render_cli --n_devices N_SLOTS --shard_mode gaussian on the same
    model, counted: every view is 2 passes of N_SLOTS strata through K3;
    its renders against the single-device renders."""
    import torch
    from gaussmart_tpu_torch import render_cli
    zero_counts()
    t0 = time.perf_counter()
    ex = render_cli.main(["-m", model, "--skip_mesh", "--device", str(device),
                          "--n_devices", str(N_SLOTS), "--shard_mode", "gaussian"])
    counts = read_counts()
    secs = time.perf_counter() - t0
    n_views = len(ex.viewpoint_stack)
    err = max((a - b).abs().max().item() for a, b in zip(ex.rgbmaps, ex_single.rgbmaps))
    finite = all(bool(torch.isfinite(m).all()) for m in ex.rgbmaps + ex.depthmaps)
    print(f"[serve] render_cli --n_devices {N_SLOTS} --shard_mode gaussian rendered "
          f"{n_views} views in {secs:.2f} s; launches {counts}; renders vs the "
          f"single-device renders max|diff| {err:.3g} (limit {SHARDED_TOL}); finite {finite}")
    if not (only(counts, raster_fwd_seeded=2 * N_SLOTS * n_views)
            and n_views == len(ex_single.rgbmaps) and finite and err <= SHARDED_TOL):
        fail("[serve] Gaussian-sharded check failed")


def row_sharded_render(device):
    """render() with the row_sharded backend over N_SLOTS slots on the
    small scene at 64x30 (30 rows: not a multiple of the slots, so they
    are padded and cropped), counted (the dense compositor: no kernel),
    against the single-device dense render."""
    import torch
    from gaussmart_tpu_torch.cameras import Camera
    from gaussmart_tpu_torch.parallel.sharding import make_mesh
    from gaussmart_tpu_torch.render.api import render_arrays
    _, a = small_scene(device)
    cam = Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3), T=np.zeros(3),
                 fovx=0.8, fovy=0.8, width=64, height=30).params(device)
    n = a["xyz"].shape[0]
    kw = dict(xyz=a["xyz"], scaling=a["scales"], rotation=a["quats"],
              opacity=a["opacity"], features=a["shs"],
              active=torch.ones(n, dtype=torch.bool, device=device), sh_degree=0,
              bg_color=torch.tensor([0.1, 0.2, 0.3], device=device), chunk=8)
    mesh = make_mesh(N_SLOTS, device)
    with torch.inference_mode():
        ref = render_arrays(cam, backend="dense", **kw)
        zero_counts()
        out = render_arrays(cam, backend="row_sharded", mesh=mesh, **kw)
        counts = read_counts()
    err = max((out[k] - ref[k]).abs().max().item()
              for k in ("render", "rend_alpha", "rend_normal", "surf_depth"))
    print(f"[serve] row_sharded render over {N_SLOTS} slots, 64x30: launches {counts}; "
          f"render, alpha, normal, depth vs the single-device dense render max|diff| "
          f"{err:.3g} (limit {ROW_TOL}); shape {tuple(out['render'].shape)}")
    if not (only(counts) and err <= ROW_TOL and out["render"].shape == (3, 30, 64)):
        fail("[serve] row-sharded check failed")


# --- the fused preprocess (K6) ------------------------------------------------

def garden_scale_state(seed, device):
    """GARDEN_SPLATS splats made on the card from `seed`: bench.py's centre
    box, log-scales round the box's mean spacing with a log-normal spread,
    random quaternions, the bimodal opacity, SH coefficients of scale 0.1,
    and 5% of the rows inactive (a capacity's free slots)."""
    import torch
    from gaussmart_tpu_torch.models.gaussians import (GaussianAux, GaussianParams,
                                                      GaussianState)
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    g = torch.Generator(device=device).manual_seed(seed)
    n = GARDEN_SPLATS

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)
    xyz = torch.stack([2 * u(n) - 1, 2 * u(n) - 1, 2 + 3 * u(n)], dim=1)
    op = torch.where(u(n) < 0.6, 0.7 + 0.29 * u(n), 0.05 + 0.25 * u(n))
    k = (SH_DEGREE + 1) ** 2
    params = GaussianParams(
        xyz=xyz, features_dc=rgb2sh(u(n, 1, 3)), features_rest=0.1 * normal(n, k - 1, 3),
        scaling=float(np.log((12.0 / n) ** (1 / 3))) + 0.4 * normal(n, 2),
        rotation=normal(n, 4), opacity=torch.log(op / (1 - op))[:, None])
    zeros = torch.zeros(n, device=device)
    aux = GaussianAux(active=u(n) >= 0.05, segments=torch.zeros(n, dtype=torch.int32,
                                                                  device=device),
                      max_radii2d=zeros, grad_accum=zeros.clone(), denom=zeros.clone())
    return GaussianState(params=params, aux=aux, max_sh_degree=SH_DEGREE,
                         active_sh_degree=SH_DEGREE, spatial_lr_scale=1.0)


def ulps(a, b):
    """Per element distance of two float32 tensors in units in the last
    place (0 where the bits are equal; NaN against a number counts huge)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i >= 0, i, -(i & 0x7FFFFFFF))
    return (ordered(a) - ordered(b)).abs()


def hold_fused(label, got, ref):
    """K6's Fused against its plain twin's: every column bit-equal, the
    zero rows zero. Prints each column group's share of bit-equal rows and
    largest gap in ulps. Returns the largest |difference| over the blob and
    conic rows."""
    import torch
    torch.cuda.synchronize()
    n = got.prep.depth.shape[0]
    cols = {"shift": got.blob[:, 11:13], "colour": got.blob[:, 14:17]}
    refs = {"shift": ref.blob[:, 11:13], "colour": ref.blob[:, 14:17]}
    elementwise = all(torch.equal(cols[k], refs[k]) for k in cols)
    groups = {
        "T": (got.blob[:, :9], ref.blob[:, :9]),
        "centre": (got.blob[:, 9:11], ref.blob[:, 9:11]),
        "opacity": (got.blob[:, 13:14], ref.blob[:, 13:14]),
        "normal": (got.blob[:, 17:20], ref.blob[:, 17:20]),
        "conics": (got.conics, ref.conics),
        "radius": (got.prep.radius[:, None], ref.prep.radius[:, None]),
        "depth": (got.prep.depth[:, None], ref.prep.depth[:, None]),
        "rx, ry": (torch.stack([got.prep.rx, got.prep.ry], 1),
                   torch.stack([ref.prep.rx, ref.prep.ry], 1)),
        "valid": (got.prep.valid[:, None].float(), ref.prep.valid[:, None].float()),
    }
    stats = {}
    for name, (a, b) in groups.items():
        d = ulps(a, b)
        stats[name] = ((d == 0).all(dim=1).float().mean().item(), int(d.max()))
    err = max((got.blob - ref.blob).abs().max().item(),
              (got.conics - ref.conics).abs().max().item())
    same = torch.equal(got.blob, ref.blob) and torch.equal(got.conics, ref.conics) and all(
        torch.equal(getattr(got.prep, f), getattr(ref.prep, f))
        for f in ("radius", "depth", "rx", "ry", "valid"))
    print(f"[fused] {label}, {n} splats ({int(ref.prep.valid.sum())} valid): shift and "
          f"colour bit-equal {elementwise}; rows bit-equal (share, max ulps): "
          + "; ".join(f"{k} {share:.6f}, {u}" for k, (share, u) in stats.items())
          + f"; max|err| of the blob and conic rows {err:.3g}; all bit-equal {same}")
    if not (same and not got.blob[-1].any() and not got.conics[-1].any()):
        fail(f"[fused] {label}: preprocess_fwd is not bit-equal to its plain twin")
    return err


def unfused_render(cam, state, bg):
    """render_arrays on the state's fields: the unfused chain that render()
    without a gradient replaces with K6."""
    from gaussmart_tpu_torch.render.api import render_arrays
    return render_arrays(
        cam, xyz=state.params.xyz, scaling=state.get_scaling,
        rotation=state.params.rotation, opacity=state.get_opacity[:, 0],
        features=state.get_features, active=state.aux.active,
        sh_degree=state.active_sh_degree, bg_color=bg)


def hold_fused_frames(label, state, cams, device):
    """render() (K6) against the unfused chain on each camera: every output
    bit-equal; one K6 and one K1 launch a render()."""
    import torch
    from gaussmart_tpu_torch.render.api import render
    bg = torch.zeros(3, device=device)
    differ = set()
    with torch.inference_mode():
        for cam in cams:
            zero_counts()
            out = render(cam, state, bg)
            counts = read_counts()
            if not only(counts, raster_fwd=1, preprocess_fwd=1):
                fail(f"[fused] {label}: render() launched {counts}")
            ref = unfused_render(cam, state, bg)
            differ |= {k for k in ref if not torch.equal(out[k], ref[k])}
    print(f"[fused] {label}: {len(cams)} frames, render() (K6) against render_arrays: "
          f"outputs not bit-equal {sorted(differ)}; one preprocess_fwd and one raster_fwd "
          "a render()")
    if differ:
        fail(f"[fused] {label}: render() and render_arrays differ in {sorted(differ)}")


def fused_bytes(state):
    """Bytes K6 must move: each input read once, each output written once."""
    n = state.capacity
    n_rest = state.params.features_rest.shape[1]
    reads = n * (4 * (3 + 2 + 4 + 1 + 3 + 3 * n_rest) + 1)
    writes = (n + 1) * 4 * (20 + 8) + n * (4 * 4 + 1)
    return reads + writes


def time_fused(label, state, cam, card):
    """K6's device time beside its byte bound, the plain chain's device time
    and launches, and the render() frame against the unfused one.
    Returns (K6 ms, plain ms, bound ms)."""
    import torch
    from gaussmart_tpu_torch.render.api import render
    from gaussmart_tpu_torch.render.preprocess_fused import (preprocess_fused,
                                                             preprocess_fused_plain)
    bg = torch.zeros(3, device=state.device)

    def unfused():
        return unfused_render(cam, state, bg)
    with torch.inference_mode():
        k6_ms, _ = device_kernel_ms(lambda: preprocess_fused(state, cam), FRAMES)
        plain_ms, plain_top = device_kernel_ms(lambda: preprocess_fused_plain(state, cam),
                                               5)
        frame_ms = time_ms(lambda: render(cam, state, bg), FRAMES)
        unfused_ms = time_ms(unfused, FRAMES)
        frame_dev, frame_top = device_kernel_ms(lambda: render(cam, state, bg), 5)
        unfused_dev, unfused_top = device_kernel_ms(unfused, 5)
    nbytes = fused_bytes(state)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3

    def launches(top):
        return sum(c for _, _, c in top)
    if k6_ms is None:
        print(f"[time] {label}: device times not measured (the profiler recorded no "
              "device events)")
        return None, None, bound_ms
    print(f"[time] {card}: {label}, {state.capacity} splats: preprocess_fwd (K6) "
          f"{k6_ms:.4f} ms device, bound {bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at "
          f"3.35 TB/s: {100 * bound_ms / k6_ms:.1f}% of it); the plain chain (activations, "
          f"preprocess, build_blob, build_conics) {plain_ms:.4f} ms device in "
          f"{launches(plain_top):g} launches; render() {frame_ms:.4f} ms a frame "
          f"(device {frame_dev:.4f} ms in {launches(frame_top):g} launches), the unfused "
          f"frame {unfused_ms:.4f} ms (device {unfused_dev:.4f} ms in "
          f"{launches(unfused_top):g} launches)")
    return k6_ms, plain_ms, bound_ms


def fused_preprocess_path(state_s, cams, seed, device, card):
    """Phase 13: K6 against its plain twin on the phase-4 model's views and
    on a garden-scale state; served frames; timings. Returns (max abs err,
    (K6 ms, plain ms, library ms), (bound ms, "bytes")) at garden scale."""
    import torch
    from gaussmart_tpu_torch.render.preprocess_fused import (preprocess_fused,
                                                             preprocess_fused_plain)
    err = 0.0
    views = [c.params(device) for c in cams]
    with torch.inference_mode():
        for i, cam in enumerate(views):
            for smod in (1.0, 0.7):
                err = max(err, hold_fused(f"phase-4 model, view {i}, scaling_modifier "
                                          f"{smod}", preprocess_fused(state_s, cam, smod),
                                          preprocess_fused_plain(state_s, cam, smod)))
    hold_fused_frames(f"phase-4 model {WIDTH}x{HEIGHT}", state_s, views, device)
    time_fused(f"phase-4 model {WIDTH}x{HEIGHT}", state_s, views[0], card)

    garden = garden_scale_state(seed, device)
    gcams = [c.params(device) for c in bench_cameras(3, GARDEN_WIDTH, GARDEN_HEIGHT)]
    with torch.inference_mode():
        for i, cam in enumerate(gcams):
            err = max(err, hold_fused(f"garden-scale state, view {i}",
                                      preprocess_fused(garden, cam),
                                      preprocess_fused_plain(garden, cam)))
    hold_fused_frames(f"garden-scale state {GARDEN_WIDTH}x{GARDEN_HEIGHT}", garden,
                      gcams, device)
    k6_ms, plain_ms, bound_ms = time_fused(
        f"garden-scale state {GARDEN_WIDTH}x{GARDEN_HEIGHT}", garden, gcams[0], card)
    del garden
    torch.cuda.empty_cache()
    return err, (k6_ms, plain_ms, None), (bound_ms, "bytes")


# --- the binning kernel (K7) -------------------------------------------------

@contextlib.contextmanager
def synced_launches():
    """Every hand-written kernel launched in the block synchronises the
    card after its launch, so that a fault surfaces at the launch that made
    it (kernels.launch raises the entry's own error code)."""
    import torch
    from gaussmart_tpu_torch import kernels

    def make(launch):
        def synced_launch(*args):
            launch(*args)
            torch.cuda.synchronize()
        return synced_launch
    with replaced(kernels, "launch", make):
        yield


def same_tensor(a, b):
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def hold_binning(label, prep, width, height, conics=None):
    """K7 against binning_plain on one prep: every Binned field bit-equal,
    lengths and padding tails included, with the plan and without it (then
    inv_slots and slot_tile empty); one binning counted, the card
    synchronised after each of its kernels. Returns (rectangle pairs, live
    pairs)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    tiles = rt.tile_grid(width, height)
    if conics is None:
        conics = rt.build_conics(prep)
    ref = rt.binning_plain(prep, *tiles, conics)
    with synced_launches():
        zero_counts()
        got = rt.binning(prep, *tiles, conics)
        launches = read_counts()["binning"]
        bare = rt.binning(prep, *tiles, conics, plan=False)
    torch.cuda.synchronize()
    differ = [f for f in rt.Binned._fields if not same_tensor(getattr(got, f), getattr(ref, f))]
    differ += [f"{f} without the plan" for f in rt.Binned._fields
               if f not in ("inv_slots", "slot_tile")
               and not same_tensor(getattr(bare, f), getattr(ref, f))]
    plan_empty = bare.inv_slots.numel() == 0 and bare.slot_tile.numel() == 0
    n_rect, n_live = ref.entry_ids.shape[0], int(ref.slot_starts[-1])
    print(f"[binning] {label}, {prep.depth.shape[0]} splats: {n_rect} rectangle pairs, "
          f"{n_live} live ({100 * n_live / max(n_rect, 1):.2f}%); {launches} K7 binning; "
          f"every Binned field bit-equal to binning_plain {not differ}"
          + (f" (differing: {', '.join(differ)})" if differ else "")
          + f"; without the plan inv_slots and slot_tile empty {plan_empty}")
    if differ or launches != 1 or not plan_empty:
        fail(f"[binning] {label}: K7 is not bit-equal to binning_plain, or counted "
             f"{launches} binnings")
    return n_rect, n_live


def leaves(x):
    """The tensors and numbers of a step's outputs, in order."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in leaves(v)]
    if hasattr(x, "__dataclass_fields__"):
        return leaves(list(vars(x).values()))
    return [x]


def hold_binning_paths(label, state, cams, gts, device):
    """render() (K6 and K7) and a training step (K7 with the plan, then K2
    and K5 through it) against the same calls with binning_plain in K7's
    place, the parent path: every output bit-equal."""
    import torch
    from gaussmart_tpu_torch.config import OptimizationParams
    from gaussmart_tpu_torch.optim import init_adam
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.api import render
    from gaussmart_tpu_torch.train_lib import make_train_step
    bg = torch.zeros(3, device=device)
    step = make_train_step(OptimizationParams(), sh_degree=state.active_sh_degree,
                           white_background=False)
    adam = init_adam(state.params)

    def run():
        with torch.inference_mode():
            frames = [render(cam, state, bg) for cam in cams]
        out = step(state.params, adam, state.aux, cams[0], gts[0], 15001)
        torch.cuda.synchronize()
        return frames, leaves(out[:4])
    zero_counts()
    frames, stepped = run()
    counts = read_counts()
    with replaced(rt, "binning", lambda orig: rt.binning_plain):
        zero_counts()
        ref_frames, ref_stepped = run()
        ref_counts = read_counts()
    differ = sorted({k for f, r in zip(frames, ref_frames) for k in r
                     if not same_tensor(f[k], r[k])})
    n_step = sum(isinstance(a, torch.Tensor) for a in stepped)
    step_differ = [i for i, (a, b) in enumerate(zip(stepped, ref_stepped))
                   if not (same_tensor(a, b) if isinstance(a, torch.Tensor) else a == b)]
    print(f"[binning] {label}: {len(cams)} render() frames and a training step through K7 "
          f"against binning_plain's: frame outputs not bit-equal {differ}; step outputs "
          f"({n_step} tensors) not bit-equal {len(step_differ)}; K7 binnings "
          f"{counts['binning']} (binning_plain's run {ref_counts['binning']})")
    if (differ or step_differ or len(stepped) != len(ref_stepped)
            or counts["binning"] != len(cams) + 1 or ref_counts["binning"]):
        fail(f"[binning] {label}: render() or the training step differs from the parent "
             "path, or K7 did not bin each frame once")


def binning_bytes(n, n_live, n_tiles):
    """Bytes binning must move: each splat's centre, rx, ry, depth, valid
    flag and 8 conic terms read once (53 bytes), each live pair written
    once as an 8-byte key and a 4-byte splat id, and the tile ranges."""
    return n * 53 + n_live * 12 + n_tiles * 8


def time_binning(label, prep, width, height, conics, card):
    """K7's three kernels' device time, the whole binning's through the
    wrapper (its cumsum and torch.sort, device and CUDA events), with and
    without the plan, beside the byte bound; the plain chain's. Returns
    (K7 ms, plain ms, bound ms) without the plan (the served frame's)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    tiles = rt.tile_grid(width, height)
    n = prep.depth.shape[0]
    with torch.inference_mode():
        n_live = int(rt.binning(prep, *tiles, conics, plan=False).slot_starts[-1])
        dev_ms, top = device_kernel_ms(lambda: rt.binning(prep, *tiles, conics, plan=False),
                                       FRAMES)
        plan_ms, plan_top = device_kernel_ms(lambda: rt.binning(prep, *tiles, conics),
                                             FRAMES)
        wall_ms = time_ms(lambda: rt.binning(prep, *tiles, conics, plan=False), FRAMES)
        plain_ms, plain_top = device_kernel_ms(
            lambda: rt.binning_plain(prep, *tiles, conics, plan=False), 5)
        plain_plan_ms, _ = device_kernel_ms(lambda: rt.binning_plain(prep, *tiles, conics), 5)
        plain_wall = time_ms(lambda: rt.binning_plain(prep, *tiles, conics, plan=False), 5)
    nbytes = binning_bytes(n, n_live, tiles[0] * tiles[1])
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if dev_ms is None:
        print(f"[time] {label}: device times not measured (the profiler recorded no "
              "device events)")
        return None, None, bound_ms

    def k7(rows):
        found = ((re.search(r"bin_(count|emit|finish)_kernel", name), ms) for name, ms, _ in rows)
        return {m.group(0): ms for m, ms in found if m}

    def launches(rows):
        return sum(c for _, _, c in rows)
    own, own_plan = k7(top), k7(plan_top)
    sort_ms = sum(ms for name, ms, _ in top if "Sort" in name or "sort" in name)
    k7_ms = sum(own.values())
    print(f"[time] {card}: {label}, {n} splats, {n_live} live pairs: K7's kernels "
          f"{k7_ms:.4f} ms device (" + ", ".join(f"{k} {ms:.4f}" for k, ms in own.items())
          + f"; with the plan {sum(own_plan.values()):.4f}), bound {bound_ms:.4f} ms "
          f"({nbytes / 1e9:.3f} GB at 3.35 TB/s: {100 * bound_ms / k7_ms:.1f}% of it); "
          f"binning through the wrapper {dev_ms:.4f} ms device in {launches(top):g} "
          f"launches (the sort {sort_ms:.4f} ms), {wall_ms:.4f} ms by CUDA events; with "
          f"the plan {plan_ms:.4f} ms device in {launches(plan_top):g} launches; "
          f"binning_plain {plain_ms:.4f} ms device in {launches(plain_top):g} launches "
          f"({plain_wall:.4f} ms by CUDA events), with the plan {plain_plan_ms:.4f} ms; "
          "top: " + "; ".join(f"{name[:50]} {ms:.4f} ms x{c:g}" for name, ms, c in top[:8]))
    return k7_ms, plain_ms, bound_ms


def binning_path(state_s, cams, seed, device, card):
    """Phase 14: K7 against binning_plain on the phase-4 model's views
    (the training chain's prep and K6's) and on a garden-scale state's;
    render() and a training step against the parent path; timings at both
    sizes. Returns ((K7 ms, plain ms, None), (bound ms, "bytes")) at garden
    scale."""
    import torch
    from gaussmart_tpu_torch.render.preprocess_fused import preprocess_fused
    views = [c.params(device) for c in cams]
    with torch.inference_mode():
        for i, cam in enumerate(views):
            hold_binning(f"phase-4 model, view {i}, the training chain's prep",
                         frame_prep(state_s, cam, SH_DEGREE), WIDTH, HEIGHT)
            fused = preprocess_fused(state_s, cam)
            hold_binning(f"phase-4 model, view {i}, K6's prep", fused.prep, WIDTH, HEIGHT,
                         fused.conics)
    gts = [torch.rand(3, HEIGHT, WIDTH, device=device,
                      generator=torch.Generator(device=device).manual_seed(seed))]
    hold_binning_paths(f"phase-4 model {WIDTH}x{HEIGHT}", state_s, views[:2], gts, device)
    with torch.inference_mode():
        fused = preprocess_fused(state_s, views[0])
    time_binning(f"phase-4 model {WIDTH}x{HEIGHT}", fused.prep, WIDTH, HEIGHT, fused.conics,
                 card)

    garden = garden_scale_state(seed, device)
    gcams = [c.params(device) for c in bench_cameras(3, GARDEN_WIDTH, GARDEN_HEIGHT)]
    with torch.inference_mode():
        for i, cam in enumerate(gcams):
            fused = preprocess_fused(garden, cam)
            hold_binning(f"garden-scale state, view {i}, K6's prep", fused.prep,
                         GARDEN_WIDTH, GARDEN_HEIGHT, fused.conics)
        hold_binning("garden-scale state, view 0, the training chain's prep",
                     frame_prep(garden, gcams[0], SH_DEGREE), GARDEN_WIDTH, GARDEN_HEIGHT)
    ggts = [torch.rand(3, GARDEN_HEIGHT, GARDEN_WIDTH, device=device,
                       generator=torch.Generator(device=device).manual_seed(seed))]
    hold_binning_paths(f"garden-scale state {GARDEN_WIDTH}x{GARDEN_HEIGHT}", garden,
                       gcams[:2], ggts, device)
    with torch.inference_mode():
        fused = preprocess_fused(garden, gcams[0])
    k7_ms, plain_ms, bound_ms = time_binning(
        f"garden-scale state {GARDEN_WIDTH}x{GARDEN_HEIGHT}", fused.prep, GARDEN_WIDTH,
        GARDEN_HEIGHT, fused.conics, card)
    del garden, fused
    torch.cuda.empty_cache()
    return (k7_ms, plain_ms, None), (bound_ms, "bytes")


def counted_train(argv, after_step):
    """gaussmart_tpu_torch.train.main(argv), counted, with its step makers
    wrapped (one device or slots) so that after_step(args, outputs) sees
    every step: (state, adam, launch counts, wall seconds)."""
    from gaussmart_tpu_torch import train
    makers = {name: getattr(train, name) for name in
              ("make_train_step", "make_dp_train_step", "make_mp_train_step")}

    def recording(make):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                out_ = step(*args)
                after_step(args, out_)
                return out_
            return run
        return wrapped

    zero_counts()
    for name, make in makers.items():
        setattr(train, name, recording(make))
    t0 = time.perf_counter()
    try:
        state, adam = train.main(argv)
    finally:
        for name, make in makers.items():
            setattr(train, name, make)
    counts = read_counts()
    return state, adam, counts, time.perf_counter() - t0


def train_cli(src, out, iters, device, losses, extra=(), dinos=None):
    """train.main on `src` with the shortened schedule, counted, with every
    step's total loss appended to `losses` (the CLI logs only every 10th),
    and its DINO term to `dinos` when given."""
    def after(args, out_):
        losses.append(float(out_[3].total))
        if dinos is not None:
            dinos.append(float(out_[3].dino))

    argv = ["-s", src, "-m", out, "--iterations", str(iters),
            "--densify_from_iter", "5", "--densification_interval", "10",
            "--dino_mode", "off", "--no_tensorboard", "--quiet",
            "--device", str(device), *extra]
    return counted_train(argv, after)


def csv_iterations(path):
    with open(path) as f:
        return [int(r["iteration"]) for r in csv.DictReader(f)]


def train_path(root, seed, n, width, height, device):
    """The training slice's main path: train, then resume."""
    src, out = os.path.join(root, "train_scene"), os.path.join(root, "trained")
    t0 = time.perf_counter()
    write_train_scene(src, seed, n, width, height)
    print(f"[train] scene: {n} points, {TRAIN_VIEWS} views at {width}x{height} "
          f"with random targets, written in {time.perf_counter() - t0:.1f} s")
    it = str(TRAIN_ITERS)
    losses = []
    state, adam, counts, secs = train_cli(
        src, out, TRAIN_ITERS, device, losses,
        ["--test_iterations", it, "--save_iterations", it,
         "--checkpoint_iterations", it])
    densified = sum(1 for i in range(1, TRAIN_ITERS + 1) if i > 5 and i % 10 == 0)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    files = [f"point_cloud/iteration_{it}/point_cloud.ply", f"chkpnt{it}.npz",
             f"chkpnt{it}.npz.json", f"eval_{it}.json", "dino_loss_log.csv",
             "train_stats.csv", "input.ply", "cameras.json", "cfg_args.json"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    with open(os.path.join(out, f"eval_{it}.json")) as f:
        ev = json.load(f)
    print(f"[train] train.main, {TRAIN_ITERS} iterations in {secs:.2f} s: launches "
          f"{counts}; loss first 5 {first:.5f}, last 5 {last:.5f}; splats "
          f"{int(state.n_active)} of capacity {state.capacity}; Adam steps "
          f"{int(adam.step)}; eval {ev}; missing outputs {missing}")
    if not (only(counts, raster_fwd=TRAIN_ITERS + EVAL_RENDERS, raster_bwd=TRAIN_ITERS,
                 segsum=TRAIN_ITERS, preprocess_fwd=EVAL_RENDERS)
            and int(adam.step) == TRAIN_ITERS - densified
            and np.all(np.isfinite(losses)) and len(losses) == TRAIN_ITERS
            and last < first and not missing
            and csv_iterations(os.path.join(out, "train_stats.csv")) == [10, 20, 30]):
        fail("[train] check failed")

    resumed = []
    state, adam, rcounts, secs = train_cli(
        src, out, TRAIN_ITERS + RESUME_ITERS, device, resumed,
        ["--test_iterations", "0", "--start_checkpoint",
         os.path.join(out, f"chkpnt{it}.npz")])
    end = TRAIN_ITERS + RESUME_ITERS
    logged = csv_iterations(os.path.join(out, "dino_loss_log.csv"))
    print(f"[train] resumed from chkpnt{it}.npz for {RESUME_ITERS} iterations in "
          f"{secs:.2f} s: launches {rcounts}; losses {resumed}; Adam steps "
          f"{int(adam.step)}; logged iterations {logged}")
    if not (only(rcounts, raster_fwd=RESUME_ITERS, raster_bwd=RESUME_ITERS,
                 segsum=RESUME_ITERS)
            and int(adam.step) == TRAIN_ITERS - densified + RESUME_ITERS
            and logged == [end] and np.all(np.isfinite(resumed))
            and os.path.exists(os.path.join(out, "point_cloud", f"iteration_{end}",
                                            "point_cloud.ply"))):
        fail("[train] resume check failed")
    return counts, losses


def train_slots_path(root, device, single_losses):
    """The multi-device training paths on the phase-5 scene: train.main
    --n_devices N_SLOTS --parallel_mode mp on the single-device run's
    schedule (every frame 2 passes of N_SLOTS strata through K3 and K4;
    densify, sharded eval, save and checkpoint from the gathered state),
    its resume, and DP_ITERS camera data-parallel iterations."""
    src, out = os.path.join(root, "train_scene"), os.path.join(root, "trained_mp")
    it = str(TRAIN_ITERS)
    slots = ["--n_devices", str(N_SLOTS)]
    per_frame = 2 * N_SLOTS
    losses = []
    state, adam, counts, secs = train_cli(
        src, out, TRAIN_ITERS, device, losses,
        slots + ["--parallel_mode", "mp", "--test_iterations", it, "--save_iterations",
                 it, "--checkpoint_iterations", it])
    densified = sum(1 for i in range(1, TRAIN_ITERS + 1) if i > 5 and i % 10 == 0)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    files = [f"point_cloud/iteration_{it}/point_cloud.ply", f"chkpnt{it}.npz",
             f"eval_{it}.json", "dino_loss_log.csv", "train_stats.csv"]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    with open(os.path.join(out, f"eval_{it}.json")) as f:
        ev = json.load(f)
    print(f"[train] train.main --n_devices {N_SLOTS} --parallel_mode mp, {TRAIN_ITERS} "
          f"iterations in {secs:.2f} s: launches {counts}; loss first 5 {first:.5f}, "
          f"last 5 {last:.5f}; the first step's loss {losses[0]:.6f} (single-device "
          f"{single_losses[0]:.6f}); splats {int(state.n_active)} of capacity "
          f"{state.capacity}; Adam steps {int(adam.step)}; eval {ev}; missing "
          f"outputs {missing}")
    if not (only(counts, raster_fwd_seeded=per_frame * (TRAIN_ITERS + EVAL_RENDERS),
                 raster_bwd_seeded=per_frame * TRAIN_ITERS, segsum=per_frame * TRAIN_ITERS)
            and int(adam.step) == TRAIN_ITERS - densified
            and np.all(np.isfinite(losses)) and len(losses) == TRAIN_ITERS
            and last < first and not missing and state.capacity % N_SLOTS == 0
            and abs(losses[0] - single_losses[0]) <= 1e-3 * single_losses[0]):
        fail("[train] Gaussian-sharded check failed")

    resumed = []
    state, adam, rcounts, secs = train_cli(
        src, out, TRAIN_ITERS + RESUME_ITERS, device, resumed,
        slots + ["--parallel_mode", "mp", "--test_iterations", "0", "--start_checkpoint",
                 os.path.join(out, f"chkpnt{it}.npz")])
    end = TRAIN_ITERS + RESUME_ITERS
    print(f"[train] Gaussian-sharded resume from chkpnt{it}.npz for {RESUME_ITERS} "
          f"iterations in {secs:.2f} s: launches {rcounts}; losses {resumed}; Adam "
          f"steps {int(adam.step)}")
    if not (only(rcounts, raster_fwd_seeded=per_frame * RESUME_ITERS,
                 raster_bwd_seeded=per_frame * RESUME_ITERS, segsum=per_frame * RESUME_ITERS)
            and int(adam.step) == TRAIN_ITERS - densified + RESUME_ITERS
            and np.all(np.isfinite(resumed))
            and os.path.exists(os.path.join(out, "point_cloud", f"iteration_{end}",
                                            "point_cloud.ply"))):
        fail("[train] Gaussian-sharded resume check failed")

    dp_losses = []
    _, adam, dcounts, secs = train_cli(src, os.path.join(root, "trained_dp"), DP_ITERS,
                                       device, dp_losses, slots + ["--test_iterations", "0"])
    print(f"[train] train.main --n_devices {N_SLOTS} (camera data-parallel), {DP_ITERS} "
          f"iterations of {N_SLOTS} views in {secs:.2f} s: launches {dcounts}; losses "
          f"{dp_losses}; Adam steps {int(adam.step)}")
    if not (only(dcounts, raster_fwd=N_SLOTS * DP_ITERS, raster_bwd=N_SLOTS * DP_ITERS,
                 segsum=N_SLOTS * DP_ITERS)
            and int(adam.step) == DP_ITERS and len(dp_losses) == DP_ITERS
            and np.all(np.isfinite(dp_losses))):
        fail("[train] data-parallel check failed")
    return counts


# --- the DINO term and the viewer (phase 8) ---------------------------------

@contextlib.contextmanager
def dino_weights(path):
    """GAUSSMART_DINO_WEIGHTS=`path` inside the block (create() reads it)."""
    from gaussmart_tpu_torch.semantics.dino import WEIGHT_ENV
    os.environ[WEIGHT_ENV] = path
    try:
        yield
    finally:
        del os.environ[WEIGHT_ENV]


def write_dino_weights(root, seed):
    """A DINOv3 ViT-B/16 npz in the layout create() reads, at the published
    widths of facebook/dinov3-vitb16-pretrain-lvd1689m: random_params from
    the seed, LayerScale drawn in [0.5, 1.5] so that its path counts."""
    from gaussmart_tpu_torch.semantics.dino import random_params
    t0 = time.perf_counter()
    params = random_params(depth=DINO_DEPTH, dim=DINO_DIM, patch=16, seed=seed,
                           n_registers=DINO_REGISTERS)
    rng = np.random.default_rng(seed + 1)
    for i in range(DINO_DEPTH):
        for j in (1, 2):
            params[f"blocks.{i}.ls{j}"] = rng.uniform(0.5, 1.5, DINO_DIM).astype(np.float32)
    params.update(meta_patch=np.int32(16), meta_n_heads=np.int32(DINO_HEADS),
                  meta_image_size=np.int32(DINO_SIZE))
    path = os.path.join(root, "dino_vitb16.npz")
    np.savez(path, **params)
    n = sum(v.size for k, v in params.items() if not k.startswith("meta_"))
    print(f"[dino] DINOv3 ViT-B/16 weights: {DINO_DEPTH} layers, width {DINO_DIM}, "
          f"{DINO_HEADS} heads, MLP {4 * DINO_DIM}, {DINO_REGISTERS} registers, RoPE "
          f"theta 100, input {DINO_SIZE}; {n} random parameters from seed {seed}, "
          f"written in {time.perf_counter() - t0:.1f} s")
    return path


def tower_flops(enc, height, width):
    """(resize, dense, attention) float32 multiply-add FLOPs of one forward
    of `enc` on a [3, height, width] image, counted from the widths: the
    two resize products, the patch embedding and each layer's qkv,
    projection and MLP products, and its two attention products. The
    elementwise work (norms, GELU, softmax) is left out."""
    S, p, L = enc.image_size, enc.patch, enc.n_layers
    D = enc.params["cls_token"].shape[0]
    N = enc.n_prefix + (S // p) ** 2
    resize = 2 * 3 * height * width * S + 2 * 3 * S * height * S
    dense = 2 * (S // p) ** 2 * 3 * p * p * D + L * (2 * N * D * 3 * D + 2 * N * D * D
                                                      + 2 * 2 * N * D * 4 * D)
    return resize, dense, L * 2 * 2 * N * N * D


def fixed_term_flops(enc, height, width):
    """The fixed DINO term: the render's and the target's forwards, and the
    backward to the render (no weight gradients: each product's input
    gradient costs its forward again, attention's two products twice)."""
    resize, dense, attention = tower_flops(enc, height, width)
    return 2 * (resize + dense + attention) + resize + dense + 2 * attention


def dino_tower(path, image, gt, device):
    """create() through GAUSSMART_DINO_WEIGHTS, on the card and a CPU copy:
    every token of a 776x584 render, and the fixed term with its gradient
    with respect to the render (target: another render)."""
    import copy
    import torch
    from gaussmart_tpu_torch.losses import dino_term
    from gaussmart_tpu_torch.semantics.dino import DinoEncoder
    with dino_weights(path):
        cpu = DinoEncoder.create()
    card = copy.deepcopy(cpu).to(device)
    with torch.no_grad():
        tokens = card.tokens(image)
        ref = cpu.tokens(image.cpu())
    tok_err = (tokens.cpu() - ref).abs().max().item()

    def term_and_grad(enc, img, target):
        x = img.detach().clone().requires_grad_()
        term = dino_term(x, target, enc, DINO_LAMBDA, mode="fixed")
        term.backward()
        return term.item(), x.grad.cpu()
    term, grad = term_and_grad(card, image, gt)
    term_ref, grad_ref = term_and_grad(cpu, image.cpu(), gt.cpu())
    scale = grad_ref.abs().max().item()
    grad_err = (grad - grad_ref).abs().max().item() / scale
    shape = (cpu.n_prefix + (DINO_SIZE // 16) ** 2, DINO_DIM)
    print(f"[dino] create() on {device} and a CPU copy: tokens {tuple(tokens.shape)} of a "
          f"{image.shape[2]}x{image.shape[1]} render, max|card - CPU| {tok_err:.3g} (limit "
          f"{DINO_TOKEN_TOL}, max |token| {ref.abs().max().item():.4f}); fixed term "
          f"(lambda {DINO_LAMBDA}) {term:.8f} on the card, {term_ref:.8f} on the CPU; its "
          f"gradient with respect to the render: max|card - CPU| / max|CPU| {grad_err:.3g} "
          f"(limit {DINO_GRAD_TOL}; max|CPU| {scale:.4g})")
    if not (tuple(tokens.shape) == shape == tuple(ref.shape) and tok_err <= DINO_TOKEN_TOL
            and grad_err <= DINO_GRAD_TOL and scale > 0 and np.isfinite(term)
            and abs(term - term_ref) <= 1e-4 * max(abs(term_ref), 1e-12)):
        fail("[dino] the card's tower disagrees with the CPU copy")
    return card, cpu


def heatmap_cli(root, path, image, card, cpu, device):
    """python -m gaussmart_tpu_torch.semantics.visualize on a 776x584 render
    saved as PNG, with the phase-8 weights, on the card: an RGB PNG of the
    render's size, the overlay of the card's heatmap; that heatmap against
    the CPU copy's."""
    from gaussmart_tpu_torch.io.images import read_png, write_png
    from gaussmart_tpu_torch.semantics import visualize
    src, out = os.path.join(root, "render.png"), os.path.join(root, "heatmap.png")
    write_png(src, (image.clamp(0, 1).permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8))
    t0 = time.perf_counter()
    with dino_weights(path):
        visualize.main(["-i", src, "-o", out, "--device", str(device)])
    secs = time.perf_counter() - t0
    rgb = visualize.read_rgb(src)
    heat = visualize.cls_patch_heatmap(card, rgb.transpose(2, 0, 1))
    err = float(np.abs(heat - visualize.cls_patch_heatmap(cpu, rgb.transpose(2, 0, 1))).max())
    want = np.clip(visualize.overlay_heatmap(rgb, heat) * 255, 0, 255).astype(np.uint8)
    got = read_png(out)
    same = got.shape == want.shape and bool((got == want).all())
    print(f"[dino] semantics.visualize CLI on the card, {rgb.shape[1]}x{rgb.shape[0]} render "
          f"in {secs:.2f} s: wrote {got.shape} {got.dtype}, equal to the overlay of the "
          f"card's heatmap {same}; heatmap {heat.shape} card vs CPU max|diff| {err:.3g} "
          f"(limit {DINO_TOKEN_TOL})")
    if not (same and heat.shape == (DINO_SIZE // 16,) * 2 and err <= DINO_TOKEN_TOL):
        fail("[dino] heatmap CLI check failed")


def dino_training(root, path, device):
    """The training paths with the term on: train.main on the phase-5 scene
    for DINO_ITERS iterations gated at DINO_GATE, then DINO_SLOT_ITERS
    Gaussian-sharded and DINO_SLOT_ITERS camera data-parallel iterations
    with the term from the first (K1/K2/K5 and K3/K4 as in phase 5)."""
    src = os.path.join(root, "train_scene")
    out = os.path.join(root, "trained_dino")
    losses, dinos = [], []
    dino = ["--dino_mode", "fixed", "--test_iterations", "0"]
    with dino_weights(path):
        _, _, counts, secs = train_cli(src, out, DINO_ITERS, device, losses,
                                       dino + ["--dino_start_iter", str(DINO_GATE)], dinos)
    with open(os.path.join(out, "dino_loss_log.csv")) as f:
        column = {int(r["iteration"]): float(r["dino_loss"]) for r in csv.DictReader(f)}
    print(f"[dino] train.main --dino_mode fixed --dino_start_iter {DINO_GATE}, {DINO_ITERS} "
          f"iterations in {secs:.2f} s: launches {counts}; dino term per step "
          f"{[round(d, 8) for d in dinos]}; dino_loss_log.csv {column}")
    gated, on = dinos[:DINO_GATE], dinos[DINO_GATE:]
    if not (only(counts, raster_fwd=DINO_ITERS, raster_bwd=DINO_ITERS, segsum=DINO_ITERS)
            and len(dinos) == DINO_ITERS and all(d == 0.0 for d in gated)
            and all(np.isfinite(d) and d > 0 for d in on) and np.all(np.isfinite(losses))
            and column.get(DINO_GATE) == 0.0 and column.get(DINO_ITERS, 0.0) > 0):
        fail("[dino] the gated term check failed")

    slots = ["--n_devices", str(N_SLOTS), "--dino_start_iter", "0"] + dino
    per_frame = 2 * N_SLOTS
    for mode, want in (("mp", dict(raster_fwd_seeded=per_frame * DINO_SLOT_ITERS,
                                   raster_bwd_seeded=per_frame * DINO_SLOT_ITERS,
                                   segsum=per_frame * DINO_SLOT_ITERS)),
                       ("dp", dict(raster_fwd=N_SLOTS * DINO_SLOT_ITERS,
                                   raster_bwd=N_SLOTS * DINO_SLOT_ITERS,
                                   segsum=N_SLOTS * DINO_SLOT_ITERS))):
        losses, dinos = [], []
        with dino_weights(path):
            _, _, counts, secs = train_cli(
                src, os.path.join(root, f"trained_dino_{mode}"), DINO_SLOT_ITERS, device,
                losses, slots + ["--parallel_mode", mode], dinos)
        print(f"[dino] train.main --n_devices {N_SLOTS} --parallel_mode {mode} with the "
              f"term, {DINO_SLOT_ITERS} iterations in {secs:.2f} s: launches {counts}; "
              f"dino term per step {dinos}; losses {losses}")
        if not (only(counts, **want) and len(dinos) == DINO_SLOT_ITERS
                and all(np.isfinite(d) and d > 0 for d in dinos)
                and np.all(np.isfinite(losses))):
            fail(f"[dino] the {mode} check failed")


@contextlib.contextmanager
def connected_viewer(module, requests):
    """module.NetworkGUI (train's or viewer.serve's) replaced by one that,
    once listening, starts a ViewerClient for `requests` and waits for its
    connection (a deadline, not a race); yields the list that receives the
    client, joined at the end."""
    from gaussmart_tpu_torch.viewer.client import ViewerClient
    original = module.NetworkGUI
    clients = []

    class Connected(original):
        def init(self, host, port):
            super().init(host, port)
            client = ViewerClient(self.listener.getsockname()[1], requests)
            clients.append(client)
            client.start()
            if not client.connected.wait(60) or client.error is not None:
                fail(f"[viewer] the client did not connect: {client.error}")

    module.NetworkGUI = Connected
    try:
        yield clients
    finally:
        module.NetworkGUI = original
        for client in clients:
            client.join(120)
            if client.is_alive():
                fail("[viewer] the client did not finish")


def viewer_path(model, state, cam, device):
    """python -m gaussmart_tpu_torch.viewer.serve on the phase-4 model
    directory, counted, answering VIEWER_ROUNDS requests of each render
    item at the model's first camera (776x584); each frame against
    image_to_bytes(render_net_image(...)) of an in-memory render of the
    same splats; K1 once per frame. Returns the round trip per frame of
    each item in ms (median over the rounds after the first)."""
    import torch
    from gaussmart_tpu_torch.cameras import MiniCam
    from gaussmart_tpu_torch.config import ModelParams
    from gaussmart_tpu_torch.render.api import render
    from gaussmart_tpu_torch.viewer import serve
    from gaussmart_tpu_torch.viewer.client import camera_request
    from gaussmart_tpu_torch.viewer.protocol import image_to_bytes, render_net_image
    items = ModelParams().render_items
    requests = [camera_request(cam, m) for _ in range(VIEWER_ROUNDS)
                for m in range(len(items))]
    zero_counts()
    t0 = time.perf_counter()
    with connected_viewer(serve, requests) as clients:
        serve.main(["-m", model, "--port", "0", "--device", str(device),
                    "--max_frames", str(len(requests))])
    counts = read_counts()
    secs = time.perf_counter() - t0
    client = clients[0]
    mini = MiniCam(cam.width, cam.height, cam.fovy, cam.fovx, cam.znear, cam.zfar,
                   cam.world_view, cam.full_proj)
    errs = {}
    with torch.inference_mode():
        pkg = render(mini.params(device), state, torch.zeros(3, device=device))
        for m, item in enumerate(items):
            ref = np.frombuffer(image_to_bytes(render_net_image(pkg, items, m, mini)),
                                np.uint8).astype(np.int16)
            errs[item] = max(int(np.abs(np.frombuffer(f[0], np.uint8) - ref).max())
                             for f in client.frames[m::len(items)])
    ms = {item: float(np.median(client.seconds[len(items) + m::len(items)])) * 1e3
          for m, item in enumerate(items)}
    print(f"[viewer] viewer.serve on the {int(state.n_active)}-splat model, "
          f"{len(client.frames)} requests ({VIEWER_ROUNDS} of each of {items}) at "
          f"{cam.width}x{cam.height} in {secs:.2f} s: launches {counts}; frames vs "
          f"image_to_bytes(render_net_image(...)) of an in-memory render max|diff| (8-bit "
          f"levels) {errs} (limit {PNG_TOL}); metrics {client.frames[0][2]}")
    if not (client.error is None and client.items == items
            and len(client.frames) == len(requests)
            and all(len(f[0]) == cam.width * cam.height * 3 for f in client.frames)
            and only(counts, raster_fwd=len(requests), preprocess_fwd=len(requests))
            and max(errs.values()) <= PNG_TOL):
        fail("[viewer] check failed")
    return ms


def gui_training(root, device):
    """train.main --gui on the phase-5 scene, counted, with a client
    connected before the first iteration that asks for GUI_FRAMES frames
    (RGB, Depth, Normal at the scene's first camera), each time asking to
    train on, then leaves: one K1 per frame beside the steps'."""
    from gaussmart_tpu_torch import train
    from gaussmart_tpu_torch.viewer.client import camera_request
    cam = bench_cameras(TRAIN_VIEWS, WIDTH, HEIGHT)[0]
    requests = [camera_request(cam, m, train=True) for m in (0, 3, 2)][:GUI_FRAMES]
    losses = []
    with connected_viewer(train, requests) as clients:
        _, _, counts, secs = train_cli(
            os.path.join(root, "train_scene"), os.path.join(root, "trained_gui"),
            GUI_ITERS, device, losses, ["--gui", "--port", "0", "--test_iterations", "0"])
    client = clients[0]
    print(f"[viewer] train.main --gui, {GUI_ITERS} iterations in {secs:.2f} s: launches "
          f"{counts}; the client received {len(client.frames)} frames of "
          f"{[len(f[0]) for f in client.frames]} bytes, round trips "
          f"{[round(t * 1e3, 2) for t in client.seconds]} ms; metrics "
          f"{[f[2] for f in client.frames]}")
    if not (client.error is None and len(client.frames) == GUI_FRAMES
            and all(len(f[0]) == WIDTH * HEIGHT * 3 and len(set(f[0])) > 1
                    for f in client.frames)
            and only(counts, raster_fwd=GUI_ITERS + GUI_FRAMES, raster_bwd=GUI_ITERS,
                     segsum=GUI_ITERS, preprocess_fwd=GUI_FRAMES)
            and len(losses) == GUI_ITERS and np.all(np.isfinite(losses))):
        fail("[viewer] train --gui check failed")


def dino_determinism(path, state, cams, gts, device):
    """[determinism] with the term: two backwards of the training step past
    the gate (train._build_dino_fn's term, the phase-8 tower)."""
    from gaussmart_tpu_torch import train
    from gaussmart_tpu_torch.config import OptimizationParams
    from gaussmart_tpu_torch.optim import init_adam
    from gaussmart_tpu_torch.train_lib import make_train_step
    with dino_weights(path):
        dino_fn = train._build_dino_fn(DINO_LAMBDA, DINO_GATE, "fixed", device)
    step = make_train_step(OptimizationParams(), backend="auto", dino_fn=dino_fn,
                           sh_degree=SH_DEGREE, white_background=False, spatial_lr_scale=1.0)
    hold_determinism({"training step with the DINO term past its gate": (
        step, (state.params, init_adam(state.params), state.aux, cams[1], gts[1],
               DINO_GATE + 1))})
    return dino_fn


def dino_viewer_path(root, seed, model, cams, state_s, state_t, cams_t, gts_t, device):
    """Phase 8's checks, on the phase-4 model directory and the phase-5
    training scene (both under `root`): the tower on the card against a
    CPU copy, the heatmap CLI, [determinism] with the term, training with
    the term in the three steps, the viewer CLI and train --gui. Returns what
    time_dino_viewer times: (the card's encoder, two renders of the model,
    the term's dino_fn, the viewer's round trips)."""
    import torch
    from gaussmart_tpu_torch.render.api import render
    path = write_dino_weights(root, seed)
    with torch.no_grad():
        views = [render(cams[i].params(device), state_s,
                        torch.zeros(3, device=device))["render"] for i in (0, 1)]
    encoder, cpu_encoder = dino_tower(path, views[0], views[1], device)
    heatmap_cli(root, path, views[0], encoder, cpu_encoder, device)
    dino_fn = dino_determinism(path, state_t, cams_t, gts_t, device)
    dino_training(root, path, device)
    viewer_ms = viewer_path(model, state_s, cams[0], device)
    gui_training(root, device)
    return encoder, views, dino_fn, viewer_ms


def time_dino_viewer(enc, views, dino_fn, viewer_ms, state, cams, gts, card):
    """The tower's forward and the fixed term's forwards plus backward on a
    776x584 render (target: a second render; CUDA events, median of
    FRAMES; device time and launches from torch.profiler) against their
    float32 FLOP bounds; the training step without and with the term
    (past its gate), in turns; the viewer's round trips."""
    import torch
    from gaussmart_tpu_torch.losses import dino_term
    image, gt = views
    x = image.detach().clone().requires_grad_()

    def forward():
        with torch.no_grad():
            enc.tokens(image)

    def fixed_term():
        dino_term(x, gt, enc, DINO_LAMBDA, mode="fixed").backward()

    height, width = image.shape[1:]
    for label, fn, flops in (
            ("tower forward", forward, sum(tower_flops(enc, height, width))),
            ("fixed term: two forwards + the backward to the render", fixed_term,
             fixed_term_flops(enc, height, width))):
        ms = time_ms(fn, FRAMES)
        kernel_ms, top = device_kernel_ms(fn, FRAMES)
        launches = sum(c for _, _, c in top)
        bound = flops / PEAK_F32_FLOPS * 1e3
        print(f"[time] {card}: DINO ViT-B/16 {label}, {width}x{height} -> {DINO_SIZE}, "
              f"median of {FRAMES}: {ms:.4f} ms; {flops / 1e9:.3f} GFLOP of float32 "
              f"products -> bound {bound:.4f} ms (operations, {PEAK_F32_FLOPS / 1e12:g} "
              f"TFLOP/s) = {bound / ms:.3f} of it; {launches:g} launches per call")
        print_device(f"DINO {label}", kernel_ms, top, ms)
    ips = {}
    for what, fn in (("without the term", None), ("with the DINO term", dino_fn),
                     ("with the DINO term", dino_fn), ("without the term", None)):
        ips.setdefault(what, []).append(time_training(state, cams, gts, card, dino_fn=fn,
                                                      first_iter=DINO_GATE + 1))
    print(f"[time] {card}: training step past the DINO gate, in turns (off, on, on, off): "
          + "; ".join(f"{k} {', '.join(f'{1e3 / v:.4f}' for v in vs)} ms"
                      for k, vs in ips.items()))
    print(f"[time] {card}: viewer round trip per {WIDTH}x{HEIGHT} frame (request sent to "
          f"frame, verify string and metrics received; median of {VIEWER_ROUNDS - 1} after "
          "the first): " + "; ".join(f"{k} {v:.4f} ms" for k, v in viewer_ms.items()))


# --- the mesh and eval paths ---------------------------------------------------

def sphere_params(seed, n, sh_degree):
    """n surfels on the unit sphere at the origin, each tangent to it (its
    normal radial), both scales the mean spacing, opacity 0.99 and the
    constant colour MESH_GREY at SH degree `sh_degree`."""
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # the rotation taking +z to the normal: (1 + n_z, -n_y, n_x, 0) in (w,x,y,z)
    q = np.stack([1 + nrm[:, 2], -nrm[:, 1], nrm[:, 0], np.zeros(n)], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k = (sh_degree + 1) ** 2
    return {"xyz": nrm.astype(np.float32),
            "features_dc": np.full((n, 1, 3), rgb2sh(MESH_GREY), np.float32),
            "features_rest": np.zeros((n, k - 1, 3), np.float32),
            "scaling": np.full((n, 2), np.log(np.sqrt(4 * np.pi / n)), np.float32),
            "rotation": q.astype(np.float32),
            "opacity": np.full((n, 1), np.log(0.99 / 0.01), np.float32)}


def ring_cameras(n_views, width, height):
    """n_views cameras on a ring of radius MESH_RING in the xz plane, each
    looking at the origin with +y up. Views 0 and 8 are llffhold-8's test
    views; on an even ring view 8 would stand opposite view 0, and the
    bounding sphere of two opposite views (trajectory.focus_point_fn) is
    singular, so views 8 and 12 swap places."""
    from gaussmart_tpu_torch.cameras import Camera
    place = list(range(n_views))
    place[8], place[12] = place[12], place[8]
    cams = []
    for i in range(n_views):
        a = 2 * np.pi * place[i] / n_views
        back = np.array([np.cos(a), 0.0, np.sin(a)])
        c2w = np.eye(4)              # COLMAP axes: x right, y down, z forward
        c2w[:3, 2] = -back
        c2w[:3, 1] = [0.0, -1.0, 0.0]
        c2w[:3, 0] = np.cross(c2w[:3, 1], c2w[:3, 2])
        c2w[:3, 3] = MESH_RING * back
        w2c = np.linalg.inv(c2w)
        cams.append(Camera(uid=i, colmap_id=i, image_name=f"c{i:03d}", R=w2c[:3, :3].T,
                           T=w2c[:3, 3], fovx=FOVX, fovy=FOVY, width=width,
                           height=height))
    return cams


def write_sphere_model(root, seed, n, width, height, n_views):
    """The mesh phase's trained-model directory: a COLMAP source of
    ring_cameras with grey GT images, the sphere's surfels as the snapshot
    at point_cloud/iteration_ITERATION, cfg_args.json with eval on
    (llffhold 8: views 0 and 8 for testing)."""
    from gaussmart_tpu_torch.io.gaussian_ply import save_gaussian_ply
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy
    src, model = os.path.join(root, "sphere_scene"), os.path.join(root, "sphere_model")
    params = sphere_params(seed, n, SH_DEGREE)
    state = state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32),
                             SH_DEGREE, SH_DEGREE, 1.0, device="cpu")
    save_gaussian_ply(os.path.join(model, "point_cloud", f"iteration_{ITERATION}",
                                   "point_cloud.ply"), state)
    cams = ring_cameras(n_views, width, height)
    grey = np.full((height, width, 3), round(MESH_GREY * 255), np.uint8)
    pts = params["xyz"][:1000]
    write_colmap_source(src, cams, [grey] * n_views, pts, np.full((len(pts), 3), 153.0))
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump({"source_path": src, "model_path": model, "sh_degree": SH_DEGREE,
                   "images": "images", "resolution": 1, "white_background": False,
                   "eval": True, "backend": "auto"}, f, indent=2)
    return model


def mesh_cli(model, device, fwd, args=()):
    """render_cli on the sphere model, counted: the extractor, wall
    seconds; fails unless K1 launched `fwd` times and nothing else."""
    from gaussmart_tpu_torch import render_cli
    zero_counts()
    t0 = time.perf_counter()
    ex = render_cli.main(["-m", model, "--device", str(device),
                          "--depth_ratio", str(MESH_DEPTH_RATIO), *args])
    counts = read_counts()
    secs = time.perf_counter() - t0
    print(f"[mesh] render_cli --depth_ratio {MESH_DEPTH_RATIO} "
          f"{' '.join(args) or '(bounded, --mesh_res 1024)'}: "
          f"{secs:.2f} s; launches {counts} (expected raster_fwd {fwd})")
    if not only(counts, raster_fwd=fwd, preprocess_fwd=fwd):
        fail("[mesh] K1 and K6 launch count check failed")
    return ex, secs


def hold_sphere(model, name, voxel):
    """Load <name>.ply and <name>_post.ply; the post-processed vertices'
    distance to the unit sphere against `voxel` (mean <= 1, 99th
    percentile <= 3) and their mean colour against MESH_GREY."""
    from gaussmart_tpu_torch.mesh.meshing import load_mesh_ply
    out = os.path.join(model, "train", f"ours_{ITERATION}")
    raw = load_mesh_ply(os.path.join(out, f"{name}.ply"))
    post = load_mesh_ply(os.path.join(out, f"{name}_post.ply"))
    err = np.abs(np.linalg.norm(post.vertices, axis=1) - 1.0)
    colour = float(post.vertex_colors.mean()) if post.vertex_colors is not None else np.nan
    mean, p99 = float(err.mean()) if len(err) else np.inf, \
        float(np.percentile(err, 99)) if len(err) else np.inf
    print(f"[mesh] {name}.ply {len(raw.vertices)} vertices, {len(raw.faces)} faces; "
          f"{name}_post.ply {len(post.vertices)} vertices, {len(post.faces)} faces; "
          f"| |v| - 1 | mean {mean:.6f}, 99th percentile {p99:.6f} (voxel {voxel:.6f}: "
          f"limits 1 and 3 voxels); mean vertex colour {colour:.4f} (splats "
          f"{MESH_GREY}, limit {COLOUR_TOL})")
    if not (len(raw.faces) > 0 and len(post.faces) > 0 and np.isfinite(post.vertices).all()
            and mean <= voxel and p99 <= 3 * voxel and abs(colour - MESH_GREY) <= COLOUR_TOL):
        fail(f"[mesh] {name} check failed")


def tsdf_card_vs_cpu(ex, voxel, sdf_trunc, depth_trunc, device, n=4):
    """The card's TSDFVolume after the run's first n depth maps against the
    same update on a CPU copy, every field within TSDF_TOL."""
    import torch
    from gaussmart_tpu_torch.mesh.tsdf import TSDFVolume
    lo, hi = ex._observed_bounds(depth_trunc, sdf_trunc, True)
    vols = [TSDFVolume(lo, hi, voxel, sdf_trunc, device=d) for d in (device, "cpu")]
    for cam, rgb, depth in list(zip(ex.viewpoint_stack, ex.rgbmaps, ex.depthmaps))[:n]:
        for v in vols:
            d = ex._masked_depth(cam, depth, True).to(v.device)
            v.integrate(d, torch.clamp(rgb, 0, 1).to(v.device), cam.params(v.device),
                        depth_trunc)
    errs = {k: (getattr(vols[0], k).cpu() - getattr(vols[1], k)).abs().max().item()
            for k in ("tsdf", "weight", "color")}
    print(f"[mesh] TSDFVolume {vols[0].dims} = {vols[0]._n} voxels after {n} views: card "
          f"vs CPU copy max|diff| " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" (limit {TSDF_TOL}); observed voxels {int((vols[0].weight > 0).sum())}")
    if max(errs.values()) > TSDF_TOL:
        fail("[mesh] TSDF card vs CPU check failed")
    return lo, hi


def eval_cli(model, root, device):
    """metrics_cli on the sphere model: without weights (LPIPS null, PSNR
    finite), then with random VGG weights named by GAUSSMART_LPIPS_WEIGHTS,
    its LPIPS held against the same scorer on the CPU. Returns the two
    wall times and the weight file."""
    import torch
    from gaussmart_tpu_torch.eval import lpips as lp
    from gaussmart_tpu_torch.eval import metrics_cli
    env = os.environ.get(lp.WEIGHT_ENV)
    try:
        os.environ[lp.WEIGHT_ENV] = os.path.join(root, "no_such_{net}.npz")
        t0 = time.perf_counter()
        res = metrics_cli.main(["-m", model, "--device", str(device)])
        plain_s = time.perf_counter() - t0
        weights = os.path.join(root, "lpips_{net}.npz")
        params = lp.random_params("vgg")
        np.savez(weights.format(net="vgg"), **params)
        os.environ[lp.WEIGHT_ENV] = weights
        t0 = time.perf_counter()
        res_w = metrics_cli.main(["-m", model, "--device", str(device)])
        lpips_s = time.perf_counter() - t0
    finally:
        if env is None:
            os.environ.pop(lp.WEIGHT_ENV, None)
        else:
            os.environ[lp.WEIGHT_ENV] = env
    with open(os.path.join(model, "results.json")) as f:
        written = json.load(f)
    method = f"ours_{ITERATION}"
    m, mw = res[model][method], res_w[model][method]
    test_dir = os.path.join(model, "test", method)
    renders, gts, _ = metrics_cli.read_images(
        Path(test_dir) / "renders", Path(test_dir) / "gt")
    cpu = lp.LPIPS(params, "vgg", device="cpu")
    ref = float(np.mean([float(cpu(torch.from_numpy(r), torch.from_numpy(g))[0])
                         for r, g in zip(renders, gts)]))
    rel = abs(mw["LPIPS"] - ref) / abs(ref)
    print(f"[eval] metrics_cli on {len(renders)} test views: SSIM {m['SSIM']:.6f}, "
          f"PSNR {m['PSNR']:.4f}, LPIPS {m['LPIPS']} in {plain_s:.2f} s; with random VGG "
          f"weights LPIPS {mw['LPIPS']:.8f} (CPU {ref:.8f}, relative diff {rel:.3g}, limit "
          f"{LPIPS_RTOL}) in {lpips_s:.2f} s; results.json {sorted(written[method])}")
    if not (m["LPIPS"] is None and np.isfinite(m["PSNR"]) and np.isfinite(m["SSIM"])
            and len(renders) == 2 and written[method] == mw and rel <= LPIPS_RTOL):
        fail("[eval] metrics_cli check failed")
    return plain_s, lpips_s, params, renders[0], gts[0]


def mesh_path(root, seed, device):
    """Phase 7: render_cli's mesh export on the sphere model, bounded at
    the default --mesh_res and --unbounded at UNBOUNDED_RES, counted and
    checked; the TSDF on the card against a CPU copy; metrics_cli.
    Returns what the timings need."""
    t0 = time.perf_counter()
    model = write_sphere_model(root, seed, MESH_SPLATS, WIDTH, HEIGHT, MESH_VIEWS)
    n_test = len(range(0, MESH_VIEWS, 8))
    n_train = MESH_VIEWS - n_test
    print(f"[mesh] sphere model: {MESH_SPLATS} surfels on the unit sphere, SH "
          f"{SH_DEGREE}, grey {MESH_GREY}; {MESH_VIEWS} views at {WIDTH}x{HEIGHT} on a "
          f"ring of radius {MESH_RING} ({n_train} train, {n_test} test), written in "
          f"{time.perf_counter() - t0:.1f} s")
    ex, bounded_s = mesh_cli(model, device, 2 * n_train + n_test)
    depth_trunc = 2.0 * ex.radius
    voxel = depth_trunc / 1024
    hold_sphere(model, "fuse", voxel)
    lo_hi = tsdf_card_vs_cpu(ex, voxel, 5.0 * voxel, depth_trunc, device)
    _, unbounded_s = mesh_cli(model, device, n_train,
                              ("--unbounded", "--mesh_res", str(UNBOUNDED_RES),
                               "--skip_train", "--skip_test"))
    # the unbounded grid's spacing in world units: 2 R radius / resolution
    hold_unbounded(model, ex, UNBOUNDED_RES)
    evals = eval_cli(model, root, device)
    return ex, (depth_trunc, voxel, lo_hi), (bounded_s, unbounded_s), evals


def hold_unbounded(model, ex, res):
    """fuse_unbounded(_post).ply. The reference's unbounded fusion starts
    every sample at tsdf 1, weight 1, and updates only samples within its
    band (5 voxels) behind a surface, so the inside of a closed surface
    keeps tsdf 1 and the mesh holds a second shell one band inside the
    first (the JAX package's too): the outer shell is held to the sphere
    (mean <= 1 voxel, 99th percentile <= 3), the inner one is reported.
    Its colours start at black with weight 1, so they are reported, not
    held to the splats' colour."""
    from gaussmart_tpu_torch.mesh.meshing import load_mesh_ply
    voxel = 2 * ex.radius / res            # fuse_samples' voxel_size
    out = os.path.join(model, "train", f"ours_{ITERATION}")
    raw = load_mesh_ply(os.path.join(out, "fuse_unbounded.ply"))
    post = load_mesh_ply(os.path.join(out, "fuse_unbounded_post.ply"))
    r = np.linalg.norm(post.vertices, axis=1)
    outer = r > 1 - 2.5 * voxel
    err = np.abs(r[outer] - 1)
    mean = float(err.mean()) if outer.any() else np.inf
    p99 = float(np.percentile(err, 99)) if outer.any() else np.inf
    inner_r = float(np.median(r[~outer])) if (~outer).any() else np.nan
    print(f"[mesh] fuse_unbounded.ply {len(raw.vertices)} vertices, {len(raw.faces)} faces; "
          f"_post {len(post.vertices)} vertices, {len(post.faces)} faces; outer shell "
          f"{int(outer.sum())} vertices: | |v| - 1 | mean {mean:.6f}, 99th percentile "
          f"{p99:.6f} (voxel {voxel:.6f}: limits 1 and 3 voxels), mean colour "
          f"{post.vertex_colors[outer].mean():.4f}; inner shell {int((~outer).sum())} "
          f"vertices at median radius {inner_r:.4f} (1 - 5 voxels = {1 - 5 * voxel:.4f})")
    if not (len(raw.faces) > 0 and np.isfinite(post.vertices).all()
            and mean <= voxel and p99 <= 3 * voxel):
        fail("[mesh] fuse_unbounded check failed")


def time_mesh(ex, geo, walls, evals, card, device):
    """The TSDF stages on the card: integrate per view (CUDA events) on the
    bounded run's grid and at the voxel cap, with the byte bound; the int8
    pull, marching, welding and colour lookup (host clock); fuse_samples
    per 128^3 block; LPIPS(vgg) per pair; the CLIs' wall times."""
    import torch
    from gaussmart_tpu_torch.eval import lpips as lp
    from gaussmart_tpu_torch.mesh import tsdf
    from gaussmart_tpu_torch.mesh.marching import marching_tetrahedra
    from gaussmart_tpu_torch.mesh.meshing import TriMesh
    depth_trunc, voxel, (lo, hi) = geo
    views = [(ex._masked_depth(c, d, True), torch.clamp(rgb, 0, 1), c.params(device))
             for c, rgb, d in zip(ex.viewpoint_stack, ex.rgbmaps, ex.depthmaps)]
    h, w = views[0][0].shape
    map_bytes = 4 * 4 * h * w          # depth and rgb, float32

    def stages(label, vol):
        per_view = []
        for d, rgb, cam in views:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            vol.integrate(d, rgb, cam, depth_trunc)
            b.record()
            b.synchronize()
            per_view.append(a.elapsed_time(b))
        nbytes = vol._n * 40 + map_bytes
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        t0 = time.perf_counter()
        q = vol.quantized()
        pull_s = time.perf_counter() - t0
        grid = np.where(q == np.int8(-128), np.float32(np.nan),
                        q.astype(np.float32) / np.float32(127.0))
        t0 = time.perf_counter()
        v, f = marching_tetrahedra(grid, 0.0, (vol.voxel_size,) * 3, vol.origin)
        march_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = TriMesh(v, f).merge_vertices(digits=6)
        weld_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vol.sample_colors(mesh.vertices)
        colour_s = time.perf_counter() - t0
        print(f"[time] {card}: TSDF {label}: grid {vol.dims} = {vol._n} voxels, "
              f"{vol._n * 20} bytes of state, voxel {vol.voxel_size:.6f}; integrate per "
              f"view (CUDA events, {len(per_view)} views) median {np.median(per_view):.4f} "
              f"ms, min {min(per_view):.4f}, max {max(per_view):.4f}; byte bound "
              f"{bound:.4f} ms ({nbytes} bytes: 40 per voxel read and written + the maps, "
              f"at {PEAK_BYTES_PER_S / 1e12} TB/s) = {np.median(per_view) / bound:.1f}x; "
              f"int8 pull {pull_s:.4f} s, marching {march_s:.4f} s ({len(f)} triangles), "
              f"welding {weld_s:.4f} s ({len(mesh.vertices)} vertices), colour lookup "
              f"{colour_s:.4f} s")

    stages("bounded run's grid (--mesh_res 1024)", tsdf.TSDFVolume(
        lo, hi, voxel, 5 * voxel, device=device))
    cap_voxel = depth_trunc / CAP_MESH_RES
    lo_c, hi_c = ex._observed_bounds(depth_trunc, 5 * cap_voxel, True)
    stages(f"at the voxel cap (--mesh_res {CAP_MESH_RES}, the default "
           "GAUSSMART_TSDF_MAX_VOXELS)", tsdf.TSDFVolume(lo_c, hi_c, cap_voxel,
                                                           5 * cap_voxel, device=device))
    torch.cuda.empty_cache()
    # fuse_samples on one 128^3 block of the unbounded run's contracted grid
    depths = torch.stack([d[0] for d in ex.depthmaps])
    rgbs = torch.stack([torch.clamp(r, 0, 1) for r in ex.rgbmaps])
    projs = torch.stack([torch.as_tensor(c.full_proj, device=device)
                         for c in ex.viewpoint_stack])
    center, radius = np.asarray(ex.center, np.float32), float(ex.radius)
    axes = np.linspace(0.0, 0.26, 128)
    pts = np.stack(np.meshgrid(axes, axes, axes, indexing="ij"), -1).reshape(-1, 3)
    pts = pts.astype(np.float32)
    vs = 2 * radius / UNBOUNDED_RES
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        tsdf.fuse_samples(pts, depths, rgbs, projs, vs, center, radius)
        host.append((time.perf_counter() - t0) * 1e3)
    dev_pts = torch.as_tensor(pts, device=device)
    c_dev = torch.as_tensor(center, device=device)
    kernel = time_ms(lambda: tsdf._fuse_batch(dev_pts, depths, rgbs, projs, vs, c_dev,
                                              radius, True), 5)
    fuse_bytes = len(pts) * (12 + 16) + len(ex.depthmaps) * map_bytes
    print(f"[time] {card}: fuse_samples per 128^3 block ({len(pts)} samples, "
          f"{len(ex.depthmaps)} views): {np.median(host):.4f} ms through the function "
          f"(host clock, its copies included), {kernel:.4f} ms on the device (CUDA "
          f"events); byte bound {fuse_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms "
          f"({fuse_bytes} bytes: the samples in, tsdf and colour out, the maps once)")
    plain_s, lpips_s, params, r, g = evals
    scorer = lp.LPIPS(params, "vgg", device=device)
    rt, gt = (torch.as_tensor(x, device=device) for x in (r, g))
    lp_ms = time_ms(lambda: scorer(rt, gt), FRAMES)
    bounded_s, unbounded_s = walls
    print(f"[time] {card}: LPIPS(vgg) per {r.shape[2]}x{r.shape[1]} pair {lp_ms:.4f} ms "
          f"(CUDA events, median of {FRAMES}); wall: render_cli bounded {bounded_s:.2f} s, "
          f"--unbounded --mesh_res {UNBOUNDED_RES} {unbounded_s:.2f} s, metrics_cli "
          f"{plain_s:.2f} s (no weights), {lpips_s:.2f} s (VGG weights)")


# --- semantic preprocessing (phase 9) ----------------------------------------------

def dtu_scan_cameras(n_views, width, height):
    """DTU's layout cut to a grid: n_views cameras on a 7x7 grid of yaw and
    pitch around the cloud's centre (0, 0, 3.5), each 3.5 from it and
    looking at it (the middle one at the origin, as bench.py's camera 0)."""
    from gaussmart_tpu_torch.cameras import Camera, focal2fov
    side = int(round(np.sqrt(n_views)))
    focal = (width / 2) / np.tan(SEM_FOVX / 2)
    centre = np.array([0.0, 0.0, 3.5])
    cams = []
    for i in range(n_views):
        yaw = (i % side - (side - 1) / 2) * 0.08
        pitch = (i // side - (side - 1) / 2) * 0.06
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        c2w = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
               @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
        pos = centre - 3.5 * c2w[:, 2]
        cams.append(Camera(uid=i, colmap_id=i, image_name=f"{i:03d}", R=c2w,
                           T=-c2w.T @ pos, fovx=focal2fov(focal, width),
                           fovy=focal2fov(focal, height), width=width, height=height))
    return cams, focal


def region_colours(pts, rng):
    """One of 8 colours per octant of the cloud's box, with a little noise."""
    palette = np.array([[0.85, 0.2, 0.2], [0.2, 0.75, 0.25], [0.2, 0.3, 0.85],
                        [0.9, 0.8, 0.2], [0.8, 0.3, 0.8], [0.2, 0.8, 0.8],
                        [0.95, 0.55, 0.15], [0.5, 0.5, 0.5]])
    region = (pts[:, 0] > 0) + 2 * (pts[:, 1] > 0) + 4 * (pts[:, 2] > 3.5)
    return np.clip(palette[region] + rng.normal(0, 0.03, (len(pts), 3)), 0, 1)


def region_cloud(seed, n, device):
    """bench.py's cloud coloured by region as splats (SH 0, opacity 0.95,
    3-NN scales): (state, points, 8-bit colours)."""
    from gaussmart_tpu_torch.models.gaussians import mean_sq_dist_to_3nn, state_from_numpy
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(seed)
    pts, _ = bench_points(rng, n)
    cols = region_colours(pts, rng)
    q = rng.normal(size=(n, 4))
    params = {"xyz": pts, "features_dc": rgb2sh(cols[:, None, :]),
              "features_rest": np.zeros((n, 0, 3)),
              "scaling": np.log(np.sqrt(np.maximum(mean_sq_dist_to_3nn(pts), 1e-7)))[:, None]
              .repeat(2, axis=1),
              "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
              "opacity": np.full((n, 1), np.log(0.95 / 0.05))}
    state = state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32), 0, 0, 1.0,
                             device=device)
    return state, pts, np.round(cols * 255.0)


def render_views(state, cams, device):
    """K1 renders of `state` from each camera, as uint8 [H, W, 3] arrays."""
    import torch
    from gaussmart_tpu_torch.render.api import render
    bg = torch.zeros(3, device=device)
    with torch.inference_mode():
        for cam in cams:
            img = render(cam.params(device), state, bg)["render"]
            yield (img.clamp(0, 1).permute(1, 2, 0) * 255).round().to(torch.uint8).cpu().numpy()


def write_dtu_scan(scan, seed, n, width, height, n_views, device, cloud=None):
    """The phase-9 scan: cameras.npz in DTU's IDR format (world_mat_i the
    w2c extrinsic, camera_mat_i the intrinsics, scale_mat_i the identity),
    points.ply (bench.py's cloud, region colours; or `cloud`, a (state,
    points, 8-bit colours) triple), the views as K1 renders of that cloud
    (SH 0, opacity 0.95, 3-NN scales) and the same cameras as a COLMAP
    text model, so that the Scene loads the scan."""
    from gaussmart_tpu_torch.io.ply import store_point_cloud
    state, pts, rgb = cloud or region_cloud(seed, n, device)
    cams, focal = dtu_scan_cameras(n_views, width, height)
    write_colmap_source(str(scan), cams, render_views(state, cams, device), pts, rgb, level=1)
    K = np.eye(4)
    K[:3, :3] = [[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]]
    mats = {}
    for i, cam in enumerate(cams):
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = cam.R.T, cam.T
        mats.update({f"world_mat_{i}": w2c, f"camera_mat_{i}": K, f"scale_mat_{i}": np.eye(4)})
    np.savez(os.path.join(scan, "cameras.npz"), **mats)
    store_point_cloud(os.path.join(scan, "points.ply"), pts, rgb)


@contextlib.contextmanager
def wrapped(owner, name, after):
    """owner.name replaced by a call that runs it synchronised and timed,
    then calls after(args, result, seconds)."""
    import torch
    orig = getattr(owner, name)

    def call(*a, **kw):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        after(a, out, time.perf_counter() - t0)
        return out
    setattr(owner, name, call)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def pipeline_run(scan, out, device):
    """python -m gaussmart_tpu_torch.semantics.pipeline -s scan -o out -t dtu
    --clean (classical masks, as no SAM checkpoint is there) on `device`,
    in this process, with its stages timed and their results kept: the
    hull's keep mask, each view's k-means labels, and the projection's
    inputs and outputs."""
    from gaussmart_tpu_torch.semantics import hull, pipeline, sam_backend
    rec = {"times": {}, "labels": []}

    def stage(key, keep=None):
        def after(a, out_, dt):
            rec["times"][key] = rec["times"].get(key, 0.0) + dt
            if keep:
                keep(a, out_)
        return after

    def projected(a, out_):
        rec.update(points=a[0], masks=a[1], cameras=a[2], seg=out_[0], areas=out_[1])

    with contextlib.ExitStack() as stack:
        for owner, name, after in (
                (pipeline.Pipeline, "select_views",
                 stage("view selection", lambda a, o: rec.update(selected=o[0]))),
                (pipeline.Pipeline, "run_segmentation", stage("segmentation")),
                (sam_backend.ClassicalSegmenter, "labels",
                 stage("colour k-means", lambda a, o: rec["labels"].append(o))),
                (pipeline, "filter_point_cloud", stage("hull", lambda a, o: rec.update(keep=o[3]))),
                (hull, "hull_distances", stage("hull distances",
                                               lambda a, o: rec.update(hull_d=o))),
                (pipeline, "project_segments", stage("projection", projected))):
            stack.enter_context(wrapped(owner, name, after))
        t0 = time.perf_counter()
        pipeline.main(["-s", str(scan), "-o", str(out), "-t", "dtu", "--clean",
                       "--device", str(device)])
        rec["wall"] = time.perf_counter() - t0
    return rec


def npz_members(path):
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def artifacts_differ(a, b):
    """The pipeline artifacts under a/segments and b/segments that differ
    (an npz by its members: the zip records their write times)."""
    names = list(SEM_ARTIFACTS) + sorted(
        "masks/" + f for f in set(os.listdir(os.path.join(a, "segments", "masks")))
        | set(os.listdir(os.path.join(b, "segments", "masks"))))
    differ = []
    for name in names:
        pa, pb = (os.path.join(r, "segments", name) for r in (a, b))
        if not (os.path.exists(pa) and os.path.exists(pb)):
            differ.append(name)
        elif name.endswith(".npz"):
            if npz_members(pa) != npz_members(pb):
                differ.append(name)
        elif Path(pa).read_bytes() != Path(pb).read_bytes():
            differ.append(name)
    return differ


def semantics_path(root, seed, device, card):
    """Phase 9: the pipeline on the DTU-scale scan on the card, held stage by
    stage against the same pipeline on the CPU; then train.main
    --run_segmentation -t dtu on it (the pipeline again on the card, in its
    subprocess: bit-equal to the first card run), counted."""
    import torch
    from gaussmart_tpu_torch import scene as scene_mod
    from gaussmart_tpu_torch.semantics.projection import project_segments
    scan = os.path.join(root, "dtu_scan")
    t0 = time.perf_counter()
    write_dtu_scan(scan, seed, N_SPLATS, SEM_WIDTH, SEM_HEIGHT, SEM_VIEWS, device)
    print(f"[semantics] scan: {SEM_VIEWS} views at {SEM_WIDTH}x{SEM_HEIGHT} (K1 renders, "
          f"DTU IDR cameras.npz + COLMAP text), {N_SPLATS} points, written in "
          f"{time.perf_counter() - t0:.1f} s")
    gpu = pipeline_run(scan, os.path.join(root, "card"), device)
    cpu = pipeline_run(scan, os.path.join(root, "cpu"), "cpu")
    n_masks = [len(m) for m in gpu["masks"]]
    # the segments that the Scene's augmentation fills (semantics/augment.py:
    # at least 5 points, fewer than max(int(sqrt(area) * 0.1), 10)), and the
    # points it adds to them
    ids, sizes = np.unique(gpu["seg"][gpu["seg"] >= 0], return_counts=True)
    median = float(np.median(list(gpu["areas"].values()))) if gpu["areas"] else 0.0
    short = [max(int(np.sqrt(gpu["areas"].get(int(i), median)) * 0.1), 10) - int(c)
             for i, c in zip(ids, sizes) if c >= 5]
    under, to_add = sum(1 for d in short if d > 0), sum(d for d in short if d > 0)
    print(f"[semantics] selected views {gpu['selected']} (CPU run: {cpu['selected']}); masks "
          f"per view {n_masks}; points after the hull {int(gpu['keep'].sum())} of "
          f"{len(gpu['keep'])}; with a segment {int((gpu['seg'] >= 0).sum())} in {len(ids)} "
          f"segments (points per segment {sizes.min() if len(sizes) else 0}-"
          f"{sizes.max() if len(sizes) else 0}), {under} under their mask-area target "
          f"(the augmentation's rule adds {to_add} points); "
          f"mask areas {len(gpu['areas'])}")
    keep_equal = np.array_equal(gpu["keep"], cpu["keep"])
    hull_err = float(np.abs(gpu["hull_d"] - cpu["hull_d"]).max())
    pixels = sum(a.size for a in gpu["labels"])
    agree = sum(int((a == b).sum()) for a, b in zip(gpu["labels"], cpu["labels"]))
    seg, areas = project_segments(cpu["points"], cpu["masks"], cpu["cameras"], "dtu",
                                  device=device)
    seg_equal = (np.array_equal(seg, cpu["seg"])
                 and list(areas.items()) == list(cpu["areas"].items()))
    whole = artifacts_differ(os.path.join(root, "card"), os.path.join(root, "cpu"))
    print(f"[semantics] card vs CPU: hull distances max|diff| {hull_err:.3g} (limit "
          f"{SEM_HULL_TOL}); hull keep mask bit-equal {keep_equal}; pixel k-means "
          f"labels equal on {agree} of {pixels} pixels ({agree / max(pixels, 1):.6f}, limit "
          f"{SEM_LABEL_AGREE}); given the CPU's masks, segment_indices and mask_areas equal "
          f"{seg_equal}; artifacts that differ {whole}")
    if not (gpu["selected"] == cpu["selected"] and keep_equal and hull_err <= SEM_HULL_TOL
            and seg_equal
            and len(gpu["labels"]) == len(cpu["labels"]) == len(gpu["selected"])
            and agree >= SEM_LABEL_AGREE * pixels and pixels > 0
            and (gpu["seg"] >= 0).any() and gpu["areas"]):
        fail("[semantics] card vs CPU check failed")

    work, out = os.path.join(root, "work"), os.path.join(root, "trained_seg")
    os.makedirs(work)
    augmented = []

    def after(a, o, dt):
        augmented.append((len(a[0]), len(o[0])))
    losses, cwd = [], os.getcwd()
    os.chdir(work)
    try:
        with wrapped(scene_mod, "augment_by_mask_areas", after):
            state, _, counts, secs = train_cli(
                scan, out, SEM_ITERS, device, losses,
                ["--run_segmentation", "--dataset_type", "dtu", "--clean"])
    finally:
        os.chdir(cwd)
    results = os.path.join(work, "identification", "results")
    picked = (Path(out, "input.ply").read_bytes()
              == Path(results, "segments", "point_cloud", "segmented_point_cloud.ply").read_bytes())
    again = artifacts_differ(os.path.join(root, "card"), results)
    print(f"[semantics] train.main --run_segmentation -t dtu, {SEM_ITERS} iterations in "
          f"{secs:.2f} s (the pipeline's subprocess included): launches {counts}; the Scene "
          f"read segmented_point_cloud.ply {picked}; augmentation (points in, out) "
          f"{augmented} (the rule's {to_add} added); losses first {losses[0]:.5f} last "
          f"{losses[-1]:.5f}; splats "
          f"{int(state.n_active)}; the subprocess's artifacts vs the first card run's: "
          f"differ {again}")
    if not (only(counts, raster_fwd=SEM_ITERS, raster_bwd=SEM_ITERS, segsum=SEM_ITERS)
            and picked and len(augmented) == 1 and augmented[0][1] - augmented[0][0] == to_add
            and len(losses) == SEM_ITERS and np.all(np.isfinite(losses)) and not again):
        fail("[semantics] train --run_segmentation check failed")
    for label, rec in ((f"{card}: --device cuda", gpu), (f"{card}: --device cpu", cpu)):
        t = rec["times"]
        print(f"[semantics] {label}: pipeline {rec['wall']:.3f} s wall; view selection "
              f"{t['view selection']:.3f} s; segmentation {t['segmentation']:.3f} s "
              f"({t['segmentation'] / len(rec['labels']):.3f} s per view, its colour k-means "
              f"{t['colour k-means'] / len(rec['labels']):.3f} s per view); hull "
              f"{t['hull']:.3f} s (its distances {t['hull distances']:.3f} s); projection "
              f"{t['projection']:.3f} s")
    print(f"[semantics] {card}: train CLI with --run_segmentation {secs:.3f} s wall")
    return counts


def sha256_of(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def host_ms(fn, frames, warmup=1):
    """Median milliseconds per call of host work, by the wall clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def jpeg_fixtures():
    """The committed fixtures: each decoded to Pillow's digest, sized as
    Pillow sizes it, each source encoded to the digest of Pillow's file,
    the orientation-6 photo turned as cv2 turns it, the CMYK one refused;
    textured_photo at 5187x3361 encoded and decoded to Pillow's digests.
    Returns read_png's time on the Pillow-written NeRF-size PNG."""
    from gaussmart_tpu_torch.io import jpeg
    from gaussmart_tpu_torch.io.images import image_size, read_image, read_png
    with open(os.path.join(JPEG_DATA, "digests.json")) as f:
        digests = json.load(f)
    bad, lines = [], []
    for name, want in sorted(digests["decoded"].items()):
        path = os.path.join(JPEG_DATA, name)
        size_ok = list(image_size(path)) == want["size"]
        if "sha256" in want:
            got = read_image(path)
            ok = list(got.shape) == want["shape"] and sha256_of(got) == want["sha256"]
            lines.append(f"{name} {'equal' if ok else 'DIFFERENT'}")
        else:
            try:
                read_image(path)
                ok = False
            except ValueError as e:
                ok = "CMYK" in str(e)
            lines.append(f"{name} refused {ok}")
        lines[-1] += "" if size_ok else " (size DIFFERENT)"
        if not (ok and size_ok):
            bad.append(name)
    print(f"[jpeg] fixtures decoded against Pillow's digests, sizes against Pillow's: "
          + "; ".join(lines))
    want = digests["cv2_upright"]["orient6.jpg"]
    up = read_image(os.path.join(JPEG_DATA, "orient6.jpg"), exif_orientation=True)
    up_ok = list(up.shape) == want["shape"] and sha256_of(up) == want["sha256"]
    enc = []
    for name, by_q in sorted(digests["encoded"].items()):
        img = read_image(os.path.join(JPEG_DATA, name))
        for q, digest in sorted(by_q.items(), key=lambda kv: int(kv[0])):
            ok = hashlib.sha256(jpeg.encode_jpeg(img, int(q))).hexdigest() == digest
            enc.append(f"{name} q{q} {'equal' if ok else 'DIFFERENT'}")
            if not ok:
                bad.append(f"{name} q{q}")
    print(f"[jpeg] orient6.jpg turned upright against cv2.imread's digest: "
          f"{'equal' if up_ok else 'DIFFERENT'}; write_jpeg against Pillow's files: "
          + "; ".join(enc))
    want = digests["textured"]
    (w, h), q = want["size"], want["quality"]
    data = jpeg.encode_jpeg(textured_photo(h, w), q)
    tex_ok = (hashlib.sha256(data).hexdigest() == want["encoded"],
              sha256_of(jpeg.decode_jpeg(data)) == want["decoded"])
    print(f"[jpeg] textured_photo {w}x{h} at quality {q} ({8 * len(data) / (w * h):.3f} "
          f"bits per pixel) against Pillow's digests: file "
          f"{'equal' if tex_ok[0] else 'DIFFERENT'}, decode {'equal' if tex_ok[1] else 'DIFFERENT'}")
    if not all(tex_ok):
        bad.append("textured")
    png = os.path.join(JPEG_DATA, "nerf_800.png")
    png_ok = sha256_of(read_png(png)) == digests["decoded"]["nerf_800.png"]["sha256"]
    png_ms = host_ms(lambda: read_png(png), 5)
    if bad or not up_ok or not png_ok:
        fail(f"[jpeg] fixtures differ from Pillow's digests: {bad}, upright {up_ok}, "
             f"nerf_800.png {png_ok}")
    return png_ms


def jpeg_path(root, seed, device, card):
    """Phase 10: the fixtures, then the Mip-NeRF-360-layout JPEG scene:
    written, resized by convert, trained from images_4 (counted), loaded
    at full size under the cap; with the host codec's times."""
    from gaussmart_tpu_torch import convert
    from gaussmart_tpu_torch import scene as scene_mod
    from gaussmart_tpu_torch.cameras import focal2fov, fov2focal
    from gaussmart_tpu_torch.io import dataset, jpeg
    from gaussmart_tpu_torch.io.images import image_size
    png_ms = jpeg_fixtures()

    scene = os.path.join(root, "garden_layout")
    state, pts, rgb = region_cloud(seed, N_SPLATS, device)
    fovy = focal2fov(fov2focal(FOVX, JPEG_WIDTH), JPEG_HEIGHT)
    cams = bench_cameras(JPEG_VIEWS, JPEG_WIDTH, JPEG_HEIGHT, fovy=fovy)
    for c in cams:
        c.image_name = f"DSC{8000 + c.uid:05d}"
    write_colmap_source(scene, cams, [], pts, rgb, suffix=".JPG")
    os.makedirs(os.path.join(scene, "images"))
    noise = noise_texture(JPEG_HEIGHT, JPEG_WIDTH)
    t0 = time.perf_counter()
    enc_s, psnrs, bits = [], [], []
    tex_enc, tex_dec, tex_bits = [], [], []      # the high-entropy case, timed only
    for cam, img in zip(cams, render_views(state, cams, device)):
        t1 = time.perf_counter()
        data = jpeg.encode_jpeg(img)
        enc_s.append(time.perf_counter() - t1)
        bits.append(8 * len(data))
        with open(os.path.join(scene, "images", f"{cam.image_name}.JPG"), "wb") as f:
            f.write(data)
        err = jpeg.read_jpeg(data).astype(np.float64) - img
        psnrs.append(float(10 * np.log10(255.0 ** 2 / max(np.mean(err ** 2), 1e-12))))
        tex = np.clip(img + noise, 0, 255).astype(np.uint8)
        t1 = time.perf_counter()
        data = jpeg.encode_jpeg(tex, JPEG_TEXTURED_QUALITY)
        tex_enc.append(time.perf_counter() - t1)
        tex_bits.append(8 * len(data))
        for _ in range(2):
            t1 = time.perf_counter()
            jpeg.decode_jpeg(data)
            tex_dec.append(time.perf_counter() - t1)
    px = JPEG_WIDTH * JPEG_HEIGHT
    print(f"[jpeg] scene: {JPEG_VIEWS} K1 renders of {N_SPLATS} splats at "
          f"{JPEG_WIDTH}x{JPEG_HEIGHT} (Mip-NeRF 360 garden's size), written by write_jpeg "
          f"(quality 75, 4:2:0, {np.mean(bits) / px:.3f} bits per pixel) in "
          f"{time.perf_counter() - t0:.1f} s with the high-entropy copies; decoded vs "
          f"rendered PSNR {min(psnrs):.2f}-{max(psnrs):.2f} dB (limit {JPEG_MIN_PSNR})")
    t0 = time.perf_counter()
    convert.resize_copies(scene)
    resize_s = time.perf_counter() - t0
    sizes = {f: sorted({image_size(os.path.join(scene, f"images_{f}", n))
                        for n in os.listdir(os.path.join(scene, f"images_{f}"))})
             for f in (2, 4, 8)}
    want = {f: [(JPEG_WIDTH // f, JPEG_HEIGHT // f)] for f in (2, 4, 8)}
    print(f"[jpeg] convert.resize_copies: images_2/4/8 of {JPEG_VIEWS} photos in "
          f"{resize_s:.3f} s; sizes {sizes} (expected {want})")
    if sizes != want or min(psnrs) < JPEG_MIN_PSNR:
        fail("[jpeg] scene or resize check failed")

    loaded = []

    def after(a, cam, dt):
        loaded.append((a[0].image_path, cam, dt))
    losses = []
    folder = f"images_{JPEG_FACTOR}"
    with wrapped(scene_mod, "load_camera", after):
        state_t, _, counts, secs = train_cli(
            scene, os.path.join(root, "trained_jpeg"), JPEG_ITERS, device, losses,
            ["-i", folder, "--test_iterations", str(JPEG_ITERS)])
    load_s = sum(dt for _, _, dt in loaded)
    mismatched = []
    for path, cam, _ in loaded:
        raw = jpeg.read_jpeg(path)
        w, h = dataset.compute_resolution(raw.shape[1], raw.shape[0], -1)
        ref = dataset._resize_u8(raw, w, h).astype(np.float32).transpose(2, 0, 1) / 255.0
        if not (os.path.dirname(path).endswith(folder) and np.array_equal(cam.image, ref)
                and (cam.width, cam.height) == (JPEG_WIDTH // JPEG_FACTOR,
                                                JPEG_HEIGHT // JPEG_FACTOR)):
            mismatched.append(path)
    print(f"[jpeg] train.main -s <scene> -i {folder}, {JPEG_ITERS} iterations in {secs:.2f} s: "
          f"launches {counts}; losses first {losses[0]:.5f} last {losses[-1]:.5f}; splats "
          f"{int(state_t.n_active)}; {len(loaded)} cameras loaded at "
          f"{JPEG_WIDTH // JPEG_FACTOR}x{JPEG_HEIGHT // JPEG_FACTOR} in {load_s:.3f} s, "
          f"each equal to read_jpeg + _resize_u8 of its file: {not mismatched}")
    if not (only(counts, raster_fwd=JPEG_ITERS + EVAL_RENDERS, raster_bwd=JPEG_ITERS,
                 segsum=JPEG_ITERS, preprocess_fwd=EVAL_RENDERS)
            and len(losses) == JPEG_ITERS and np.all(np.isfinite(losses))
            and len(loaded) == JPEG_VIEWS and not mismatched):
        fail("[jpeg] training check failed")

    t0 = time.perf_counter()
    info = dataset.detect_and_read(scene)
    full = [dataset.load_camera(c) for c in info.train_cameras]
    full_s = time.perf_counter() - t0
    capped = sorted({(c.width, c.height) for c in full})
    raw = jpeg.read_jpeg(info.train_cameras[0].image_path)
    ref = dataset._resize_u8(raw, *JPEG_CAPPED).astype(np.float32).transpose(2, 0, 1) / 255
    print(f"[jpeg] the full-size photos loaded without -i (resolution -1): sizes {capped} "
          f"(the 1600-px cap gives {JPEG_CAPPED}); the first equal to read_jpeg + "
          f"_resize_u8 {np.array_equal(full[0].image, ref)}; {full_s:.3f} s for "
          f"{len(full)} views")
    if capped != [JPEG_CAPPED] or not np.array_equal(full[0].image, ref):
        fail("[jpeg] auto-cap check failed")

    big = [c.image_path for c in info.train_cameras]
    small = [os.path.join(scene, folder, os.path.basename(p)) for p in big]
    dec = {}
    for label, paths, (w, h) in (("full", big, (JPEG_WIDTH, JPEG_HEIGHT)),
                                 (folder, small, (JPEG_WIDTH // JPEG_FACTOR,
                                                  JPEG_HEIGHT // JPEG_FACTOR))):
        datas = []
        for p in paths:
            with open(p, "rb") as f:
                datas.append(f.read())
        per = []
        for data in datas + datas:
            t0 = time.perf_counter()
            jpeg.decode_jpeg(data)
            per.append(time.perf_counter() - t0)
        ms = 1e3 * float(np.median(per))
        dec[label] = (w, h, ms, ms / (w * h / 1e6))
    enc_ms = 1e3 * float(np.median(enc_s))
    tex_dec_ms = 1e3 * float(np.median(tex_dec))
    print(f"[time] {card}: host JPEG codec (one CPU thread of the card's machine), median "
          f"over {JPEG_VIEWS} views x 2: the scene's low-entropy renders at quality 75 "
          f"({np.mean(bits) / px:.3f} bits per pixel): decode "
          + "; ".join(f"{w}x{h} {ms:.2f} ms per view ({mp:.3f} ms per megapixel)"
                      for w, h, ms, mp in dec.values())
          + f"; encode {JPEG_WIDTH}x{JPEG_HEIGHT} {enc_ms:.2f} ms per view; high-entropy "
          f"(render + noise_texture, quality {JPEG_TEXTURED_QUALITY}, "
          f"{np.mean(tex_bits) / px:.3f} bits per pixel) {JPEG_WIDTH}x{JPEG_HEIGHT}: decode "
          f"{tex_dec_ms:.2f} ms per view ({tex_dec_ms / (px / 1e6):.3f} ms per megapixel), "
          f"encode {1e3 * float(np.median(tex_enc)):.2f} ms per view; convert "
          f"resize_copies {resize_s:.3f} s ({JPEG_VIEWS} photos to images_2/4/8); scene load "
          f"-i {folder} {load_s:.3f} s, full size under the cap {full_s:.3f} s; read_png "
          f"nerf_800.png (Pillow-written 800x800 RGBA) {png_ms:.2f} ms")
    return counts


# --- the paper's evaluation path (phase 11) ---------------------------------------

@contextlib.contextmanager
def replaced(owner, name, make):
    """owner.name replaced by make(original) for the block."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def synthetic_scene(root, device, card):
    """(a) The validation scene ray-traced on `device` by the port's
    make_synthetic_scene at the record's size: its files and sizes, the
    tracer's time per view and the whole generation's."""
    from gaussmart_tpu_torch.io.images import image_size
    from gaussmart_tpu_torch.io.ply import read_ply
    from gaussmart_tpu_torch.scripts import make_synthetic_scene as gen
    scene = os.path.join(root, "synthetic_scene")
    traced = []
    log = io.StringIO()
    t0 = time.perf_counter()
    with wrapped(gen, "render_view", lambda a, o, dt: traced.append(dt)), \
            contextlib.redirect_stdout(log):
        gen.main(["--out", scene, "--views", str(SYNTH_VIEWS), "--width", str(SYNTH_WIDTH),
                  "--height", str(SYNTH_HEIGHT), "--focal", str(SYNTH_FOCAL),
                  "--sfm_points", str(SYNTH_SFM), "--gt_points", str(SYNTH_GT),
                  "--device", str(device)])
    secs = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(scene, "images")))
    sizes = sorted({image_size(os.path.join(scene, "images", n)) for n in names})
    sfm = len(read_ply(os.path.join(scene, "sparse", "0", "points3D.ply"))["x"])
    gt = np.load(os.path.join(scene, "gt_surface_points.npy"))
    print(f"[synthetic] {card}: make_synthetic_scene --device {device}: {len(names)} views "
          f"at {sizes} ray-traced in float64 (2x2 supersampled) in {sum(traced):.3f} s "
          f"({1e3 * np.median(traced):.1f} ms per view), the scene written in {secs:.2f} s; "
          f"{sfm} SfM points, GT samples {gt.shape}; "
          f"{log.getvalue().strip().splitlines()[-1]}")
    if not (len(names) == SYNTH_VIEWS and sizes == [(SYNTH_WIDTH, SYNTH_HEIGHT)]
            and sfm > SYNTH_SFM // 2 and gt.ndim == 2 and gt.shape[1] == 3
            and len(gt) > SYNTH_GT // 2 and np.isfinite(gt).all()):
        fail("[synthetic] scene check failed")
    return scene, sfm, secs


def expected_schedule(iters):
    """The default schedule's events up to `iters` on a white background
    (config.py, train.py): densify passes, opacity resets (also at
    densify_from_iter), SH raises, test evals."""
    from gaussmart_tpu_torch.config import OptimizationParams
    opt = OptimizationParams()
    until = min(iters, opt.densify_until_iter - 1)
    return {"densify": [i for i in range(1, until + 1) if i > opt.densify_from_iter
                        and i % opt.densification_interval == 0],
            "reset": [i for i in range(1, until + 1) if i % opt.opacity_reset_interval == 0
                      or i == opt.densify_from_iter],
            "sh": [(1000 * d, d) for d in (1, 2, 3) if 1000 * d <= iters],
            "eval": [i for i in (7000, 30000) if i <= iters]}


def synthetic_training(scene, out, iters, device):
    """(b) python -m gaussmart_tpu_torch.train -s <scene> -m <out> --eval -r 2
    --white_background --iterations <iters> --quiet, in this process,
    counted, with the schedule's densify passes (splats before and after,
    children with no free slot, capacity), capacity growths, opacity
    resets, SH raises and evals recorded as they happen, and each step's
    loss and host time."""
    import torch
    from gaussmart_tpu_torch import train
    from gaussmart_tpu_torch.models import gaussians
    steps = {"iter": [], "t": [], "loss": []}
    ev = {"densify": [], "grow": [], "reset": [], "sh": [], "eval": []}

    def after(args, out_):
        steps["iter"].append(int(args[5]))
        steps["t"].append(time.perf_counter())
        steps["loss"].append(out_[3].total.detach())

    def now():      # the last step's iteration
        return steps["iter"][-1] if steps["iter"] else 0

    def densify_maker(make):
        def maker(*a, **kw):
            step = make(*a, **kw)

            def run(state, adam, gen, use_size):
                n0 = int(state.n_active)
                state, adam, n_drop = step(state, adam, gen, use_size)
                ev["densify"].append((now(), n0, int(state.n_active), int(n_drop),
                                      state.capacity))
                return state, adam, n_drop
            return run
        return maker

    def growing(grow):
        def run(state, adam, dropped=0, multiple=1):
            cap = state.capacity
            state, adam = grow(state, adam, dropped, multiple)
            ev["grow"].append((now(), cap, state.capacity, int(dropped)))
            return state, adam
        return run

    def resetting(reset):
        def run(state, adam):
            ev["reset"].append(now())
            return reset(state, adam)
        return run

    def raising(oneup):
        def run(self):       # at the top of the iteration after now()
            state = oneup(self)
            ev["sh"].append((now() + 1, state.active_sh_degree))
            return state
        return run

    with contextlib.ExitStack() as stack:
        for owner, name, make in ((train, "make_densify_step", densify_maker),
                                  (train, "_grow", growing),
                                  (train, "reset_opacity", resetting),
                                  (gaussians.GaussianState, "oneup_sh_degree", raising)):
            stack.enter_context(replaced(owner, name, make))
        stack.enter_context(wrapped(train, "report_eval",
                                    lambda a, o, dt: ev["eval"].append((a[4], o, dt))))
        state, _, counts, secs = counted_train(
            ["-s", scene, "-m", out, "--eval", "-r", "2", "--white_background",
             "--iterations", str(iters), "--quiet", "--device", str(device)], after)
    losses = torch.stack(steps["loss"]).cpu().numpy()
    with open(os.path.join(out, "train_stats.csv")) as f:
        stats = list(csv.DictReader(f))
    return state, counts, secs, steps, losses, ev, stats


def synthetic_scoring(scene, out, iters, device):
    """(c) render_cli --iteration <iters> (train and test renders, the
    bounded mesh at the default --mesh_res 1024), counted, its stages
    timed; metrics_cli; eval_synthetic's Chamfer of fuse.ply (the
    record's mesh) at crop radius SYNTH_CROP."""
    from gaussmart_tpu_torch import render_cli
    from gaussmart_tpu_torch.eval import metrics_cli
    from gaussmart_tpu_torch.mesh import extract, tsdf
    from gaussmart_tpu_torch.scripts import eval_synthetic
    stages, grids = {}, []

    def timed(key, keep=None):
        def after(a, o, dt):
            stages[key] = stages.get(key, 0.0) + dt
            if keep:
                keep(a, o)
        return after
    with contextlib.ExitStack() as stack:
        for owner, name, key, keep in (
                (extract.GaussianExtractor, "reconstruction", "renders", None),
                (extract.GaussianExtractor, "export_image", "image export", None),
                (tsdf.TSDFVolume, "__init__", "TSDF grid",
                 lambda a, o: grids.append((a[0].dims, a[3], a[0].voxel_size))),
                (tsdf.TSDFVolume, "integrate", "TSDF integrate", None),
                (tsdf.TSDFVolume, "extract_mesh", "marching + welding", None),
                (render_cli, "post_process_mesh", "post-process", None),
                (render_cli, "save_mesh_ply", "PLY writes", None)):
            stack.enter_context(wrapped(owner, name, timed(key, keep)))
        zero_counts()
        t0 = time.perf_counter()
        render_cli.main(["-m", out, "--iteration", str(iters), "--device", str(device)])
        counts = read_counts()
        render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics_cli.main(["-m", out, "--device", str(device)])
    metrics_s = time.perf_counter() - t0
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)[f"ours_{iters}"]
    t0 = time.perf_counter()
    chamfer = eval_synthetic.chamfer_vs_gt(
        os.path.join(out, "train", f"ours_{iters}", "fuse.ply"),
        np.load(os.path.join(scene, "gt_surface_points.npy")), 0.002, SYNTH_CROP)
    chamfer_s = time.perf_counter() - t0
    return counts, render_s, stages, grids, results, metrics_s, chamfer, chamfer_s


def covered(ev):
    """Each densify pass that found no free slot for some children was
    followed by one capacity growth that holds its splats and those
    children (train._grow; the children themselves stay lost, as in the
    JAX package)."""
    short = [(i, n1 + d) for i, _, n1, d, _ in ev["densify"] if d > 0]
    return (len(short) == len(ev["grow"])
            and all(i == g and new >= need
                    for (i, need), (g, _, new, _) in zip(short, ev["grow"])))


BESIDE_DRIVERS = ", the five drivers' chains running beside it"
BESIDE_SYNTHETIC = ", beside the validation run,"


def synthetic_path(root, device, card, iters=SYNTH_ITERS, beside=""):
    """Phase 11 (a)-(d): BASELINE.md's bounded photometric recipe through the
    port's CLIs, its default schedule and quality held."""
    t_phase = time.perf_counter()
    scene, n_init, gen_s = synthetic_scene(root, device, card)
    out = os.path.join(root, "synthetic_model")
    want = expected_schedule(iters)
    state, counts, train_s, steps, losses, ev, stats = synthetic_training(scene, out, iters,
                                                                          device)
    n_evals = len(want["eval"])
    k1 = iters + n_evals * (SYNTH_TEST + 5)       # + each eval's test and 5 train renders
    t = np.asarray(steps["t"])
    windows = [(k + 1000, 999 / (t[k + 999] - t[k])) for k in range(0, len(t) - 999, 1000)]
    eval_s = sum(dt for _, _, dt in ev["eval"])
    ips = (len(t) - 1) / (t[-1] - t[0])
    n_end = int(state.n_active)
    drops = sum(d for _, _, _, d, _ in ev["densify"])
    binned = max(int(r["n_dropped"]) for r in stats)
    by_k = {i: (n0, n1) for i, n0, n1, _, _ in ev["densify"]}
    trace_ = "; ".join(f"{i}: {by_k[i][0]}->{by_k[i][1]}" for i in sorted(by_k)
                       if i % 1000 == 0 or i == min(by_k))
    print(f"[synthetic] train.main -s <scene> -m <out> --eval -r 2 --white_background "
          f"--iterations {iters} --quiet: {train_s:.1f} s wall ({ips:.2f} iterations/s over "
          f"the steps, evals {eval_s:.1f} s); launches {counts} (expected raster_fwd {k1}, "
          f"raster_bwd {iters}, segsum {iters}); losses finite {bool(np.isfinite(losses).all())}, first "
          f"100 mean {losses[:100].mean():.5f}, last 100 {losses[-100:].mean():.5f}")
    print(f"[synthetic] schedule: {len(ev['densify'])} densify passes at "
          f"{ev['densify'][0][0] if ev['densify'] else None}..."
          f"{ev['densify'][-1][0] if ev['densify'] else None} (expected {len(want['densify'])} "
          f"at {want['densify'][:1]}...{want['densify'][-1:]}); splats before->after "
          f"(every 1000th pass) {trace_}; opacity resets at {ev['reset']} (expected "
          f"{want['reset']}); SH raised at {ev['sh']} (expected {want['sh']}); evals at "
          f"{[i for i, _, _ in ev['eval']]} (expected {want['eval']})")
    print(f"[synthetic] splats: {n_init} in the initial cloud, {n_end} at {iters} of capacity "
          f"{state.capacity}; capacity growths (iteration, from, to, that pass's children "
          f"with no free slot) {ev['grow']}; children with no free slot over all passes "
          f"{drops}; binning's dropped duplicates, most on a logged step, {binned}")
    print(f"[synthetic] {card}: iterations/s per 1000 (host clock between steps{beside}; "
          f"ending at): " + ", ".join(f"{e}: {r:.2f}" for e, r in windows))
    for it_, res, dt in ev["eval"]:
        print(f"[synthetic] in-loop eval at {it_} ({dt:.2f} s): "
              + "; ".join(f"{k} L1 {v['l1']:.5f} PSNR {v['psnr']:.3f} SSIM {v['ssim']:.4f}"
                          for k, v in res.items()))
    if not (only(counts, raster_fwd=k1, raster_bwd=iters, segsum=iters,
                 preprocess_fwd=k1 - iters)
            and len(losses) == iters and np.isfinite(losses).all()
            and [i for i, *_ in ev["densify"]] == want["densify"]
            and ev["reset"] == want["reset"] and ev["sh"] == want["sh"]
            and [i for i, _, _ in ev["eval"]] == want["eval"]
            and n_end > n_init and binned == 0 and covered(ev)):
        fail("[synthetic] training check failed")

    counts, render_s, stages, grids, results, metrics_s, chamfer, chamfer_s = \
        synthetic_scoring(scene, out, iters, device)
    k1 = 2 * SYNTH_TRAIN + SYNTH_TEST
    (dims, asked, voxel), = grids
    n_vox = int(np.prod(dims))
    print(f"[synthetic] render_cli --iteration {iters} (bounded mesh, --mesh_res 1024) in "
          f"{render_s:.2f} s: launches {counts} (expected raster_fwd {k1}); TSDF grid {dims} = "
          f"{n_vox} voxels of {voxel:.5f} (asked {asked:.5f}; the cap {TSDF_CAP}, "
          f"{'reached' if voxel > asked else 'not reached'}); stages (s) "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    psnr, ssim = results["PSNR"], results["SSIM"]
    in_loop = ev["eval"][-1][1]["test"] if ev["eval"] else {}
    print(f"[synthetic] metrics_cli in {metrics_s:.2f} s: test PSNR {psnr:.4f} SSIM {ssim:.5f} "
          f"LPIPS {results['LPIPS']} at {iters} (the train log's in-loop test PSNR "
          f"{in_loop.get('psnr', float('nan')):.4f}, SSIM {in_loop.get('ssim', float('nan')):.5f})")
    print(f"[synthetic] eval_synthetic.chamfer_vs_gt(fuse.ply, crop_radius {SYNTH_CROP}) in "
          f"{chamfer_s:.2f} s: d2s {chamfer['mean_d2s']:.5f} s2d {chamfer['mean_s2d']:.5f} "
          f"overall {chamfer['overall']:.5f} ({chamfer['n_mesh_samples']} mesh samples)")
    floor = SYNTH_FLOORS.get(iters)
    # the grid spans the observed surface's box at depth_trunc / 1024; where
    # that box needs more than TSDF_CAP voxels the voxel grows to hold the
    # cap (its ceil rounding may pass it by a layer)
    capped = voxel > asked
    ok = (only(counts, raster_fwd=k1, preprocess_fwd=k1) and n_vox < 1.01 * TSDF_CAP
          and (not capped or n_vox > 0.99 * TSDF_CAP)
          and np.isfinite(psnr) and np.isfinite(chamfer["overall"]))
    held = []
    if floor:
        held.append(f"test PSNR {psnr:.4f} >= {floor[0]}, SSIM {ssim:.5f} >= {floor[1]}")
        ok = ok and psnr >= floor[0] and ssim >= floor[1]
    if iters == 30000:
        fuse = chamfer["overall"]
        held.append(f"splats {n_end} in {SYNTH_SPLATS_30K}, Chamfer {fuse:.5f} <= "
                    f"{SYNTH_CHAMFER_30K}")
        ok = (ok and SYNTH_SPLATS_30K[0] <= n_end <= SYNTH_SPLATS_30K[1]
              and fuse <= SYNTH_CHAMFER_30K)
    print(f"[synthetic] {card}: held at {iters}: {'; '.join(held) or 'no quality bound'}; "
          f"phase wall times (s): scene {gen_s:.2f}, train {train_s:.2f}, render + mesh "
          f"{render_s:.2f}, metrics {metrics_s:.2f}, Chamfer {chamfer_s:.2f}; whole "
          f"{time.perf_counter() - t_phase:.1f}")
    if not ok:
        fail("[synthetic] render, mesh or quality check failed")


def dtu_projection_scan(scan, gt, scan_id):
    """Turn a write_dtu_scan scan into the layout eval.cull reads, in
    millimetres as DTU's: world_mat the projection K [R|t] of the world
    (IDR's P, at DTU's 1600x1200) and scale_mat DTU_MM_PER_UNIT from the
    scan's units (so world_mat @ scale_mat projects the scan's points),
    white masks, and the official ground truth beside it (ObsMask all
    observed over the cloud's box, the ground plane below everything, the
    cloud as STL). The cull's Chamfer samples at 0.2 and dedups within
    0.2, so it must see millimetres: in the scan's units every sample
    would have every other one within reach."""
    import scipy.io
    from gaussmart_tpu_torch.io.images import write_png
    from gaussmart_tpu_torch.io.ply import fetch_point_cloud, store_point_cloud
    with np.load(os.path.join(scan, "cameras.npz")) as z:
        mats = dict(z)
    n = sum(1 for k in mats if k.startswith("world_mat_"))
    white = np.full((SEM_HEIGHT, SEM_WIDTH), 255, np.uint8)
    scale = np.diag([DTU_MM_PER_UNIT] * 3 + [1.0])
    for i in range(n):
        mats[f"world_mat_{i}"] = (mats[f"camera_mat_{i}"] @ mats[f"world_mat_{i}"]
                                  @ np.linalg.inv(scale))
        mats[f"scale_mat_{i}"] = scale
        write_png(os.path.join(scan, "mask", f"{i:03d}.png"), white, level=1)
    np.savez(os.path.join(scan, "cameras.npz"), **mats)
    pts, _, _ = fetch_point_cloud(os.path.join(scan, "points.ply"))
    pts = pts * DTU_MM_PER_UNIT
    lo, hi, res = pts.min(0) - 50.0, pts.max(0) + 50.0, 5.0
    os.makedirs(os.path.join(gt, "ObsMask"))
    scipy.io.savemat(os.path.join(gt, "ObsMask", f"ObsMask{scan_id}_10.mat"),
                     {"ObsMask": np.ones(np.ceil((hi - lo) / res).astype(int) + 1, np.uint8),
                      "BB": np.stack([lo, hi]).astype(np.float64), "Res": np.array([[res]])})
    scipy.io.savemat(os.path.join(gt, "ObsMask", f"Plane{scan_id}.mat"),
                     {"P": np.array([[0.0], [0.0], [0.0], [1.0]])})
    store_point_cloud(os.path.join(gt, "Points", "stl", f"stl{scan_id:03d}_total.ply"), pts,
                      np.full((len(pts), 3), 128.0))


def rgba_views(state, cams, device):
    """K1 renders over black as (colour / alpha, alpha) uint8 RGBA arrays."""
    import torch
    from gaussmart_tpu_torch.render.api import render
    bg = torch.zeros(3, device=device)
    with torch.inference_mode():
        for cam in cams:
            pkg = render(cam.params(device), state, bg)
            a = pkg["rend_alpha"].clamp(0, 1)
            rgb = (pkg["render"] / a.clamp_min(1e-6)).clamp(0, 1)
            img = torch.cat([rgb, a]).permute(1, 2, 0)
            yield (img * 255).round().to(torch.uint8).cpu().numpy()


def square_pixel_fovy(width, height):
    """The vertical field of view of a square-pixel camera of FOVX at this
    size, as the dataset readers derive it."""
    from gaussmart_tpu_torch.cameras import focal2fov, fov2focal
    return focal2fov(fov2focal(FOVX, width), height)


def ring_scene_cams(width, height):
    """ring_cameras with square pixels."""
    import dataclasses
    fovy = square_pixel_fovy(width, height)
    return [dataclasses.replace(c, fovy=fovy)
            for c in ring_cameras(DRIVER_RING_VIEWS, width, height)]


def sphere_state(seed, n, device, ball=((0.0, 0.0, 0.0), 1.0)):
    """sphere_params at SH degree 0 moved to the sphere `ball` (centre,
    radius): (params, state)."""
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy
    (centre, radius) = ball
    params = sphere_params(seed, n, 0)
    params["xyz"] = (params["xyz"] * radius + np.asarray(centre)).astype(np.float32)
    params["scaling"] = params["scaling"] + np.float32(np.log(radius))
    return params, state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32), 0, 0,
                                    1.0, device=device)


def driver_datasets(data, seed, device):
    """A tiny scene in each benchmark's layout: DTU scans (IDR), a
    Mip-NeRF 360 COLMAP JPEG scene (phase 10's layout), a NeRF-synthetic
    RGBA-PNG scene and a Tanks and Temples COLMAP JPEG scene with its GT
    files (.log trajectory, crop JSON, GT PLY)."""
    from gaussmart_tpu_torch.eval.tnt_fscore import CameraPose, write_trajectory
    from gaussmart_tpu_torch.io import jpeg
    from gaussmart_tpu_torch.io.images import write_png
    from gaussmart_tpu_torch.io.ply import store_point_cloud
    # DTU: scan24 for the photometric chain (the segmentation pipeline reads
    # world_mat as the w2c, as phase 9 writes it), scan37 for the mesh chain
    # (eval.cull reads it as the projection)
    # (eval.cull reads it as the projection); the mesh chain's object is a
    # sphere of surfels where the grid looks, so that its TSDF at voxel
    # 0.004 holds one surface (bench.py's volume cloud would give a surface
    # at every splat)
    write_dtu_scan(os.path.join(data, "dtu", "scan24"), seed, DRIVER_POINTS, SEM_WIDTH,
                   SEM_HEIGHT, DRIVER_DTU_VIEWS, device)
    params, ball = sphere_state(seed, DRIVER_POINTS, device, DRIVER_DTU_BALL)
    write_dtu_scan(os.path.join(data, "dtu", "scan37"), seed, DRIVER_POINTS, SEM_WIDTH,
                   SEM_HEIGHT, DRIVER_DTU_VIEWS, device,
                   cloud=(ball, params["xyz"], np.full((DRIVER_POINTS, 3), 153.0)))
    dtu_projection_scan(os.path.join(data, "dtu", "scan37"), os.path.join(data, "dtu_gt"), 37)

    # Mip-NeRF 360 garden: phase 10's photos (5187x3361 JPEG, quality 75) of a
    # sphere of surfels from a ring around it (render_cli's bounding sphere
    # needs views that converge: bench.py's poses are parallel)
    params, sphere = sphere_state(seed, DRIVER_POINTS, device)
    garden = os.path.join(data, "m360", "garden")
    cams = ring_scene_cams(JPEG_WIDTH, JPEG_HEIGHT)
    for c in cams:
        c.image_name = f"DSC{8000 + c.uid:05d}"
    sfm = params["xyz"][:2000]
    write_colmap_source(garden, cams, [], sfm, np.full((len(sfm), 3), 153.0), suffix=".JPG")
    for cam, img in zip(cams, render_views(sphere, cams, device)):
        jpeg.write_jpeg(os.path.join(garden, "images", f"{cam.image_name}.JPG"), img)

    # NeRF-synthetic lego: RGBA PNGs of the sphere, views 0 and 8 held out
    lego = os.path.join(data, "nerf", "lego")
    cams = ring_scene_cams(*DRIVER_NERF_SIZE)
    frames = {"train": [], "test": []}
    for cam, img in zip(cams, rgba_views(sphere, cams, device)):
        split = "test" if cam.uid in (0, 8) else "train"
        write_png(os.path.join(lego, split, f"{cam.image_name}.png"), img, level=1)
        c2w = cam.c2w()
        c2w[:3, 1:3] *= -1                   # COLMAP -> OpenGL axes
        frames[split].append({"file_path": f"{split}/{cam.image_name}",
                              "transform_matrix": c2w.tolist()})
    for split, fr in frames.items():
        with open(os.path.join(lego, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": FOVX, "frames": fr}, f)

    # Tanks and Temples Courthouse: JPEG photos of the sphere and its GT
    court, court_gt = (os.path.join(data, d, "Courthouse") for d in ("tnt", "tnt_gt"))
    cams = ring_scene_cams(*DRIVER_TNT_SIZE)
    write_colmap_source(court, cams, [], sfm, np.full((len(sfm), 3), 153.0), suffix=".jpg")
    for cam, img in zip(cams, render_views(sphere, cams, device)):
        jpeg.write_jpeg(os.path.join(court, "images", f"{cam.image_name}.jpg"), img)
    os.makedirs(court_gt)
    store_point_cloud(os.path.join(court_gt, "Courthouse.ply"), params["xyz"],
                      np.full((len(params["xyz"]), 3), 153.0))
    write_trajectory([CameraPose([i, i, 0], c.c2w()) for i, c in enumerate(cams)],
                     os.path.join(court_gt, "Courthouse_COLMAP_SfM.log"))
    with open(os.path.join(court_gt, "Courthouse.json"), "w") as f:
        json.dump({"orthogonal_axis": "Y", "axis_min": -1.5, "axis_max": 1.5,
                   "bounding_polygon": [[-1.5, 0, -1.5], [1.5, 0, -1.5], [1.5, 0, 1.5],
                                        [-1.5, 0, 1.5]]}, f)


def start_drivers(root, seed, device):
    """Phase 11 (e), started: the datasets written, then every benchmark
    driver launched at once, each through the card (each CLI picks it: no
    --device; elsewhere --device cpu) at DRIVER_ITERS iterations on one
    tiny scene of its dataset's layout, in a working directory and a
    session of its own (train --run_segmentation writes there), its output
    to a log, a thread watching the host's free memory. Returns what
    finish_drivers reads."""
    from gaussmart_tpu_torch.scripts import dtu_eval_mesh
    data, out = os.path.join(root, "data"), os.path.join(root, "eval")
    t0 = time.perf_counter()
    driver_datasets(data, seed, device)
    data_s = time.perf_counter() - t0
    on = [] if device.type == "cuda" else ["--device", str(device)]
    culled = dtu_eval_mesh.cull_dir("37")
    runs = {
        "dtu_eval": (["--dtu", f"{data}/dtu", "--scenes", "scan24"],
                     [f"{out}/dtu_eval/scan24/results.json"]),
        "dtu_eval_mesh": (["--dtu", f"{data}/dtu", "--DTU_Official", f"{data}/dtu_gt",
                           "--scenes", "scan37"],
                          [f"{culled}/culled_mesh.ply", f"{culled}/results.json"]),
        "m360_eval": (["--m360", f"{data}/m360", "--scenes", "garden"],
                      [f"{out}/m360_eval/garden/results.json"]),
        "nerf_eval": (["--nerf", f"{data}/nerf", "--scenes", "lego"],
                      [f"{out}/nerf_eval/lego/results.json"]),
        "tnt_eval": (["--TNT_data", f"{data}/tnt", "--TNT_GT", f"{data}/tnt_gt",
                      "--scenes", "Courthouse"],
                     [f"{out}/tnt_eval/Courthouse/Courthouse_results.json"]),
    }
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    t0 = time.perf_counter()
    for name, (args, _) in runs.items():
        cwd = os.path.join(root, f"work_{name}")
        os.makedirs(cwd)
        with open(os.path.join(root, f"{name}.log"), "w") as f:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"gaussmart_tpu_torch.scripts.{name}", *args,
                 "--output_path", f"{out}/{name}", "--iterations", str(DRIVER_ITERS), *on],
                cwd=cwd, env=env, stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    import threading
    drv = {"root": root, "out": out, "runs": runs, "procs": procs, "culled": culled,
           "data_s": data_s, "t0": t0, "low": None, "peaks": {}}
    drv["watch"] = threading.Thread(
        target=lambda: drv.update(low=host_memory_watch(procs.values(), drv["peaks"])),
        daemon=True)
    drv["watch"].start()
    return drv


def available_gib() -> float:
    with open("/proc/meminfo") as f:
        fields = dict(line.split(":", 1) for line in f)
    return int(fields["MemAvailable"].split()[0]) / 2**20


def session_rss_gib(sids):
    """{session id: resident GiB of its processes} from /proc."""
    page = os.sysconf("SC_PAGE_SIZE")
    rss = dict.fromkeys(sids, 0.0)
    for pid in filter(str.isdigit, os.listdir("/proc")):
        with contextlib.suppress(OSError, IndexError, ValueError):
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()   # from field 3, state
            if int(fields[3]) in rss:                           # field 6, session
                rss[int(fields[3])] += int(fields[21]) * page / 2**30   # field 24, rss
    return rss


def host_memory_watch(procs, peaks):
    """Wait for `procs` (each its own session), keeping each session's
    peak resident memory in `peaks` {pid: GiB}; if the host's available
    memory falls below DRIVER_MEM_FLOOR_GIB first, kill every process
    group and return the lowest reading, else None."""
    import signal
    procs = list(procs)
    while any(p.poll() is None for p in procs):
        for sid, gib in session_rss_gib([p.pid for p in procs]).items():
            peaks[sid] = max(peaks.get(sid, 0.0), gib)
        free = available_gib()
        if free < DRIVER_MEM_FLOOR_GIB:
            for p in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
            return free
        time.sleep(0.5)
    return None


def finish_drivers(drv, card, beside=""):
    """Phase 11 (e), finished: wait for every driver; each one's rc, its
    log free of the drivers' "job failed" line, its output files; the DTU
    mesh chain's Chamfer and the TnT F-score; then the summary over the
    photometric results."""
    from gaussmart_tpu_torch.scripts import summary
    runs, out, culled = drv["runs"], drv["out"], drv["culled"]
    drv["watch"].join()
    rcs = {name: p.wait() for name, p in drv["procs"].items()}
    wall = time.perf_counter() - drv["t0"]
    peaks = {name: drv["peaks"].get(p.pid, 0.0) for name, p in drv["procs"].items()}
    print(f"[drivers] peak resident memory of each driver's processes (GiB): "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()))
    if drv["low"]:
        for name in runs:
            log = Path(drv["root"], f"{name}.log").read_text(errors="replace")
            print(f"[drivers] {name} log, last lines:\n{log[-1500:]}")
        shutil.rmtree(culled, ignore_errors=True)
        fail(f"[drivers] the host's available memory fell to {drv['low']:.1f} GiB (floor "
             f"{DRIVER_MEM_FLOOR_GIB} GiB): every driver's process group killed")
    bad = []
    for name, rc in rcs.items():
        log = Path(drv["root"], f"{name}.log").read_text(errors="replace")
        missing = [p for p in runs[name][1] if not os.path.exists(p)]
        failed = "job failed" in log
        print(f"[drivers] {name} {' '.join(runs[name][0])} --iterations {DRIVER_ITERS}: "
              f"rc {rc}; 'job failed' in its log {failed}; missing outputs {missing}")
        if rc != 0 or failed or missing:
            bad.append(name)
            print(f"[drivers] {name} log, last lines:\n{log[-4000:]}")
    if bad:
        shutil.rmtree(culled, ignore_errors=True)
        fail(f"[drivers] check failed: {bad}")
    with open(runs["tnt_eval"][1][0]) as f:
        fscore = json.load(f)
    with open(runs["dtu_eval_mesh"][1][1]) as f:
        dtu_chamfer = json.load(f)
    shutil.rmtree(culled)                   # beside the driver, in the checkout
    with contextlib.suppress(OSError):
        os.rmdir(os.path.dirname(culled))
    summaries = {}
    for name in ("dtu_eval", "m360_eval", "nerf_eval"):
        with contextlib.redirect_stdout(io.StringIO()):
            rows, means = summary.main(["--root", f"{out}/{name}"])
        summaries[name] = ([(r["scene"], r["method"]) for r in rows], means)
    print(f"[drivers] {card}: datasets written in {drv['data_s']:.1f} s; the five chains "
          f"at once{beside} in {wall:.1f} s; DTU mesh Chamfer {dtu_chamfer}; TnT F-score "
          f"{fscore}; summary (rows, averages) {summaries}")
    if any(not rows or not np.isfinite(means.get("PSNR", np.nan))
           for rows, means in summaries.values()):
        fail("[drivers] summary check failed")


# --- timings -------------------------------------------------------------------

def time_ms(fn, frames, warmup=2):
    """Median milliseconds per call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(frames):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_kernel_ms(fn, frames, warmup=2):
    """Device kernel milliseconds per call of fn and every kernel's
    (name, ms per call, launches per call), most time first, from
    torch.profiler over `frames` calls, recorded after `warmup` traced but
    discarded calls and a pause (a trace that has just started drops the
    first kernels it sees: launches per call then read below the code's);
    (None, []) when the profiler records no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=frames,
                                   repeat=1)) as prof:
        for i in range(warmup + frames):
            fn()
            if i >= warmup - 1:
                torch.cuda.synchronize()
            prof.step()
            if i == warmup - 1:         # the recorded calls start here
                time.sleep(0.1)
    # kernels only: the schedule's step annotations (ProfilerStep#) have a
    # device range of their own
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    total_us = sum(e.self_device_time_total for e in events)
    if not events or total_us <= 0:
        return None, []
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    return total_us / 1e3 / frames, [(e.key, e.self_device_time_total / 1e3 / frames,
                                      e.count / frames) for e in ranked]


def print_device(label, kernel_ms, top, wall_ms):
    if kernel_ms is None:
        print(f"[time] {label}: device kernel time not measured (the profiler "
              "recorded no device events)")
        return
    print(f"[time] {label}: device kernel time {kernel_ms:.4f} ms per call "
          f"(torch.profiler) = busy share {kernel_ms / wall_ms:.3f}; top: "
          + "; ".join(f"{name[:60]} {ms:.4f} ms x{calls:g}"
                      for name, ms, calls in top[:10]))


def walk_counts(blob, ids, ranges, ints, width, height):
    """(K2 evaluations, blends) that this frame needs: K2 evaluates a
    pixel's entries below n_contrib; K1 and K2 blend (forward) or step back
    (backward) through those with alpha > 0 at that pixel, tested with the
    compositor's own expressions. K1's evaluations: forward_warp_counts."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    tx, ty = rt.tile_grid(width, height)
    n_tiles = tx * ty
    nc = ints[0].reshape(ty, rt.TILE, tx, rt.TILE).permute(0, 2, 1, 3)
    nc = nc.reshape(n_tiles, rt.TILE * rt.TILE).to(torch.int64)
    starts = ranges[:, 0].to(torch.int64)
    t = torch.arange(n_tiles, device=blob.device)[:, None]
    p = torch.arange(rt.TILE * rt.TILE, device=blob.device)[None, :]
    px = ((t % tx) * rt.TILE + p % rt.TILE).to(torch.float32)
    py = ((t // tx) * rt.TILE + p // rt.TILE).to(torch.float32)
    blends = torch.zeros((), dtype=torch.int64, device=blob.device)
    for e in range(int(nc.max())):
        slot = torch.clamp(starts + e, 0, ids.shape[0] - 1)
        r = [c[:, None] for c in blob[ids[slot].to(torch.int64)].unbind(1)]
        blends += ((e < nc) & (rt._geom_res(r, px, py)["alpha"] > 0)).sum()
    return int(nc.sum()), int(blends)


def warp_walk_evals(ranges, ints, width, height):
    """(entry, pixel) evaluations that raster_bwd.cu makes: each warp of a
    tile's 8 (two pixel rows each) evaluates, at all of its 32 pixels, the
    entries below its pixels' largest n_contrib."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    tx, ty = rt.tile_grid(width, height)
    nc = ints[0].reshape(ty, rt.TILE, tx, rt.TILE).permute(0, 2, 1, 3)
    warp_max = nc.reshape(tx * ty, 8, 32).amax(dim=2).to(torch.int64)
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)[:, None]
    return int(torch.minimum(warp_max, counts).sum()) * 32


def forward_warp_counts(io, width, height):
    """The (entry, warp) pairs of raster_fwd's walk on this frame, a warp
    being a 4x8 block of a tile (rt.warp_pixels): it walks its tile's
    entries until its last pixel ends (at the entry that terminates it,
    else at the end of the list). Returns {name: count}: "evaluations",
    the per-pixel evaluations up to each pixel's end; "kept_evaluations",
    those of them in pairs that the band cull keeps (band_mask_plain);
    "walked", the pairs walked (each takes a band test); "no_pass", those
    where no pixel of the warp passes the alpha and near tests; "blend",
    those where some pixel blends; "culled", those the cull skips;
    "culled_passing", those of them where some pixel passes (0 when the
    cull is exact)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.raster_common import T_EPS
    blob, conics, ids, ranges, fb, ints = (
        io[k] for k in ("blob", "conics", "ids", "ranges", "fb", "ints"))
    tx, ty = rt.tile_grid(width, height)
    n_tiles = tx * ty

    def to_tiles(x):    # [H_pad, W_pad] -> [n_tiles, 256]
        x = x.reshape(ty, rt.TILE, tx, rt.TILE).permute(0, 2, 1, 3)
        return x.reshape(n_tiles, rt.TILE * rt.TILE)

    nc = to_tiles(ints[0]).to(torch.int64)
    ended = to_tiles(fb[rt.FB_CHANNELS.index("mt")]) < T_EPS
    starts = ranges[:, 0].to(torch.int64)
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    mask = rt.band_mask_plain(blob, conics, ids, ranges, width)
    t = torch.arange(n_tiles, device=blob.device)[:, None]
    p = torch.arange(rt.TILE * rt.TILE, device=blob.device)[None, :]
    px = ((t % tx) * rt.TILE + p % rt.TILE).to(torch.float32)
    py = ((t // tx) * rt.TILE + p // rt.TILE).to(torch.float32)
    length = counts[:, None].expand(n_tiles, rt.TILE * rt.TILE).clone()
    warps = rt.warp_pixels(blob.device)
    passes, blends, kept = [], [], []
    for e in range(int(counts.max()) if n_tiles else 0):
        slot = torch.clamp(starts + e, 0, ids.shape[0] - 1)
        r = [c[:, None] for c in blob[ids[slot].to(torch.int64)].unbind(1)]
        hit = (rt._geom_res(r, px, py)["alpha"] > 0) & (e < counts)[:, None]
        # an ended pixel stops at its first considered entry past n_contrib
        stop = ended & hit & (e >= nc) & (length == counts[:, None])
        length = torch.where(stop, e + 1, length)
        passes.append(hit[:, warps].any(dim=2))
        blends.append((hit & (e < nc))[:, warps].any(dim=2))
        kept.append(mask[slot])
    if not passes:
        return dict.fromkeys(("evaluations", "kept_evaluations", "walked", "no_pass",
                              "blend", "culled", "culled_passing"), 0)
    warp_len = length[:, warps].amax(dim=2)
    walked = torch.arange(len(passes), device=blob.device)[:, None, None] < warp_len
    passes, blends, kept = torch.stack(passes), torch.stack(blends), torch.stack(kept)
    # a pixel's kept evaluations: its warp's kept entries below its length
    warp_of = torch.empty(rt.TILE * rt.TILE, dtype=torch.int64, device=blob.device)
    warp_of[warps.reshape(-1)] = torch.arange(warps.shape[0], device=blob.device
                                              ).repeat_interleave(warps.shape[1])
    kept_below = torch.cumsum(kept.to(torch.int32), dim=0)[
        torch.clamp_min(length - 1, 0), t, warp_of[None, :]]
    return {"evaluations": int(length.sum()),
            "kept_evaluations": int(torch.where(length > 0, kept_below, 0).sum()),
            "walked": int(walked.sum()),
            "no_pass": int((walked & ~passes).sum()), "blend": int((walked & blends).sum()),
            "culled": int((walked & ~kept).sum()),
            "culled_passing": int((walked & ~kept & passes).sum())}


def print_warp_counts(label, kernel, io, width, height):
    """forward_warp_counts as a [bound] line; fails if the band cull would
    skip an entry that some pixel of the warp takes."""
    w = forward_warp_counts(io, width, height)
    print(f"[bound] {label}: {kernel} per-pixel evaluations {w['evaluations']}, "
          f"{w['kept_evaluations']} of them in pairs the band cull keeps; the warps "
          f"walk {w['walked']} (entry, warp) pairs = {32 * w['walked']} evaluations, "
          f"{w['no_pass']} of the pairs with no pixel passing the alpha and near tests, "
          f"{w['blend']} with a pixel blending; the band cull skips {w['culled']} of "
          f"them, {w['culled_passing']} with a pixel passing (limit 0)")
    if w["culled_passing"]:
        fail(f"[bound] {label}: the band cull skips entries that a pixel takes")
    return w


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def forward_ops(w, blends):
    """K1's (K3's) float32 operations on a frame with forward_warp_counts
    `w`: the geometry of every evaluation in a pair the band cull keeps,
    the band test of every walked pair, and the blends."""
    return (OPS_PER_EVAL * w["kept_evaluations"] + OPS_PER_BAND_TEST * w["walked"]
            + OPS_PER_BLEND * blends)


def kernel_bounds(io, width, height):
    """{kernel: (bound_ms, bound_by, ops, bytes)} on this frame's inputs,
    each input read once and each output written once."""
    from gaussmart_tpu_torch.render import raster_tiled as rt
    blob, ids, ranges, fb, ints = (io[k] for k in ("blob", "ids", "ranges", "fb", "ints"))
    k2_evals, blends = walk_counts(blob, ids, ranges, ints, width, height)
    w = print_warp_counts("frame", "raster_fwd", io, width, height)
    plane = fb.shape[1] * fb.shape[2] * 4
    inputs = blob.numel() * 4 + ids.numel() * 4 + ranges.numel() * 4
    rows_bytes = ids.numel() * rt.F * 4
    k1 = (forward_ops(w, blends),
          inputs + io["conics"].numel() * 4 + (rt.CH + 2) * plane)
    # K2 reads A, T, M1, M2, n_contrib, med_e and the CT cotangent planes
    k2 = (OPS_PER_EVAL * k2_evals + (OPS_PER_BWD_STEP + rt.F) * blends,
          inputs + (4 + 2 + rt.CT) * plane + rows_bytes)
    # K5 as grad_reduce launches it: reduction_bytes, one add per element
    # of each walked row
    nbytes, walked, live = reduction_bytes(io)
    k5 = (walked * rt.F, nbytes)
    print(f"[bound] frame: segsum reads {walked} walked rows of {live} live slots "
          f"({nbytes} bytes)")
    print(f"[bound] frame: (entry, pixel) evaluations {k2_evals} below n_contrib in "
          f"raster_bwd, {blends} of them blended; raster_bwd's warps evaluate "
          f"{warp_walk_evals(ranges, ints, width, height)}")
    return report_bounds(("raster_fwd", "raster_bwd", "segsum"), (k1, k2, k5))


def report_bounds(names, works, show=True):
    out = {}
    for name, (ops, nbytes) in zip(names, works):
        out[name] = bound(ops, nbytes) + (ops, nbytes)
        if show:
            print(f"[bound] {name}: {ops:.4g} f32 ops, {nbytes:.4g} bytes -> "
                  f"{out[name][0]:.4f} ms, bound by {out[name][1]}")
    return out


def seeded_bounds(io, width, height, show=True):
    """{kernel: (bound_ms, bound_by, ops, bytes)} of K3 and K4 on the seeded
    stratum: K1's and K2's counts on its walk, plus the seed read (K3, K4),
    the two moment cotangent planes, K4's seeded terms per step and the
    seed gradient written per pixel. `show` prints the counts and bounds."""
    from gaussmart_tpu_torch.render import raster_tiled as rt
    blob, ids, ranges, fb, ints = (io[k] for k in ("blob", "ids", "ranges", "fb", "ints"))
    k4_evals, blends = walk_counts(blob, ids, ranges, ints, width, height)
    w = (print_warp_counts("seeded stratum", "raster_fwd_seeded", io, width, height) if show
         else forward_warp_counts(io, width, height))
    pixels = fb.shape[1] * fb.shape[2]
    plane = pixels * 4
    inputs = blob.numel() * 4 + ids.numel() * 4 + ranges.numel() * 4
    k3 = (forward_ops(w, blends),
          inputs + io["conics"].numel() * 4 + 3 * plane + (rt.CH + 2) * plane)
    # K4 reads A, T, M1, M2, n_contrib, med_e, the CT_SEEDED cotangent
    # planes and the seed, and writes the rows and the seed gradient
    k4 = (OPS_PER_EVAL * k4_evals + (OPS_PER_SEEDED_BWD_STEP + rt.F) * blends
          + OPS_PER_SEED_GRAD * pixels,
          inputs + (4 + 2 + rt.CT_SEEDED + 3) * plane + ids.numel() * rt.F * 4
          + 3 * plane)
    if show:
        print(f"[bound] seeded stratum: (entry, pixel) evaluations {k4_evals} below "
              f"n_contrib in raster_bwd_seeded, {blends} of them blended; "
              f"raster_bwd_seeded's warps evaluate "
              f"{warp_walk_evals(ranges, ints, width, height)}")
    return report_bounds(("raster_fwd_seeded", "raster_bwd_seeded"), (k3, k4), show)


def time_serving(state, cam, device, card):
    """The serving frame (render_arrays) and its stages; then the
    Gaussian-sharded frame over N_SLOTS slots."""
    import torch
    from gaussmart_tpu_torch.parallel.sharding import make_mesh
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.api import render_arrays
    zeros = torch.zeros(N_SPLATS, 2, device=device)
    mesh = make_mesh(N_SLOTS, device)

    def frame(**kw):
        return render_arrays(
            cam, xyz=state.params.xyz, scaling=state.get_scaling,
            rotation=state.params.rotation, opacity=state.get_opacity[:, 0],
            features=state.get_features, active=state.aux.active,
            sh_degree=SH_DEGREE, bg_color=torch.zeros(3, device=device), **kw)

    with torch.inference_mode():
        prep = frame_prep(state, cam, SH_DEGREE)
        prep_ms = time_ms(lambda: frame_prep(state, cam, SH_DEGREE), FRAMES)
        bin_ms = time_ms(lambda: (rt.build_blob(prep, zeros, WIDTH, HEIGHT),
                                  rt.binning(prep, *rt.tile_grid(WIDTH, HEIGHT))),
                         FRAMES)
        frame_ms = time_ms(frame, FRAMES)
        kernel_ms, top = device_kernel_ms(frame, FRAMES)
        # device time of the frame's stages, and of the binning's conic rows
        # on the frame and on one depth stratum (an mp step bins 4)
        stratum = seeded_stratum(prep, WIDTH, HEIGHT, 0)[0]
        stage_ms = {name: device_kernel_ms(fn, FRAMES) for name, fn in (
            ("preprocess", lambda: frame_prep(state, cam, SH_DEGREE)),
            ("build_blob+binning", lambda: (rt.build_blob(prep, zeros, WIDTH, HEIGHT),
                                            rt.binning(prep, *rt.tile_grid(WIDTH, HEIGHT)))),
            ("build_conics", lambda: rt.build_conics(prep)),
            ("build_conics on a stratum", lambda: rt.build_conics(stratum)))}
    print(f"[time] {card}: serving frame {WIDTH}x{HEIGHT}, {N_SPLATS} splats, "
          f"median of {FRAMES}: preprocess {prep_ms:.4f} ms, build_blob+binning "
          f"{bin_ms:.4f} ms, render_arrays frame {frame_ms:.4f} ms")
    print_device("serving frame", kernel_ms, top, frame_ms)
    print(f"[time] {card}: serving frame's stages, device kernel time per call "
          "(torch.profiler): " + "; ".join(
              f"{name} " + ("not measured" if ms is None else
                            f"{ms:.4f} ms in {sum(c for _, _, c in ranked):g} launches")
              for name, (ms, ranked) in stage_ms.items())
          + f" (binning builds the conic rows once per frame, and once for each of the "
          f"{N_SLOTS} strata of a Gaussian-sharded frame or mp step)")

    def sharded():
        return frame(backend="gaussian_sharded_pallas", mesh=mesh)
    with torch.inference_mode():
        sharded_ms = time_ms(sharded, FRAMES)
        kernel_ms, top = device_kernel_ms(sharded, FRAMES)
    print(f"[time] {card}: Gaussian-sharded serving frame over {N_SLOTS} slots on one "
          f"card, {WIDTH}x{HEIGHT}, {N_SPLATS} splats, median of {FRAMES}: "
          f"{sharded_ms:.4f} ms (single-device {frame_ms:.4f} ms)")
    print_device("Gaussian-sharded serving frame", kernel_ms, top, sharded_ms)


def time_training(state, cams, gts, card, mesh=None, dino_fn=None, first_iter=1):
    """make_train_step on bench.py's state, or with `mesh`
    make_mp_train_step (gaussian_sharded_pallas) on its per-slot chunks:
    iterations/s (median step of FRAMES, each step's output feeding the
    next, from iteration `first_iter`), the per-stage breakdown by CUDA
    events, and the device busy share from torch.profiler. `dino_fn`: the
    single-device step with the DINO term (its tower runs in "losses")."""
    import torch
    from gaussmart_tpu_torch.config import OptimizationParams
    from gaussmart_tpu_torch.optim import init_adam
    from gaussmart_tpu_torch.parallel.sharding import make_mp_train_step, shard_state
    from gaussmart_tpu_torch.train_lib import make_train_step
    stages = ("render", "losses", "backward", "adam")
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    kw = dict(sh_degree=SH_DEGREE, white_background=False, spatial_lr_scale=1.0,
              phase=mark)
    if mesh is None:
        step = make_train_step(OptimizationParams(), backend="auto", dino_fn=dino_fn, **kw)
        params, adam, aux = state.params, init_adam(state.params), state.aux
        what = "training step" + (" with the DINO term" if dino_fn else "")
    else:
        step = make_mp_train_step(OptimizationParams(), mesh,
                                  backend="gaussian_sharded_pallas", **kw)
        params, adam, aux = shard_state(state.params, init_adam(state.params), state.aux,
                                        mesh)
        what = f"Gaussian-sharded training step over {mesh.size} slots on one card"
    carry = {"params": params, "adam": adam, "aux": aux, "it": first_iter}

    def one():
        i = carry["it"]
        p, a, x, _, carry["it"] = step(carry["params"], carry["adam"], carry["aux"],
                                       cams[i % len(cams)], gts[i % len(cams)], i)
        carry.update(params=p, adam=a, aux=x)

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    wall, split = [], []
    for _ in range(FRAMES):
        events.clear()
        mark("start")
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        split.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    step_ms = float(np.median(wall))
    parts = np.median(np.array(split), axis=0)
    print(f"[time] {card}: {what}, {N_SPLATS} splats, {TRAIN_VIEWS} cameras "
          f"at {WIDTH}x{HEIGHT}, default OptimizationParams, median of {FRAMES} steps "
          f"{step_ms:.4f} ms = {1e3 / step_ms:.4f} iterations/s; by CUDA events: "
          + ", ".join(f"{s} {ms:.4f} ms" for s, ms in zip(stages, parts)))
    kernel_ms, top = device_kernel_ms(one, 5)
    print_device(what, kernel_ms, top, step_ms)
    # the compositor's kernels (K1/K2, or K3/K4 over slots) and K5
    for part, key in (("render", "raster_fwd_kernel"), ("backward", "raster_bwd_kernel"),
                      ("backward", "segsum_kernel")):
        ms = sum(t for name, t, _ in top if key in name)
        print(f"[time] {what}: {part} {parts[stages.index(part)]:.4f} ms, of which "
              f"{key} {ms:.4f} ms device time (torch.profiler)")
    return 1e3 / step_ms


def time_kernels(io, width, height):
    """{kernel: (ms, plain_ms, library_ms)} on one full-width frame."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render import segsum
    blob, ids, ranges, fb, ints, ct = (io[k] for k in
                                       ("blob", "ids", "ranges", "fb", "ints", "ct"))
    need = io["need"]
    args = (blob, ids, ranges, width, height)
    bargs = (blob, ids, ranges, fb, ints, ct, width, height) + tuple(need)
    k5 = reduction_inputs(io)
    with torch.inference_mode():
        out = {
            "raster_fwd": (time_ms(lambda: rt.composite_tiles(blob, io["conics"], ids,
                                                              ranges, width, height),
                                   FRAMES),
                           time_ms(lambda: rt.composite_tiles_plain(*args),
                                   PLAIN_FRAMES, warmup=1), None),
            "raster_bwd": (time_ms(lambda: rt.composite_tiles_bwd(*bargs), FRAMES),
                           time_ms(lambda: rt.composite_tiles_bwd_plain(*bargs),
                                   PLAIN_FRAMES, warmup=1), None),
            # K5 as grad_reduce launches it; its plain version on the card
            # (a loop over slot positions), torch.segment_reduce on the
            # rows already in slot order
            "segsum": (time_ms(lambda: segsum.segment_sum_gathered(*k5["k5"]), FRAMES),
                       time_ms(lambda: segsum.segment_sum_gathered_plain(*k5["k5"]),
                               PLAIN_FRAMES, warmup=1),
                       time_ms(lambda: torch.segment_reduce(
                           k5["rows_in_slots"], "sum", lengths=k5["lengths"], axis=0),
                           FRAMES)),
        }
    return out


def reduction_inputs(io):
    """K5's arguments on a frame's rows as grad_reduce passes them, and the
    rows in slot order with each splat's slot count
    (torch.segment_reduce's)."""
    import torch
    b, rows = io["binned"], io["rows"]
    n_rows = b.slot_starts.shape[0]
    live = int(b.slot_starts[-1])
    return {"k5": (rows, b.inv_slots, b.slot_starts, n_rows, b.slot_tile, io["limits"]),
            "rows_in_slots": rows[b.inv_slots[:live].to(torch.int64)].contiguous(),
            "lengths": (b.slot_starts[1:] - b.slot_starts[:-1]).to(torch.int64)}


def reduction_bytes(io):
    """(bytes, walked, live): what K5 must move on the frame (each input
    read once, each output written once): the walked rows (80 B each),
    order and slot_tile of every live slot (8 B), slot_starts and the walk
    limits read, one row per splat and the dummy row written."""
    from gaussmart_tpu_torch.render import raster_tiled as rt
    b, limits = io["binned"], io["limits"]
    walked = int((limits - b.tile_ranges[:, 0]).sum())
    live = int(b.slot_starts[-1])
    row = rt.F * 4
    table = b.slot_starts.numel() * 4
    out = b.slot_starts.numel() * row
    return walked * row + live * 8 + table + limits.numel() * 4 + out, walked, live


def time_reduction(io, card):
    """The per-splat reduction on the training frame's rows: K5 alone,
    grad_reduce whole (walk limits + K5) and torch.segment_reduce, each as
    the median of FRAMES calls by CUDA events (host work included where the
    card waits for it) and as device time per call by torch.profiler (K5's
    own kernel: kernel only), with K5's byte bound."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render import segsum
    k5 = reduction_inputs(io)
    b, rows, ints = io["binned"], io["rows"], io["ints"]
    nbytes, walked, live = reduction_bytes(io)
    calls = {"K5": lambda: segsum.segment_sum_gathered(*k5["k5"]),
             "grad_reduce": lambda: rt.grad_reduce(rows, b, ints),
             "torch.segment_reduce on the rows already in slot order":
                 lambda: torch.segment_reduce(k5["rows_in_slots"], "sum",
                                              lengths=k5["lengths"], axis=0)}
    parts = []
    with torch.inference_mode():
        for label, fn in calls.items():
            wall = time_ms(fn, FRAMES)
            device, top = device_kernel_ms(fn, FRAMES)
            own = [(ms, calls) for name, ms, calls in top if "segsum_kernel" in name]
            parts.append(f"{label} {wall:.4f} ms, device " + (
                "not measured" if device is None else
                f"{device:.4f} ms in {sum(c for _, _, c in top):g} launches"
                + "".join(f" (segsum_kernel {ms / calls:.4f} ms per launch)"
                          for ms, calls in own)))
    print(f"[time] {card}: per-splat reduction of the training frame's K2 rows "
          f"({live} live slots, {walked} below their tile's walk limit), median of "
          f"{FRAMES} by CUDA events and device time per call by torch.profiler: "
          + "; ".join(parts)
          + f"; K5's bound {bound(walked * rt.F, nbytes)[0]:.4f} ms ({nbytes} bytes: the "
          f"walked rows, 8 bytes of slot map per live slot, slot_starts, the walk "
          f"limits, the output)")


def time_seeded_kernels(io, width, height):
    """{kernel: (ms, plain_ms, None)} of K3 and K4 on the seeded stratum."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    blob, ids, ranges, fb, ints, ct, init = (
        io[k] for k in ("blob", "ids", "ranges", "fb", "ints", "ct", "init"))
    args = (blob, ids, ranges, width, height)
    bargs = (blob, ids, ranges, fb, ints, ct, width, height) + tuple(io["need"])
    with torch.inference_mode():
        return {
            "raster_fwd_seeded": (
                time_ms(lambda: rt.composite_tiles(blob, io["conics"], ids, ranges, width,
                                                   height, init=init), FRAMES),
                time_ms(lambda: rt.composite_tiles_plain(*args, init=init),
                        PLAIN_FRAMES, warmup=1), None),
            "raster_bwd_seeded": (
                time_ms(lambda: rt.composite_tiles_bwd(*bargs, init=init), FRAMES),
                time_ms(lambda: rt.composite_tiles_bwd_plain(*bargs, init=init),
                        PLAIN_FRAMES, warmup=1), None),
        }


def time_dist_med_bwd(io, width, height):
    """K2 (K4 when `io` holds a seed) in its (need_dist, need_med) = (True,
    True) variant, the one a loss with the distortion and median terms
    runs, on the same frame: median ms."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    args = tuple(io[k] for k in ("blob", "ids", "ranges", "fb", "ints", "ct"))
    with torch.inference_mode():
        return time_ms(lambda: rt.composite_tiles_bwd(*args, width, height, True, True,
                                                      init=io.get("init")), FRAMES)


def record_mp_launches(state, cams, gts, mesh):
    """One make_mp_train_step step on camera 0 with K3's and K4's wrappers
    recording their inputs: the 8 (pass, stratum) launches of the step as
    render_gaussian_sharded builds them (its depth strata, the identity
    seed of pass 1, the fold's seeds of pass 2) with the step's own
    cotangents. Returns [{blob, conics, ids, ranges, fb, ints, ct, init,
    need}] in launch order of the forward."""
    from gaussmart_tpu_torch.config import OptimizationParams
    from gaussmart_tpu_torch.optim import init_adam
    from gaussmart_tpu_torch.parallel.sharding import make_mp_train_step, shard_state
    from gaussmart_tpu_torch.render import raster_tiled as rt
    step = make_mp_train_step(OptimizationParams(), mesh,
                              backend="gaussian_sharded_pallas", sh_degree=SH_DEGREE,
                              white_background=False, spatial_lr_scale=1.0)
    params, adam, aux = shard_state(state.params, init_adam(state.params), state.aux, mesh)
    fwd, bwd = [], []
    kernels = rt.composite_tiles, rt.composite_tiles_bwd

    def fwd_rec(blob, conics, ids, ranges, width, height, init=None):
        out = kernels[0](blob, conics, ids, ranges, width, height, init=init)
        fwd.append(dict(blob=blob, conics=conics, ids=ids, ranges=ranges, fb=out[0],
                        ints=out[1], init=init))
        return out

    def bwd_rec(blob, ids, ranges, fb, ints, ct, width, height, need_dist, need_med,
                init=None):
        bwd.append(dict(fb=fb, ct=ct, need=(need_dist, need_med)))
        return kernels[1](blob, ids, ranges, fb, ints, ct, width, height, need_dist,
                          need_med, init=init)

    rt.composite_tiles, rt.composite_tiles_bwd = fwd_rec, bwd_rec
    try:
        step(params, adam, aux, cams[0], gts[0], 1)
    finally:
        rt.composite_tiles, rt.composite_tiles_bwd = kernels
    by_fb = {b["fb"].data_ptr(): b for b in bwd}
    launches = [dict(f, **by_fb[f["fb"].data_ptr()]) for f in fwd]
    if len(launches) != 2 * N_SLOTS or any(f["init"] is None for f in launches):
        fail(f"[step] recorded {len(fwd)} K3 and {len(bwd)} K4 launches of the mp step, "
             f"expected {2 * N_SLOTS} seeded ones each")
    return launches


def time_mp_launches(launches, width, height, card):
    """K3 and K4 on each of the mp step's 8 launches: time and bound per
    launch, and their sums per step."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    sums = {"raster_fwd_seeded": [0.0, 0.0], "raster_bwd_seeded": [0.0, 0.0]}
    for i, io in enumerate(launches):
        args = (io["blob"], io["ids"], io["ranges"])
        with torch.inference_mode():
            ms = {"raster_fwd_seeded": time_ms(
                      lambda: rt.composite_tiles(io["blob"], io["conics"], io["ids"],
                                                 io["ranges"], width, height,
                                                 init=io["init"]), FRAMES),
                  "raster_bwd_seeded": time_ms(
                      lambda: rt.composite_tiles_bwd(*args, io["fb"], io["ints"], io["ct"],
                                                     width, height, *io["need"],
                                                     init=io["init"]), FRAMES)}
        bounds = seeded_bounds(io, width, height, show=False)
        for k in sums:
            sums[k][0] += ms[k]
            sums[k][1] += bounds[k][0]
        t0 = io["init"][0, :height, :width]
        print(f"[step] {card}: mp step, camera 0, pass {i // N_SLOTS + 1} stratum "
              f"{i % N_SLOTS + 1} of {N_SLOTS} ({int(io['ranges'][-1, 1])} (splat, tile) "
              f"pairs, seed T0 mean {t0.mean().item():.4f}): "
              + "; ".join(f"{k} {ms[k]:.4f} ms, bound {bounds[k][0]:.4f} ms "
                          f"({bounds[k][1]})" for k in sums))
    print(f"[step] {card}: per mp step ({2 * N_SLOTS} launches each, median of {FRAMES} "
          "per launch): " + "; ".join(f"{k} {t:.4f} ms, bound {b:.4f} ms"
                                      for k, (t, b) in sums.items()))
    return sums


# --- the trajectory videos (phase 12) ----------------------------------------------

def read_tiff_f32(path) -> np.ndarray:
    """The [H, W] float32 image of a one-strip TIFF as io/images.write_tiff_f32
    writes it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian TIFF")
    ifd = struct.unpack_from("<I", data, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        tag, typ, _, val = struct.unpack_from("<HHII", data, ifd + 2 + 12 * i)
        tags[tag] = val & 0xFFFF if typ == 3 else val
    return np.frombuffer(data, "<f4", tags[256] * tags[257], tags[273]).reshape(
        tags[257], tags[256])


def traj_frames(traj, n=TRAJ_FRAMES):
    """{video name: uint8 [n, H, W, 3]} rebuilt from what export_image wrote
    in traj/: renders/*.png, vis/normal_*.png, and vis/depth_*.tiff through
    render_cli's mapping (trajectory.depth_video_frames), quantized as
    create_video quantizes (trajectory.frames_u8)."""
    from gaussmart_tpu_torch.io.images import read_png
    from gaussmart_tpu_torch.trajectory import depth_video_frames, frames_u8

    def pngs(fmt):
        return np.stack([read_png(os.path.join(traj, fmt.format(i))) for i in range(n)])

    depths = [read_tiff_f32(os.path.join(traj, "vis", f"depth_{i:05d}.tiff"))
              for i in range(n)]
    return {"render_traj.mp4": pngs("renders/{:05d}.png"),
            "depth_traj.mp4": frames_u8(depth_video_frames(depths)),
            "normal_traj.mp4": pngs("vis/normal_{:05d}.png")}


def video_fixture_digests():
    """[(label, sha256 of the port's file, the committed sha256)] for each
    fixture of tests/torch_data/video/digests.json."""
    from gaussmart_tpu_torch.io import video
    with open(os.path.join(VIDEO_DATA, "digests.json")) as f:
        spec = json.load(f)
    return [(f"{c['frames']} frames at {c['width']}x{c['height']}",
             hashlib.sha256(video.video_bytes(video_fixture(c["frames"], c["height"],
                                                            c["width"]),
                                              spec["fps"])).hexdigest(),
             c["sha256"]) for c in spec["cases"]]


def render_path_videos(model, device, card):
    """render_cli --render_path --skip_train --skip_test --skip_mesh on the
    phase-4 model, counted (K1 once per trajectory frame) and timed (its
    stages by the host clock; each K1 call between CUDA events); the three
    videos read back as TRAJ_FRAMES I-VOPs at the trajectory's size and
    TRAJ_FPS, each equal to the byte to its re-encode from the exported
    files (the encoder timed there); then the fixtures' digests."""
    import torch
    from gaussmart_tpu_torch import render_cli
    from gaussmart_tpu_torch.io import video
    from gaussmart_tpu_torch.mesh.extract import GaussianExtractor
    from gaussmart_tpu_torch.render import raster_tiled as rt
    walls = {"reconstruction": 0.0, "export_image": 0.0, "create_video": 0.0}
    k1 = []

    def add(name):
        def after(_args, _out, seconds):
            walls[name] += seconds
        return after

    def between_events(orig):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            k1.append((start, end))
            return out
        return call

    zero_counts()
    t0 = time.perf_counter()
    with wrapped(GaussianExtractor, "reconstruction", add("reconstruction")), \
            wrapped(GaussianExtractor, "export_image", add("export_image")), \
            wrapped(render_cli, "create_video", add("create_video")), \
            replaced(rt, "composite_tiles", between_events):
        ex = render_cli.main(["-m", model, "--render_path", "--skip_train", "--skip_test",
                              "--skip_mesh", "--device", str(device)])
    counts = read_counts()
    cli_s = time.perf_counter() - t0
    k1_ms = [a.elapsed_time(b) for a, b in k1]
    cam = ex.viewpoint_stack[0]
    finite = all(bool(torch.isfinite(m).all())
                 for m in ex.rgbmaps + ex.depthmaps + ex.normalmaps)
    covered = float(np.mean([(d > 0).float().mean().item() for d in ex.depthmaps]))
    print(f"[video] {card}: render_cli --render_path rendered {len(ex.rgbmaps)} trajectory "
          f"frames at {cam.width}x{cam.height} and wrote the three videos in {cli_s:.3f} s: "
          f"reconstruction {walls['reconstruction']:.3f} s, export_image "
          f"{walls['export_image']:.3f} s, create_video x3 {walls['create_video']:.3f} s; "
          f"launches {counts}; K1 through its wrapper on the path (CUDA events) median "
          f"{np.median(k1_ms):.4f} ms, min {min(k1_ms):.4f}, max {max(k1_ms):.4f}, sum "
          f"{sum(k1_ms):.2f} ms; finite {finite}; pixels with depth > 0 {covered:.3f}")
    ok = (only(counts, raster_fwd=TRAJ_FRAMES, preprocess_fwd=TRAJ_FRAMES)
          and len(k1_ms) == TRAJ_FRAMES and finite
          and (cam.width, cam.height) == (WIDTH, HEIGHT))
    traj = os.path.join(model, "traj", f"ours_{ITERATION}")
    t0 = time.perf_counter()
    frames = traj_frames(traj)
    print(f"[video] the exported files read back and mapped in {time.perf_counter() - t0:.3f} s")
    for name in VIDEO_NAMES:
        path = os.path.join(traj, name)
        info = video.read_mp4_info(path)
        u8 = frames[name]
        t0 = time.perf_counter()
        vol, vops = video.encode_mp4v(u8, TRAJ_FPS)
        enc_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            same = f.read() == video.mp4_bytes(vol, vops, u8.shape[2], u8.shape[1], TRAJ_FPS)
        size = os.path.getsize(path)
        print(f"[video] {card}: {name}: {info['codec']}, {info['n_samples']} I-VOPs at "
              f"{info['width']}x{info['height']}, {info['fps']} fps, profile_and_level "
              f"0x{info['profile_level']:02x}; {size} bytes ({size / len(u8):.1f} per frame, "
              f"VOPs {min(info['sample_sizes'])}-{max(info['sample_sizes'])}); re-encoded from "
              f"the exported files: byte-equal {same}, encode {1e3 * enc_s / len(u8):.3f} ms "
              "per frame (one host thread)")
        ok = ok and same and info["codec"] == "mp4v" and info["n_samples"] == TRAJ_FRAMES \
            and (info["width"], info["height"]) == (WIDTH, HEIGHT) \
            and info["fps"] == TRAJ_FPS and u8.shape == (TRAJ_FRAMES, HEIGHT, WIDTH, 3)
    for label, got, want in video_fixture_digests():
        print(f"[video] fixture {label}: sha256 {got}, committed {want}, equal {got == want}")
        ok = ok and got == want
    if not ok:
        fail("[video] check failed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")

    # 1. the card
    card = card_line()
    print(f"[card] {card} | torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. build from the checkout's sources, never from an earlier build
    t_run = time.perf_counter()
    build_all()
    t_phase = phase_wall("2 (builds)", t_run)

    # 3. kernels vs plain versions; tiled vs the dense oracle
    cam_s, arrays = small_scene(dev)
    prep_small = small_prep(cam_s, arrays, dev)
    both = [(True, True), (False, False)]
    errs, _ = compare_kernels(prep_small, cam_s.width, cam_s.height, "small 64x32", both)
    errs = worst(errs, compare_seeded(prep_small, cam_s.width, cam_s.height,
                                      "small 64x32", both)[0])
    tiled_vs_dense(dev)
    state_t, cams_t, gts_t = bench_state(args.seed, N_SPLATS, WIDTH, HEIGHT, dev)
    backward_determinism(state_t, cams_t, gts_t, dev)
    # the training step's frame: camera 0, SH bands above degree 0 masked
    # (iterations below 1000), no distortion or median terms in K2 and K4
    prep_t = frame_prep(state_t, cams_t[0], SH_DEGREE, active_degree=0)
    label_t = "full 776x584 training frame"
    # the training default (False, False) last: its tensors are timed
    errs_t, io_t = compare_kernels(prep_t, WIDTH, HEIGHT, label_t, both)
    # the Gaussian-sharded step's two shapes: pass 1 (identity seed, where
    # most of its K3/K4 time goes) and pass 2 (the fold's seed)
    e_pass1, io_pass1 = compare_seeded(prep_t, WIDTH, HEIGHT, label_t, both, k=0)
    e_pass2, io_pass2 = compare_seeded(prep_t, WIDTH, HEIGHT, label_t, both)
    errs = worst(errs, errs_t, e_pass1, e_pass2)
    t_phase = phase_wall("3 (kernels vs plain)", t_phase)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        # 4. the serving path
        t0 = time.perf_counter()
        model, cams, params = write_model_dir(root, args.seed, N_SPLATS, WIDTH,
                                              HEIGHT, N_VIEWS)
        print(f"[scene] {N_SPLATS} splats, SH {SH_DEGREE}, {N_VIEWS} views at "
              f"{WIDTH}x{HEIGHT} written in {time.perf_counter() - t0:.1f} s")
        state_s = state_from_numpy(params, np.ones(N_SPLATS, bool),
                                   np.zeros(N_SPLATS, np.int32), SH_DEGREE,
                                   SH_DEGREE, 1.0, device=dev)
        prep_s = frame_prep(state_s, cams[0].params(dev), SH_DEGREE)
        label_s = "full 776x584 serving frame"
        e_s, _ = compare_kernels(prep_s, WIDTH, HEIGHT, label_s, [(True, True)])
        errs = worst(errs, e_s, compare_seeded(prep_s, WIDTH, HEIGHT, label_s,
                                               [(True, True)])[0])
        _, ex_single = serve(model, state_s, dev)
        serve_sharded(model, ex_single, dev)
        row_sharded_render(dev)
        t_phase = phase_wall("4 (serving)", t_phase)

        # 13. the no-grad render's fused preprocess (K6)
        k6_err, k6_times, k6_bound = fused_preprocess_path(state_s, cams, args.seed, dev,
                                                           card)
        errs["preprocess_fwd"] = k6_err
        t_phase = phase_wall("13 (fused preprocess)", t_phase)

        # 14. the binning kernel (K7)
        k7_times, k7_bound = binning_path(state_s, cams, args.seed, dev, card)
        errs["binning"] = 0.0
        t_phase = phase_wall("14 (binning)", t_phase)

        # 5. the training paths
        counts, losses = train_path(root, args.seed, N_SPLATS, WIDTH, HEIGHT, dev)
        mp_counts = train_slots_path(root, dev, losses)
        t_phase = phase_wall("5 (training)", t_phase)

        # 8. the DINO tower and term; the viewer
        phase8 = dino_viewer_path(root, args.seed, model, cams, state_s, state_t, cams_t,
                                  gts_t, dev)
        t_phase = phase_wall("8 (DINO, viewer)", t_phase)

        # 12. render_cli --render_path on the phase-4 model: the trajectory videos
        render_path_videos(model, dev, card)
        t_phase = phase_wall("12 (render_path videos)", t_phase)

    # 6. timings
    time_serving(state_s, cams[0].params(dev), dev, card)
    ips = time_training(state_t, cams_t, gts_t, card)
    from gaussmart_tpu_torch.parallel.sharding import make_mesh
    mp_ips = time_training(state_t, cams_t, gts_t, card, mesh=make_mesh(N_SLOTS, dev))
    times = time_kernels(io_t, WIDTH, HEIGHT)
    times.update(time_seeded_kernels(io_pass1, WIDTH, HEIGHT))
    bounds = kernel_bounds(io_t, WIDTH, HEIGHT)
    bounds.update(seeded_bounds(io_pass1, WIDTH, HEIGHT))
    pass2 = time_seeded_kernels(io_pass2, WIDTH, HEIGHT)
    pass2_bounds = seeded_bounds(io_pass2, WIDTH, HEIGHT)
    print(f"[time] {card}: need_dist/need_med (True, True) on the same frames, median "
          f"of {FRAMES}: raster_bwd {time_dist_med_bwd(io_t, WIDTH, HEIGHT):.4f} ms "
          f"(training frame); raster_bwd_seeded "
          f"{time_dist_med_bwd(io_pass1, WIDTH, HEIGHT):.4f} ms (pass 1's stratum 1)")
    time_mp_launches(record_mp_launches(state_t, cams_t, gts_t, make_mesh(N_SLOTS, dev)),
                     WIDTH, HEIGHT, card)
    time_reduction(io_t, card)
    time_dino_viewer(*phase8, state_t, cams_t, gts_t, card)
    t_phase = phase_wall("6 (timings)", t_phase)

    # 7. the mesh export and evaluation paths, after the timings above so
    # that their host and device work does not run beside them
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as root:
        ex_mesh, mesh_geo, mesh_walls, evals = mesh_path(root, args.seed, dev)
    time_mesh(ex_mesh, mesh_geo, mesh_walls, evals, card, dev)
    t_phase = phase_wall("7 (mesh, eval)", t_phase)

    # 9. semantic preprocessing and train --run_segmentation
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sem_") as root:
        semantics_path(root, args.seed, dev, card)
    t_phase = phase_wall("9 (semantics)", t_phase)

    # 10. JPEG photos: the codec against Pillow's digests, the 360-layout scene
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_") as root:
        jpeg_path(root, args.seed, dev, card)
    t_phase = phase_wall("10 (JPEG)", t_phase)

    # 11. the paper's evaluation path: every benchmark driver's chain started,
    # then beside them the validation scene at full width, SYNTH_ITERS
    # iterations of the default schedule, mesh and scores
    with tempfile.TemporaryDirectory(prefix="chip_smoke_synthetic_") as root:
        drivers = start_drivers(root, args.seed, dev)
        try:
            synthetic_path(root, dev, card, beside=BESIDE_DRIVERS)
        finally:
            finish_drivers(drivers, card, beside=BESIDE_SYNTHETIC)
    phase_wall("11 (evaluation path)", t_phase)
    print(f"[phase] the whole run so far: {time.perf_counter() - t_run:.1f} s")

    def listed(ts):
        return "; ".join(f"{k} {ms:.4f} ms, plain {p:.4f} ms"
                         + (f", torch.segment_reduce {lib:.4f} ms" if lib else "")
                         for k, (ms, p, lib) in ts.items())
    print(f"[time] {card}: kernels on the full-width training frame (the seeded ones "
          f"on its first depth stratum of {N_SLOTS} from the identity seed, as in "
          f"pass 1), median of {FRAMES} ({PLAIN_FRAMES} for the compositors' plain "
          f"versions): {listed(times)}")
    print(f"[time] {card}: the seeded kernels on pass 2's shape (stratum 2, seeded by "
          f"stratum 1): {listed(pass2)}; bounds "
          + ", ".join(f"{k} {b[0]:.4f} ms ({b[1]})" for k, b in pass2_bounds.items()))
    print(f"[time] card during the run: {card_state()}")
    print(f"[result] {card}: {ips:.4f} training iterations/s at {N_SPLATS} splats, "
          f"{WIDTH}x{HEIGHT}; Gaussian-sharded over {N_SLOTS} slots on the one card "
          f"{mp_ips:.4f} iterations/s")

    # each kernel's launches on its main path: K1/K2/K5 in single-device
    # training, K3/K4 in Gaussian-sharded training
    launches = {"raster_fwd": counts["raster_fwd"], "raster_bwd": counts["raster_bwd"],
                "segsum": counts["segsum"],
                "raster_fwd_seeded": mp_counts["raster_fwd_seeded"],
                "raster_bwd_seeded": mp_counts["raster_bwd_seeded"],
                "preprocess_fwd": counts["preprocess_fwd"], "binning": counts["binning"]}
    times["preprocess_fwd"], bounds["preprocess_fwd"] = k6_times, k6_bound
    times["binning"], bounds["binning"] = k7_times, k7_bound
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda",
        "source": f"gaussmart_tpu_torch/csrc/{src}.cu", "replaces": replaces,
        "launches": launches[k], "max_abs_err": errs[k],
        "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": bounds[k][0],
        "bound_by": bounds[k][1], "library_ms": times[k][2]}
        for k, (src, replaces) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
