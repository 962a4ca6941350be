#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure exits non-zero:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the kernel from csrc/ with nvcc (sm_90a), timed;
  3. each kernel against its plain PyTorch version on the same inputs, at
     the tests' small scene and at one camera of the full-width scene,
     plus the tiled render against the dense oracle on the small scene;
  4. the main path: a trained-model directory (100k splats, SH degree 3,
     8 views at 776x584, made from --seed) rendered by
     gaussmart_tpu_torch.render_cli on the card, with the kernels' launch
     counts zeroed just before and read just after; its saved renders
     held against in-memory renders of the same splats, and its loaded
     splats rendered for the mean alpha;
  5. full-width timings with CUDA events (median over FRAMES calls after
     warm-up): each kernel, its plain version, preprocess + binning, and
     one whole render_arrays frame; each kernel's bound from this run's
     inputs.
The last lines are the kernels JSON, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
gaussmart_tpu_torch package beside it, it fails before printing a result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# The full-width configuration: the DTU-scale scene of bench.py
WIDTH, HEIGHT, N_SPLATS, SH_DEGREE, N_VIEWS = 776, 584, 100_000, 3, 8
FOVX, FOVY = 1.2, 0.9
ITERATION = 30000
FRAMES = 20               # timed calls per measurement (median)
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# float32 operations of raster_fwd (csrc/raster_fwd.cu), counted from its
# source: per (entry, pixel) evaluation up to the alpha test, and per
# entry a pixel blends
OPS_PER_EVAL = 50
OPS_PER_BLEND = 39
FLOAT_TOL = 1e-4          # kernel vs plain, every float channel
INT_AGREE = 0.999         # kernel vs plain, n_contrib / med_e pixel share
PNG_TOL = 1               # saved render vs in-memory render, 8-bit levels


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bench_cameras(n_views, width, height):
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
                           fovy=FOVY, width=width, height=height))
    return cams


def scene_params(seed, n, sh_degree):
    """bench.py's splat distribution: centres uniform in [-1,1]^2 x [2,5],
    3-NN log-scales, random unit quaternions, bimodal opacity (60% in
    [0.7, 0.99], the rest in [0.05, 0.3]), random colours and f_rest of
    scale 0.1 so every SH band is exercised."""
    from gaussmart_tpu_torch.models.gaussians import mean_sq_dist_to_3nn
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(2.0, 5.0, n)], axis=1).astype(np.float32)
    dist2 = np.maximum(mean_sq_dist_to_3nn(xyz), 1e-7)
    scaling = np.log(np.sqrt(dist2))[:, None].repeat(2, axis=1)
    q = rng.normal(size=(n, 4))
    op = np.where(rng.random(n) < 0.6, rng.uniform(0.7, 0.99, n),
                  rng.uniform(0.05, 0.3, n))
    k = (sh_degree + 1) ** 2
    return {
        "xyz": xyz,
        "features_dc": rgb2sh(rng.random((n, 1, 3))),
        "features_rest": rng.normal(0.0, 0.1, (n, k - 1, 3)),
        "scaling": scaling,
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "opacity": np.log(op / (1 - op))[:, None],
    }


def write_model_dir(root, seed, n, width, height, n_views):
    """A trained-model directory: COLMAP text source with GT PNGs, the
    snapshot at point_cloud/iteration_30000, and cfg_args.json."""
    from gaussmart_tpu_torch.cameras import fov2focal
    from gaussmart_tpu_torch.io import colmap
    from gaussmart_tpu_torch.io.gaussian_ply import save_gaussian_ply
    from gaussmart_tpu_torch.io.images import write_png
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy

    src, model = os.path.join(root, "scene"), os.path.join(root, "model")
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    params = scene_params(seed, n, SH_DEGREE)
    state = state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32),
                             SH_DEGREE, SH_DEGREE, 1.0, device="cpu")
    save_gaussian_ply(os.path.join(model, "point_cloud", f"iteration_{ITERATION}",
                                   "point_cloud.ply"), state)

    cams = bench_cameras(n_views, width, height)
    colmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), {
        1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array([
            fov2focal(FOVX, width), fov2focal(FOVY, height),
            width / 2, height / 2]))})
    colmap.write_images_text(os.path.join(sparse, "images.txt"), {
        c.uid + 1: colmap.ColmapImage(c.uid + 1, colmap.rotmat2qvec(c.R.T),
                                      np.asarray(c.T), 1, f"{c.image_name}.png")
        for c in cams})
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i, p in enumerate(params["xyz"][:1000]):
            f.write(f"{i + 1} {p[0]} {p[1]} {p[2]} 128 128 128 0.5\n")
    yy, xx = np.mgrid[0:height, 0:width]
    for i, c in enumerate(cams):
        gt = np.stack([xx * 255 // width, yy * 255 // height,
                       np.full_like(xx, 32 * i)], axis=-1).astype(np.uint8)
        write_png(os.path.join(src, "images", f"{c.image_name}.png"), gt)
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump({"source_path": src, "model_path": model,
                   "sh_degree": SH_DEGREE, "images": "images",
                   "resolution": -1, "white_background": False,
                   "eval": False, "backend": "auto"}, f, indent=2)
    return model, cams, params


def small_scene(device):
    """The tests' scene: 30 splats at 64x32 seen from the origin."""
    import torch
    from gaussmart_tpu_torch.cameras import Camera
    from gaussmart_tpu_torch.ops.sh import rgb2sh
    from gaussmart_tpu_torch.render.raster_common import preprocess
    rng = np.random.default_rng(0)
    n = 30
    cam = Camera(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                 T=np.zeros(3), fovx=0.8, fovy=0.8, width=64, height=32)
    xyz = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(2.0, 4.0, n)], axis=1)
    scales = 0.15 * rng.uniform(0.5, 1.5, (n, 2))
    quats = rng.normal(size=(n, 4))
    shs = rgb2sh(rng.random((n, 1, 3)))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    prep = preprocess(t(xyz), t(scales), t(quats), t(np.full(n, 0.8)), t(shs),
                      torch.ones(n, dtype=torch.bool, device=device),
                      cam.params(device), sh_degree=0)
    return cam, prep


def full_prep(params, cam, device):
    import torch
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy
    from gaussmart_tpu_torch.render.raster_common import preprocess
    n = params["xyz"].shape[0]
    st = state_from_numpy(params, np.ones(n, bool), np.zeros(n, np.int32),
                          SH_DEGREE, SH_DEGREE, 1.0, device=device)
    prep = preprocess(st.params.xyz, st.get_scaling, st.params.rotation,
                      st.get_opacity[:, 0], st.get_features, st.aux.active,
                      cam.params(device), sh_degree=SH_DEGREE)
    return st, prep


def compare_k1(prep, width, height, label):
    """raster_fwd vs composite_tiles_plain on the same binned lists."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    n = prep.depth.shape[0]
    tx, ty = rt.tile_grid(width, height)
    blob = rt.build_blob(prep, torch.zeros(n, 2, device=prep.depth.device),
                         width, height)
    ids, ranges = rt.binning(prep, tx, ty)
    fb_k, ints_k = rt.composite_tiles(blob, ids, ranges, width, height)
    fb_p, ints_p = rt.composite_tiles_plain(blob, ids, ranges, width, height)
    if blob.is_cuda:
        torch.cuda.synchronize()
    err = (fb_k - fb_p).abs().amax(dim=(1, 2))
    agree = [(ints_k[i] == ints_p[i]).float().mean().item() for i in range(2)]
    worst = err.max().item()
    finite = bool(torch.isfinite(fb_k).all())
    print(f"[compare] {label}: pairs {int(ranges[-1, 1])}, max|err| per channel "
          + " ".join(f"{c}={e:.3g}" for c, e in zip(rt.FB_CHANNELS, err.tolist()))
          + f"; n_contrib equal {agree[0]:.6f}, med_e equal {agree[1]:.6f}")
    if not (finite and worst <= FLOAT_TOL and min(agree) >= INT_AGREE):
        raise SystemExit(f"[compare] {label}: kernel disagrees with its plain "
                         f"version (max err {worst}, int agreement {agree}, "
                         f"finite {finite}; limits {FLOAT_TOL}, {INT_AGREE})")
    return worst, (blob, ids, ranges, fb_k, ints_k)


def card_state() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "power.limit,temperature.gpu", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()


def device_kernel_ms(fn, frames):
    """Device kernel milliseconds per call of fn and the top kernels by
    device time, from torch.profiler over `frames` calls; (None, []) when
    the profiler records no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    if not events or total_us <= 0:
        return None, []
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return total_us / 1e3 / frames, [(e.key, e.self_device_time_total / 1e3 / frames,
                                      e.count // frames) for e in top]


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


def k1_bound(prep, ids, ranges, fb, ints, width, height):
    """(bound_ms, bound_by, ops, bytes) of raster_fwd on this run's inputs:
    each pixel evaluates its tile's entries up to the one that terminates
    it (n_contrib + 1 where it terminated, mt < T_EPS) or all of them, and
    blends at most n_contrib entries."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.raster_common import T_EPS
    tx, ty = rt.tile_grid(width, height)
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    per_pixel = counts.reshape(ty, 1, tx, 1).expand(ty, rt.TILE, tx, rt.TILE)
    per_pixel = per_pixel.reshape(ty * rt.TILE, tx * rt.TILE)
    n_contrib = ints[0].to(torch.int64)
    ended = fb[rt.FB_CHANNELS.index("mt")] < T_EPS
    evals = torch.where(ended, torch.minimum(n_contrib + 1, per_pixel), per_pixel)
    ops = OPS_PER_EVAL * evals.sum().item() + OPS_PER_BLEND * n_contrib.sum().item()
    n_entries = int(ranges[-1, 1])
    nbytes = (prep.depth.shape[0] + 1) * rt.F * 4 + n_entries * 4 \
        + ranges.numel() * 4 + fb.numel() * 4 + ints.numel() * 4
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from gaussmart_tpu_torch import kernels, render_cli
    from gaussmart_tpu_torch.io.images import read_png
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.render.api import render, render_arrays
    from gaussmart_tpu_torch.render.raster_common import preprocess
    from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")

    # 1. the card
    card = card_line()
    print(f"[card] {card} | torch: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. build from the checkout's sources, never from an earlier build
    kernels.library_path("raster_fwd").unlink(missing_ok=True)
    t0 = time.perf_counter()
    log = kernels.build("raster_fwd")
    print(f"[build] raster_fwd built with nvcc {' '.join(kernels.NVCC_FLAGS)} "
          f"in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] raster_fwd: {line.strip()}")

    # 3. kernels vs plain versions; tiled vs the dense oracle
    cam_s, prep_s = small_scene(dev)
    err_small, _ = compare_k1(prep_s, cam_s.width, cam_s.height, "small 64x32")
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    zeros = torch.zeros(prep_s.depth.shape[0], 2, device=dev)
    tiled = rt.rasterize_tiled(prep_s, zeros, bg, cam_s.width, cam_s.height)
    dense = rasterize_pixels(prep_s, zeros, bg, cam_s.width, cam_s.height, chunk=8)
    d_img = (tiled["image"] - dense["image"]).abs().max().item()
    print(f"[compare] small tiled vs dense oracle: image max|err| {d_img:.3g}")
    if not d_img <= 6e-3:
        raise SystemExit("[compare] tiled render disagrees with the dense oracle")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        model, cams, params = write_model_dir(root, args.seed, N_SPLATS, WIDTH,
                                              HEIGHT, N_VIEWS)
        print(f"[scene] {N_SPLATS} splats, SH {SH_DEGREE}, {N_VIEWS} views at "
              f"{WIDTH}x{HEIGHT} written in {time.perf_counter() - t0:.1f} s")
        state, prep_f = full_prep(params, cams[0], dev)
        err_full, k1_io = compare_k1(prep_f, WIDTH, HEIGHT, "full 776x584 camera 0")

        # 4. the main path, counted
        rt.launches = 0
        t0 = time.perf_counter()
        ex = render_cli.main(["-m", model, "--skip_mesh", "--device", "cuda"])
        torch.cuda.synchronize()
        k1_launches = rt.launches
        cli_s = time.perf_counter() - t0
        out_dir = os.path.join(model, "train", f"ours_{ITERATION}")
        renders = [read_png(os.path.join(out_dir, "renders", f"{i:05d}.png"))
                   for i in range(len(ex.viewpoint_stack))]
        finite = all(bool(torch.isfinite(m).all())
                     for m in ex.rgbmaps + ex.depthmaps + ex.normalmaps)
        # What render_cli wrote, against the same cameras rendered from the
        # splats held in memory (never through the PLY); and the mean alpha
        # of the splats render_cli loaded back from point_cloud.ply.
        png_err, alpha = [], []
        with torch.inference_mode():
            for cam, png in zip(ex.viewpoint_stack, renders):
                ref = render(cam.params(dev), state, ex.bg)["render"]
                ref = np.clip(ref.permute(1, 2, 0).cpu().numpy() * 255, 0, 255)
                png_err.append(int(np.abs(png.astype(np.int16)
                                          - ref.astype(np.uint8)).max()))
                alpha.append(render(cam.params(dev), ex.state, ex.bg)
                             ["rend_alpha"].mean().item())
        print(f"[main path] render_cli rendered {len(renders)} views in "
              f"{cli_s:.2f} s; raster_fwd launches {k1_launches}; renders "
              f"{renders[0].shape}; finite {finite}; saved render vs in-memory "
              f"render max|diff| (8-bit levels) {max(png_err)}; mean rend_alpha "
              "of the loaded splats " + " ".join(f"{a:.3f}" for a in alpha))
        if not (k1_launches == N_VIEWS and len(renders) == N_VIEWS and finite
                and all(r.shape == (HEIGHT, WIDTH, 3) for r in renders)
                and max(png_err) <= PNG_TOL and float(np.mean(alpha)) > 0.5):
            raise SystemExit("[main path] check failed")

    # 5. full-width timings on camera 0
    blob, ids, ranges, fb, ints = k1_io
    cam0 = cams[0].params(dev)
    zeros_f = torch.zeros(N_SPLATS, 2, device=dev)

    def prep():
        return preprocess(state.params.xyz, state.get_scaling, state.params.rotation,
                          state.get_opacity[:, 0], state.get_features,
                          state.aux.active, cam0, sh_degree=SH_DEGREE)

    def frame():
        return render_arrays(
            cam0, xyz=state.params.xyz, scaling=state.get_scaling,
            rotation=state.params.rotation, opacity=state.get_opacity[:, 0],
            features=state.get_features, active=state.aux.active,
            sh_degree=SH_DEGREE, bg_color=torch.zeros(3, device=dev))

    with torch.inference_mode():
        k1_ms = time_ms(lambda: rt.composite_tiles(blob, ids, ranges, WIDTH, HEIGHT),
                        FRAMES)
        plain_ms = time_ms(lambda: rt.composite_tiles_plain(blob, ids, ranges,
                                                            WIDTH, HEIGHT), FRAMES)
        prep_ms = time_ms(prep, FRAMES)
        bin_ms = time_ms(lambda: (rt.build_blob(prep_f, zeros_f, WIDTH, HEIGHT),
                                  rt.binning(prep_f, *rt.tile_grid(WIDTH, HEIGHT))),
                         FRAMES)
        frame_ms = time_ms(frame, FRAMES)
        kernel_ms, top = device_kernel_ms(frame, FRAMES)
    bound_ms, bound_by, ops, nbytes = k1_bound(prep_f, ids, ranges, fb, ints,
                                               WIDTH, HEIGHT)
    print(f"[time] {card}: full width {WIDTH}x{HEIGHT}, {N_SPLATS} splats, "
          f"{int(ranges[-1, 1])} (splat, tile) pairs, median of {FRAMES}: "
          f"raster_fwd {k1_ms:.4f} ms, plain {plain_ms:.4f} ms, preprocess "
          f"{prep_ms:.4f} ms, build_blob+binning {bin_ms:.4f} ms, render_arrays "
          f"frame {frame_ms:.4f} ms")
    if kernel_ms is None:
        print("[time] device kernel time per frame: not measured (the profiler "
              "recorded no device events)")
    else:
        print(f"[time] device kernel time per frame {kernel_ms:.4f} ms (torch.profiler, "
              f"{FRAMES} frames) = {kernel_ms / frame_ms:.3f} of the frame; top: "
              + "; ".join(f"{name[:60]} {ms:.4f} ms x{calls}" for name, ms, calls in top))
    print(f"[time] card during the run: {card_state()}")
    print(f"[bound] raster_fwd: {ops:.4g} f32 ops, {nbytes:.4g} bytes -> "
          f"{bound_ms:.4f} ms, bound by {bound_by}")

    print(json.dumps({"kernels": [{
        "name": "raster_fwd", "route": "cuda",
        "source": "gaussmart_tpu_torch/csrc/raster_fwd.cu",
        "replaces": "gaussmart_tpu/render/raster_pallas.py:327",
        "launches": k1_launches, "max_abs_err": max(err_small, err_full),
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
