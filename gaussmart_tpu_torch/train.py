"""Training CLI — ``python -m gaussmart_tpu_torch.train -s <scene> -m <out> ...``.

The flags, schedule and outputs of gaussmart_tpu/train.py: 30k
iterations, densify every 100 in (500, 15000), opacity reset every 3000
(and at densify_from_iter on a white background), the SH degree raised
every 1000, test/save at {7000, 30000}, checkpoints (.npz + .json, shared
with the JAX package), dino_loss_log.csv and train_stats.csv, plus
``--device {cuda,cpu}`` (default cuda: no CUDA device is an error, never
a silent CPU run).

``--n_devices D`` (D > 1) trains over D device slots (parallel/sharding.py:
D cards, or D slots sharing one card or the CPU). ``--parallel_mode dp``
(default) is camera data-parallel: D views per step, state replicated.
``--parallel_mode mp`` is Gaussian-sharded: one view per step, params,
Adam moments and densify statistics in per-slot chunks, the strata
composited by the seeded tiled core (K3/K4) unless the pipeline's backend
is dense; eval renders through the same sharded backend. Densify, opacity
reset, snapshots and checkpoints run on the gathered state (file formats
unchanged), which is then placed on the slots again, its capacity a
multiple of D.

``--dino_mode fixed`` (default) adds lambda_dino * (1 - cos) of the DINO
embeddings of the render and its target (semantics/dino.py) past
``--dino_start_iter``, in all three steps; ``parity`` logs +lambda * cos
with no gradient; ``off`` leaves it out. Without encoder weights
($GAUSSMART_DINO_WEIGHTS, or the default paths) the term is disabled with
a message, as in the JAX trainer. ``--gui`` serves the live viewer
(viewer/protocol.py) once per iteration on ``--ip``/``--port``.
``--run_segmentation`` first runs the segmentation pipeline
(``python -m gaussmart_tpu_torch.semantics.pipeline``, semantics/
pipeline.py) in a subprocess on the scene, writing identification/results/
in the working directory, where the Scene then finds the segmented cloud
and its mask areas; it forwards --dataset_type, --skip_camera_clustering,
--sam2, --clean and --device, and exits 1 if the pipeline fails. The
binning never drops a (splat, tile) pair, so there is no duplicate budget
to grow and train_stats.csv's n_dropped column is always 0.
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import time
from argparse import ArgumentParser
from random import Random
from typing import List, Optional

import torch

from gaussmart_tpu_torch.config import (ModelParams, OptimizationParams,
                                        PipelineParams, add_group_args,
                                        extract_group, save_cfg)
from gaussmart_tpu_torch.eval.lpips import load_lpips
from gaussmart_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from gaussmart_tpu_torch.logging_utils import TensorBoardLogger, profile_trace
from gaussmart_tpu_torch.losses import dino_term
from gaussmart_tpu_torch.models.gaussians import grow_capacity
from gaussmart_tpu_torch.ops.image import l1_loss, psnr as psnr_fn
from gaussmart_tpu_torch.ops.ssim import ssim as ssim_fn
from gaussmart_tpu_torch.optim import AdamState, init_adam
from gaussmart_tpu_torch.parallel.sharding import (BatchedCameras, gather_state,
                                                   make_dp_train_step, make_mesh,
                                                   make_mp_train_step, replicate,
                                                   shard_batch, shard_state,
                                                   sharded_render_backend)
from gaussmart_tpu_torch.render.api import render
from gaussmart_tpu_torch.runtime import resolve_device, setup
from gaussmart_tpu_torch.scene import Scene
from gaussmart_tpu_torch.semantics.dino import DinoEncoder
from gaussmart_tpu_torch.train_lib import (make_densify_step, make_train_step,
                                           reset_opacity)
from gaussmart_tpu_torch.viewer.protocol import NetworkGUI, serve_frame
from gaussmart_tpu_torch.viewer.serve import frame_renderer


def training(dataset: ModelParams, opt: OptimizationParams,
             pipe: PipelineParams, testing_iterations: List[int],
             saving_iterations: List[int], checkpoint_iterations: List[int],
             start_checkpoint: Optional[str] = None,
             use_dino_loss: bool = True, lambda_dino: float = 0.05,
             dino_start_iter: int = 3000, dino_mode: str = "fixed",
             seed: int = 0, quiet: bool = False,
             capacity: Optional[int] = None, log_every: int = 10,
             tensorboard: bool = True, adam_on_densify: str = "drop",
             device="cuda", n_devices: int = 1, parallel_mode: str = "dp",
             gui: Optional[NetworkGUI] = None):
    """Train; returns the (state, adam) on `device`. n_devices > 1 trains
    over that many device slots, parallel_mode "dp" (camera data-parallel)
    or "mp" (Gaussian-sharded). `gui` (an initialised NetworkGUI) is
    served once per iteration."""
    if parallel_mode not in ("dp", "mp"):
        raise ValueError(f"parallel_mode={parallel_mode!r}: expected 'dp' or 'mp'")
    os.makedirs(dataset.model_path, exist_ok=True)
    tb = TensorBoardLogger(dataset.model_path) if tensorboard else None
    scene = Scene(dataset, capacity=capacity, seed=seed, device=device)
    state = scene.gaussians
    adam = init_adam(state.params)
    first_iter = 0
    if start_checkpoint:
        state, adam, first_iter = load_checkpoint(start_checkpoint, device=device)
        print(f"Resumed from {start_checkpoint} at iteration {first_iter}")
    dino_fn = (_build_dino_fn(lambda_dino, dino_start_iter, dino_mode, device)
               if use_dino_loss else None)

    loss_log_path = os.path.join(dataset.model_path, "dino_loss_log.csv")
    log_fields = ["iteration", "dino_loss", "total_loss", "l1_loss",
                  "dist_loss", "normal_loss"]
    stat_log_path = os.path.join(dataset.model_path, "train_stats.csv")
    stat_fields = ["iteration", "n_points", "n_dropped", "view", "dist_loss"]
    for path, fields in ((loss_log_path, log_fields), (stat_log_path, stat_fields)):
        with open(path, "w", newline="") as f:
            csv.DictWriter(f, fieldnames=fields).writeheader()
    log_rows: List[dict] = []
    stat_rows: List[dict] = []

    mesh = make_mesh(n_devices, device) if n_devices > 1 else None
    mp = mesh is not None and parallel_mode == "mp"
    common = dict(sh_degree=state.max_sh_degree,
                  white_background=dataset.white_background,
                  depth_ratio=pipe.depth_ratio, spatial_lr_scale=state.spatial_lr_scale,
                  adam_on_densify=adam_on_densify, dino_fn=dino_fn)
    if mp:
        step = make_mp_train_step(opt, mesh, backend=sharded_render_backend(pipe.backend),
                                  **common)
    elif mesh is not None:
        step = make_dp_train_step(opt, mesh, backend=pipe.backend, **common)
    else:
        step = make_train_step(opt, backend=pipe.backend, **common)

    def place(params, adam, aux):
        """Whole state -> the step's layout: per-slot chunks (mp) or
        replicas (dp)."""
        if mp:
            return shard_state(params, adam, aux, mesh)
        if mesh is not None:
            return replicate(params, mesh), replicate(adam, mesh), replicate(aux, mesh)
        return params, adam, aux

    def gathered(params, adam, aux):
        """The inverse of place, on `device`."""
        if mp:
            return gather_state(params, adam, aux, device)
        if mesh is not None:
            return params[0], adam[0], aux[0]
        return params, adam, aux
    densify_step = make_densify_step(opt, extent=scene.cameras_extent)
    # split noise: drawn on the host from the seed, so a CPU and a CUDA run
    # of the same scene place the same children
    gen = torch.Generator().manual_seed(seed)

    train_cams = scene.get_train_cameras()
    cam_params = [c.params(device) for c in train_cams]
    gt_images = [torch.as_tensor(c.image, dtype=torch.float32, device=device)
                 for c in train_cams]
    rnd = Random(seed)
    viewpoint_stack: List[int] = []

    def pop_view():
        nonlocal viewpoint_stack
        if not viewpoint_stack:
            viewpoint_stack = list(range(len(train_cams)))
        return viewpoint_stack.pop(rnd.randint(0, len(viewpoint_stack) - 1))

    params, adam, aux = place(state.params, adam, state.aux)
    ema = {"loss": 0.0, "dist": 0.0, "normal": 0.0, "dino": 0.0}
    t_start = time.time()

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if iteration % 1000 == 0 and state.active_sh_degree < state.max_sh_degree:
            state = state.oneup_sh_degree()

        if mesh is None or mp:
            idx = pop_view()
            params, adam, aux, metrics, _ = step(params, adam, aux, cam_params[idx],
                                                 gt_images[idx], iteration)
        else:
            idxs = [pop_view() for _ in range(n_devices)]
            batched = BatchedCameras.stack([cam_params[i] for i in idxs])
            gts = torch.stack([gt_images[i] for i in idxs])
            params, adam, aux, metrics, _ = step(
                params, adam, aux, shard_batch(batched, mesh), shard_batch(gts, mesh),
                iteration)
            # the step's dist is the mean over the D views: no one view
            idx = -1

        if iteration % log_every == 0 or iteration == opt.iterations:
            m = {k: float(v) for k, v in metrics._asdict().items()}
            for k, src in (("loss", "total"), ("dist", "dist"), ("normal", "normal"),
                           ("dino", "dino")):
                ema[k] = 0.4 * m[src] + 0.6 * ema[k]
            if not quiet:
                ips = (iteration - first_iter) / max(time.time() - t_start, 1e-9)
                print(f"[{iteration}/{opt.iterations}] loss {ema['loss']:.5f} "
                      f"dist {ema['dist']:.5f} normal {ema['normal']:.5f} "
                      f"dino {ema['dino']:.5f} pts {int(m['n_active'])} "
                      f"({ips:.1f} it/s)", flush=True)
            log_rows.append({"iteration": iteration, "dino_loss": m["dino"],
                             "total_loss": m["total"], "l1_loss": m["l1"],
                             "dist_loss": m["dist"], "normal_loss": m["normal"]})
            stat_rows.append({"iteration": iteration, "n_points": int(m["n_active"]),
                              "n_dropped": int(m["n_dropped"]), "view": idx,
                              "dist_loss": m["dist"]})
            if tb is not None:
                tb.scalar("train_loss_patches/total_loss", m["total"], iteration)
                tb.scalar("train_loss_patches/reg_loss", m["l1"], iteration)
                tb.scalar("train_loss_patches/dist_loss", ema["dist"], iteration)
                tb.scalar("train_loss_patches/normal_loss", ema["normal"], iteration)
                tb.scalar("train_loss_patches/dino_loss", ema["dino"], iteration)
                tb.scalar("total_points", int(m["n_active"]), iteration)
                tb.scalar("raster/dropped_duplicates", int(m["n_dropped"]), iteration)
                tb.scalar("iter_time", (time.time() - t_start) / iteration, iteration)
            if len(log_rows) >= 50:
                _flush_log(loss_log_path, log_fields, log_rows)
                _flush_log(stat_log_path, stat_fields, stat_rows)

        if iteration in testing_iterations:
            if mp:   # eval renders the per-slot chunks through the sharded fold
                chunks = [state.replace(params=p, aux=x) for p, x in zip(params, aux)]
                report_eval(scene, chunks, pipe, dataset, iteration, tb=tb,
                            device=device, mesh=mesh)
            else:
                p, _, x = gathered(params, adam, aux)
                report_eval(scene, state.replace(params=p, aux=x), pipe, dataset,
                            iteration, tb=tb, device=device)

        if iteration in saving_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            p, _, x = gathered(params, adam, aux)
            scene.save(iteration, state.replace(params=p, aux=x))

        if iteration < opt.densify_until_iter:
            densify_now = (iteration > opt.densify_from_iter
                           and iteration % opt.densification_interval == 0)
            reset_now = (iteration % opt.opacity_reset_interval == 0
                         or (dataset.white_background
                             and iteration == opt.densify_from_iter))
            if densify_now or reset_now:
                p, adam, x = gathered(params, adam, aux)
                state = state.replace(params=p, aux=x)
            if densify_now:
                use_size = iteration > opt.opacity_reset_interval
                state, adam, n_drop = densify_step(state, adam, gen, use_size)
                if n_drop > 0:
                    state, adam = _grow(state, adam, n_drop,
                                        multiple=n_devices if mp else 1)
            if reset_now:
                state, adam = reset_opacity(state, adam)
            if densify_now or reset_now:
                params, adam, aux = place(state.params, adam, state.aux)

        if gui is not None:
            if mp:
                shown = [state.replace(params=p, aux=x) for p, x in zip(params, aux)]
            elif mesh is not None:     # dp: replica 0
                shown = state.replace(params=params[0], aux=aux[0])
            else:
                shown = state.replace(params=params, aux=aux)
            _serve_gui(gui, shown, pipe, dataset, ema, iteration, opt.iterations,
                       mesh=mesh if mp else None, device=device)

        if iteration in checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            p, a, x = gathered(params, adam, aux)
            save_checkpoint(os.path.join(dataset.model_path, f"chkpnt{iteration}.npz"),
                            state.replace(params=p, aux=x), a, iteration)

    _flush_log(loss_log_path, log_fields, log_rows)
    _flush_log(stat_log_path, stat_fields, stat_rows)
    if tb is not None:
        tb.close()
    params, adam, aux = gathered(params, adam, aux)
    return state.replace(params=params, aux=aux), adam


def _serve_gui(gui: NetworkGUI, state, pipe, dataset, ema, iteration: int, max_iters: int,
               mesh=None, device="cuda"):
    """One poll/serve round of the live viewer (JAX train.py:357-386):
    accept a waiting viewer, then answer its requests until it asks to
    train on (or leaves). `state` is one GaussianState or, with `mesh`, the
    per-slot chunks of the Gaussian-sharded state, rendered through the
    sharded fold (K3 on the card)."""
    if gui.conn is None:
        gui.try_connect(dataset.render_items)
        if gui.conn is None:
            return
    frame = frame_renderer(state, pipe, dataset.white_background, device, mesh)
    chunks = state if mesh is not None else [state]
    metrics = {"#": sum(int(s.n_active) for s in chunks), "loss": ema["loss"]}
    while gui.conn is not None:
        do_training, keep_alive = serve_frame(gui, frame, dataset.render_items,
                                              dataset.source_path, metrics)
        if do_training and (iteration < max_iters or not keep_alive):
            break


def _build_dino_fn(lambda_dino: float, start_iter: int, mode: str, device):
    """The DINO embedding term ``dino_fn(image, gt, iteration)`` of the
    training steps (JAX train.py:423-440), or None when no encoder weights
    are found: the term is then 0, as in the JAX trainer. Past `start_iter`
    it is losses.dino_term; at or below it the tower is skipped and the
    term is 0 with a zero gradient, what JAX's where(iteration >
    start_iter, term, 0) gives. The encoder is read straight onto the
    step's device (DinoEncoder.create: one array on the host at a time)
    and copied device to device to any other device it meets (a dp slot's
    view lies on its slot's device; slots sharing a card share one copy)."""
    try:
        encoder = DinoEncoder.create(device=torch.empty(0, device=device).device)
    except FileNotFoundError as e:
        print(f"[dino] encoder unavailable ({e}); DINO loss disabled")
        return None
    encoders = {encoder.device: encoder}

    def on(dev: torch.device) -> DinoEncoder:
        if dev not in encoders:
            encoders[dev] = encoder.to_device(dev)
        return encoders[dev]

    def fn(image, gt, iteration: int):
        if iteration <= start_iter:
            return torch.zeros((), dtype=torch.float32, device=image.device)
        return dino_term(image, gt, on(image.device), lambda_dino, mode=mode)

    return fn


def _flush_log(path, fields, rows):
    if rows:
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            for r in rows:
                w.writerow(r)
        rows.clear()


def _grow(state, adam: AdamState, dropped: int = 0, multiple: int = 1):
    """Grow the arena after densify overflowed, in 1.25x steps rounded to
    capacity/8, covering this pass's dropped splats so one growth
    suffices, then up to a multiple of `multiple` (the slot count of
    Gaussian-sharded state). The dropped splats stay lost, as in the JAX
    package."""
    cap = state.capacity
    gran = max(cap // 8, 16)
    need = int(state.n_active) + int(dropped) + gran
    new_cap = max(int(cap * 1.25), cap + gran, need)
    new_cap = -(-new_cap // gran) * gran
    new_cap = -(-new_cap // multiple) * multiple
    print(f"[capacity] growing {cap} -> {new_cap}")
    grown = grow_capacity(state, new_cap)
    pad = new_cap - cap

    def pad_group(g):
        return type(g)(**{k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                          for k, v in vars(g).items()})
    return grown, AdamState(mu=pad_group(adam.mu), nu=pad_group(adam.nu), step=adam.step)


@torch.no_grad()
def report_eval(scene: Scene, state, pipe, dataset, iteration, tb=None,
                device="cuda", mesh=None):
    """In-loop eval of the test cameras and 5 train cameras: mean L1, PSNR
    and SSIM of the clipped renders, and LPIPS(alex) when local weights
    exist (eval/lpips.py), printed and written to eval_<iteration>.json.
    With `mesh`, `state` is the Gaussian-sharded training state's per-slot
    chunks, rendered through the sharded backend."""
    lpips = load_lpips("alex", device)
    backend = pipe.backend if mesh is None else sharded_render_backend(pipe.backend)
    configs = [("test", scene.get_test_cameras())]
    train_cams = scene.get_train_cameras()
    if train_cams:
        configs.append(("train", [train_cams[i % len(train_cams)]
                                  for i in range(5, 30, 5)]))
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=device)
    results = {}
    for name, cams in configs:
        if not cams:
            continue
        tot = {"l1": 0.0, "psnr": 0.0, "ssim": 0.0}
        if lpips is not None:
            tot["lpips"] = 0.0
        for vi, cam in enumerate(cams):
            pkg = render(cam.params(device), state, bg, depth_ratio=pipe.depth_ratio,
                         backend=backend, mesh=mesh)
            img = torch.clamp(pkg["render"], 0, 1)
            gt = torch.clamp(torch.as_tensor(cam.image, device=device), 0, 1)
            if tb is not None and vi < 5:
                d = pkg["surf_depth"] / torch.clamp_min(pkg["surf_depth"].max(), 1e-9)
                prefix = f"{name}_view_{cam.image_name}"
                tb.image(f"{prefix}/render", img.cpu().numpy(), iteration)
                tb.image(f"{prefix}/depth", torch.cat([d] * 3).cpu().numpy(), iteration)
                tb.image(f"{prefix}/rend_normal",
                         (pkg["rend_normal"] * 0.5 + 0.5).cpu().numpy(), iteration)
                tb.image(f"{prefix}/rend_alpha",
                         torch.cat([pkg["rend_alpha"]] * 3).cpu().numpy(), iteration)
            tot["l1"] += float(l1_loss(img, gt))
            tot["psnr"] += float(psnr_fn(img[None], gt[None])[0, 0])
            tot["ssim"] += float(ssim_fn(img, gt))
            if lpips is not None:
                tot["lpips"] += float(lpips(img, gt)[0])
        results[name] = {k: v / len(cams) for k, v in tot.items()}
        if tb is not None:
            for k, v in results[name].items():
                tb.scalar(f"{name}/loss_viewpoint - {k}", v, iteration)
        print(f"\n[ITER {iteration}] Evaluating {name}: "
              f"L1 {results[name]['l1']:.5f} PSNR {results[name]['psnr']:.3f} "
              f"SSIM {results[name]['ssim']:.4f}")
    with open(os.path.join(dataset.model_path, f"eval_{iteration}.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="gaussmart_tpu_torch training")
    add_group_args(parser, ModelParams)
    add_group_args(parser, OptimizationParams)
    add_group_args(parser, PipelineParams)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--run_segmentation", action="store_true")
    parser.add_argument("--segmentation_output", type=str, default="segmentation_results")
    parser.add_argument("--dataset_type", type=str, choices=["dtu", "nerf", "tyt"],
                        default="tyt")
    parser.add_argument("--skip_camera_clustering", action="store_true")
    parser.add_argument("--sam2", action="store_true")
    parser.add_argument("--clean", action="store_true")
    parser.add_argument("--dino_start_iter", type=int, default=3000)
    parser.add_argument("--lambda_dino", type=float, default=0.05)
    parser.add_argument("--dino_mode", type=str, default="fixed",
                        choices=["fixed", "parity", "off"])
    parser.add_argument("--capacity", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler Chrome trace to this dir")
    parser.add_argument("--no_tensorboard", action="store_true")
    parser.add_argument("--gui", action="store_true",
                        help="serve the live viewer during training")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="train over this many device slots (see --parallel_mode)")
    parser.add_argument("--parallel_mode", type=str, default="dp", choices=["dp", "mp"],
                        help="dp: camera data-parallel, state replicated; mp: "
                             "Gaussian-sharded, state in per-slot chunks")
    parser.add_argument("--adam_on_densify", type=str, default="drop",
                        choices=["apply", "drop"],
                        help="'drop' (default) skips the Adam update on densify "
                             "iterations, as the reference does")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to train (cuda unless asked otherwise)")
    return parser


def run_segmentation(args):
    """The segmentation pipeline on args.source_path in a subprocess, its
    output CWD-relative (where io/dataset.py looks); exits 1 if it fails.
    PYTHONPATH leads with the port's parent directory, so the module is
    found from any working directory."""
    print("\nRunning segmentation process...", flush=True)
    seg_output = os.path.join("identification", "results")
    os.makedirs(seg_output, exist_ok=True)
    cmd = [sys.executable, "-m", "gaussmart_tpu_torch.semantics.pipeline",
           "-s", args.source_path, "-o", seg_output, "-t", args.dataset_type,
           "--device", args.device]
    if args.skip_camera_clustering:
        cmd.append("--skip_camera_clustering")
    if args.sam2:
        cmd.append("--sam2")
    if args.clean:
        cmd.append("--clean")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    try:
        subprocess.run(cmd, check=True, env=env)
        print("Segmentation completed successfully!")
    except subprocess.CalledProcessError as e:
        print(f"Segmentation failed with error: {e}")
        sys.exit(1)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    print("Optimizing " + args.model_path)
    if args.run_segmentation:
        run_segmentation(args)
    setup()
    device = resolve_device(args.device)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    dataset = extract_group(args, ModelParams)
    opt = extract_group(args, OptimizationParams)
    pipe = extract_group(args, PipelineParams)
    os.makedirs(dataset.model_path, exist_ok=True)
    save_cfg(dataset.model_path, args)

    gui = None
    if args.gui:
        gui = NetworkGUI()
        gui.init(args.ip, args.port)
    try:
        with profile_trace(args.profile_dir):
            out = training(dataset, opt, pipe, args.test_iterations, args.save_iterations,
                           args.checkpoint_iterations, args.start_checkpoint,
                           use_dino_loss=(args.dino_mode != "off"),
                           lambda_dino=args.lambda_dino,
                           dino_start_iter=args.dino_start_iter,
                           dino_mode=args.dino_mode, seed=args.seed, quiet=args.quiet,
                           capacity=args.capacity, tensorboard=not args.no_tensorboard,
                           adam_on_densify=args.adam_on_densify, device=device,
                           n_devices=args.n_devices, parallel_mode=args.parallel_mode,
                           gui=gui)
    finally:
        if gui is not None:
            gui.shutdown()
    print("\nTraining complete.")
    return out


if __name__ == "__main__":
    main()
