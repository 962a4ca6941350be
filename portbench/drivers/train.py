"""Training steps of the system, closed loop: `train_lib.make_train_step`
from the cell's first iteration on, one view per step, the training views
cycled in a seeded per-epoch shuffle as `train.training` draws them, each
step's state feeding the next.

Set-up makes the state, the targets and the DINO tower's weights from the
seed (the tower on the device, written to an npz under $TMPDIR one array
at a time and freed before the peak is reset), builds the step as
`train.training` does (the term from `train._build_dino_fn` on that npz),
and drives the
step's first three calls: they compile and warm it, and the reference
follows them from the seed's state. The window counts every step that
completes in it. The three steps right after it go through the same step
object in its steady state, and the reference follows them from the
state the window left (parameters and Adam's moments): so a path that the
program only takes once it is warm is compared too. Each check reads the
steps' loss terms, the first step's gradient (from Adam's first moment
before and after it) and the change of the parameters over the three. The
reference draws the tower again from the seed once the program's state is
freed. A traced run profiles PROFILED_STEPS more steps, then as many with
the program's own spans on, then HOST_STEPS with the spans on and no
profiler, for the spans' host times (spans.traced)."""
from __future__ import annotations

import gc
import math
import os
import random
import tempfile
import time

import torch

from portbench import check, common, counts, scene as scenes, spans, trace as tracing

ROLE = "train"
CHECK_STEPS = 3
WARM_STEPS = 2
PROFILED_STEPS = 4
HOST_STEPS = 40


class Views:
    """`train.training`'s draw: a view popped at random from a stack that is
    refilled with every training view once it is empty."""

    def __init__(self, views, seed):
        self.views, self.rnd, self.stack = list(views), random.Random(seed), []

    def __next__(self):
        if not self.stack:
            self.stack = list(self.views)
        return self.stack.pop(self.rnd.randint(0, len(self.stack) - 1))


def run(args, cfg, traffic, device) -> common.Run:
    from gaussmart_tpu_torch import runtime
    from gaussmart_tpu_torch.cameras import CameraParams
    from gaussmart_tpu_torch.config import OptimizationParams
    from gaussmart_tpu_torch.models.gaussians import GaussianAux, GaussianParams
    from gaussmart_tpu_torch.optim import init_adam
    from gaussmart_tpu_torch.train_lib import make_train_step

    runtime.setup()
    marks = [("imports", common.process_age_s())]
    sc = scenes.build(cfg, args.seed, device)
    views = scenes.train_views(cfg, sc.cams)
    gts = scenes.targets(len(sc.cams), sc.width, sc.height, args.seed, device)
    dino = cfg["dino"] if traffic["dino"] else None
    npz = os.path.join(tempfile.gettempdir(), f"portbench_dino_{os.getpid()}.npz")
    if dino:
        scenes.write_dino_npz(scenes.dino_weights(dino, args.seed, device), dino, npz)
    common.sync(device)
    common.reset_peak(device)
    marks.append(("inputs", common.process_age_s()))
    ref_cams = [scenes.camera(c, sc.width, sc.height, device) for c in sc.cams]
    cams = [CameraParams(world_view=c.world_view, full_proj=c.full_proj,
                         camera_center=c.center, tanfovx=math.tan(d["fovx"] / 2),
                         tanfovy=math.tan(d["fovy"] / 2), width=sc.width, height=sc.height)
            for c, d in zip(ref_cams, sc.cams)]
    dino_fn = None
    if dino:
        from gaussmart_tpu_torch.semantics.dino import WEIGHT_ENV
        os.environ[WEIGHT_ENV] = npz
        from gaussmart_tpu_torch import train as train_cli
        try:
            dino_fn = train_cli._build_dino_fn(traffic["lambda_dino"], traffic["dino_start_iter"],
                                               traffic["dino_mode"], device)
        finally:
            del os.environ[WEIGHT_ENV]
            os.remove(npz)
        if dino_fn is None:
            raise RuntimeError("the system found no DINO weights")

    marks.append(("dino", common.process_age_s()))
    rec = {}
    recording = {"on": False, "events": []}

    def mark(name):
        if recording["on"]:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            recording["events"].append((name, ev))

    timed_dino = None
    if dino_fn is not None:
        def timed_dino(image, gt, iteration):
            mark("dino_start")
            out = dino_fn(image, gt, iteration)
            mark("dino_end")
            return out

    step = make_train_step(OptimizationParams(), sh_degree=cfg["sh_degree"],
                           white_background=False, depth_ratio=0.0, backend="auto",
                           dino_fn=timed_dino, spatial_lr_scale=sc.spatial_lr_scale, phase=mark)
    params = GaussianParams(**sc.params)
    C = sc.active.shape[0]
    zeros = torch.zeros(C, dtype=torch.float32, device=device)
    aux = GaussianAux(active=sc.active, segments=torch.zeros(C, dtype=torch.int32, device=device),
                      max_radii2d=zeros, grad_accum=zeros.clone(), denom=zeros.clone())
    carry = {"params": params, "adam": init_adam(params), "aux": aux,
             "it": traffic["first_iteration"]}
    order = Views(views, args.seed)

    def one():
        v = next(order)
        mark("start")
        p, a, x, m, carry["it"] = step(carry["params"], carry["adam"], carry["aux"], cams[v],
                                       gts[v], carry["it"])
        carry.update(params=p, adam=a, aux=x)
        return v, m

    def check_steps():
        """CHECK_STEPS steps from the carry as it stands: where they started
        (parameters, Adam's moments and count, iteration), their views, and
        the program's readings of them. The step is functional, so holding
        the start's tensors copies nothing."""
        p0, adam0 = carry["params"], carry["adam"]
        start = {"params": vars(p0), "m": None, "v": None, "t": int(adam0.step),
                 "it": carry["it"]}
        if start["t"]:
            # fresh moments are zeros, not held: they would raise the peak
            start.update(m=vars(adam0.mu), v=vars(adam0.nu))
        del adam0
        views, prog = [], {"losses": []}
        for i in range(CHECK_STEPS):
            v, m = one()
            views.append(v)
            prog["losses"].append({t: float(getattr(m, t)) for t in check.TERMS})
            if i == 0:
                prog["grad"] = check.first_gradient(start["m"], vars(carry["adam"].mu))
        prog["change"] = check.leaf_norms({g: getattr(carry["params"], g) - start["params"][g]
                                           for g in check.GROUPS})
        return start, views, prog

    # set-up: the check steps from the seed's state (the window's own call),
    # then warm steps
    first = check_steps()
    first[0]["params"] = {g: t.cpu() for g, t in sc.params.items()}
    active_host = sc.active.cpu()
    scale = sc.spatial_lr_scale
    del params, sc
    marks.append(("check_steps", common.process_age_s()))
    for _ in range(WARM_STEPS):
        one()
    common.sync(device)
    rec["setup_s"] = common.process_age_s()
    marks.append(("warm_steps", rec["setup_s"]))
    rec["setup_marks"] = marks

    # the window
    recording["on"] = bool(args.trace)
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        one()
        steps += 1
    common.sync(device)
    rec["window_s"] = time.perf_counter() - t0
    rec["steps"] = steps
    rec["peak_bytes"] = common.peak_bytes(device)
    recording["on"] = False
    t_end = time.perf_counter()
    if args.trace:
        rec.update(_stage_times(recording["events"], steps, device))
    # the steady state's check steps, right after the window
    steady = check_steps()
    if args.trace:
        kept = []

        def profiled_step(i):
            before = carry["params"]
            v, _ = one()
            if i >= 1:
                kept.append((before, v))

        rec["trace"] = tracing.profile(profiled_step, PROFILED_STEPS)
        rec["profiled"] = kept
        rec["spans"] = spans.traced(ROLE, profiled_step, PROFILED_STEPS, HOST_STEPS)
    rec["phases"] = {"profile_s": time.perf_counter() - t_end}
    t_end = time.perf_counter()
    rec["active"] = int(aux.active.sum())
    rec["pixels"] = cams[0].width * cams[0].height
    rec["height"], rec["width"] = cams[0].height, cams[0].width
    rec["params_per_splat"] = sum(t[0].numel() for t in first[0]["params"].values())
    rec["dino"] = dino

    # the program's state goes before the reference runs; what stays is the
    # state the window left, which the steady check starts from, and the
    # targets of the checked views
    check_gts = {v: gts[v] for v in first[1] + steady[1]}
    profiled = rec.pop("profiled", [])
    del carry, step, dino_fn, timed_dino, gts, aux, order
    gc.collect()
    torch.cuda.empty_cache()
    active = active_host.to(device)
    if args.trace:
        rec["work"] = [counts.frame_work(vars(p), active, ref_cams[v]) for p, v in profiled]
    del profiled
    rec["phases"]["work_s"] = time.perf_counter() - t_end
    t_end = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    weights = scenes.dino_weights(dino, args.seed, device) if dino else None

    def reference(start, views, precision="float32", fault=None):
        state = None if start["m"] is None else dict(m=start["m"], v=start["v"], t=start["t"])
        return check.reference_steps(
            {g: t.to(device) for g, t in start["params"].items()}, active,
            [ref_cams[v] for v in views], torch.stack([check_gts[v] for v in views]),
            list(range(start["it"], start["it"] + CHECK_STEPS)), scale, state=state,
            tower_weights=weights, dino=dino, lambda_dino=traffic.get("lambda_dino", 0.0),
            precision=precision, fault=fault)

    refs = [reference(*first[:2]), reference(*steady[:2])]
    rec["phases"]["reference_s"] = time.perf_counter() - t_end
    rec["reference_steps"] = refs[0]["diag"] + refs[1]["diag"]

    def numbers(got_first, got_steady):
        """Readings of both checks held against the reference's."""
        return {**check.train_numbers(got_first, refs[0]),
                **check.train_numbers(got_steady, refs[1], prefix="steady_")}

    def control(precision, fault):
        """The reference put in the program's place, in `precision` or with
        `fault` planted (control.py)."""
        return numbers(reference(*first[:2], precision, fault),
                       reference(*steady[:2], precision, fault))

    return common.Run(rec, numbers(first[2], steady[2]), steps, control)


def _stage_times(events, steps, device):
    """Mean ms per step of each stage (between the phase hook's marks) and
    of the DINO term's forward."""
    common.sync(device)
    sums = {"render": 0.0, "losses": 0.0, "backward": 0.0, "adam": 0.0}
    dino, prev, d0 = 0.0, None, None
    for name, ev in events:
        if name == "dino_start":
            d0 = ev
        elif name == "dino_end":
            dino += d0.elapsed_time(ev)
        elif name == "start":
            prev = ev
        else:
            sums[name] += prev.elapsed_time(ev)
            prev = ev
    out = {f"{k}_ms": v / steps for k, v in sums.items()}
    out["dino_fwd_ms"] = dino / steps if d0 is not None else None
    return out
