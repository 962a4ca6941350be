"""Novel views served to one viewer client, closed loop: each request is a
pose of the ellipse through the training cameras and a render mode, and
goes through the frame path `protocol.serve_frame` runs, without the
socket: the request's `MiniCam`, `viewer.serve.frame_renderer(state, pipe,
...)(cam, 1.0)`, `protocol.render_net_image`, `protocol.image_to_bytes`.
The next request is sent once the bytes of the last are on the host.

Set-up fixes the host heap's thresholds (`steady_host_heap`), makes the
model from the seed and serves WARM_FRAMES requests over poses spread
evenly around the path, in the cell's mode cycle. The window times every
request from its send to its bytes. Afterwards a seeded sample of the
served frames, some of each mode, is rendered again by the reference and
compared byte for byte. A traced run profiles PROFILED_FRAMES more frames,
then as many with the program's own spans on, then HOST_FRAMES (the whole
path) with the spans on and no profiler, for the spans' host times
(spans.traced)."""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import check, common, counts, scene as scenes, spans, trace as tracing

ROLE = "view"
PROFILED_FRAMES = 6
HOST_FRAMES = 240
WARM_FRAMES = 60
SAMPLE_PER_MODE = 2


def mode_of(i: int, cycle) -> str:
    """The render mode of request i: the first rule [every, offset, mode]
    that matches, else the default."""
    for every, offset, mode in cycle["rules"]:
        if i % every == offset:
            return mode
    return cycle["default"]


class Sample:
    """A seeded reservoir of SAMPLE_PER_MODE served frames per mode."""

    def __init__(self, seed):
        self.rnd, self.seen, self.kept = random.Random(seed), {}, {}

    def offer(self, mode, item):
        n = self.seen[mode] = self.seen.get(mode, 0) + 1
        kept = self.kept.setdefault(mode, [])
        if len(kept) < SAMPLE_PER_MODE:
            kept.append(item)
        else:
            j = self.rnd.randrange(n)
            if j < SAMPLE_PER_MODE:
                kept[j] = item

    def items(self):
        return [it for mode in sorted(self.kept) for it in self.kept[mode]]


def steady_host_heap():
    """Fix glibc's malloc thresholds for this process: blocks under 32 MiB
    come from the heap, and the heap is never trimmed. Each frame's 3.3 MB
    copy to the host and its bytes then reuse the same pages. Left to
    glibc's dynamic thresholds, the heap was trimmed and grown again for
    some frames and not others: those frames' copy and `tobytes` took
    2.5-4 ms against 0.4-0.7, in stretches of seconds, and the window's
    95th percentile swung by 10-15% from run to run."""
    import ctypes
    libc = ctypes.CDLL("libc.so.6")
    m_trim_threshold, m_mmap_threshold = -1, -3
    if not (libc.mallopt(m_mmap_threshold, 32 << 20) and libc.mallopt(m_trim_threshold, 1 << 30)):
        raise RuntimeError("mallopt refused the host heap's thresholds")


def run(args, cfg, traffic, device) -> common.Run:
    from gaussmart_tpu_torch import runtime
    from gaussmart_tpu_torch.cameras import MiniCam
    from gaussmart_tpu_torch.config import ModelParams, PipelineParams
    from gaussmart_tpu_torch.models.gaussians import GaussianAux, GaussianParams, GaussianState
    from gaussmart_tpu_torch.viewer import protocol, serve

    runtime.setup()
    steady_host_heap()
    marks = [("imports", common.process_age_s())]
    sc = scenes.build(cfg, args.seed, device)
    common.sync(device)
    common.reset_peak(device)
    marks.append(("inputs", common.process_age_s()))
    train_cams = [sc.cams[i] for i in scenes.train_views(cfg, sc.cams)]
    path = common.module("paths", traffic["path"]).make(train_cams, traffic["frames"])
    fovx, fovy = train_cams[0]["fovx"], train_cams[0]["fovy"]
    poses = [scenes.camera(dict(R=R, t=t, fovx=fovx, fovy=fovy), sc.width, sc.height, "cpu")
             for R, t in path]
    C = sc.active.shape[0]
    zeros = torch.zeros(C, dtype=torch.float32, device=device)
    state = GaussianState(
        params=GaussianParams(**sc.params),
        aux=GaussianAux(active=sc.active, segments=torch.zeros(C, dtype=torch.int32,
                                                                device=device),
                        max_radii2d=zeros, grad_accum=zeros.clone(), denom=zeros.clone()),
        max_sh_degree=cfg["sh_degree"], active_sh_degree=cfg["sh_degree"],
        spatial_lr_scale=sc.spatial_lr_scale)
    frame = serve.frame_renderer(state, PipelineParams(), False, device)
    items = ModelParams().render_items
    start = args.seed % len(poses)
    mats = [(p.world_view.numpy(), p.full_proj.numpy()) for p in poses]

    def serve(k, mode):
        """Serve pose k in `mode`: (pose, mode, bytes, seconds from send to bytes)."""
        t0 = time.perf_counter()
        cam = MiniCam(sc.width, sc.height, fovy, fovx, 0.01, 100.0, mats[k][0], mats[k][1])
        data = protocol.image_to_bytes(protocol.render_net_image(frame(cam, 1.0), items,
                                                                 items.index(mode), cam))
        return k, mode, data, time.perf_counter() - t0

    def request(i):
        """Serve request i of the window."""
        return serve((start + i) % len(poses), mode_of(i, traffic["modes"]))

    for j in range(WARM_FRAMES):
        serve(j * len(poses) // WARM_FRAMES, mode_of(j, traffic["modes"]))
    common.sync(device)
    rec = {"setup_s": common.process_age_s()}
    marks.append(("warm_frames", rec["setup_s"]))
    rec["setup_marks"] = marks

    sample = Sample(args.seed)
    latencies = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        k, mode, data, dt = request(len(latencies))
        latencies.append(dt)
        sample.offer(mode, (k, mode, data))
    rec["window_s"] = time.perf_counter() - t0
    rec["latencies_s"] = latencies
    rec["frames"] = len(latencies)
    rec["peak_bytes"] = common.peak_bytes(device)
    t_end = time.perf_counter()
    if args.trace:
        shown = []

        def profiled_frame(i):
            k, _, _, _ = request(len(latencies) + i)
            if i >= 1:
                shown.append(k)

        rec["trace"] = tracing.profile(profiled_frame, PROFILED_FRAMES)
        rec["spans"] = spans.traced(ROLE, profiled_frame, PROFILED_FRAMES, HOST_FRAMES)
    rec["pixels"] = sc.width * sc.height
    rec["phases"] = {"profile_s": time.perf_counter() - t_end}
    t_end = time.perf_counter()

    params, active, sc_width, sc_height = sc.params, sc.active, sc.width, sc.height
    del frame, state, sc
    gc.collect()
    torch.cuda.empty_cache()

    def cam_of(k):
        return scenes.camera(dict(R=path[k][0], t=path[k][1], fovx=fovx, fovy=fovy),
                             sc_width, sc_height, device)
    if args.trace:
        rec["work"] = [counts.frame_work(params, active, cam_of(k)) for k in shown]
    rec["phases"]["work_s"] = time.perf_counter() - t_end
    t_end = time.perf_counter()
    pairs, refs = [], []
    for k, mode, data in sample.items():
        served = np.frombuffer(data, np.uint8).reshape(sc_height, sc_width, 3)
        refs.append((k, mode))
        pairs.append((served, check.reference_frame(params, active, cam_of(k), mode)))
    rec["phases"]["reference_s"] = time.perf_counter() - t_end

    def control(precision, fault):
        """The reference in the program's place, in `precision`, or each
        served frame with one pixel altered (`fault`), held against the
        reference (control.py)."""
        if fault == "altered":
            return check.view_numbers([(altered(a), b) for a, b in pairs])
        return check.view_numbers([(check.reference_frame(params, active, cam_of(k), mode,
                                                          precision), b)
                                   for (k, mode), (_, b) in zip(refs, pairs)])

    return common.Run(rec, check.view_numbers(pairs), len(latencies), control)


def altered(frame: np.ndarray) -> np.ndarray:
    """The frame with its middle pixel's bytes flipped in the top bit."""
    out = frame.copy()
    out[out.shape[0] // 2, out.shape[1] // 2] ^= 0x80
    return out

