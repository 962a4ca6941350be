"""Reading a torch.profiler trace of a short steady window: device busy
time (the union of device operations), the window, kernels by name, the
number of kernel launches, and the idle gaps labelled by what the host was
doing in them."""
from __future__ import annotations

import bisect
import collections
import json
import os
import sys
import tempfile
import time

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def profile(fn, n: int, warmup: int = 1):
    """Run fn(i) for i < warmup + n under torch.profiler and read the last n
    calls from its Chrome trace: a dict with window_s, busy_s, kernels
    (launch count), by_name {device op: seconds}, top (the ten longest),
    gaps [(host label, seconds)] and calls; None when the trace holds no
    device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, schedule

    path = os.path.join(tempfile.gettempdir(), f"portbench_trace_{os.getpid()}.json")
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=warmup, active=n, repeat=1),
                       on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for i in range(warmup + n):
            fn(i)
            if i == warmup - 1:
                torch.cuda.synchronize()
                time.sleep(0.1)   # a trace that has just started drops its first kernels
            if i == warmup + n - 1:
                torch.cuda.synchronize()
            prof.step()
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("cat"))
             for e in events if e.get("ph") == "X"]
    steps = [s for s in spans if s[0].startswith("ProfilerStep#")]
    device = [s[:3] for s in spans if s[3] in DEVICE_CATS]
    host = [s[:3] for s in spans if s[3] in HOST_CATS and not s[0].startswith("ProfilerStep")]
    if not steps or not device:
        cats = collections.Counter(s[3] for s in spans)
        print(f"[trace] no device operation in the trace: {dict(cats)}", file=sys.stderr)
        return None
    t0 = min(s[1] for s in steps)
    t1 = max([s[2] for s in steps] + [s[2] for s in device])
    return dict(summarise(t0, t1, [d for d in device if d[2] > t0], host), calls=n)


def summarise(t0, t1, device, host):
    """The window [t0, t1] (us) with device ops and host ops as (name,
    start, end) in us."""
    spans = sorted((max(s, t0), min(e, t1)) for _, s, e in device if e > s)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_name = collections.Counter()
    kernels = 0
    for name, s, e in device:
        by_name[name] += (e - s) * 1e-6
        kernels += _is_kernel(name)
    gaps, prev = [], t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    labels = collections.Counter()
    for s, e in gaps:
        # the innermost host op at the gap's middle: the latest-starting
        # one that still runs there
        mid = 0.5 * (s + e)
        label = "host (no traced op)"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(last - 2000, -1), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        labels[label] += (e - s) * 1e-6
    return dict(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6, kernels=kernels,
                by_name=dict(by_name), gaps=labels.most_common(10),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:10])


def kernel_seconds(trace: dict, key: str) -> float:
    """Seconds of device ops whose name holds `key`."""
    return sum(s for name, s in trace["by_name"].items() if key in name)
