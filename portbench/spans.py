"""The port's own spans and counters (gaussmart_tpu_torch.logging_utils)
read beside a torch.profiler trace: each device operation put down to the
innermost `gm/` span that encloses its launch, each idle gap of the device
to the innermost `gm/` span at the gap's middle, and the per-step or
per-frame numbers that follow from them.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> [--rounds <k>]

runs the cell as `portbench/run.py ... --trace 1` does and, after the
cell's profiled window, `k` rounds of two more profiled windows of as many
steps or frames, one with the program's tracing off and one with it on, in
turns. It prints the idle-by-span table, the device time by span, the
numbers of `METRICS` and the time per call of both kinds of window as
`[spans]` lines on standard error, and writes them to
chiprun_out/spans_<cell>_<seed>.json.

Every traced run of a cell keeps one such window with tracing on
(`traced`, called by the drivers) as `rec["spans"]`, which the per-layer
metrics of METRICS, and any later metrics/<name>.py, read. Its readings
of the host's clock come from a longer window of their own, with the
program's tracing on and no profiler, whose annotations slow the host:
each the median over that window's calls."""
from __future__ import annotations

import bisect
import collections
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
PREFIX = "gm/"
ROOTS = ("step", "frame")
OUTSIDE = "(no gm/ span)"
# per step (train) or frame (view): (kind of reading, span); the kinds of
# HOST are read on the host's clock
METRICS = {
    "train": {"preprocess_ms.train": ("device", "render.preprocess"),
              "binning_ms.train": ("device", "render.binning"),
              "pair_yield.train": ("yield", None),
              "sync_wait_ms.train": ("sync", None),
              "dino_target_ms.train": ("device", "losses.dino.target"),
              "dino_bwd_ms.train": ("device", "backward.dino")},
    "view": {"preprocess_ms.view": ("device", "render.preprocess"),
             "binning_ms.view": ("device", "render.binning"),
             "sync_wait_ms.view": ("sync", None),
             "to_host_ms.view": ("self", "frame.to_host")},
}
HOST = ("sync", "self")


class Intervals:
    """The `gm/` annotations of a trace by thread, to find the innermost
    one (the latest to start among those still open) at a time."""

    def __init__(self, spans):
        self.by_tid = collections.defaultdict(list)
        for name, tid, s, e in spans:
            self.by_tid[tid].append((s, e, name))
        for v in self.by_tid.values():
            v.sort()
        self.starts = {t: [x[0] for x in v] for t, v in self.by_tid.items()}

    def innermost(self, t, tid=None):
        """The innermost span open at `t` on thread `tid`, else on any
        thread; None outside every span."""
        if tid is not None and tid in self.by_tid:
            hit = self._on(tid, t)
            if hit:
                return hit[1]
        best = None
        for other in self.by_tid:
            hit = self._on(other, t)
            if hit and (best is None or hit[0] > best[0]):
                best = hit
        return best[1] if best else None

    def _on(self, tid, t):
        v, starts = self.by_tid[tid], self.starts[tid]
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, e, name = v[j]
            if e >= t:
                return s, name
        return None


def attribute(events, t0=None, t1=None):
    """From Chrome trace events (torch.profiler's export), over the window
    [t0, t1] in us (default: the ProfilerStep# events'): window_s, busy_s,
    kernels (launches), device_s {span: seconds of the device operations
    it launched, its children's not counted}, idle_s {span: seconds of
    the device's idle gaps whose middle it holds, innermost}. A device
    operation is linked to its launch by the `correlation` of the runtime
    call (else `External id`, to the operator's start); operations and
    gaps outside every `gm/` span go to OUTSIDE."""
    xs = [e for e in events if e.get("ph") == "X"]
    if t0 is None:
        steps = [e for e in xs if e["name"].startswith("ProfilerStep#")]
        t0 = min(float(e["ts"]) for e in steps)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in steps)
    spans, launch, external = [], {}, {}
    for e in xs:
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        cat, args = e.get("cat"), e.get("args") or {}
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((e["name"][len(PREFIX):], e.get("tid"), ts, end))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = (e.get("tid"), ts)
        elif cat == "cpu_op" and "External id" in args:
            external.setdefault(args["External id"], (e.get("tid"), ts))
    where = Intervals(spans)
    device = [e for e in xs if e.get("cat") in DEVICE_CATS
              and float(e["ts"]) + float(e.get("dur", 0)) > t0 and float(e["ts"]) < t1]
    device_s = collections.Counter()
    kernels = 0
    for e in device:
        args = e.get("args") or {}
        at = launch.get(args.get("correlation")) or external.get(args.get("External id"))
        name = where.innermost(at[1], at[0]) if at else None
        device_s[name or OUTSIDE] += float(e.get("dur", 0)) * 1e-6
        kernels += e.get("cat") == "kernel"
    merged = []
    for s, e in sorted((max(float(d["ts"]), t0), min(float(d["ts"]) + float(d.get("dur", 0)), t1))
                       for d in device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    idle_s, prev = collections.Counter(), t0
    for s, e in merged + [[t1, t1]]:
        if s > prev:
            idle_s[where.innermost(0.5 * (prev + s)) or OUTSIDE] += (s - prev) * 1e-6
        prev = max(prev, e)
    return dict(window_s=(t1 - t0) * 1e-6, busy_s=sum(e - s for s, e in merged) * 1e-6,
                kernels=kernels, device_s=dict(device_s), idle_s=dict(idle_s))


def under(table: dict, name: str) -> float:
    """The sum over `name` and its children (names that start `name.`)."""
    return sum(v for k, v in table.items() if k == name or k.startswith(name + "."))


def program_spans(spans):
    """{name: host seconds} of the program's own span records
    (logging_utils.Span), and the same for each span's time less its
    `.sync` children's ({name: self seconds})."""
    total, sync_in = collections.Counter(), collections.Counter()
    for s in spans:
        dt = (s.end_ns - s.start_ns) * 1e-9
        total[s.name] += dt
        if s.name.endswith(".sync"):
            sync_in[s.name[:-len(".sync")]] += dt
    return dict(total), {k: v - sync_in.get(k, 0.0) for k, v in total.items()}


def host_ms(how: str, span, program_s: dict, program_self_s: dict) -> float:
    """A reading of the kinds of HOST from program_spans' tables: the host
    ms in every `*.sync` span, or in `span` less its `.sync` child."""
    if how == "sync":
        return 1e3 * sum(v for k, v in program_s.items() if k.endswith(".sync"))
    return 1e3 * program_self_s.get(span, 0.0)


def metrics(role: str, summary: dict, calls: int) -> dict:
    """The numbers of METRICS[role] from a window's summary (attribute's,
    with `program_s`, `program_self_s` and `counters` added), per call."""
    out = {}
    for name, (how, span) in METRICS[role].items():
        if how == "device":
            out[name] = 1e3 * under(summary["device_s"], span) / calls
        elif how in HOST:
            out[name] = host_ms(how, span, summary["program_s"],
                                summary["program_self_s"]) / calls
        else:
            c = summary["counters"]
            rect = c.get("render.rect_pairs", 0)
            out[name] = 100.0 * c.get("render.live_pairs", 0) / rect if rect else None
    return out


def window(fn, n: int, on: bool, warmup: int = 1, first: int = 0):
    """fn(first + i) for i < warmup + n under torch.profiler, the program's
    tracing `on`: (seconds per call of the last n, host clock, ending with
    a synchronize; attribute()'s summary with the program's spans and
    counters of those n calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from gaussmart_tpu_torch import logging_utils

    path = os.path.join(tempfile.gettempdir(), f"portbench_spans_{os.getpid()}.json")
    was = logging_utils.tracing(on)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup, active=n, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(warmup + n):
                if i == warmup:
                    logging_utils.collect()
                    t0 = time.perf_counter()
                fn(first + i)
                if i == warmup - 1:
                    torch.cuda.synchronize()
                    time.sleep(0.1)   # a trace that has just started drops its first kernels
                if i == warmup + n - 1:
                    torch.cuda.synchronize()
                    dt = (time.perf_counter() - t0) / n
                    spans, counters = logging_utils.collect()
                prof.step()
    finally:
        logging_utils.tracing(was)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
    summary = attribute(events)
    summary["program_s"], summary["program_self_s"] = program_spans(spans)
    summary["counters"] = counters
    return dt, summary


def record(role: str, summary: dict, calls: int) -> dict:
    """A window with tracing on as a run keeps it, per call: each span's
    device ms (of the ops it launched, its children's apart), idle ms and
    host ms, each counter, and the numbers of METRICS[role]."""
    def per_call(table, scale=1e3):
        return {k: scale * v / calls for k, v in table.items()}
    return {"calls": calls, "device_ms": per_call(summary["device_s"]),
            "idle_ms": per_call(summary["idle_s"]), "host_ms": per_call(summary["program_s"]),
            "counters": per_call(summary["counters"], 1), "metrics": metrics(role, summary, calls)}


def host_window(role: str, fn, n: int, warmup: int = 1, first: int = 0) -> dict:
    """fn(first + i) for i < warmup + n with the program's tracing on and no
    profiler; the last n calls told apart by their spans' root id: per span
    the median over the calls of its host ms (`host_median_ms`, 0 in a
    call without it), and each reading of the kinds of HOST in METRICS[role]
    as its median over the calls."""
    from gaussmart_tpu_torch import logging_utils

    was = logging_utils.tracing(True)
    try:
        for i in range(warmup + n):
            if i == warmup:
                logging_utils.collect()
            fn(first + i)
        spans, _ = logging_utils.collect()
    finally:
        logging_utils.tracing(was)
    by_call = collections.defaultdict(list)
    for s in spans:
        by_call[s.id].append(s)
    calls = [program_spans(v) for v in by_call.values()]
    names = sorted({k for total, _ in calls for k in total})
    return {"host_calls": len(calls),
            "host_median_ms": {k: 1e3 * statistics.median(t.get(k, 0.0) for t, _ in calls)
                               for k in names},
            "metrics": {name: statistics.median(host_ms(how, span, *c) for c in calls)
                        for name, (how, span) in METRICS[role].items() if how in HOST}}


def traced(role: str, fn, n: int, host_calls: int, warmup: int = 1) -> dict:
    """After a cell's profiled window fn(0 .. warmup + n - 1), a window of
    as many calls under the profiler with the program's tracing on
    (record()'s numbers of its last n), then host_window's of host_calls
    calls, whose medians replace the host readings. The calls are numbered
    below 0, so what a driver keeps of its profiled calls (those from 1 on)
    stays as it is."""
    _, summary = window(fn, n, True, warmup, first=-(warmup + n))
    out = record(role, summary, n)
    host = host_window(role, fn, host_calls, warmup, first=-(warmup + host_calls))
    out["metrics"].update(host.pop("metrics"))
    return {**out, **host}


def _add(total: dict, summary: dict):
    for key in ("device_s", "idle_s", "program_s", "program_self_s", "counters"):
        into = total.setdefault(key, {})
        for k, v in summary[key].items():
            into[k] = into.get(k, 0) + v
    for key in ("window_s", "busy_s", "kernels"):
        total[key] = total.get(key, 0) + summary[key]


def report(workload: str, role: str, total: dict, calls: int, times: dict) -> dict:
    """The [spans] lines of the windows with tracing on, summed in `total`
    over `calls` calls; `times` {on: [seconds per call of each window]}."""
    idle = sum(total["idle_s"].values())
    left = sum(v for k, v in total["idle_s"].items() if k in ROOTS or k == OUTSIDE)
    out = {"workload": workload, "idle_share": 1 - total["busy_s"] / total["window_s"],
           "idle_left_share": left / idle if idle else 0.0, **record(role, total, calls),
           "kernels": total["kernels"] / calls,
           "ms_per_call": {("on" if on else "off"): [1e3 * t for t in ts] for on, ts in times.items()}}
    p = lambda *a: print("[spans]", *a, file=sys.stderr)  # noqa: E731
    p(f"{workload}: {calls} calls traced, device idle {100 * out['idle_share']:.1f}%, "
      f"{100 * out['idle_left_share']:.1f}% of the idle at a root or outside every gm/ span, "
      f"{out['kernels']:.1f} launches a call")
    p("span | idle ms/call | share of idle | device ms/call | host ms/call")
    for k in sorted(set(out["idle_ms"]) | set(out["device_ms"]),
                    key=lambda k: -out["idle_ms"].get(k, 0.0)):
        i = out["idle_ms"].get(k, 0.0)
        p(f"{k} | {i:.3f} | {100 * i / (1e3 * idle / calls) if idle else 0:.1f}% | "
          f"{out['device_ms'].get(k, 0.0):.3f} | {out['host_ms'].get(k, 0.0):.3f}")
    for k, v in out["metrics"].items():
        p(f"metric {k} {v!r}")
    p(f"counters a call {json.dumps(out['counters'], sort_keys=True)}")
    if times.get(True) and times.get(False):
        on, off = statistics.median(times[True]), statistics.median(times[False])
        p(f"cost: {1e3 * off:.3f} ms a call with tracing off, {1e3 * on:.3f} on "
          f"(medians of {len(times[False])} windows each, in turns): {100 * (on / off - 1):+.2f}%; "
          f"off {[round(1e3 * t, 3) for t in times[False]]} on {[round(1e3 * t, 3) for t in times[True]]}")
    return out


def main(argv=None) -> int:
    import argparse

    from portbench import common, run, trace

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1, help="pairs of windows, off and on")
    own, rest = ap.parse_known_args(argv)
    args = common.parse_args(rest + ["--trace", "1"])
    role = common.role(args.workload)
    cell_profile = trace.profile
    done = {}

    def profile(fn, n, warmup=1):
        # the cell's own window first, then the rounds: negative call
        # numbers keep the drivers' records of the cell's window as they are
        out = cell_profile(fn, n, warmup)
        times, total = {True: [], False: []}, {}
        for r in range(own.rounds):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                dt, summary = window(fn, n, on, warmup, first=-(warmup + n))
                times[on].append(dt)
                if on:
                    _add(total, summary)
        done["report"] = report(args.workload, role, total, n * own.rounds, times)
        return out

    trace.profile = profile
    rc = run.main(rest + ["--trace", "1"])
    if "report" in done:
        os.makedirs("chiprun_out", exist_ok=True)
        with open(f"chiprun_out/spans_{args.workload}_{args.seed}.json", "w") as f:
            json.dump(done["report"], f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
