"""Observability (counterpart of gaussmart_tpu/logging_utils.py):
TensorBoard scalars and images, a profiler trace around a training run
(``--profile_dir``), here torch.profiler's Chrome trace, and the port's
one tracer: spans at the stage boundaries of the step and the frame, and
counters.

Spans. ``with span(name):`` times a stage on the host clock and, while a
torch.profiler records, mirrors itself into its trace as the annotation
``gm/<name>`` (record_function), on the trace's own clock, so each device
operation and each idle gap of the device can be put down to the stage
whose host code launched it or was running. Tracing is off unless ``tracing(True)``; off, a
span is one test of a module flag and a shared no-op. The roots are
``step`` (id = the iteration) and ``frame`` (id = the request); a span
records its parent (the innermost span open on its thread, else the open
root: a span on autograd's device thread hangs from its step) and the id
of the last root opened, which every thread shares.

Counters. ``count(name, value)`` adds a host int at once; a 0-d device
tensor (counted only while tracing is on, since adding it launches a
kernel) is summed on the device and read only when the registry is read,
so counting never waits for the device. The kernel launch counters
(``LAUNCHES``) are always on. ``collect()`` returns the spans and the
counters and clears both."""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Tuple


class TensorBoardLogger:
    """Thin optional wrapper over torch.utils.tensorboard."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(logdir)
        except Exception as e:  # tensorboard not installed
            print(f"Tensorboard not available: not logging progress ({e})")
            self.writer = None

    def scalar(self, tag: str, value: float, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)

    def image(self, tag: str, img, step: int):
        """img: [C,H,W] float in [0,1] (numpy)."""
        if self.writer is not None:
            import numpy as np
            self.writer.add_image(tag, np.clip(np.asarray(img), 0, 1), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


@contextmanager
def profile_trace(logdir: Optional[str]):
    """Record a torch.profiler trace (host, and the card where there is
    one) with tracing on, and write it to `logdir`/trace.json
    (chrome://tracing; the stages are its ``gm/`` annotations) and the
    counters to `logdir`/counters.json."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = tracing(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        tracing(was)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(collect()[1], f, indent=1, sort_keys=True)


# --- spans and counters ----------------------------------------------------

# the launch counters of the hand-written kernels: K1, K2, K3, K4, K5, K6
LAUNCHES = ("raster_fwd", "raster_bwd", "raster_fwd_seeded", "raster_bwd_seeded", "segsum",
            "preprocess_fwd")
MAX_SPANS = 1 << 17     # the buffer keeps the newest spans


class Span(NamedTuple):
    """One closed span: host times from time.perf_counter_ns."""
    name: str
    parent: Optional[str]
    id: Optional[int]       # the id of its root (of the last root opened)
    thread: int             # threading.get_native_id(), the profiler's tid
    start_ns: int
    end_ns: int


_on = False
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_threads = threading.local()
_root: Optional["_Open"] = None
_root_id: Optional[int] = None
_counts: Dict[str, int] = {}
_device_counts: dict = {}
_lock = threading.Lock()


class _Off:
    """The span of tracing off: nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span while tracing is on (see span)."""

    __slots__ = ("name", "id", "parent", "outer_root", "annotation", "start_ns")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        global _root, _root_id
        stack = _stack()
        if self.id is not None:
            self.parent, self.outer_root = None, _root
            _root, _root_id = self, self.id
        else:
            self.parent = stack[-1].name if stack else (_root.name if _root else None)
        stack.append(self)
        import torch
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function("gm/" + self.name)
            self.annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _root
        end_ns = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        stack = _stack()
        stack.remove(self)
        if self.id is not None:
            _root = self.outer_root
        _spans.append(Span(self.name, self.parent, self.id if self.id is not None else _root_id,
                           threading.get_native_id(), self.start_ns, end_ns))
        return False


def _stack() -> List[_Open]:
    stack = getattr(_threads, "stack", None)
    if stack is None:
        stack = _threads.stack = []
    return stack


def span(name: str, id: Optional[int] = None):
    """A context manager timing the stage `name` (a root span given `id`);
    a shared no-op while tracing is off. Its ``__enter__`` and
    ``__exit__`` may also be called apart, on one thread, for a stage that
    no ``with`` block can hold (the DINO tower's backward)."""
    if not _on:
        return _OFF
    return _Open(name, id)


def child(suffix: str):
    """A span named ``<innermost open span>.<suffix>`` (the open root's
    name on a thread with none open; `suffix` alone outside every span),
    so that code called under several stages is read under each of them
    by name (the DINO tower's blocks: ``losses.dino.render.attn``); a
    shared no-op while tracing is off."""
    if not _on:
        return _OFF
    stack = _stack()
    outer = stack[-1].name if stack else (_root.name if _root else None)
    return _Open(f"{outer}.{suffix}" if outer else suffix, None)


def tracing(on: bool) -> bool:
    """Switch tracing on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


def is_tracing() -> bool:
    return _on


def count(name: str, value) -> None:
    """Add `value` to the counter `name`: a host int at once, a 0-d device
    tensor on the device (held; read by counter and collect). A tensor is
    dropped while tracing is off."""
    if isinstance(value, int):
        with _lock:
            _counts[name] = _counts.get(name, 0) + value
        return
    if not _on:
        return
    with _lock:
        held = _device_counts.get(name)
        _device_counts[name] = value.long() if held is None else held + value


def counter(name: str) -> int:
    """The counter's value (waits for the device if it holds a tensor)."""
    with _lock:
        host, held = _counts.get(name, 0), _device_counts.get(name)
    return host + (int(held) if held is not None else 0)


def collect() -> Tuple[List[Span], Dict[str, int]]:
    """The spans recorded and every counter, then clears both."""
    with _lock:
        spans = list(_spans)
        _spans.clear()
        names = set(_counts) | set(_device_counts)
        counts = {n: _counts.get(n, 0) + (int(_device_counts[n]) if n in _device_counts else 0)
                  for n in sorted(names)}
        _counts.clear()
        _device_counts.clear()
    return spans, counts
