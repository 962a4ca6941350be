"""portbench/spans.py on a synthetic Chrome trace: device operations put
down to the innermost `gm/` span around their launch (through the runtime
call's correlation, on the launching thread first, a launch on autograd's
thread outside its own spans to the span open on another thread, and
through `External id`), idle gaps to the innermost span at their middle
on any thread, and the numbers derived from the program's own spans and
counters."""
import pytest

from gaussmart_tpu_torch.logging_utils import Span
from portbench import spans

MAIN, AUTOGRAD = 11, 22


def _x(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    ann = "user_annotation"
    return [
        _x("ProfilerStep#3", ann, MAIN, 0.0, 100.0),
        _x("gm/step", ann, MAIN, 0.0, 100.0),
        _x("gm/render.preprocess", ann, MAIN, 5.0, 25.0),
        _x("gm/render.binning", ann, MAIN, 30.0, 30.0),
        _x("gm/render.binning.sync", ann, MAIN, 50.0, 10.0),
        _x("gm/backward", ann, MAIN, 60.0, 40.0),
        _x("gm/backward.raster", ann, AUTOGRAD, 70.0, 20.0),
        _x("record_param_comms", ann, MAIN, 1.0, 2.0),          # not a gm/ span
        _x("cudaLaunchKernel", "cuda_runtime", MAIN, 10.0, 1.0, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", MAIN, 40.0, 1.0, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 75.0, 1.0, correlation=3),
        _x("cudaLaunchKernel", "cuda_runtime", AUTOGRAD, 65.0, 1.0, correlation=4),
        _x("aten::add", "cpu_op", MAIN, 2.0, 1.0, **{"External id": 9}),
        _x("k_prep", "kernel", 7, 12.0, 8.0, correlation=1),
        _x("k_bin", "kernel", 7, 41.0, 4.0, correlation=2),
        _x("k2", "kernel", 7, 76.0, 19.0, correlation=3),
        _x("k_grad", "kernel", 7, 66.0, 2.0, correlation=4),
        _x("Memcpy DtoH", "gpu_memcpy", 7, 96.0, 3.0, **{"External id": 9}),
    ]


def test_attribute_puts_device_ops_and_idle_gaps_down_to_spans():
    got = spans.attribute(_trace())
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx((8 + 4 + 19 + 2 + 3) * 1e-6)
    assert got["kernels"] == 4
    assert got["device_s"] == pytest.approx({
        "render.preprocess": 8e-6, "render.binning": 4e-6,
        "backward.raster": 19e-6,          # launched inside it, on autograd's thread
        "backward": 2e-6,                  # autograd's thread outside its spans
        "step": 3e-6})                     # by External id, to the root
    # gaps [0,12] [20,41] [45,66] [68,76] [95,96] [99,100]: middles 6, 30.5,
    # 55.5, 72 (backward.raster, the latest to open, on the other thread),
    # 95.5, 99.5
    assert got["idle_s"] == pytest.approx({
        "render.preprocess": 12e-6, "render.binning": 21e-6,
        "render.binning.sync": 21e-6, "backward.raster": 8e-6, "backward": 2e-6})
    assert spans.under(got["idle_s"], "render.binning") == pytest.approx(42e-6)


def test_attribute_leaves_out_what_no_span_holds():
    events = [e for e in _trace() if e["name"] not in ("gm/step", "gm/render.preprocess")]
    got = spans.attribute(events)
    assert got["device_s"][spans.OUTSIDE] == pytest.approx((8 + 3) * 1e-6)
    assert got["idle_s"][spans.OUTSIDE] == pytest.approx(12e-6)


def _span(name, ms, parent=None):
    return Span(name, parent, 3, MAIN, 0, int(ms * 1e6))


def test_metrics_per_call_from_the_trace_and_the_program():
    summary = spans.attribute(_trace())
    program = [_span("step", 9.0), _span("render.binning", 4.0, "step"),
               _span("render.binning.sync", 1.5, "render.binning"),
               _span("frame.to_host", 2.0), _span("frame.to_host.sync", 0.5, "frame.to_host")]
    summary["program_s"], summary["program_self_s"] = spans.program_spans(program)
    summary["counters"] = {"render.rect_pairs": 400, "render.live_pairs": 100}
    train = spans.metrics("train", summary, calls=2)
    assert train["binning_ms.train"] == pytest.approx(1e3 * 4e-6 / 2)
    assert train["preprocess_ms.train"] == pytest.approx(1e3 * 8e-6 / 2)
    assert train["pair_yield.train"] == pytest.approx(25.0)
    assert train["sync_wait_ms.train"] == pytest.approx((1.5 + 0.5) / 2)
    assert train["dino_target_ms.train"] == train["dino_bwd_ms.train"] == 0.0
    view = spans.metrics("view", summary, calls=2)
    assert view["to_host_ms.view"] == pytest.approx((2.0 - 0.5) / 2)
    assert set(view) == set(spans.METRICS["view"])
    summary["counters"] = {}
    assert spans.metrics("train", summary, calls=1)["pair_yield.train"] is None


def test_host_window_reads_the_median_call(monkeypatch):
    """host_window's host readings: per call, told apart by the root's id,
    the ms in the `.sync` spans and in `frame.to_host` less its sync; each
    the median over the calls after the warm-up, which is left out."""
    import time

    from gaussmart_tpu_torch import logging_utils
    clock = [0]
    monkeypatch.setattr(time, "perf_counter_ns", lambda: clock[0])

    def wait(ms):
        clock[0] += int(ms * 1e6)
    # call: (binning's sync, the copy, its sync) in ms; call 0 warms up
    calls = {0: (50.0, 50.0, 50.0), 1: (1.0, 1.0, 0.5), 2: (2.0, 4.0, 0.5), 3: (10.0, 2.0, 0.5)}

    def frame(i):
        binning_sync, copy, copy_sync = calls[i]
        with logging_utils.span("frame", id=100 + i), logging_utils.span("render.binning"):
            with logging_utils.span("render.binning.sync"):
                wait(binning_sync)
        with logging_utils.span("frame.to_host"):
            wait(copy)
            with logging_utils.span("frame.to_host.sync"):
                wait(copy_sync)

    got = spans.host_window("view", frame, 3)
    assert not logging_utils.is_tracing() and got["host_calls"] == 3
    assert got["metrics"] == pytest.approx({"sync_wait_ms.view": 2.5, "to_host_ms.view": 2.0})
    assert got["host_median_ms"]["frame.to_host"] == pytest.approx(2.5)
    assert got["host_median_ms"]["render.binning.sync"] == pytest.approx(2.0)
