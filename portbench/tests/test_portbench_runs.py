"""Whole runs at a tiny size on the CPU: each cell's driver and run.py past
its look for a card (sound, and with the timed path broken underneath, where
`correct` has to come out false), run.py without a card and without the
system beside it, no JAX module in a run's process, a traced run's record
of the program's spans, and cells classed by their driver's ROLE. One test
needs the card (marker `cuda`)."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import common
from portbench.tests.helpers import run_args, tiny_cell

CELLS = [w["name"] for w in common.spec()["workloads"]]


def is_training(workload):
    """A cell is checked as training by its driver's ROLE, not its name."""
    return common.role(workload) == "train"


TRAIN = [w for w in CELLS if is_training(w)]
SERVED = [w for w in CELLS if w not in TRAIN]
DEVICE_METRICS = {"peak_mem_gib"}


def _run_on_cpu(monkeypatch, capsys, workload):
    """run.main past its look for a card, on the CPU, at a tiny size:
    (exit code, the result line)."""
    from portbench import run
    tiny = tiny_cell(workload)
    monkeypatch.setattr(run, "DEVICE", "cpu")
    monkeypatch.setattr(run.common, "cell", lambda spec, name: tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu (test)")
    a = run_args(workload)
    rc = run.main(["--workload", workload, "--seed", str(a.seed), "--seconds",
                   str(a.seconds), "--trace", "0"])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct_and_writes_no_device_metric(monkeypatch, capsys, workload):
    rc, res = _run_on_cpu(monkeypatch, capsys, workload)
    assert rc == 0 and res["correct"] is True, res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert not DEVICE_METRICS & set(res["metrics"])
    assert list(res)[-1] == "compared"
    assert all(c["value"] <= c["limit"] for c in res["compared"].values())


# the step's first call of the window: set-up makes three check calls and
# two warm ones before it
WINDOW_CALL = 6


def _unchanged(step):
    """The step returning the state it was given."""
    def same(params, adam, aux, cam, gt, iteration):
        _, _, _, metrics, nxt = step(params, adam, aux, cam, gt, iteration)
        return params, adam, aux, metrics, nxt
    return same


def _half_batch(step):
    """The step taking its photometric loss over the top half of the rows."""
    from gaussmart_tpu_torch import train_lib
    loss = train_lib.photometric_loss

    def half(*args):
        train_lib.photometric_loss = lambda image, gt, lam: loss(
            image[:, :image.shape[1] // 2], gt[:, :gt.shape[1] // 2], lam)
        try:
            return step(*args)
        finally:
            train_lib.photometric_loss = loss
    return half


def _plant(fault, from_call=1):
    """Plant a training fault in every step the system makes, from its
    `from_call`-th call on."""
    def plant(monkeypatch):
        from gaussmart_tpu_torch import train_lib
        make = train_lib.make_train_step

        def made(*a, **k):
            sound = make(*a, **k)
            broken, calls = fault(sound), [0]

            def step(*args):
                calls[0] += 1
                return (broken if calls[0] >= from_call else sound)(*args)
            return step
        monkeypatch.setattr(train_lib, "make_train_step", made)
    plant.__name__ = fault.__name__
    return plant


def _altered_answer(monkeypatch):
    from gaussmart_tpu_torch.viewer import protocol
    to_bytes = protocol.image_to_bytes

    def altered(image):
        data = bytearray(to_bytes(image))
        mid = (image.shape[1] // 2 * image.shape[2] + image.shape[2] // 2) * 3
        data[mid] ^= 0x80
        return bytes(data)
    monkeypatch.setattr(protocol, "image_to_bytes", altered)


FAULTS = [(w, _plant(f)) for w in TRAIN for f in (_unchanged, _half_batch)] + \
    [(w, _altered_answer) for w in SERVED]
LATE_FAULTS = [(w, _plant(f, WINDOW_CALL)) for w in TRAIN for f in (_unchanged, _half_batch)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, workload, fault):
    fault(monkeypatch)
    rc, res = _run_on_cpu(monkeypatch, capsys, workload)
    assert rc == 0 and res["correct"] is False, res["compared"]


@pytest.mark.parametrize("workload,fault", LATE_FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in LATE_FAULTS])
def test_a_fault_from_the_windows_first_call_on_is_not_correct(monkeypatch, capsys, workload,
                                                               fault):
    """The set-up's check and warm steps stay sound; the steps after the
    window, which the steady check compares, carry the fault."""
    fault(monkeypatch)
    rc, res = _run_on_cpu(monkeypatch, capsys, workload)
    assert rc == 0 and res["correct"] is False, res["compared"]
    first = [k for k in res["compared"] if not k.startswith("steady_")]
    assert all(res["compared"][k]["value"] <= res["compared"][k]["limit"] for k in first)


def _run_py(cwd, workload=CELLS[0]):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_py_exits_non_zero_without_a_card():
    p = _run_py(common.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout


def test_run_py_exits_non_zero_without_the_system_beside_it(tmp_path):
    shutil.copy(common.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(common.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax_module():
    """Every module of the benchmark and what its drivers load of the
    system, then a tiny run of each driver: no loaded module's whole
    top-level name is jax, jaxlib, flax or gaussmart_tpu."""
    code = """
import argparse, sys, torch
sys.path.insert(0, %r)
from portbench import common, check, counts, scene, trace, control, run
from portbench.tests.helpers import tiny_cell, run_args
spec = common.spec()
for w in spec["workloads"]:
    _, _, cfg, traffic = tiny_cell(w["name"])
    for name, _ in common.metrics_of(spec, w["name"], 0) + common.metrics_of(spec, w["name"], 1):
        common.module("metrics", name)
    common.module("drivers", traffic["driver"]).run(run_args(w["name"], seconds=0.2), cfg,
                                                      traffic, torch.device("cpu"))
assert all(n.split(".")[0] != "gaussmart_tpu" for n in sys.modules)
print(",".join(common.forbidden_modules()) or "none")
""" % str(common.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "none"


def _traced_on_cpu(monkeypatch, workload, spans_window):
    """The cell's driver at a tiny size on the CPU with --trace 1, on a
    clock that ticks a second at each reading, so that a window takes the
    same steps or frames every time; the profiler traces the CPU alone over
    windows of 2 calls, and the stage times' CUDA events read 0. With
    `spans_window` False, spans.traced runs no window of its own."""
    import time
    from torch.profiler import ProfilerActivity
    from portbench import spans

    class Event:
        def __init__(self, **k):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.0
    ticks = iter(range(10**9))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    profile = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities, **k: profile(activities=[ProfilerActivity.CPU], **k))
    if not spans_window:
        monkeypatch.setattr(spans, "traced", lambda role, fn, n, host_calls, warmup=1: None)
    _, _, cfg, traffic = tiny_cell(workload)
    driver = common.module("drivers", traffic["driver"])
    for name in ("PROFILED_STEPS", "PROFILED_FRAMES", "HOST_STEPS", "HOST_FRAMES"):
        if hasattr(driver, name):
            monkeypatch.setattr(driver, name, 2 if name.startswith("PROFILED") else 3)
    return driver.run(run_args(workload, seconds=3.5, trace=1), cfg, traffic,
                      torch.device("cpu")).rec


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_keeps_the_program_spans_and_the_same_work(monkeypatch, workload):
    from portbench import spans
    rec = _traced_on_cpu(monkeypatch, workload, True)
    role = common.role(workload)
    kept = rec["spans"]
    assert kept["calls"] >= 1 and set(kept["metrics"]) == set(spans.METRICS[role])
    root = "step" if role == "train" else "frame"
    assert kept["host_ms"][root] > 0 and "render.binning" in kept["host_ms"]
    assert kept["host_calls"] == 3 and kept["host_median_ms"][root] > 0
    if role == "train":
        assert kept["counters"]["render.rect_pairs"] > 0
        assert 0 < kept["metrics"]["pair_yield.train"] <= 100
    for name in spans.METRICS[role]:
        value = common.module("metrics", name).read(rec)
        assert value is not None and value >= 0, name
    without = _traced_on_cpu(monkeypatch, workload, False)
    assert without["spans"] is None and rec["work"] and rec["work"] == without["work"]


def test_a_training_driver_under_another_name_is_training(monkeypatch, tmp_path):
    """A driver named `fit` that declares ROLE = "train" is classed as
    training by these tests and by portbench/spans.py."""
    from portbench import run, spans, trace
    train = common.module("drivers", "train")
    fit = dict(common.cell(common.spec(), TRAIN[0])[3], driver="fit")
    cell, module = common.cell, common.module
    monkeypatch.setattr(common, "cell", lambda spec, name: cell(spec, TRAIN[0])[:3] + (fit,))
    monkeypatch.setattr(common, "module", lambda kind, name: train if (kind, name) == (
        "drivers", "fit") else module(kind, name))
    assert is_training("x.fit")
    seen = []
    monkeypatch.setattr(trace, "profile", lambda fn, n, warmup=1: None)
    monkeypatch.setattr(spans, "window", lambda *a, **k: (0.001, {}))
    monkeypatch.setattr(spans, "_add", lambda total, summary: None)
    monkeypatch.setattr(spans, "report", lambda workload, role, *a: seen.append(role) or {})
    monkeypatch.setattr(run, "main", lambda argv: trace.profile(lambda i: None, 1) and 0)
    monkeypatch.chdir(tmp_path)
    spans.main(["--workload", "x.fit", "--seed", "1", "--seconds", "1"])
    assert seen == ["train"]


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", TRAIN[0],
                        "--seed", "2147483901", "--seconds", "2", "--trace", "0"],
                       cwd=common.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
