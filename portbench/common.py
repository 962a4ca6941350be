"""What every part of the benchmark shares: where its files are, how a
name in BENCHMARK.json finds its file, the run's command line, the
process clock, the table of peaks and the check that no JAX module was
loaded."""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussmart_tpu")
# the tower of a configuration's `dino` that names no `kind`
DEFAULT_TOWER = "dinov3-vit"


class Run(NamedTuple):
    """What a driver returns: the run's record (what the metrics read), the
    numbers the reference compared, the steps or requests attempted, and the
    control (control.py): (precision, fault) -> the same numbers with the
    reference in the program's place, in that precision or with that fault."""
    rec: Dict[str, Any]
    numbers: Dict[str, float]
    attempted: int
    control: Callable[[str, Any], Dict[str, float]]


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(SPEC)


def cell(spec_: dict, name: str):
    """(workload, config entry, config file, traffic file) of a cell."""
    work = {w["name"]: w for w in spec_["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec_["configs"]}[w["config"]]
    return w, conf, load_json(ROOT / conf["file"]), load_json(HERE / "traffic" / f"{w['traffic']}.json")


def module(kind: str, name: str):
    """portbench/<kind>/<name>.py, loaded by path (names may hold '.' and '-')."""
    path = HERE / kind / f"{name}.py"
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec_ = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec_)
    sys.modules[key] = mod
    spec_.loader.exec_module(mod)
    return mod


def tower(dino: dict):
    """The tower kind a configuration's `dino` names: towers/<kind>.py."""
    return module("towers", dino.get("kind", DEFAULT_TOWER))


def role(workload: str) -> str:
    """What a cell's driver does, "train" or "view" (the driver's ROLE):
    how its runs are traced and checked, whatever the driver's name."""
    return module("drivers", cell(spec(), workload)[3]["driver"]).ROLE


def metrics_of(spec_: dict, workload: str, trace: int):
    """The (name, entry) pairs a run of `workload` reports: its end-to-end
    metrics, or with --trace 1 its per-layer metrics (each per-layer metric
    names its cells under `workloads`)."""
    if trace:
        return [(m["name"], m) for m in spec_["per_layer"] if workload in m["workloads"]]
    return [(m["name"], m) for m in spec_["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def sync(device):
    """Wait for the device (nothing to wait for on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    """Start the device's peak memory reading afresh (from the inputs made)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The device's peak allocated bytes since the last reset_peak (0 on the
    CPU, where it is not measured)."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0
