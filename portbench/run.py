"""One run of one cell of BENCHMARK.json on the CUDA card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json), which names its driver (drivers/<driver>.py). The
driver makes the inputs from the seed, sets up the system under test
(gaussmart_tpu_torch), runs the measured window and returns the run's
record and the numbers the reference compared. Each metric the cell
reports is read from the record by metrics/<metric>.py. The last line of
standard output is the result as one JSON object; the numbers compared,
each beside its limit (limits/<cell>.json), are the last lines of standard
error and the last key of the result.

Exits non-zero and prints no result without enough CUDA cards, and when a
JAX module or the JAX package is loaded once the window has closed."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# one process with few threads: the host side of a step is one Python thread
# dispatching to the card, and an idle OpenMP pool spinning beside it only
# adds noise (measured: 6% faster and a narrower spread on the host-bound
# cells with one thread)
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

from portbench import check, common  # noqa: E402

DEVICE = "cuda"


def power_limit_w():
    """The card's power limit in watts, from nvidia-smi (None if unread)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    args = common.parse_args(argv)
    spec = common.spec()
    work, _, cfg, traffic = common.cell(spec, args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"[portbench] {args.workload} needs {work['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = common.module("drivers", traffic["driver"])
    rec, numbers, attempted, _ = driver.run(args, cfg, traffic, torch.device(DEVICE))
    loaded = common.forbidden_modules()
    if loaded:
        print(f"[portbench] the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    correct, compared = check.verdict(numbers, check.limits(args.workload))

    metrics = {}
    for name, m in common.metrics_of(spec, args.workload, args.trace):
        value = common.module("metrics", name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": work["chips"], "memory_peak_bytes": int(rec["peak_bytes"]),
              "power_limit_w": power_limit_w()}
    # a step or a request that fails raises: none that returned has failed
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device}
    if args.trace:
        tr = rec.get("trace") or {"busy_s": 0.0, "window_s": 0.0, "top": [], "gaps": []}
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr["top"]],
                               "idle_gaps": [[n, s] for n, s in tr["gaps"]]}
    result["compared"] = compared
    sys.stdout.flush()
    phases = dict(setup_s=rec["setup_s"], window_s=rec["window_s"], **rec.get("phases", {}))
    print("[phases] " + " ".join(f"{k} {v:.2f}" for k, v in phases.items()), file=sys.stderr)
    print("[setup] " + " ".join(f"{k} {v:.2f}" for k, v in rec.get("setup_marks", ())),
          file=sys.stderr)
    for d in rec.get("reference_steps", ()):
        print(f"[reference] {json.dumps(d)}", file=sys.stderr)
    for name, c in compared.items():
        print(f"[compared] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
