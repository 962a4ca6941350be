"""The control and the planted faults of a cell, read on the chip at the
cell's own size: for each seed, one run of the cell's driver with no
measured window (a training cell) or a short one (a served cell), in one
process, printing as one JSON line per seed the numbers that compare the
system with the reference (the lower readings) and those that compare
with it the reference put in the system's place in TF32, and the planted
faults (the upper readings), each with the verdict the cell's limits give
it (`correct`). The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, common  # noqa: E402

VARIANTS = {"train": (("tf32", None), ("float32", "half")),
            "view": (("tf32", None), ("float32", "altered"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control_seeds", type=int, default=3,
                    help="the first this many seeds also read the control and the faults")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[control] no CUDA card", file=sys.stderr)
        return 2
    _, _, cfg, traffic = common.cell(common.spec(), args.workload)
    driver = common.module("drivers", traffic["driver"])
    lim = check.limits(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                 trace=0)
        out = driver.run(run, cfg, traffic, torch.device("cuda"))
        read = {"program": out.numbers}
        if i < args.control_seeds:
            read.update({f"{p}/{f}": out.control(p, f) for p, f in VARIANTS[driver.ROLE]})
        line = {k: dict(v, correct=check.verdict(v, lim)[0]) for k, v in read.items()}
        print(json.dumps({"seed": seed, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
