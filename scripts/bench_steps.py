#!/usr/bin/env python3
"""Time the training step and the Gaussian-sharded training step of one
checkout of the port on one CUDA card.

    python3 scripts/bench_steps.py [--root DIR]

DIR (default: this checkout) is the root of a checkout that holds
chip_smoke.py and gaussmart_tpu_torch/, for example the parent commit
unpacked with `git archive` into a directory that .gitignore lists. Its
kernels are built from its own sources (chip_smoke.build_all), and its
chip_smoke.time_training times make_train_step and make_mp_train_step
over chip_smoke.N_SLOTS slots on bench.py's mid-training state (100k
splats, 776x584): iterations/s, the stages by CUDA events, the device
kernel time and busy share from torch.profiler. To compare two checkouts,
run them in one call on one card, in turns: parent, change, change,
parent.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout to time")
    args = ap.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)

    import torch
    if not torch.cuda.is_available():
        print("bench_steps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.parallel.sharding import make_mesh
    from gaussmart_tpu_torch.runtime import setup
    if not cs.__file__.startswith(root):
        raise SystemExit(f"imported {cs.__file__}, not the checkout at {root}")
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[steps] checkout {root}")
    cs.build_all()
    state, cams, gts = cs.bench_state(0, cs.N_SPLATS, cs.WIDTH, cs.HEIGHT, dev)
    cs.time_training(state, cams, gts, card)
    cs.time_training(state, cams, gts, card, mesh=make_mesh(cs.N_SLOTS, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
