#!/usr/bin/env python3
"""Run chip_smoke.py's semantic-preprocessing phase (phase 9) alone, on one
CUDA card.

    python3 scripts/bench_semantics.py [--seed 0]

Builds the kernels from csrc/ (chip_smoke.build_all), then
chip_smoke.semantics_path: the DTU-scale scan (49 K1 renders at
1600x1200, DTU IDR cameras.npz, bench.py's 100k-point cloud) through the
segmentation pipeline on the card and on the CPU, held stage by stage
(hull distances and keep mask, the pixel k-means labels, the projection
given the CPU's masks), then train.main --run_segmentation -t dtu on it
(K1/K2/K5 launches counted, its pipeline subprocess's artifacts against
the first card run's), with each stage's time. A failed check exits
non-zero, as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    import torch
    if not torch.cuda.is_available():
        print("bench_semantics: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card} | {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    cs.build_all()
    with tempfile.TemporaryDirectory(prefix="bench_semantics_") as root:
        cs.semantics_path(root, args.seed, dev, card)
    print(f"[semantics] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
