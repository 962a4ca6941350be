#!/usr/bin/env python3
"""Run chip_smoke.py's mesh-export and evaluation phase and its mesh
timings alone, on one CUDA card.

    python3 scripts/bench_mesh.py [--seed 0]

Builds the kernels from csrc/ (chip_smoke.build_all), then
chip_smoke.mesh_path: the 100k-surfel sphere model exported by render_cli
bounded at --mesh_res 1024 and --unbounded at chip_smoke.UNBOUNDED_RES
(K1 launches counted, each mesh held to the sphere), the card's TSDF grid
against a CPU copy, metrics_cli with and without LPIPS weights; then
chip_smoke.time_mesh: TSDF integrate per view on the bounded grid and at
the 200M-voxel cap with the byte bound, the int8 pull, marching, welding
and colour lookup, fuse_samples per 128^3 block, LPIPS(vgg) per pair and
the CLIs' wall times. A failed check exits non-zero, as in chip_smoke.py.
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
        print("bench_mesh: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card} | {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    cs.build_all()
    with tempfile.TemporaryDirectory(prefix="bench_mesh_") as root:
        ex, geo, walls, evals = cs.mesh_path(root, args.seed, dev)
        cs.time_mesh(ex, geo, walls, evals, card, dev)
    print(f"[mesh] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
