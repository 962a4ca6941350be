#!/usr/bin/env python3
"""Run chip_smoke.py's evaluation phase (phase 11) alone, on one CUDA card.

    python3 scripts/bench_synthetic.py [--iterations 7000] [--seed 0]

Builds the kernels from csrc/ (chip_smoke.build_all), then
chip_smoke.synthetic_path: the ray-traced validation scene of BASELINE.md's
bounded photometric recipe (33 views at 776x584, 30,000 SfM points,
200,000 GT samples) generated on the card by the port's
make_synthetic_scene, trained by the port's train CLI at -r 2 over the
scene's white background with the default schedule for --iterations
(K1/K2/K5 launches counted; densify passes, opacity resets, SH raises,
capacity growths and evals recorded),
rendered with the bounded mesh (render_cli, --mesh_res 1024, the grid
within the 200M-voxel cap), scored by metrics_cli and the Chamfer of fuse.ply at crop radius 2.0.
At 7000 iterations (chip_smoke.py's depth) it holds the 7k floors on test
PSNR and SSIM; --iterations 30000 runs the whole recipe and holds the 30k
floors, the splat range and the Chamfer bound, the recipe alone. At
chip_smoke.py's depth the phase also runs
chip_smoke.start_drivers/finish_drivers: every benchmark driver's chain
at 30 iterations on a tiny scene of its dataset's layout, started first
and run beside the validation run, then the summary. A failed check
exits non-zero, as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=7000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    import torch
    if not torch.cuda.is_available():
        print("bench_synthetic: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card} | {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    cs.build_all()
    with tempfile.TemporaryDirectory(prefix="bench_synthetic_") as root:
        if args.iterations != cs.SYNTH_ITERS:
            cs.synthetic_path(root, dev, card, args.iterations)
        else:
            drivers = cs.start_drivers(root, args.seed, dev)
            try:
                cs.synthetic_path(root, dev, card, args.iterations, beside=cs.BESIDE_DRIVERS)
            finally:
                cs.finish_drivers(drivers, card, beside=cs.BESIDE_SYNTHETIC)
    print(f"[synthetic] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
