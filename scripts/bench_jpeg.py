#!/usr/bin/env python3
"""Run chip_smoke.py's JPEG phase (phase 10) alone, on one CUDA card.

    python3 scripts/bench_jpeg.py [--seed 0]

Builds the kernels from csrc/ (chip_smoke.build_all), then
chip_smoke.jpeg_path: the committed fixtures of tests/torch_data/jpeg
and chip_smoke.textured_photo at 5187x3361 against the digests Pillow
gave (the image codec is built by g++ on this machine at first use),
then the Mip-NeRF-360-layout scene (6 K1 renders at 5187x3361 written as
JPEG, convert's images_2/4/8, train -i images_4 for 10 iterations with
K1/K2/K5 counted, the full-size load under the 1600-px cap) and the host
codec's times, on the renders and on high-entropy copies of them. A
failed check exits non-zero, as in chip_smoke.py.
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
        print("bench_jpeg: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card} | {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    cs.build_all()
    with tempfile.TemporaryDirectory(prefix="bench_jpeg_") as root:
        cs.jpeg_path(root, args.seed, dev, card)
    print(f"[jpeg] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
