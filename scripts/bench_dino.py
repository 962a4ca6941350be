#!/usr/bin/env python3
"""Run chip_smoke.py's DINO-term and viewer phase and its timings alone,
on one CUDA card.

    python3 scripts/bench_dino.py [--seed 0]

Builds the kernels from csrc/ (chip_smoke.build_all), writes the phase-4
model directory and the phase-5 training scene (100k splats, 776x584),
then chip_smoke.dino_viewer_path: a DINOv3 ViT-B/16 npz at the published
widths (random weights), its tokens and the fixed term's gradient on the
card against a CPU copy, two backwards of the training step with the term
bit-equal, train.main with the term gated (single-device, then
Gaussian-sharded and data-parallel over 4 slots), viewer.serve and train
--gui answering a scripted client; then chip_smoke.time_dino_viewer: the
tower's forward and the term against their float32 FLOP bounds, the
training step without and with the term in turns, and the viewer's round
trip per render item. A failed check exits non-zero, as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    import torch
    if not torch.cuda.is_available():
        print("bench_dino: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.models.gaussians import state_from_numpy
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card} | {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    cs.build_all()
    state_t, cams_t, gts_t = cs.bench_state(args.seed, cs.N_SPLATS, cs.WIDTH, cs.HEIGHT, dev)
    with tempfile.TemporaryDirectory(prefix="bench_dino_") as root:
        model, cams, params = cs.write_model_dir(root, args.seed, cs.N_SPLATS, cs.WIDTH,
                                                 cs.HEIGHT, cs.N_VIEWS)
        state_s = state_from_numpy(params, np.ones(cs.N_SPLATS, bool),
                                   np.zeros(cs.N_SPLATS, np.int32), cs.SH_DEGREE,
                                   cs.SH_DEGREE, 1.0, device=dev)
        cs.write_train_scene(os.path.join(root, "train_scene"), args.seed, cs.N_SPLATS,
                             cs.WIDTH, cs.HEIGHT)
        phase8 = cs.dino_viewer_path(root, args.seed, model, cams, state_s, state_t, cams_t,
                                     gts_t, dev)
    cs.time_dino_viewer(*phase8, state_t, cams_t, gts_t, card)
    print(f"[dino] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
