#!/usr/bin/env python3
"""Run chip_smoke.py's training-preprocess phase (phase 15) alone, on one CUDA card.

    python3 scripts/bench_preprocess_grad.py [--seed 0]

Builds the kernels from the checkout's sources (chip_smoke.build_all),
makes phase 4's model (100k splats, SH 3, 8 views at 776x584, from
--seed), then chip_smoke.preprocess_grad_path: K8's forward
(preprocess_grad_fwd) against the chain bit for bit and its VJP
(preprocess_bwd) against autograd through the chain, on the model's views
and on a 3M-splat state at 1296x840, and the timings (both kernels beside
their byte bounds, the chain's forward and backward). A failed check exits
non-zero, as in chip_smoke.py.
"""
from __future__ import annotations

import argparse
import sys
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
        print("bench_preprocess_grad: no CUDA device", file=sys.stderr)
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
    params = cs.scene_params(args.seed, cs.N_SPLATS, cs.SH_DEGREE)
    state = state_from_numpy(params, np.ones(cs.N_SPLATS, bool),
                             np.zeros(cs.N_SPLATS, np.int32), cs.SH_DEGREE, cs.SH_DEGREE,
                             1.0, device=dev)
    cams = cs.bench_cameras(cs.N_VIEWS, cs.WIDTH, cs.HEIGHT)
    cs.preprocess_grad_path(state, cams, args.seed, dev, card)
    print(f"[grad] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
