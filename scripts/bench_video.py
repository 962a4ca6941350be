#!/usr/bin/env python3
"""Run chip_smoke.py's trajectory-video phase (phase 12) alone, on one CUDA card.

    python3 scripts/bench_video.py [--seed 0]

Builds the kernels and the host image codec from the checkout's sources
(chip_smoke.build_all), writes phase 4's trained-model directory (100k
splats, SH 3, 8 views at 776x584, from --seed), then
chip_smoke.render_path_videos: render_cli --render_path --skip_train
--skip_test --skip_mesh (240 trajectory frames through K1, counted, its
stages and each K1 call timed), the three videos read back as 240 I-VOPs
at 776x584 and 30 fps, each byte-equal to its re-encode from the exported
PNG and TIFF files (encode timed), and the integer-only fixtures against
tests/torch_data/video/digests.json. A failed check exits non-zero, as in
chip_smoke.py.
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
        print("bench_video: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card} | {torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    t0 = time.perf_counter()
    cs.build_all()
    with tempfile.TemporaryDirectory(prefix="bench_video_") as root:
        model, _, _ = cs.write_model_dir(root, args.seed, cs.N_SPLATS, cs.WIDTH, cs.HEIGHT,
                                         cs.N_VIEWS)
        cs.render_path_videos(model, dev, card)
    print(f"[video] done in {time.perf_counter() - t0:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {cs.card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
