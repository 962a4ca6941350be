#!/usr/bin/env python3
"""Time builds of the backward compositor (K2 raster_bwd, K4
raster_bwd_seeded) against each other, in turns, on one CUDA card.

    python3 scripts/bench_raster_bwd.py [--baseline OTHER/raster_bwd.cu]
        [--variant LABEL:NAME=VALUE[,NAME=VALUE...]] ...

Sources: "current" is gaussmart_tpu_torch/csrc/raster_bwd.cu; --baseline
adds another file with the same C entry points (for example the parent
commit's, unpacked with `git archive`); each --variant adds the current
source with its `constexpr int NAME = ...;` constants set to VALUE. Each
is built with kernels.NVCC_FLAGS into its own library (their ptxas
reports are printed) and called through ctypes, with kernels.SIGNATURES'
argument types, as the wrapper calls it.

Frames (chip_smoke.py's): the full-width training frame (bench.py's state,
camera 0, 776x584, SH bands above 0 masked) for K2 with need_dist/need_med
(False, False) and (True, True), and its first depth stratum of 4 from
the identity seed (pass 1 of the Gaussian-sharded step) for K4. Every
source's rows and seed gradient are held against the first source's
(within 1e-5 of each column's max). Then ROUNDS rounds, the sources in
order and then reversed, each timing every case as the median of FRAMES
launches (CUDA events around each, kernel only: the rows are zero-filled
once). Prints one line per (source, case) with the median over the turns
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ROUNDS = 2
FRAMES = 20


def build(label, text, out_dir):
    """Compile `text` (a raster_bwd.cu) into out_dir/lib<label>.so; returns
    (label, library path, ptxas report)."""
    from gaussmart_tpu_torch import kernels
    src = out_dir / f"{label}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{label}.so"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {label}:\n{proc.stdout}")
    return label, lib, proc.stdout


def with_constants(text, assignments):
    for name, value in assignments:
        text, n = re.subn(rf"constexpr int {name} = [^;]+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"no `constexpr int {name}` in the source")
    return text


def frames(dev):
    """The cases: {name: (entry, inputs)} with the frame tensors."""
    import torch
    import chip_smoke as cs
    from gaussmart_tpu_torch.render import raster_tiled as rt
    W, H = cs.WIDTH, cs.HEIGHT
    state, cams, _ = cs.bench_state(0, cs.N_SPLATS, W, H, dev)
    prep = cs.frame_prep(state, cams[0], cs.SH_DEGREE, active_degree=0)
    tx, ty = rt.tile_grid(W, H)
    cases = {}
    with torch.inference_mode():
        for label, (p, init) in (("training frame", (prep, None)),
                                 ("pass 1 stratum 1", cs.seeded_stratum(prep, W, H, 0))):
            n = p.depth.shape[0]
            blob = rt.build_blob(p, torch.zeros(n, 2, device=dev), W, H)
            ids, ranges, conics = rt.binning(p, tx, ty)[:3]
            fb, ints = rt.composite_tiles(blob, conics, ids, ranges, W, H, init=init)
            ct = cs.random_cotangent(fb, W, H, rt.CT if init is None else rt.CT_SEEDED)
            io = dict(blob=blob, ids=ids, ranges=ranges, fb=fb, ints=ints, ct=ct,
                      init=init, tiles=(tx, ty))
            needs = [(False, False), (True, True)] if init is None else [(False, False)]
            for need in needs:
                kernel = "raster_bwd" if init is None else "raster_bwd_seeded"
                cases[f"{kernel} {label} need_dist/need_med {need}"] = (io, need)
    return cases


def launcher(lib, io, need):
    """A no-argument function launching `lib`'s kernel on `io`, and the
    outputs it writes (rows, seed gradient or None)."""
    import torch
    from gaussmart_tpu_torch import kernels
    from gaussmart_tpu_torch.render import raster_tiled as rt
    tx, ty = io["tiles"]
    rows = torch.zeros((io["ids"].shape[0], rt.F), device=io["blob"].device)
    head = [io[k].data_ptr() for k in ("blob", "ids", "ranges", "fb", "ints", "ct")]
    if io["init"] is None:
        fn = kernels.bind(lib, "raster_bwd")
        gi = None
        args = head + [tx, ty, int(need[0]), int(need[1]), rows.data_ptr()]
    else:
        fn = kernels.bind(lib, "raster_bwd_seeded")
        gi = torch.empty_like(io["init"])
        args = head + [io["init"].data_ptr(), tx, ty, int(need[0]), int(need[1]),
                       rows.data_ptr(), gi.data_ptr()]

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed with CUDA error {err}")
    return run, (rows, gi)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another raster_bwd.cu to time against")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL:NAME=VALUE[,NAME=VALUE...] of the current source")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_raster_bwd: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    current = (ROOT / "gaussmart_tpu_torch" / "csrc" / "raster_bwd.cu").read_text()
    texts = {"current": current}
    if args.baseline:
        texts["baseline"] = Path(args.baseline).read_text()
    for v in args.variant:
        label, _, sets = v.partition(":")
        texts[label] = with_constants(current, [s.split("=", 1) for s in sets.split(",")])
    out_dir = ROOT / "build" / "bench_raster_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], kv[1], out_dir), texts.items()))
    libs = {}
    for label, path, log in built:
        libs[label] = ctypes.CDLL(str(path))
        for kernel, regs, smem, spills in cs.ptxas_report(log):
            print(f"[build] {label}: {kernel}: {regs} registers, {smem} bytes shared "
                  f"memory, spill stores + loads {spills} bytes")

    cases = frames(dev)
    runs = {(label, case): launcher(lib, io, need)
            for label, lib in libs.items() for case, (io, need) in cases.items()}
    first = next(iter(libs))
    for (label, case), (run, out) in runs.items():
        run()
        ref = runs[(first, case)][1]
        for got, want, what in zip(out, ref, ("rows", "seed gradient")):
            if got is None:
                continue
            got, want = (got.reshape(3, -1).T, want.reshape(3, -1).T) \
                if what == "seed gradient" else (got, want)
            err = ((got - want).abs().amax(0) / (want.abs().amax(0) + 1e-30)).max().item()
            print(f"[check] {label}, {case}: {what} vs {first} per column of its max "
                  f"{err:.3g} (limit 1e-5)")
            if not err <= 1e-5:
                raise SystemExit(f"[check] {label} disagrees with {first}")

    order = list(libs)
    times = {key: [] for key in runs}
    for r in range(ROUNDS):
        for label in (order if r % 2 == 0 else order[::-1]) + (order[::-1] if r % 2 == 0 else order):
            for case in cases:
                times[(label, case)].append(cs.time_ms(runs[(label, case)][0], FRAMES))
    for (label, case), ts in times.items():
        print(f"[time] {card}: {label}, {case}: median {float(np.median(ts)):.4f} ms "
              f"over {len(ts)} turns of {FRAMES} launches ("
              + " ".join(f"{t:.4f}" for t in ts) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
