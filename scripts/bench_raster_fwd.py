#!/usr/bin/env python3
"""Time builds of the forward compositor (K1 raster_fwd, K3
raster_fwd_seeded) against each other, in turns, on one CUDA card.

    python3 scripts/bench_raster_fwd.py [--baseline OTHER/raster_fwd.cu] ...
        [--variant LABEL:NAME=VALUE[,NAME=VALUE...]] ... [--sass DIR]

Sources: "current" is gaussmart_tpu_torch/csrc/raster_fwd.cu; each
--baseline adds another file, labelled by its name without ".cu", with the
same C entry points, with or without the conic rows after the blob (an
earlier source, for example the parent commit's unpacked with `git
archive`); each --variant adds the current source with
its `constexpr int NAME = ...;` constants set to VALUE. Each is built with
kernels.NVCC_FLAGS into its own library (bench_raster_bwd.build; their
ptxas reports are printed) and called through ctypes as the wrapper calls
it. For each build the SASS of the walk loop (the innermost loop around
the alpha test's expf, `cuobjdump -sass`) is counted: its instructions,
and those before the alpha test's branch; --sass DIR also writes each
library's SASS there.

Frames (chip_smoke.py's): the full-width training frame (bench.py's state,
camera 0, 776x584, SH bands above 0 masked) for K1; its first depth
stratum of 4 from the identity seed (chip_smoke.seeded_stratum) for K3;
and the 8 K3 launches of one Gaussian-sharded training step on camera 0
(pass 1 from the identity seed, pass 2 from the fold's seeds), recorded
from the step by chip_smoke.record_mp_launches. Every source's fb and ints
must equal the first source's to the bit, and the first source's must
equal composite_tiles_plain's on the training frame. Then ROUNDS rounds,
the sources in order and then reversed, each timing every case as the
median of FRAMES launches (CUDA events around each, kernel only: the
outputs are allocated once). Prints one line per (source, case) with the
median over the turns, the sum over the mp step's 8 launches, and the
card's name and power limit; then the training frame's (entry, warp)
counts (chip_smoke.forward_warp_counts) and, for the current source and
its variants, the instruction-issue estimate they give with the walk
loop's SASS counts.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from bench_raster_bwd import build, with_constants  # noqa: E402

ROUNDS = 2
FRAMES = 20
# warp schedulers of an H100 SXM: 132 SMs x 4, each issuing at most one
# warp-instruction per clock
SCHEDULERS = 132 * 4


def walk_loop_sass(text):
    """{kernel: (instructions of the innermost loop holding the first
    MUFU.EX2, of them before the first conditional branch after it)} from
    the output of `cuobjdump -sass`."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        name = fn.split()[0]
        code = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", fn)
        addr = [int(a, 16) for a, _ in code]
        ex2 = next((i for i, (_, ins) in enumerate(code) if "MUFU.EX2" in ins), None)
        if ex2 is None:
            continue
        loops = []
        for i, (_, ins) in enumerate(code):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
            if m and i > ex2 and int(m.group(1), 16) <= addr[ex2]:
                first = addr.index(int(m.group(1), 16)) if int(m.group(1), 16) in addr else 0
                loops.append((i - first + 1, first, i))
        if not loops:
            continue
        size, first, last = min(loops)
        test = next((i for i in range(ex2, last) if re.match(r"@!?U?P\w* BRA", code[i][1])),
                    last)
        out[name] = (size, test - first)
    return out


def frames(dev):
    """{case: io} with io the launch's inputs: blob, conics, ids, ranges,
    init (None for K1), tiles."""
    import torch
    import chip_smoke as cs
    from gaussmart_tpu_torch.parallel.sharding import make_mesh
    from gaussmart_tpu_torch.render import raster_tiled as rt
    W, H = cs.WIDTH, cs.HEIGHT
    state, cams, gts = cs.bench_state(0, cs.N_SPLATS, W, H, dev)
    prep = cs.frame_prep(state, cams[0], cs.SH_DEGREE, active_degree=0)
    tiles = rt.tile_grid(W, H)
    cases = {}
    with torch.inference_mode():
        for label, (p, init) in (("raster_fwd training frame", (prep, None)),
                                 ("raster_fwd_seeded pass 1 stratum 1",
                                  cs.seeded_stratum(prep, W, H, 0))):
            ids, ranges, conics = rt.binning(p, *tiles)[:3]
            cases[label] = dict(blob=rt.build_blob(p, torch.zeros(p.depth.shape[0], 2,
                                                                  device=dev), W, H),
                                conics=conics, ids=ids, ranges=ranges, init=init,
                                tiles=tiles)
    for i, io in enumerate(cs.record_mp_launches(state, cams, gts,
                                                 make_mesh(cs.N_SLOTS, dev))):
        cases[f"raster_fwd_seeded mp step pass {i // cs.N_SLOTS + 1} stratum "
              f"{i % cs.N_SLOTS + 1}"] = dict(
            {k: io[k].detach() for k in ("blob", "conics", "ids", "ranges", "init")},
            tiles=tiles)
    return cases


def launcher(lib, io, takes_conics):
    """A no-argument function launching `lib`'s kernel on `io`, and the
    outputs it writes (fb, ints)."""
    import torch
    from gaussmart_tpu_torch.render import raster_tiled as rt
    tx, ty = io["tiles"]
    dev = io["blob"].device
    fb = torch.empty((rt.CH, ty * rt.TILE, tx * rt.TILE), device=dev)
    ints = torch.empty((2, ty * rt.TILE, tx * rt.TILE), dtype=torch.int32, device=dev)
    head = [io["blob"].data_ptr()] + ([io["conics"].data_ptr()] if takes_conics else [])
    head += [io["ids"].data_ptr(), io["ranges"].data_ptr()]
    n = len(head)
    if io["init"] is None:
        fn = lib.raster_fwd
        args = head + [tx, ty, fb.data_ptr(), ints.data_ptr()]
    else:
        fn = lib.raster_fwd_seeded
        args = head + [io["init"].data_ptr(), tx, ty, fb.data_ptr(), ints.data_ptr()]
        n += 1
    fn.argtypes = [ctypes.c_void_p] * n + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed with CUDA error {err}")
    return run, (fb, ints)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another raster_fwd.cu to time against")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL:NAME=VALUE[,NAME=VALUE...] of the current source")
    ap.add_argument("--sass", help="directory to write each build's SASS into")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_raster_fwd: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.render import raster_tiled as rt
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    current = (ROOT / "gaussmart_tpu_torch" / "csrc" / "raster_fwd.cu").read_text()
    texts = {"current": current}
    baselines = {Path(p).stem for p in args.baseline}
    for path in map(Path, args.baseline):
        texts[path.stem] = path.read_text()
    for v in args.variant:
        label, _, sets = v.partition(":")
        texts[label] = with_constants(current, [s.split("=", 1) for s in sets.split(",")])
    out_dir = ROOT / "build" / "bench_raster_fwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], kv[1], out_dir), texts.items()))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    libs, takes, sass = {}, {}, {}
    for label, path, log in built:
        libs[label] = ctypes.CDLL(str(path))
        takes[label] = "const void* conics" in texts[label]
        for kernel, regs, smem, spills in cs.ptxas_report(log):
            print(f"[build] {label}: {kernel}: {regs} registers, {smem} bytes shared "
                  f"memory, spill stores + loads {spills} bytes")
        text = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        if args.sass:
            Path(args.sass).mkdir(parents=True, exist_ok=True)
            (Path(args.sass) / f"{label}.sass").write_text(text)
        sass[label] = walk_loop_sass(text)
        for kernel, (size, before) in sass[label].items():
            print(f"[sass] {label}: {kernel}: walk loop {size} instructions, {before} "
                  "before the alpha test's branch")

    cases = frames(dev)
    runs = {(label, case): launcher(lib, io, takes[label])
            for label, lib in libs.items() for case, io in cases.items()}
    first = next(iter(libs))
    for (label, case), (run, out) in runs.items():
        run()
        ref = runs[(first, case)][1]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out, ref))
        print(f"[check] {label}, {case}: fb and ints bit-equal to {first}'s {same}")
        if not same:
            raise SystemExit(f"[check] {label} disagrees with {first}")
    io = cases["raster_fwd training frame"]
    fb, ints = runs[(first, "raster_fwd training frame")][1]
    W, H = cs.WIDTH, cs.HEIGHT
    with torch.inference_mode():
        ref = rt.composite_tiles_plain(io["blob"], io["ids"], io["ranges"], W, H)
    same = torch.equal(fb, ref[0]) and torch.equal(ints, ref[1])
    print(f"[check] {first}, raster_fwd training frame: bit-equal to "
          f"composite_tiles_plain {same}")
    if not same:
        raise SystemExit("[check] the kernel disagrees with its plain version")

    order = list(libs)
    times = {key: [] for key in runs}
    for r in range(ROUNDS):
        for label in (order if r % 2 == 0 else order[::-1]) + (order[::-1] if r % 2 == 0 else order):
            for case in cases:
                times[(label, case)].append(cs.time_ms(runs[(label, case)][0], FRAMES))
    step = {label: 0.0 for label in libs}
    for (label, case), ts in times.items():
        med = float(np.median(ts))
        if "mp step" in case:
            step[label] += med
        print(f"[time] {card}: {label}, {case}: median {med:.4f} ms over {len(ts)} "
              f"turns of {FRAMES} launches (" + " ".join(f"{t:.4f}" for t in ts) + ")")
    for label, ms in step.items():
        print(f"[time] {card}: {label}, raster_fwd_seeded over the mp step's "
              f"{2 * cs.N_SLOTS} launches: {ms:.4f} ms (sum of the medians)")

    # the instruction-issue estimate on the training frame, for the current
    # source and its variants (the warps and cull that forward_warp_counts
    # models): every walked (entry, warp) pair the cull keeps issues the
    # loop up to the alpha test's branch, every pair with a blending pixel
    # the rest of it
    w = cs.print_warp_counts("training frame", "raster_fwd", dict(io, fb=fb, ints=ints),
                             W, H)
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]) * 1e6
    for label in libs:
        loop = next((v for k, v in sass[label].items() if "Lb0E" in k), None)
        if loop is None or label in baselines:
            print(f"[issue] {label}: not estimated (no walk loop in the SASS, or "
                  "another source than the current one)")
            continue
        size, before = loop
        pairs = w["walked"] - w["culled"]
        issued = pairs * before + w["blend"] * (size - before)
        print(f"[issue] {card}: {label}, training frame: {pairs} (entry, warp) pairs x "
              f"{before} + {w['blend']} blending pairs x {size - before} = {issued} "
              f"warp-instructions in the walk loop; at one per clock on each of "
              f"{SCHEDULERS} schedulers at {clock / 1e6:.0f} MHz "
              f"{issued / (SCHEDULERS * clock) * 1e3:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
