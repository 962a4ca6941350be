#!/usr/bin/env python3
"""Time builds of the per-splat gradient reduction kernel (K5,
gaussmart_tpu_torch/csrc/segsum.cu) against each other, in turns, on one
CUDA card.

    python3 scripts/bench_grad_reduce.py [--variant LABEL:NAME=VALUE[,NAME=VALUE...]] ...
        [--sorted-baseline OTHER/segsum.cu]

Sources: "current" is csrc/segsum.cu; each --variant adds it with its
`constexpr int NAME = ...;` constants set to VALUE (for example UNROLL,
the rows a lane has in flight); --sorted-baseline adds an earlier
segsum.cu whose C entry is segsum(rows, ids, m, f, n_segments, out,
stream), summing rows already sorted by splat id (the source before the
work-slot map, for example the parent commit's unpacked with `git
archive`): it is timed on the frames' rows sorted by a stable sort of the
entry ids, as that route gave them to it, kernel only and as its whole
route (sort, row gather, kernel, the dummy row's zero). Each source is
built with kernels.NVCC_FLAGS into its own library
(bench_raster_bwd.build; their ptxas reports are printed) and called
through ctypes, with kernels.SIGNATURES' argument types, as the wrapper
calls it.

Rows (chip_smoke.py's frames): K2's on the full-width training frame
(bench.py's state, camera 0, 776x584, need_dist/need_med (False, False),
a fixed-seed cotangent) and K4's on its first depth stratum of 4 from the
identity seed (pass 1 of the Gaussian-sharded step), each reduced through
the frame's binning plan over the walked rows only, as grad_reduce
reduces them. Every build's sums are held against
segment_sum_gathered_plain on a CPU copy (within 1e-5 of each column's
max; bit-equality printed). Then ROUNDS rounds, the sources in order and
then reversed, each timing every case as the median of FRAMES launches
(CUDA events around each, kernel only). Prints one line per (source, case)
with the median over the turns and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
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


def frames(dev):
    """({case: K5's arguments (rows, order, slot_starts, n_out[, slot_tile,
    tile_limit])}, {frame: (rows, entry_ids, n_out)}) on the training
    frame's K2 rows and pass 1's stratum 1's K4 rows."""
    import torch
    import chip_smoke as cs
    from gaussmart_tpu_torch.render import raster_tiled as rt
    W, H = cs.WIDTH, cs.HEIGHT
    state, cams, _ = cs.bench_state(0, cs.N_SPLATS, W, H, dev)
    prep = cs.frame_prep(state, cams[0], cs.SH_DEGREE, active_degree=0)
    cases, plain = {}, {}
    with torch.inference_mode():
        for label, (p, init) in (("raster_bwd rows, training frame", (prep, None)),
                                 ("raster_bwd_seeded rows, pass 1 stratum 1",
                                  cs.seeded_stratum(prep, W, H, 0))):
            b = rt.binning(p, *rt.tile_grid(W, H))
            blob = rt.build_blob(p, torch.zeros(p.depth.shape[0], 2, device=dev), W, H)
            fb, ints = rt.composite_tiles(blob, b.conics, b.entry_ids, b.tile_ranges, W, H,
                                          init=init)
            ct = cs.random_cotangent(fb, W, H, rt.CT if init is None else rt.CT_SEEDED)
            rows = rt.composite_tiles_bwd(blob, b.entry_ids, b.tile_ranges, fb, ints, ct,
                                          W, H, False, False, init=init)
            rows = rows if init is None else rows[0]
            io = dict(rows=rows, binned=b, limits=rt.walk_limits(ints, b.tile_ranges))
            _, walked, live = cs.reduction_bytes(io)
            cases[f"{label} ({walked} walked of {live} live)"] = cs.reduction_inputs(io)["k5"]
            plain[label] = (rows, b.entry_ids, b.slot_starts.shape[0])
    return cases, plain


def sorted_launcher(lib, rows, entry_ids, n_out):
    """(kernel only, the whole route, output) of an earlier segsum on
    `rows` sorted by a stable sort of `entry_ids`: the kernel over the n_out
    - 1 splats (the dummy id sorts last and is left out), the route with
    the sort, the row gather and the dummy row's zero around it."""
    import torch
    fn = lib.segsum
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    seg, perm = torch.sort(entry_ids, stable=True)
    rows_sorted = rows[perm].contiguous()
    out = torch.empty((n_out - 1, rows.shape[1]), device=rows.device)

    def kernel(r=rows_sorted, s=seg, o=out):
        err = fn(r.data_ptr(), s.data_ptr(), r.shape[0], r.shape[1], n_out - 1,
                 o.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed with CUDA error {err}")
        return o

    def route():
        s, p = torch.sort(entry_ids, stable=True)
        o = torch.empty((n_out - 1, rows.shape[1]), device=rows.device)
        kernel(rows[p].contiguous(), s, o)
        return torch.cat([o, o.new_zeros((1, rows.shape[1]))])
    return kernel, route, out


def launcher(lib, args):
    """A no-argument function launching `lib`'s segsum on K5's `args`
    (rows, order, slot_starts, n_out[, slot_tile, tile_limit]), and its
    output."""
    import torch
    from gaussmart_tpu_torch import kernels
    from gaussmart_tpu_torch.render import segsum
    rows, order, starts, n_out = args[:4]
    walk = args[4:] or (None, None)
    out = torch.empty((n_out, segsum.F), device=rows.device)
    fn = kernels.bind(lib, "segsum")
    ptrs = [rows.data_ptr(), order.data_ptr(), starts.data_ptr(),
            *(None if x is None else x.data_ptr() for x in walk),
            starts.shape[0] - 1, n_out, out.data_ptr()]

    def run():
        err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed with CUDA error {err}")
    return run, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL:NAME=VALUE[,NAME=VALUE...] of the current source")
    ap.add_argument("--sorted-baseline",
                    help="an earlier segsum.cu that sums rows sorted by splat id")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_grad_reduce: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gaussmart_tpu_torch.render import segsum
    from gaussmart_tpu_torch.runtime import setup
    setup()
    dev = torch.device("cuda")
    card = cs.card_line()
    current = (ROOT / "gaussmart_tpu_torch" / "csrc" / "segsum.cu").read_text()
    texts = {"current": current}
    for v in args.variant:
        label, _, sets = v.partition(":")
        texts[label] = with_constants(current, [s.split("=", 1) for s in sets.split(",")])
    out_dir = ROOT / "build" / "bench_grad_reduce"
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.sorted_baseline:
        texts["sorted-baseline"] = Path(args.sorted_baseline).read_text()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], kv[1], out_dir), texts.items()))
    libs = {}
    for label, path, log in built:
        libs[label] = ctypes.CDLL(str(path))
        for kernel, regs, smem, spills in cs.ptxas_report(log):
            print(f"[build] {label}: {kernel}: {regs} registers, {smem} bytes shared "
                  f"memory, spill stores + loads {spills} bytes")
    baseline = libs.pop("sorted-baseline", None)

    cases, frame_rows = frames(dev)
    runs = {(label, case): launcher(lib, k5)
            for label, lib in libs.items() for case, k5 in cases.items()}
    refs = {case: segsum.segment_sum_gathered_plain(
        *(x.cpu() if isinstance(x, torch.Tensor) else x for x in k5))
        for case, k5 in cases.items()}
    checks = {key: (run, out, refs[key[1]]) for key, (run, out) in runs.items()}
    if baseline is not None:
        for frame, (rows, ids, n_out) in frame_rows.items():
            kernel, route, out = sorted_launcher(baseline, rows, ids, n_out)
            ref = next(refs[c] for c in cases if c.startswith(frame))[:n_out - 1]
            for what, fn in (("kernel only", kernel), ("whole route", route)):
                runs[("sorted-baseline", f"{frame}, sorted rows, {what}")] = (fn, out)
            checks[("sorted-baseline", f"{frame}, sorted rows")] = (kernel, out, ref)
    for (label, case), (run, out, ref) in checks.items():
        run()
        got = out.cpu()
        err = ((got - ref).abs().amax(0) / (ref.abs().amax(0) + 1e-30)).max().item()
        print(f"[check] {label}, {case}: vs the plain version on a CPU copy, per column "
              f"of its max {err:.3g} (limit 1e-5), bit-equal {torch.equal(got, ref)}")
        if not err <= 1e-5:
            raise SystemExit(f"[check] {label} disagrees with the plain version")

    order = list(libs) + (["sorted-baseline"] if baseline is not None else [])
    times = {key: [] for key in runs}
    for r in range(ROUNDS):
        for label in (order if r % 2 == 0 else order[::-1]) + (order[::-1] if r % 2 == 0 else order):
            for key in times:
                if key[0] == label:
                    times[key].append(cs.time_ms(runs[key][0], FRAMES))
    for (label, case), ts in times.items():
        print(f"[time] {card}: {label}, {case}: median {float(np.median(ts)):.4f} ms "
              f"over {len(ts)} turns of {FRAMES} launches ("
              + " ".join(f"{t:.4f}" for t in ts) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
