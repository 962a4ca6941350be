"""COLMAP SfM convert CLI — `python -m gaussmart_tpu_torch.convert -s <dir>`
(the port's counterpart of gaussmart_tpu/convert.py).

Pipeline parity with reference convert.py:31-123: feature extraction ->
exhaustive matching -> mapper -> image undistortion via the `colmap`
binary, with the same command lines, order, exit codes and sparse/0 moves,
and optional 2x/4x/8x downscaled image copies. Gated on `colmap`
availability. The copies are resized by io/dataset.py's copy of Pillow's
default (bicubic) resize, equal to it to the bit, and written by
io/images.py: the port decodes 8-bit PNGs only, so with --resize a photo
in another format is refused before anything is written.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.io.dataset import _resize_u8
from gaussmart_tpu_torch.io.images import png_size, read_png, write_png


def run(cmd: str) -> int:
    print(cmd, flush=True)
    return subprocess.call(cmd, shell=True)


def require_png(folder: str):
    """Raise unless every file in `folder` is a PNG, naming the first one
    that is not and the decoder it would need."""
    for fname in sorted(os.listdir(folder)):
        try:
            png_size(os.path.join(folder, fname))
        except ValueError:
            ext = os.path.splitext(fname)[1].lstrip(".").upper() or "this"
            raise ValueError(f"{os.path.join(folder, fname)}: --resize decodes 8-bit "
                             f"PNGs only; the port has no {ext} decoder") from None


def main(argv=None):
    parser = ArgumentParser("COLMAP converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--camera", default="OPENCV")
    parser.add_argument("--colmap_executable", default="")
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    colmap = (f'"{args.colmap_executable}"' if args.colmap_executable
              else "colmap")
    if shutil.which(args.colmap_executable or "colmap") is None:
        print("error: colmap binary not found on PATH", file=sys.stderr)
        sys.exit(1)
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path
    if args.resize:
        # image_undistorter writes images/ from input/ under the same names
        require_png(f"{src}/input")

    if not args.skip_matching:
        os.makedirs(f"{src}/distorted/sparse", exist_ok=True)
        rc = run(f"{colmap} feature_extractor "
                 f"--database_path {src}/distorted/database.db "
                 f"--image_path {src}/input "
                 f"--ImageReader.single_camera 1 "
                 f"--ImageReader.camera_model {args.camera} "
                 f"--SiftExtraction.use_gpu {use_gpu}")
        if rc:
            sys.exit(rc)
        rc = run(f"{colmap} exhaustive_matcher "
                 f"--database_path {src}/distorted/database.db "
                 f"--SiftMatching.use_gpu {use_gpu}")
        if rc:
            sys.exit(rc)
        rc = run(f"{colmap} mapper "
                 f"--database_path {src}/distorted/database.db "
                 f"--image_path {src}/input "
                 f"--output_path {src}/distorted/sparse "
                 f"--Mapper.ba_global_function_tolerance=0.000001")
        if rc:
            sys.exit(rc)

    rc = run(f"{colmap} image_undistorter --image_path {src}/input "
             f"--input_path {src}/distorted/sparse/0 --output_path {src} "
             f"--output_type COLMAP")
    if rc:
        sys.exit(rc)

    # move sparse files into sparse/0 (reference convert.py:92-101)
    os.makedirs(f"{src}/sparse/0", exist_ok=True)
    for f in os.listdir(f"{src}/sparse"):
        if f == "0":
            continue
        shutil.move(os.path.join(src, "sparse", f),
                    os.path.join(src, "sparse", "0", f))

    if args.resize:
        print("Copying and resizing...")
        for factor in (2, 4, 8):
            outdir = f"{src}/images_{factor}"
            os.makedirs(outdir, exist_ok=True)
            for fname in os.listdir(f"{src}/images"):
                img = read_png(os.path.join(src, "images", fname))
                write_png(os.path.join(outdir, fname),
                          _resize_u8(img, img.shape[1] // factor, img.shape[0] // factor))
    print("Done.")


if __name__ == "__main__":
    main()
