"""COLMAP SfM convert CLI — `python -m gaussmart_tpu_torch.convert -s <dir>`
(the port's counterpart of gaussmart_tpu/convert.py).

Pipeline parity with reference convert.py:31-123: feature extraction ->
exhaustive matching -> mapper -> image undistortion via the `colmap`
binary, with the same command lines, order, exit codes and sparse/0 moves,
and optional 2x/4x/8x downscaled image copies. Gated on `colmap`
availability. The copies (``resize_copies``) are resized by
io/dataset.py's copy of Pillow's default (bicubic) resize, equal to it to
the bit, and saved by io/images.py in the format Pillow's save picks from
the name: a JPEG equal to Pillow's file byte for byte (its comment kept,
its EXIF and ICC profile dropped, as Pillow does), a PNG decoding to the
same pixels. With --resize an input the port cannot decode or re-save is
refused, naming its format, before colmap runs or anything is written.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser

from gaussmart_tpu_torch.io import jpeg
from gaussmart_tpu_torch.io.dataset import _resize_u8
from gaussmart_tpu_torch.io.images import image_format, read_image, save_format, write_image


def run(cmd: str) -> int:
    print(cmd, flush=True)
    return subprocess.call(cmd, shell=True)


def require_readable(folder: str):
    """Raise unless every file in `folder` is a PNG or JPEG whose name
    saves it as one, naming the first that is not and its format."""
    for fname in sorted(os.listdir(folder)):
        path = os.path.join(folder, fname)
        image_format(path)
        save_format(path)


def resize_copies(src: str):
    """images_<f>/ beside src/images for f in 2, 4, 8: each image resized
    to (w // f, h // f) as Pillow's ``Image.resize`` and saved under its
    own name as Pillow's ``save`` (the JAX CLI's loop)."""
    for factor in (2, 4, 8):
        outdir = f"{src}/images_{factor}"
        os.makedirs(outdir, exist_ok=True)
        for fname in os.listdir(f"{src}/images"):
            path = os.path.join(src, "images", fname)
            img = read_image(path)
            comment = None
            if image_format(path) == "JPEG":
                with open(path, "rb") as f:
                    comment = jpeg.jpeg_comment(f.read())
            write_image(os.path.join(outdir, fname),
                        _resize_u8(img, img.shape[1] // factor, img.shape[0] // factor),
                        comment=comment)


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
        require_readable(f"{src}/input")

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
        resize_copies(src)
    print("Done.")


if __name__ == "__main__":
    main()
