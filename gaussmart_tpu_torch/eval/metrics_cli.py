"""Metrics CLI — ``python -m gaussmart_tpu_torch.eval.metrics_cli -m <models...>``
(counterpart of gaussmart_tpu/eval/metrics_cli.py).

Output parity with reference metrics.py:36-92: reads
`<model>/test/ours_N/{renders,gt}`, computes per-view SSIM/PSNR/LPIPS(vgg),
writes `results.json` + `per_view.json` with the same schema. LPIPS is
null when no local weights exist (eval/lpips.py); the LPIPS net is built
once, not per image. Images are read with the port's own PNG codec
(io/images.py). ``--device {cuda,cpu}`` (default cuda: no CUDA device is
an error, never a silent CPU run).
"""
from __future__ import annotations

import json
import os
import traceback
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussmart_tpu_torch.eval import lpips as lpips_mod
from gaussmart_tpu_torch.io.images import read_image
from gaussmart_tpu_torch.ops.image import psnr as psnr_fn
from gaussmart_tpu_torch.ops.ssim import ssim as ssim_fn
from gaussmart_tpu_torch.runtime import resolve_device, setup


def _read_rgb(path: Path) -> np.ndarray:
    return np.asarray(read_image(path), np.float32)[..., :3].transpose(2, 0, 1) / 255.0


def read_images(renders_dir: Path, gt_dir: Path):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        renders.append(_read_rgb(renders_dir / fname))
        gts.append(_read_rgb(gt_dir / fname))
        names.append(fname)
    return renders, gts, names


@torch.no_grad()
def evaluate(model_paths, use_lpips: bool = True, device="cuda"):
    lpips = lpips_mod.load_lpips("vgg", device) if use_lpips else None
    if use_lpips and lpips is None:
        print("[metrics] LPIPS weights not found "
              f"(set ${lpips_mod.WEIGHT_ENV}); reporting LPIPS as null")

    full = {}
    per_view = {}
    for scene_dir in model_paths:
        try:
            print("Scene:", scene_dir)
            full[scene_dir] = {}
            per_view[scene_dir] = {}
            test_dir = Path(scene_dir) / "test"
            for method in os.listdir(test_dir):
                print("Method:", method)
                mdir = test_dir / method
                renders, gts, names = read_images(mdir / "renders", mdir / "gt")
                ssims, psnrs, lpipss = [], [], []
                for r, g in zip(renders, gts):
                    r = torch.as_tensor(r, device=device)
                    g = torch.as_tensor(g, device=device)
                    ssims.append(float(ssim_fn(r, g)))
                    psnrs.append(float(psnr_fn(r[None], g[None])[0, 0]))
                    if lpips is not None:
                        lpipss.append(float(lpips(r, g)[0]))
                print(f"  SSIM : {np.mean(ssims):>12.7f}")
                print(f"  PSNR : {np.mean(psnrs):>12.7f}")
                if lpipss:
                    print(f"  LPIPS: {np.mean(lpipss):>12.7f}")
                full[scene_dir][method] = {
                    "SSIM": float(np.mean(ssims)),
                    "PSNR": float(np.mean(psnrs)),
                    "LPIPS": float(np.mean(lpipss)) if lpipss else None,
                }
                per_view[scene_dir][method] = {
                    "SSIM": dict(zip(names, map(float, ssims))),
                    "PSNR": dict(zip(names, map(float, psnrs))),
                    "LPIPS": (dict(zip(names, map(float, lpipss)))
                              if lpipss else {}),
                }
            with open(os.path.join(scene_dir, "results.json"), "w") as fp:
                json.dump(full[scene_dir], fp, indent=True)
            with open(os.path.join(scene_dir, "per_view.json"), "w") as fp:
                json.dump(per_view[scene_dir], fp, indent=True)
        except Exception as e:   # one model's failure must not stop the others
            print(f"Unable to compute metrics for model {scene_dir}: {e}")
            traceback.print_exc()
    return full


def main(argv=None):
    parser = ArgumentParser(description="metric evaluation")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to compute (cuda unless asked otherwise)")
    args = parser.parse_args(argv)
    setup()
    return evaluate(args.model_paths, use_lpips=not args.no_lpips,
                    device=resolve_device(args.device))


if __name__ == "__main__":
    main()
