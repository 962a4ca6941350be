"""Configuration system (the port's own copy of gaussmart_tpu/config.py).

Dataclass parameter groups with the same flag surface as the JAX package:
every field becomes a ``--flag``; fields listed in ``_shorthand`` also get
a one-letter alias. Saved configs round-trip through ``cfg_args.json`` in
the same format, so a model directory written by the JAX trainer loads
unchanged (its ``backend`` may be ``auto``, ``pallas`` or ``dense``).

Keys a group does not know in a saved config are carried through
``get_combined_args`` untouched.
"""
from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = False
    render_items: List[str] = field(default_factory=lambda: [
        "RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"])
    uniform_upsampling: bool = False
    _shorthand = ("source_path", "model_path", "images", "resolution",
                  "white_background")

    def finalize(self):
        if self.source_path:
            self.source_path = os.path.abspath(self.source_path)
        return self


@dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    depth_ratio: float = 0.0
    debug: bool = False
    # rasterizer: "auto" and "pallas" take the tiled compositor (the CUDA
    # kernel on a CUDA tensor), "dense" the dense one (render/api.py)
    backend: str = "auto"
    _shorthand = ()


@dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    # linear ramp length of lambda_dist after its iteration-3000 gate
    # (0: full weight at once)
    lambda_dist_ramp: int = 0
    # cap on the raw per-view mean distortion entering the loss (0: none)
    lambda_dist_clip: float = 0.0
    lambda_normal: float = 0.05
    lambda_segment: float = 0.05   # parsed, unused (as in the JAX package)
    opacity_cull: float = 0.05
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    _shorthand = ()


def add_group_args(parser: ArgumentParser, cls, sentinel: bool = False):
    """Register a dataclass's fields as CLI flags."""
    shorthand = set(getattr(cls, "_shorthand", ()))
    defaults = cls()
    for f in dataclasses.fields(cls):
        default = None if sentinel else getattr(defaults, f.name)
        names = ["--" + f.name]
        if f.name in shorthand:
            names.append("-" + f.name[0])
        ftype = f.type if isinstance(f.type, type) else type(getattr(defaults, f.name))
        if ftype is bool:
            parser.add_argument(*names, default=default, action="store_true")
        elif ftype is list or isinstance(getattr(defaults, f.name), list):
            parser.add_argument(*names, nargs="+", default=default)
        else:
            parser.add_argument(*names, default=default, type=ftype)


def extract_group(args: Namespace, cls):
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in vars(args).items() if k in known and v is not None}
    obj = cls(**kwargs)
    if hasattr(obj, "finalize"):
        obj.finalize()
    return obj


def save_cfg(model_path: str, args: Namespace):
    os.makedirs(model_path, exist_ok=True)
    payload = {k: v for k, v in vars(args).items()
               if isinstance(v, (int, float, str, bool, list, type(None)))}
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(payload, f, indent=2)


def load_cfg(model_path: str) -> Optional[dict]:
    path = os.path.join(model_path, "cfg_args.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge CLI args over the saved training config (CLI wins)."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    saved = load_cfg(getattr(args_cmdline, "model_path", "") or "")
    if saved:
        merged.update(saved)
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
