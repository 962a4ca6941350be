"""Configuration system (the port's own copy of gaussmart_tpu/config.py).

Dataclass parameter groups with the same flag surface as the JAX package:
every field becomes a ``--flag``; fields listed in ``_shorthand`` also get
a one-letter alias. Saved configs round-trip through ``cfg_args.json`` in
the same format, so a model directory written by the JAX trainer loads
unchanged (its ``backend`` may be ``auto``, ``pallas`` or ``dense``).

Only the groups the serving path reads are here; the optimisation group
comes with the training slice. Keys of other groups in a saved config are
carried through ``get_combined_args`` untouched.
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
