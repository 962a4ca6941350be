"""Tiny versions of the cells for the CPU tests."""
from __future__ import annotations

import argparse
import copy

from portbench import common


def tiny(cfg: dict) -> dict:
    """The configuration at a size a CPU test holds: 300 splats at 64x48,
    at most 16 views, a 2-block tower of width 192 on 64x64 inputs."""
    cfg = copy.deepcopy(cfg)
    cfg.update(splats=300, width=64, height=48, views=min(cfg["views"], 16))
    cfg["dino"].update(depth=2, dim=192, heads=3, mlp=768, image_size=64)
    return cfg


def tiny_cell(workload: str):
    w, conf, cfg, traffic = common.cell(common.spec(), workload)
    return w, conf, tiny(cfg), traffic


def run_args(workload: str, seed: int = 2**31 + 7, seconds: float = 0.5, trace: int = 0):
    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
