"""How `correct` is decided: the reference's readings of what the timed path
produced, the numbers that compare the two, and the limits of each cell
(limits/<cell>.json)."""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import common
from portbench.reference import raster
from portbench.reference import train as ref_train
from portbench.reference.precision import MATMUL

GROUPS = ref_train.GROUPS
BETA1 = ref_train.BETA1
TERMS = ("total", "l1", "normal", "dino")
# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone: its change is left out
STILL_LEAF = 1e-3


def limits(workload: str) -> Dict[str, float]:
    return common.load_json(common.HERE / "limits" / f"{workload}.json")


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {g: float(torch.linalg.norm(tensors[g].double())) for g in GROUPS}


def first_gradient(m0: Optional[Dict[str, torch.Tensor]],
                   m1: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norms of the gradient an Adam step got, from its first moment before
    (m0; None for fresh, zero moments) and after (m1) it:
    (m1 - beta1 m0) / (1 - beta1)."""
    def grad(g):
        m = m1[g].double()
        return m if m0 is None else m - BETA1 * m0[g].double()
    return {g: float(torch.linalg.norm(grad(g))) / (1.0 - BETA1) for g in GROUPS}


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    """The worst leaf's gap of norms, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[g] for g in GROUPS)
    return max(abs(prog[g] - ref[g]) / max(ref[g], med, 1e-30) for g in leaves)


def train_numbers(prog: dict, ref: dict, prefix: str = "") -> Dict[str, float]:
    """prog and ref: {"losses": [per step {term: value}], "grad": {leaf: norm
    of the first step's gradient}, "change": {leaf: norm of the change after
    the steps}}."""
    loss = max(abs(p[t] - r[t]) / max(abs(r["total"]), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"]) for t in TERMS)
    med = statistics.median(ref["grad"][g] for g in GROUPS)
    moving = [g for g in GROUPS if ref["grad"][g] >= STILL_LEAF * med]
    return {f"{prefix}loss_gap": loss,
            f"{prefix}grad_gap": _worst(prog["grad"], ref["grad"], GROUPS),
            f"{prefix}change_gap": _worst(prog["change"], ref["change"], moving)}


def reference_steps(p0: Dict[str, torch.Tensor], active, cams, gts, iterations: List[int],
                    scale: float, state: Optional[dict] = None, tower_weights=None,
                    dino: Optional[dict] = None, lambda_dino: float = 0.0,
                    precision: str = "float32", fault: Optional[str] = None) -> dict:
    """The reference's readings of steps from p0 and Adam's `state` (m, v,
    t; fresh if None): each step's loss terms, the first step's gradient
    norms, the change's norms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = MATMUL[precision]
    tower = None
    if tower_weights is not None:
        tower = common.tower(dino).Tower(tower_weights, dino, mm)
    params = dict(p0)
    state = ref_train.init_adam(p0) if state is None else state
    out = {"losses": [], "diag": []}
    for i, (cam, gt, it) in enumerate(zip(cams, gts, iterations)):
        t0, stats = time.perf_counter(), {}
        terms, grads, params, state = ref_train.step(params, state, active, cam, gt, it, scale,
                                                     tower, lambda_dino, mm, fault, stats)
        out["losses"].append(terms)
        out["diag"].append(dict(seconds=round(time.perf_counter() - t0, 2),
                                pairs=stats["pairs"], max_tile=stats["max_tile"],
                                walked=stats["walked"], blends=int(stats["blends"])))
        if i == 0:
            out["grad"] = leaf_norms(grads)
        del grads
    out["change"] = leaf_norms({g: params[g] - p0[g] for g in GROUPS})
    return out


# -- novel views ---------------------------------------------------------------
def view_image(pkg, mode: str):
    """The viewer's image of a render mode: RGB, the world normal mapped to
    [0, 1], or the depth min-max normalised to grey."""
    if mode == "Normal":
        return (pkg["rend_normal"] + 1) / 2
    if mode == "Depth":
        d = pkg["surf_depth"]
        lo, hi = d.min(), d.max()
        return torch.cat([(d - lo) / torch.clamp_min(hi - lo, 1e-9)] * 3, dim=0)
    return pkg["render"]


def frame_bytes(image) -> np.ndarray:
    """[3,H,W] in [0,1] -> [H,W,3] uint8: clipped, times 255, truncated."""
    return (torch.clamp(image, 0, 1) * 255).to(torch.uint8).permute(1, 2, 0).cpu().numpy()


@torch.no_grad()
def reference_frame(params, active, cam, mode: str, precision: str = "float32",
                    stats=None) -> np.ndarray:
    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = raster.render(raster.activated(params, active), cam, MATMUL[precision], stats)
    return frame_bytes(view_image(pkg, mode))


def view_numbers(pairs) -> Dict[str, float]:
    """pairs: [(served [H,W,3] uint8, reference [H,W,3] uint8)] -> the widest
    gap in levels over the frames, and the largest mean gap of a frame."""
    gaps = [np.abs(a.astype(np.int16) - b.astype(np.int16)) for a, b in pairs]
    return {"max_gap": float(max(g.max() for g in gaps)),
            "mean_gap": float(max(g.mean() for g in gaps))}


def verdict(numbers: Dict[str, float], lim: Dict[str, float]):
    """(correct, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
    ok = all(np.isfinite(numbers[k]) and numbers[k] <= lim[k] for k in lim)
    return ok, shown
