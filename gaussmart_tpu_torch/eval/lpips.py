"""LPIPS in torch (VGG16, AlexNet & SqueezeNet backbones + 1x1 linear
heads); counterpart of gaussmart_tpu/eval/lpips_jax.py, reading the same
.npz weights.

Architecture parity with the reference's vendored lpipsPyTorch/ (component
#16): ImageNet-normalized input in [-1,1], per-layer unit-normalized
features, learned 1x1 weights, spatial mean, summed over layers. The
backbones are written with torch.nn.functional's convolutions and pools
(the JAX package computes them with lax.conv_general_dilated, outside any
Pallas kernel); on the card they run in float32, since runtime.setup()
turns TF32 off.

Weights must be provided locally — either a torch checkpoint dict
(convert with `convert_torch_lpips`) or a pre-converted .npz, named by
$GAUSSMART_LPIPS_WEIGHTS (``{net}`` in it is replaced by the network) or
found at DEFAULT_PATHS. `available()` gates callers; the metrics CLI
reports LPIPS as null when none are found.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# ImageNet scaling used by LPIPS (applied after the [-1,1] input convention)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# feature taps after each relu block (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)
VGG_TAPS = [1, 3, 6, 9, 12]   # conv indices (0-based) whose relu output is tapped

ALEX_CONVS = [  # (out_ch, kernel, stride, pad)
    (64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
    (256, 3, 1, 1)]
ALEX_POOL_AFTER = {0, 1}      # maxpool after conv0 and conv1 (and conv4, unused)

# SqueezeNet 1.1 (reference lpipsPyTorch/modules/networks.py:66-74:
# torchvision squeezenet1_1.features, taps [2,5,8,10,11,12,13] 1-based =
# relu1 + fire{4,7,9,10,11,12} outputs, channels below). Fire modules as
# (torchvision features index, squeeze ch, expand ch); 'M' = 3x3/2
# ceil-mode maxpool; 'T' = tap after the preceding module.
SQUEEZE_PLAN = ["C0", "T", "M", "F3", "F4", "T", "M", "F6", "F7", "T",
                "M", "F9", "T", "F10", "T", "F11", "T", "F12", "T"]
SQUEEZE_FIRE_CH = {3: (16, 64), 4: (16, 64), 6: (32, 128), 7: (32, 128),
                   9: (48, 192), 10: (48, 192), 11: (64, 256),
                   12: (64, 256)}
SQUEEZE_TAP_CH = [64, 128, 256, 384, 384, 512, 512]

WEIGHT_ENV = "GAUSSMART_LPIPS_WEIGHTS"
DEFAULT_PATHS = [
    os.path.join(os.path.dirname(__file__), "weights", "lpips_{net}.npz"),
    os.path.expanduser("~/.cache/gaussmart_tpu/lpips_{net}.npz"),
]


def _conv(x, w, b, stride=1, pad=1):
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def _maxpool(x, k=2, ceil=False):
    """VGG pools 2x2/2; AlexNet pools 3x3/2; SqueezeNet pools 3x3/2 with
    ceil_mode=True (torchvision .features parity): a partial window at
    the tail counts, as the JAX package's -inf tail padding does."""
    return F.max_pool2d(x, k, 2, ceil_mode=ceil)


def _vgg_features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    ci = 0
    for v in VGG16_CFG:
        if v == "M":
            x = _maxpool(x)
        else:
            x = F.relu(_conv(x, params[f"conv{ci}_w"], params[f"conv{ci}_b"], 1, 1))
            if ci in VGG_TAPS:
                feats.append(x)
            ci += 1
    return feats


def _alex_features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    for i, (_, k, s, p) in enumerate(ALEX_CONVS):
        x = F.relu(_conv(x, params[f"conv{i}_w"], params[f"conv{i}_b"], s, p))
        feats.append(x)
        if i in ALEX_POOL_AFTER:
            x = _maxpool(x, k=3)
    return feats


def _fire(params: Dict, x: torch.Tensor, idx: int) -> torch.Tensor:
    s = F.relu(_conv(x, params[f"fire{idx}_squeeze_w"],
                     params[f"fire{idx}_squeeze_b"], 1, 0))
    e1 = F.relu(_conv(s, params[f"fire{idx}_e1_w"], params[f"fire{idx}_e1_b"], 1, 0))
    e3 = F.relu(_conv(s, params[f"fire{idx}_e3_w"], params[f"fire{idx}_e3_b"], 1, 1))
    return torch.cat([e1, e3], dim=1)


def _squeeze_features(params: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    for step in SQUEEZE_PLAN:
        if step == "C0":
            x = F.relu(_conv(x, params["conv0_w"], params["conv0_b"], 2, 0))
        elif step == "M":
            x = _maxpool(x, k=3, ceil=True)
        elif step == "T":
            feats.append(x)
        else:
            x = _fire(params, x, int(step[1:]))
    return feats


_FEATURES = {"vgg": _vgg_features, "alex": _alex_features,
             "squeeze": _squeeze_features}


def _unit_normalize(x, eps=1e-10):
    n = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (n + eps)


class LPIPS:
    """Functional LPIPS scorer; construct once, call many."""

    def __init__(self, params: Dict[str, np.ndarray], net_type: str = "vgg",
                 device="cuda"):
        self.net_type = net_type
        self.device = torch.device(device)
        self.params = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                       for k, v in params.items()}
        self._shift = torch.as_tensor(_SHIFT, device=self.device).reshape(1, 3, 1, 1)
        self._scale = torch.as_tensor(_SCALE, device=self.device).reshape(1, 3, 1, 1)

    @torch.no_grad()
    def _score(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: [N,3,H,W] in [-1, 1]."""
        feat = _FEATURES[self.net_type]
        fx = feat(self.params, (x - self._shift) / self._scale)
        fy = feat(self.params, (y - self._shift) / self._scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            lin = self.params[f"lin{i}_w"]        # [1, C, 1, 1]
            total = total + torch.mean(torch.sum(d * lin, dim=1), dim=(1, 2))
        return total

    def __call__(self, x, y) -> torch.Tensor:
        """Inputs in [0,1], [3,H,W] or [N,3,H,W] (tensors or arrays, moved
        to the scorer's device); returns the per-image score [N]."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        if x.dim() == 3:
            x = x[None]
            y = y[None]
        return self._score(x * 2.0 - 1.0, y * 2.0 - 1.0)


def _weight_path(net_type: str) -> Optional[str]:
    env = os.environ.get(WEIGHT_ENV)
    cands = ([env.format(net=net_type)] if env else []) + \
        [p.format(net=net_type) for p in DEFAULT_PATHS]
    for p in cands:
        if p and os.path.exists(p):
            return p
    return None


def available(net_type: str = "vgg") -> bool:
    return _weight_path(net_type) is not None


@functools.lru_cache(maxsize=4)
def _load(path: str, net_type: str, device: str) -> LPIPS:
    with np.load(path) as z:
        params = {k: z[k] for k in z.files}
    return LPIPS(params, net_type, device)


def load_lpips(net_type: str = "vgg", device="cuda") -> Optional[LPIPS]:
    """The scorer built from the weights found for `net_type`, on `device`
    (built once per weight file and device), or None when there are none."""
    path = _weight_path(net_type)
    if path is None:
        return None
    return _load(path, net_type, str(torch.device(device)))


def convert_torch_lpips(backbone_state: Dict, lin_state: Dict,
                        net_type: str, out_path: str):
    """Convert torch state dicts (torchvision backbone `features.*` +
    richzhang `lin*.model.1.weight`) to the .npz layout used here."""
    out = {}
    if net_type == "squeeze":
        # torchvision squeezenet1_1: features.0 (stem conv) +
        # features.N.{squeeze,expand1x1,expand3x3} fire modules
        out["conv0_w"] = np.asarray(backbone_state["features.0.weight"])
        out["conv0_b"] = np.asarray(backbone_state["features.0.bias"])
        for idx in SQUEEZE_FIRE_CH:
            for src, dst in (("squeeze", "squeeze"), ("expand1x1", "e1"),
                             ("expand3x3", "e3")):
                for kind in ("weight", "bias"):
                    out[f"fire{idx}_{dst}_{kind[0]}"] = np.asarray(
                        backbone_state[f"features.{idx}.{src}.{kind}"])
    else:
        conv_i = 0
        keys = sorted((k for k in backbone_state if k.endswith(".weight")
                       and "features" in k),
                      key=lambda s: int(s.split(".")[1]))
        for k in keys:
            w = np.asarray(backbone_state[k])
            b = np.asarray(backbone_state[k.replace(".weight", ".bias")])
            out[f"conv{conv_i}_w"] = w
            out[f"conv{conv_i}_b"] = b
            conv_i += 1
    n_lins = len(SQUEEZE_TAP_CH) if net_type == "squeeze" else 5
    for i in range(n_lins):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in lin_state:
                out[f"lin{i}_w"] = np.asarray(lin_state[cand])
                break
        else:
            raise KeyError(f"lin{i} weight not found")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)
    return out_path


def random_params(net_type: str = "vgg", seed: int = 0) -> Dict[str, np.ndarray]:
    """Random-init parameter set (for tests / architecture validation)."""
    rng = np.random.default_rng(seed)
    out = {}
    cin = 3
    if net_type == "vgg":
        taps = []
        ci = 0
        for v in VGG16_CFG:
            if v == "M":
                continue
            out[f"conv{ci}_w"] = rng.normal(0, 0.05, (v, cin, 3, 3)).astype(np.float32)
            out[f"conv{ci}_b"] = np.zeros(v, np.float32)
            if ci in VGG_TAPS:
                taps.append(v)
            cin = v
            ci += 1
    elif net_type == "squeeze":
        out["conv0_w"] = rng.normal(0, 0.05, (64, 3, 3, 3)).astype(np.float32)
        out["conv0_b"] = np.zeros(64, np.float32)
        cin = 64
        for idx, (sq, ex) in SQUEEZE_FIRE_CH.items():
            out[f"fire{idx}_squeeze_w"] = rng.normal(0, 0.05, (sq, cin, 1, 1)).astype(np.float32)
            out[f"fire{idx}_squeeze_b"] = np.zeros(sq, np.float32)
            out[f"fire{idx}_e1_w"] = rng.normal(0, 0.05, (ex, sq, 1, 1)).astype(np.float32)
            out[f"fire{idx}_e1_b"] = np.zeros(ex, np.float32)
            out[f"fire{idx}_e3_w"] = rng.normal(0, 0.05, (ex, sq, 3, 3)).astype(np.float32)
            out[f"fire{idx}_e3_b"] = np.zeros(ex, np.float32)
            cin = 2 * ex
        taps = list(SQUEEZE_TAP_CH)
    else:
        taps = []
        for i, (cout, k, s, p) in enumerate(ALEX_CONVS):
            out[f"conv{i}_w"] = rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32)
            out[f"conv{i}_b"] = np.zeros(cout, np.float32)
            taps.append(cout)
            cin = cout
    for i, c in enumerate(taps):
        out[f"lin{i}_w"] = np.abs(rng.normal(0, 0.01, (1, c, 1, 1))).astype(np.float32)
    return out
