"""A mid-training model of an outdoor scene as regions of splats: each
region (an ellipsoid volume, a ground disc or a distant shell) holds its
share of the splats uniformly, with log-scales from the region's density
(the mean spacing of its points) and a log-normal spread, random colours,
small higher SH bands, and orientations random or facing up."""
import math

import torch

from portbench.scene import SH_C0, generator


def _ellipsoid(r, n, gen, dev):
    d = torch.randn((n, 3), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    u = torch.rand((n, 1), generator=gen, device=dev) ** (1.0 / 3.0)
    pts = d * u * torch.tensor(r["radii"], device=dev)
    vol = 4.0 / 3.0 * math.pi * math.prod(r["radii"])
    return pts, (vol / n) ** (1.0 / 3.0)


def _disc(r, n, gen, dev):
    u = torch.rand((2, n), generator=gen, device=dev)
    rad = r["radius"] * torch.sqrt(u[0])
    th = 2 * math.pi * u[1]
    pts = torch.stack([rad * torch.cos(th), rad * torch.sin(th), torch.zeros_like(rad)], 1)
    return pts, (math.pi * r["radius"] ** 2 / n) ** 0.5


def _shell(r, n, gen, dev):
    r0, r1 = r["radius"]
    zlo = r["z_min"] / (0.5 * (r0 + r1))
    u = torch.rand((3, n), generator=gen, device=dev)
    z = zlo + (1 - zlo) * u[0]
    ph = 2 * math.pi * u[1]
    rad = r0 + (r1 - r0) * u[2]
    s = torch.sqrt(torch.clamp_min(1 - z * z, 0.0))
    pts = rad[:, None] * torch.stack([s * torch.cos(ph), s * torch.sin(ph), z], 1)
    area = 2 * math.pi * (0.5 * (r0 + r1)) ** 2 * (1 - zlo)
    return pts, (area / n) ** 0.5


SHAPES = {"ellipsoid": _ellipsoid, "disc": _disc, "shell": _shell}


def make(spec: dict, n: int, sh_degree: int, seed: int, device):
    gen = generator(seed, 1, device)
    counts = [int(round(r["share"] * n)) for r in spec["regions"]]
    counts[-1] = n - sum(counts[:-1])
    xyz, scale, rot = [], [], []
    for r, m in zip(spec["regions"], counts):
        pts, spacing = SHAPES[r["shape"]](r, m, gen, device)
        xyz.append(pts + torch.tensor(r.get("center", [0.0, 0.0, 0.0]), device=device))
        spread = torch.randn((m, 2), generator=gen, device=device) * spec["log_spread"]
        scale.append(math.log(spacing) + spread)
        q = torch.randn((m, 4), generator=gen, device=device)
        if r["orient"] == "up":
            q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device) + 0.05 * q
        rot.append(q)
    k = (sh_degree + 1) ** 2
    rgb = torch.rand((n, 1, 3), generator=gen, device=device)
    rest = torch.randn((n, k - 1, 3), generator=gen, device=device) * spec["rest_std"]
    return dict(xyz=torch.cat(xyz), features_dc=(rgb - 0.5) / SH_C0, features_rest=rest,
                scaling=torch.cat(scale), rotation=torch.cat(rot))
