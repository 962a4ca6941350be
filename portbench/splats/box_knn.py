"""bench.py's point cloud as its training state holds it: centres uniform
in a box, random colours, log-scales from the mean squared distance to the
3 nearest neighbours on both surfel axes, quaternions uniform in
[0, 1)^4 (unnormalised), no higher SH bands yet."""
import torch

from portbench.scene import SH_C0, generator

ROWS = 1024   # points per block of the neighbour search


def mean_sq_dist_3nn(xyz):
    """Mean squared distance to the 3 nearest other points, by blocks of
    rows against all points (|a|^2 + |b|^2 - 2 a.b, on centred points)."""
    x = xyz - xyz.mean(0)
    sq = (x * x).sum(1)
    out = []
    for s in range(0, x.shape[0], ROWS):
        d2 = sq[s:s + ROWS, None] + sq[None, :] - 2.0 * (x[s:s + ROWS] @ x.T)
        out.append(torch.clamp_min(torch.topk(d2, 4, largest=False).values[:, 1:], 0.0).mean(1))
    return torch.cat(out)


def make(spec: dict, n: int, sh_degree: int, seed: int, device):
    gen = generator(seed, 1, device)
    lo = torch.tensor(spec["lo"], dtype=torch.float32, device=device)
    hi = torch.tensor(spec["hi"], dtype=torch.float32, device=device)
    xyz = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=device)
    rgb = torch.rand((n, 1, 3), generator=gen, device=device)
    rot = torch.rand((n, 4), generator=gen, device=device)
    scale = torch.log(torch.sqrt(torch.clamp_min(mean_sq_dist_3nn(xyz), 1e-7)))
    k = (sh_degree + 1) ** 2
    return dict(xyz=xyz, features_dc=(rgb - 0.5) / SH_C0,
                features_rest=torch.zeros((n, k - 1, 3), device=device),
                scaling=scale[:, None].repeat(1, 2), rotation=rot)
