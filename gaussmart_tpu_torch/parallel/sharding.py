"""Multi-device rendering and training over D device slots (counterpart of
gaussmart_tpu/parallel/sharding.py).

The JAX package drives a mesh of D devices from one controller. The port
does the same in one process with a list of D slots (``Mesh``): slot i
lives on device ``i % count`` of the requested type, so D slots fill D
cards, or share one card, or sit on the CPU. Autograd crosses devices in
one process, so the backward through the stratum gathers and the fold
needs no hand-written collectives; the collectives are explicit copies:
all_gather is ``.to(slot device)`` plus a stack, psum a sum and pmax a max
on slot 0's device.

  * Camera data-parallel training (``make_dp_train_step``): one camera per
    slot; state replicated (``replicate``); gradients averaged, densify
    statistics summed (max radii maxed) on slot 0, then one Adam step.
  * Row-sharded rendering (``render_row_sharded``): each slot composites
    its block of image rows with the dense compositor; exact.
  * Gaussian-sharded rendering (``render_gaussian_sharded``): splats
    depth-sorted into D contiguous strata, each composited on its slot,
    the segments folded with the associativity of the over operator in
    two passes (parallel/DESIGN.md of the JAX package, section 3). Its
    "pallas" inner compositor is the seeded tiled core, K3/K4.
  * Gaussian-sharded training (``make_mp_train_step``): params, Adam
    moments and densify statistics held as per-slot chunks of capacity/D
    rows (``shard_state``); only preprocess rows and framebuffer maps move.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch

from gaussmart_tpu_torch.cameras import CameraParams
from gaussmart_tpu_torch.config import OptimizationParams
from gaussmart_tpu_torch.models.densify import add_densification_stats
from gaussmart_tpu_torch.models.gaussians import GaussianAux, GaussianParams
from gaussmart_tpu_torch.optim import NAMES, AdamState, adam_step, group_lrs
from gaussmart_tpu_torch.render import raster_tiled
from gaussmart_tpu_torch.render.raster_common import T_EPS, Preprocessed
from gaussmart_tpu_torch.render.raster_dense import rasterize_pixels
from gaussmart_tpu_torch.train_lib import (StepMetrics, _apply_update,
                                           _check_adam_on_densify, _drops_adam, _grads,
                                           _leaves, _loss_and_aux, _metrics)


class Mesh(NamedTuple):
    """D device slots; slot i's tensors live on devices[i]."""
    devices: List[torch.device]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """`n_devices` slots on the devices of `device`'s type, slot i on
    device i % count: cuda:0..D-1 on a machine with D cards, D slots on
    cuda:0 with one card, D slots on the CPU for device="cpu". (The JAX
    make_mesh keeps at most as many slots as there are devices.)"""
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: need at least one slot")
    kind = torch.device(device).type
    if kind == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is available for the mesh")
        devices = [torch.device("cuda", i % count) for i in range(n_devices)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * n_devices
    else:
        raise ValueError(f"a mesh runs on cuda or cpu devices, not {device}")
    names = sorted({str(d) for d in devices})
    print(f"[mesh] {n_devices} slots on {', '.join(names)}")
    return Mesh(devices)


def to_device(obj, device):
    """A tensor, or a dataclass/NamedTuple of them (params, aux, Adam state,
    cameras), with every tensor moved to `device` (no copy where it is
    there already)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    return obj


def replicate(obj, mesh: Mesh) -> list:
    """One copy of `obj` per slot, on its device (slots that share a
    device share the tensors)."""
    return [to_device(obj, d) for d in mesh.devices]


def _split(obj, mesh: Mesh, i: int):
    """Slot i's contiguous 1/D of every tensor's leading axis."""
    if isinstance(obj, torch.Tensor):
        n = obj.shape[0] // mesh.size
        return obj[i * n:(i + 1) * n].to(mesh.devices[i])
    return dataclasses.replace(obj, **{f.name: _split(getattr(obj, f.name), mesh, i)
                                       for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name), torch.Tensor)})


def shard_batch(obj, mesh: Mesh) -> list:
    """A batch of D (a tensor or BatchedCameras, leading axis D) as one
    item of the batch per slot, on its device."""
    return [_split(obj, mesh, i) for i in range(mesh.size)]


@dataclasses.dataclass(frozen=True)
class BatchedCameras:
    """A stack of B same-resolution cameras (leading axis B)."""
    world_view: torch.Tensor      # [B,4,4]
    full_proj: torch.Tensor       # [B,4,4]
    camera_center: torch.Tensor   # [B,3]
    tanfovx: torch.Tensor         # [B]
    tanfovy: torch.Tensor         # [B]
    width: int
    height: int

    @staticmethod
    def stack(cams: List[CameraParams]) -> "BatchedCameras":
        dev = cams[0].device
        return BatchedCameras(
            world_view=torch.stack([c.world_view for c in cams]),
            full_proj=torch.stack([c.full_proj for c in cams]),
            camera_center=torch.stack([c.camera_center for c in cams]),
            tanfovx=torch.tensor([c.tanfovx for c in cams], dtype=torch.float64, device=dev),
            tanfovy=torch.tensor([c.tanfovy for c in cams], dtype=torch.float64, device=dev),
            width=cams[0].width, height=cams[0].height)

    def index(self, i: int) -> CameraParams:
        return CameraParams(world_view=self.world_view[i], full_proj=self.full_proj[i],
                            camera_center=self.camera_center[i],
                            tanfovx=float(self.tanfovx[i]), tanfovy=float(self.tanfovy[i]),
                            width=self.width, height=self.height)


# --- sharded state (Gaussian-sharded training) -------------------------------

def shard_state(params: GaussianParams, adam: AdamState, aux: GaussianAux,
                mesh: Mesh):
    """Split scene state into per-slot chunks of capacity/D rows on each
    slot's device: (params chunks, Adam chunks, aux chunks), the layout
    make_mp_train_step takes and returns. The Adam step count is
    replicated."""
    cap = params.xyz.shape[0]
    if cap % mesh.size:
        raise ValueError(f"capacity {cap} is not a multiple of the {mesh.size} "
                         "slots: Gaussian-sharded state needs equal chunks")
    p = [_split(params, mesh, i) for i in range(mesh.size)]
    a = [AdamState(mu=_split(adam.mu, mesh, i), nu=_split(adam.nu, mesh, i),
                   step=adam.step.to(d)) for i, d in enumerate(mesh.devices)]
    x = [_split(aux, mesh, i) for i in range(mesh.size)]
    return p, a, x


def gather_state(params: List[GaussianParams], adam: List[AdamState],
                 aux: List[GaussianAux], device):
    """The inverse of shard_state: whole (params, adam, aux) on `device`."""
    def cat(chunks):
        return dataclasses.replace(chunks[0], **{
            f.name: torch.cat([getattr(c, f.name).to(device) for c in chunks])
            for f in dataclasses.fields(chunks[0])})
    return (cat(params), AdamState(mu=cat([a.mu for a in adam]),
                                   nu=cat([a.nu for a in adam]),
                                   step=adam[0].step.to(device)), cat(aux))


# --- training steps ----------------------------------------------------------

def _bg(white_background: bool, device) -> torch.Tensor:
    return torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                        dtype=torch.float32, device=device)


def make_dp_train_step(opt: OptimizationParams, mesh: Mesh, *, sh_degree: int,
                       white_background: bool, depth_ratio: float = 0.0,
                       backend: str = "auto", spatial_lr_scale: float = 1.0,
                       adam_on_densify: str = "drop", dino_fn: Optional[Callable] = None):
    """Camera data-parallel step ``step(params, adam, aux, cams, gt_images,
    iteration) -> (params, adam, aux, StepMetrics, iteration + 1)``.

    params/adam/aux are per-slot replicas (``replicate``), cams and
    gt_images one camera and one [1,3,H,W] target per slot
    (``shard_batch``). Each slot renders and differentiates its view; on
    slot 0 the gradients are averaged (gradient accumulation over the D
    views), the densify statistics summed and the radii maxed, then one
    masked Adam step, replicated back to every slot. `dino_fn` (the DINO
    term, train._build_dino_fn) is taken on each slot's view, on its
    device."""
    _check_adam_on_densify(adam_on_densify)
    dev0 = mesh.devices[0]

    def step(params, adam, aux, cams, gt_images, iteration: int):
        totals, extras, grads, stats = [], [], [], []
        for i, dev in enumerate(mesh.devices):
            leaves = _leaves(params[i])
            means2d = torch.zeros((leaves.xyz.shape[0], 2), dtype=torch.float32,
                                  device=dev, requires_grad=True)
            total, ex = _loss_and_aux(leaves, means2d, aux[i], cams[i].index(0),
                                     gt_images[i][0], iteration, opt,
                                     _bg(white_background, dev), sh_degree,
                                     depth_ratio, backend, dino_fn)
            total.backward()
            totals.append(total.detach().to(dev0))
            extras.append({k: v.detach().to(dev0) for k, v in ex.items()})
            grads.append(to_device(_grads(leaves), dev0))
            zero = torch.zeros_like(aux[i].grad_accum)
            stats.append(to_device(add_densification_stats(
                dataclasses.replace(aux[i], grad_accum=zero, denom=zero,
                                    max_radii2d=zero), means2d.grad, ex["radii"]), dev0))
        D = mesh.size
        with torch.no_grad():
            mean = GaussianParams(**{n: sum(getattr(g, n) for g in grads) / D
                                     for n in NAMES})
            x = aux[0]
            if iteration < opt.densify_until_iter:
                x = dataclasses.replace(
                    x, grad_accum=x.grad_accum + sum(s.grad_accum for s in stats),
                    denom=x.denom + sum(s.denom for s in stats),
                    max_radii2d=torch.maximum(x.max_radii2d, torch.stack(
                        [s.max_radii2d for s in stats]).amax(0)))
            p, a = params[0], adam[0]
            if not _drops_adam(opt, iteration, adam_on_densify):
                p, a = adam_step(p, mean, a, group_lrs(opt, iteration, spatial_lr_scale),
                                 x.active)

            def pmean(k):
                return torch.stack([e[k] for e in extras]).mean()
            metrics = StepMetrics(
                total=torch.stack(totals).mean(), l1=pmean("l1"), dist=pmean("dist"),
                normal=pmean("normal"), dino=pmean("dino"), psnr=pmean("psnr"),
                n_active=x.active.sum(),
                n_dropped=torch.stack([e["n_dropped"] for e in extras]).sum())
        return (replicate(p, mesh), replicate(a, mesh), replicate(x, mesh), metrics,
                iteration + 1)

    return step


def make_mp_train_step(opt: OptimizationParams, mesh: Mesh, *, sh_degree: int,
                       white_background: bool, depth_ratio: float = 0.0,
                       spatial_lr_scale: float = 1.0, adam_on_densify: str = "drop",
                       backend: str = "gaussian_sharded",
                       dino_fn: Optional[Callable] = None,
                       phase: Optional[Callable[[str], None]] = None):
    """Gaussian-sharded (model-parallel) step ``step(params, adam, aux, cam,
    gt_image, iteration) -> (params, adam, aux, StepMetrics, iteration +
    1)`` on per-slot chunks (``shard_state``); the outputs stay per-slot
    chunks, so each slot holds capacity/D rows of params, Adam moments and
    densify statistics.

    One camera per iteration, as the single-device step. Each chunk is
    preprocessed on its slot; render_gaussian_sharded moves the prep rows
    to their stratum's slot and folds the strata on slot 0, where the loss
    is taken (cam and gt_image live there; so is the DINO term `dino_fn`,
    when given); autograd brings the gradients
    back to each chunk, which takes its densify statistics and masked Adam
    step as in train_lib.make_train_step. backend: "gaussian_sharded"
    composites each stratum with the dense compositor,
    "gaussian_sharded_pallas" with the seeded tiled core (K3/K4). `phase`
    is make_train_step's stage hook."""
    _check_adam_on_densify(adam_on_densify)
    if backend not in ("gaussian_sharded", "gaussian_sharded_pallas"):
        raise ValueError(f"backend {backend!r}: expected 'gaussian_sharded' or "
                         "'gaussian_sharded_pallas'")
    mark = phase or (lambda name: None)

    def step(params, adam, aux, cam: CameraParams, gt_image: torch.Tensor,
             iteration: int):
        leaves = [_leaves(p) for p in params]
        means2d = [torch.zeros((p.xyz.shape[0], 2), dtype=torch.float32,
                               device=p.xyz.device, requires_grad=True) for p in params]
        total, extras = _loss_and_aux(leaves, means2d, aux, cam, gt_image, iteration,
                                      opt, _bg(white_background, cam.device), sh_degree,
                                      depth_ratio, backend, dino_fn, mark, mesh=mesh)
        total.backward()
        mark("backward")
        out = [_apply_update(params[i], _grads(leaves[i]), adam[i], aux[i],
                             means2d[i].grad, extras["radii"][i], iteration, opt,
                             spatial_lr_scale, adam_on_densify)
               for i in range(mesh.size)]
        metrics = _metrics(total, extras,
                           sum(x.active.sum().to(cam.device) for _, _, x in out))
        mark("adam")
        return ([p for p, _, _ in out], [a for _, a, _ in out], [x for _, _, x in out],
                metrics, iteration + 1)

    return step


# --- rendering ---------------------------------------------------------------

def sharded_render_backend(backend: str) -> str:
    """The Gaussian-sharded backend for a pipeline backend: the seeded
    tiled core (K3/K4 on a card, their plain versions on the CPU) where
    the single-device render would take the tiled compositor ("auto",
    "pallas"), the dense compositor for "dense"."""
    return "gaussian_sharded" if backend == "dense" else "gaussian_sharded_pallas"


def _cat_prep(preps: List[Preprocessed], device) -> Preprocessed:
    return Preprocessed(*(torch.cat([x.to(device) for x in xs]) for xs in zip(*preps)))


def render_gaussian_sharded(mesh: Mesh, prep, means2d, bg: torch.Tensor, width: int,
                            height: int, chunk: int = 64, backend: str = "dense",
                            need_dist_grad: bool = True, need_med_grad: bool = True):
    """Splat-sharded rendering: the splats are depth-sorted (stable) and
    cut into D contiguous strata, each composited on its slot, and the
    per-pixel segments folded with the associativity of the over operator

        C = C_near + T_near * C_far,   T = T_near * T_far,

    plus the distortion-moment offsets, the deepest stratum's median and
    an exact sticky-termination carry. Pass 1 composites every stratum
    from an identity seed and gathers its transmittance factor, moments
    and min test transmittance; each stratum's incoming (T, M1, M2) follows
    (T zeroed past a stratum where the single-device walk terminates,
    T_in * min_test < T_EPS); pass 2 composites again from that seed; slot
    0 sums the strata, takes T from the last live stratum and the median
    from the deepest stratum that recorded a T > 0.5 crossing.

    `prep`/`means2d` are one Preprocessed and its [N,2] means2d, or lists
    of per-slot chunks (the sharded training state), gathered on slot 0 in
    order. backend: "dense" composites each stratum with rasterize_pixels,
    "pallas" with the seeded tiled core (K3 forward, K4 backward; each
    stratum binned once per frame for both passes: the binning depends
    only on the prep rows). Differentiable end to end; need_dist_grad /
    need_med_grad as for rasterize_tiled."""
    if backend not in ("dense", "pallas"):
        raise ValueError(f"backend {backend!r}: expected 'dense' or 'pallas'")
    D = mesh.size
    dev0 = mesh.devices[0]
    if isinstance(prep, (list, tuple)) and not isinstance(prep, Preprocessed):
        prep = _cat_prep(prep, dev0)
        means2d = torch.cat([m.to(dev0) for m in means2d])
    N = prep.depth.shape[0]
    P = width * height

    # depth-stratified assignment: global stable sort, contiguous strata,
    # padded to a multiple of D with invalid zero-opacity rows
    with torch.no_grad():
        order = torch.argsort(torch.where(prep.valid, prep.depth, torch.inf), stable=True)
    n_pad = -(-N // D) * D
    per = n_pad // D

    def sorted_padded(x):
        x = x[order]
        return torch.cat([x, x.new_zeros((n_pad - N,) + x.shape[1:])])

    prep_s = Preprocessed(*(sorted_padded(x) for x in prep))
    prep_s = prep_s._replace(opacity=prep_s.opacity * prep_s.valid.to(torch.float32))
    means2d_s = sorted_padded(means2d)
    strata = [(Preprocessed(*(to_device(x[i * per:(i + 1) * per], d) for x in prep_s)),
               means2d_s[i * per:(i + 1) * per].to(d)) for i, d in enumerate(mesh.devices)]

    if backend == "pallas":
        tiles = raster_tiled.tile_grid(width, height)
        with torch.no_grad():
            binned = [raster_tiled.binning(p, *tiles) for p, _ in strata]

        def raster(i, init):
            p, m = strata[i]
            if init is None:
                init = {"T": torch.ones(P, device=m.device),
                        "M1": torch.zeros(P, device=m.device),
                        "M2": torch.zeros(P, device=m.device)}
            return raster_tiled.rasterize_tiled(
                p, m, torch.zeros(3, device=m.device), width, height,
                need_dist_grad=need_dist_grad, need_med_grad=need_med_grad,
                init_state=init, return_raw=True, binned=binned[i])["raw"]
    else:
        def raster(i, init):
            p, m = strata[i]
            return rasterize_pixels(p, m, torch.zeros(3, device=m.device), width,
                                    height, chunk=chunk, init_state=init,
                                    return_raw=True)["raw"]

    # pass 1: every stratum from an identity seed; gather its summary
    p1 = [raster(i, None) for i in range(D)]
    factors = torch.stack([torch.stack([r["T"], r["M1"], r["M2"], r["min_test"]]).to(dev0)
                           for r in p1])                           # [D, 4, P]
    T_in = torch.cat([torch.ones_like(factors[:1, 0]),
                      torch.cumprod(factors[:, 0], dim=0)[:-1]])    # [D, P]

    def exclusive_sum(x):
        return torch.cumsum(x, dim=0) - x
    # incoming moments: earlier strata's moments scaled by their incoming
    # transmittance (w-linearity; exact wherever the T_EPS cutoff does not bite)
    M1_in = exclusive_sum(T_in * factors[:, 1])
    M2_in = exclusive_sum(T_in * factors[:, 2])
    # sticky termination: stratum k ends a pixel for good iff T_in_k *
    # min_test_k < T_EPS; a zero seed T reproduces "done" downstream
    trig = (T_in * factors[:, 3] < T_EPS).to(torch.int32)
    done_in = exclusive_sum(trig) > 0
    T_seed = torch.where(done_in, 0.0, T_in)

    # pass 2: every stratum from its exact incoming state
    p2 = [raster(i, {"T": T_seed[i].to(d), "M1": M1_in[i].to(d), "M2": M2_in[i].to(d)})
          for i, d in enumerate(mesh.devices)]

    def gathered(key):
        return torch.stack([r[key].to(dev0) for r in p2])

    # final T from the last live stratum (the product of every factor would
    # keep multiplying past a termination)
    ranks = torch.arange(D, device=dev0)[:, None]
    r_live = torch.where(~done_in, ranks, -1)
    T_total = torch.where(r_live == r_live.amax(0), gathered("T"), 0.0).sum(0)
    # median: the deepest stratum that recorded a T > 0.5 crossing
    med = gathered("median")
    r_hit = torch.where(med > 0, ranks, -1)
    median = torch.where(r_hit == r_hit.amax(0), med, 0.0).sum(0)

    color = gathered("color").sum(0)
    normal = gathered("normal").sum(0)
    image = color + T_total[None, :] * bg[:, None]
    allmap = torch.stack([gathered("depth").sum(0), gathered("alpha").sum(0),
                          normal[0], normal[1], normal[2], median,
                          gathered("dist").sum(0)])
    return {"image": image.reshape(3, height, width),
            "allmap": allmap.reshape(7, height, width),
            "n_dropped": torch.zeros((), dtype=torch.int32, device=dev0)}


def render_row_sharded(mesh: Mesh, prep: Preprocessed, means2d: torch.Tensor,
                       bg: torch.Tensor, width: int, height: int, chunk: int = 64):
    """Image rows in D equal blocks, block i composited on slot i by the
    dense compositor over every splat (replicated); exact, since
    compositing is per pixel. `height` must be a multiple of D (render_arrays
    pads and crops)."""
    D = mesh.size
    if height % D:
        raise ValueError(f"height {height} is not a multiple of the {D} slots")
    rows = height // D
    outs = [rasterize_pixels(to_device(prep, d), means2d.to(d), bg.to(d), width, height,
                             chunk=chunk, rows=rows, row_offset=i * rows)
            for i, d in enumerate(mesh.devices)]
    dev0 = mesh.devices[0]
    return {k: torch.cat([o[k].to(dev0) for o in outs], dim=1)
            for k in ("image", "allmap")}
