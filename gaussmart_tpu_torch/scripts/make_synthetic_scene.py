#!/usr/bin/env python3
"""Generate a realistic COLMAP-format validation scene with ray-traced GT
(counterpart of scripts/make_synthetic_scene.py, with its flags and
output files).

The GT images come from an analytic ray tracer (textured sphere,
checkerboard ground plane, two boxes, Lambertian lighting), independent of
the framework's own rasterizer, so training against them is an honest
end-to-end optimization benchmark. The tracer runs in float64 torch
tensors on --device (the card unless --device cpu); the camera ring and
every random draw (SfM cloud, its noise and outliers, GT samples) stay
numpy from the same seeds, so the text models, the SfM cloud and the GT
samples equal the JAX script's to the bit, and the pixels differ only
where float64 transcendentals round differently before the uint8 cast.

Outputs under --out:
  images/r_XX.png              ray-traced views (2x2 supersampled)
  sparse/0/{cameras,images,points3D}.txt   COLMAP text model
  sparse/0/points3D.ply, poses_bounds.npy  nerf-format exports
  gt_surface_points.npy        dense GT surface samples (Chamfer reference)
  masks_gt/segments_XXX.npz    analytic object masks (--write_masks)

    python -m gaussmart_tpu_torch.scripts.make_synthetic_scene --out <dir> \
        [--views 32] [--width 776] [--height 584] [--sfm_points 30000] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Tuple

import numpy as np
import torch

from gaussmart_tpu_torch.io.colmap import (ColmapCamera, ColmapImage, rotmat2qvec,
                                           write_cameras_text, write_images_text)
from gaussmart_tpu_torch.io.images import write_png
from gaussmart_tpu_torch.io.ply import write_ply
from gaussmart_tpu_torch.runtime import resolve_device
from gaussmart_tpu_torch.semantics.sam_backend import save_masks_npz

PLANE_Y = -0.8
SPHERE_R = 0.65
BOX1 = (np.array([-1.15, PLANE_Y, -0.35]), np.array([-0.55, -0.15, 0.25]))
BOX2 = (np.array([0.6, PLANE_Y, 0.15]), np.array([1.1, -0.35, 0.65]))
BOX_COLOURS = (np.array([0.8, 0.45, 0.2]), np.array([0.3, 0.65, 0.75]))
LIGHTS = [(np.array([0.4, 0.8, 0.45]), 0.85), (np.array([-0.6, 0.5, -0.6]), 0.45)]
AMBIENT = 0.25


@dataclasses.dataclass
class Layout:
    """What the flags change. Bounded (DTU-like) by default; `unbounded` is
    an M360-style layout: the ground plane runs to the horizon and a ring
    of far "hill" spheres surrounds the foreground, so splats must cover
    depth from ~2 to ~25 units and mesh extraction needs the contraction
    (unbounded) path. `float_sphere` raises the sphere into the void above
    the scene: from the ring cameras its mask then has (almost) no other
    geometry behind it, the one configuration in which the reference's
    mask-area augmentation target (sqrt(area)*0.1) can exceed the
    segment's assigned point count."""
    sphere_c: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -0.1, 0.0]))
    plane_ext: float = 2.2
    far_spheres: List[Tuple[np.ndarray, float, np.ndarray]] = dataclasses.field(
        default_factory=list)   # (center[3], radius, albedo[3])


def make_layout(unbounded: bool = False, float_sphere: bool = False) -> Layout:
    lay = Layout()
    if unbounded:
        lay.plane_ext = 40.0
        rng = np.random.default_rng(11)
        for i in range(10):
            ang = 2 * np.pi * i / 10 + rng.uniform(-0.15, 0.15)
            dist = rng.uniform(14.0, 22.0)
            rad = rng.uniform(4.0, 8.0)
            c = np.array([dist * np.cos(ang), PLANE_Y - 0.55 * rad,
                          dist * np.sin(ang)])
            col = np.array([0.25 + 0.2 * rng.random(),
                            0.4 + 0.25 * rng.random(),
                            0.2 + 0.15 * rng.random()])
            lay.far_spheres.append((c, rad, col))
    if float_sphere:
        lay.sphere_c = np.array([0.0, 1.1, 0.0])
    return lay


# The textures take numpy arrays (the SfM colours, drawn on the host as the
# JAX script draws them) or torch tensors (the tracer), with the same ops.

def _xp(p):
    return torch if isinstance(p, torch.Tensor) else np


def _vec(values, like):
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(values, np.float64), device=like.device)
    return np.asarray(values, np.float64)


def _checker(p):
    xp = _xp(p)
    c = (xp.floor(p[..., 0] * 2.0) + xp.floor(p[..., 2] * 2.0)) % 2
    col = xp.where(c[..., None] > 0.5,
                   _vec([0.85, 0.82, 0.78], p), _vec([0.25, 0.3, 0.4], p))
    # LOD fade: beyond ~6 units the checker frequency exceeds what any
    # camera in the ring resolves (and what a splat model could fit), so
    # blend toward the mean color like a mip chain would. No-op within the
    # bounded scene's 2.2-unit extent.
    r = xp.linalg.norm(p[..., [0, 2]], axis=-1, keepdims=True)
    w = xp.clip((r - 6.0) / 12.0, 0.0, 0.9)
    mean = _vec([0.55, 0.56, 0.59], p)
    return col * (1 - w) + mean * w


def _sphere_tex(p, lay: Layout):
    xp = _xp(p)
    d = (p - _vec(lay.sphere_c, p)) / SPHERE_R
    phi = xp.arctan2(d[..., 2], d[..., 0])
    theta = xp.arccos(xp.clip(d[..., 1], -1, 1))
    stripes = 0.5 + 0.5 * xp.sin(6.0 * phi) * xp.sin(5.0 * theta)
    base = xp.stack([0.9 * stripes + 0.05, 0.25 + 0.45 * (1 - stripes),
                     0.3 + 0.2 * xp.sin(3 * phi)], axis=-1)
    return xp.clip(base, 0, 1)


def _box_hit(o, d, lo, hi):
    lo, hi = _vec(lo, d), _vec(hi, d)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, 1e-9, d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = tmax > torch.clamp_min(tmin, 1e-4)
    return torch.where(hit, tmin, torch.inf)


def _box_normal(p, lo, hi):
    eps = 1e-4
    n = torch.zeros_like(p)
    for ax in range(3):
        n[..., ax] = torch.where(torch.abs(p[..., ax] - lo[ax]) < eps, -1.0,
                                 torch.where(torch.abs(p[..., ax] - hi[ax]) < eps,
                                             1.0, 0.0))
    return n


def _sphere_hit(o, d, centre, radius, best_t):
    oc = o - _vec(centre, d)
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius ** 2
    disc = b * b - c
    ts = -b - torch.sqrt(torch.clamp_min(disc, 0))
    return (disc > 0) & (ts > 1e-4) & (ts < best_t), ts


def trace(o, d, lay: Layout):
    """o, d: [..., 3] float64 rays -> rgb [..., 3], hit point [..., 3],
    hit mask [...], material id [...] (0 none, 1 plane, 2 sphere, 3/4 box,
    5+k far sphere k)."""
    best_t = torch.full(d.shape[:-1], torch.inf, dtype=d.dtype, device=d.device)
    mat = torch.zeros(d.shape[:-1], dtype=torch.int32, device=d.device)

    # plane (bounded to the scene extent so geometry stays finite)
    tp = (PLANE_Y - o[..., 1]) / torch.where(torch.abs(d[..., 1]) < 1e-9, 1e-9,
                                             d[..., 1])
    pp = o + tp[..., None] * d
    inb = (torch.abs(pp[..., 0]) < lay.plane_ext) & (torch.abs(pp[..., 2]) < lay.plane_ext)
    ok = (tp > 1e-4) & (tp < best_t) & inb
    best_t = torch.where(ok, tp, best_t)
    mat = torch.where(ok, 1, mat)

    ok, ts = _sphere_hit(o, d, lay.sphere_c, SPHERE_R, best_t)
    best_t = torch.where(ok, ts, best_t)
    mat = torch.where(ok, 2, mat)

    for mi, (lo, hi) in ((3, BOX1), (4, BOX2)):
        tb = _box_hit(o, d, lo, hi)
        ok = tb < best_t
        best_t = torch.where(ok, tb, best_t)
        mat = torch.where(ok, mi, mat)

    for k, (fc, fr, _col) in enumerate(lay.far_spheres):
        ok, ts = _sphere_hit(o, d, fc, fr, best_t)
        best_t = torch.where(ok, ts, best_t)
        mat = torch.where(ok, 5 + k, mat)

    hit = torch.isfinite(best_t)
    t = torch.where(hit, best_t, 0.0)
    p = o + t[..., None] * d

    # normals + albedo per material
    albedo = torch.zeros_like(p)
    normal = torch.zeros_like(p)
    albedo = torch.where((mat == 1)[..., None], _checker(p), albedo)
    normal = torch.where((mat == 1)[..., None], _vec([0.0, 1.0, 0.0], p), normal)
    albedo = torch.where((mat == 2)[..., None], _sphere_tex(p, lay), albedo)
    sn = (p - _vec(lay.sphere_c, p)) / SPHERE_R
    normal = torch.where((mat == 2)[..., None], sn, normal)
    for mi, (lo, hi), col in zip((3, 4), (BOX1, BOX2), BOX_COLOURS):
        albedo = torch.where((mat == mi)[..., None], _vec(col, p), albedo)
        normal = torch.where((mat == mi)[..., None], _box_normal(p, lo, hi), normal)
    for k, (fc, fr, col) in enumerate(lay.far_spheres):
        sel = (mat == 5 + k)[..., None]
        albedo = torch.where(sel, _vec(col, p), albedo)
        normal = torch.where(sel, (p - _vec(fc, p)) / fr, normal)

    shade = AMBIENT * torch.ones(d.shape[:-1], dtype=d.dtype, device=d.device)
    for ldir, lint in LIGHTS:
        ld = _vec(ldir / np.linalg.norm(ldir), p)
        shade = shade + lint * torch.clamp_min(torch.sum(normal * ld, dim=-1), 0.0)
    rgb = torch.clip(albedo * shade[..., None], 0, 1)
    rgb = torch.where(hit[..., None], rgb, _vec([1.0, 1.0, 1.0], p))  # white bg
    return rgb, p, hit, mat


def camera_ring(n_views, radius=3.1, height_amp=0.75):
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        h = 0.55 + height_amp * (0.5 + 0.5 * np.sin(3 * ang + 0.7))
        eye = np.array([radius * np.cos(ang), h, radius * np.sin(ang)])
        target = np.array([0.0, -0.25, 0.0])
        fwd = target - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        # world->cam rotation rows: x=right, y=-up (image y down), z=fwd
        R = np.stack([right, -up, fwd])            # [3,3] w2c
        t = -R @ eye
        cams.append((R, t, eye))
    return cams


def _pixel_rays(R, eye, W, H, f, ox, oy, device):
    """World rays through pixel (x + ox, y + oy) of every pixel, [H, W, 3]."""
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=device) + oy,
                            torch.arange(W, dtype=torch.float64, device=device) + ox,
                            indexing="ij")
    dirs_cam = torch.stack([(xs - W / 2) / f, (ys - H / 2) / f, torch.ones_like(xs)],
                           dim=-1)
    dirs = dirs_cam @ torch.as_tensor(R, device=device)   # R^T @ d per pixel
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return torch.as_tensor(eye, device=device).expand(dirs.shape), dirs


@torch.no_grad()
def render_view(R, eye, W, H, f, lay: Layout, ss=2, device="cpu"):
    """`ss`x`ss` supersampling, as [H, W, 3] float64 numpy: photographs are
    band-limited by the lens + sensor; 1-ray-per-pixel GT has aliased
    (Nyquist-violating) edges that no splat model can fit, which keeps edge
    gradients permanently high and drives runaway densification.
    Box-filtered SSAA makes the target realizable, like the reference's
    real-photo datasets."""
    acc = torch.zeros((H, W, 3), dtype=torch.float64, device=device)
    offs = (np.arange(ss) + 0.5) / ss
    for oy in offs:
        for ox in offs:
            o, dirs = _pixel_rays(R, eye, W, H, f, ox, oy, device)
            acc += trace(o, dirs, lay)[0]
    return (acc / (ss * ss)).cpu().numpy()


@torch.no_grad()
def object_masks(R, eye, W, H, f, lay: Layout, device="cpu"):
    """One centre ray per pixel; material id -> binary object masks in the
    reference's segments npz layout (segmentation, bbox, area)."""
    o, dirs = _pixel_rays(R, eye, W, H, f, 0.5, 0.5, device)
    mat = trace(o, dirs, lay)[3].cpu().numpy()
    masks = []
    for m_id in np.unique(mat):
        if m_id == 0:
            continue
        seg = mat == m_id
        ys_m, xs_m = np.where(seg)
        masks.append({
            "segmentation": seg,
            "bbox": [int(xs_m.min()), int(ys_m.min()),
                     int(xs_m.max() - xs_m.min() + 1),
                     int(ys_m.max() - ys_m.min() + 1)],
            "area": int(seg.sum())})
    return masks


def sample_surface(n, rng, lay: Layout):
    """GT surface samples with albedo colors (for SfM cloud + Chamfer),
    numpy on the host: the same draws as the JAX script's."""
    pts, cols = [], []
    # proportional-ish areas
    n_sph = n // 3
    n_pl = n // 3
    n_box = n - n_sph - n_pl
    v = rng.normal(size=(n_sph, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    p = lay.sphere_c + SPHERE_R * v
    keep = p[:, 1] > PLANE_Y
    pts.append(p[keep])
    cols.append(_sphere_tex(p[keep], lay))
    p = np.stack([rng.uniform(-2.2, 2.2, n_pl), np.full(n_pl, PLANE_Y),
                  rng.uniform(-2.2, 2.2, n_pl)], axis=1)
    pts.append(p)
    cols.append(_checker(p))
    for (lo, hi), col in zip((BOX1, BOX2), BOX_COLOURS):
        m = n_box // 2
        face = rng.integers(0, 5, m)  # skip bottom face
        u = rng.uniform(0, 1, (m, 3))
        p = lo + u * (hi - lo)
        for ax, side in ((0, 0), (0, 1), (2, 0), (2, 1), (1, 1)):
            sel = face == (ax * 2 + side if ax < 1 else
                           (2 + side if ax == 2 else 4))
            p[sel, ax] = (hi if side else lo)[ax]
        pts.append(p)
        cols.append(np.broadcast_to(col, p.shape).copy())
    if lay.far_spheres:
        # background coverage for the SfM-like cloud: far ground with a
        # near-biased radial density (as real SfM tracks thin out with
        # distance) plus the camera-facing upper caps of the hill spheres
        m = n // 4
        rad = 2.2 + 18.0 * np.sqrt(rng.uniform(0, 1, m))
        ang = rng.uniform(0, 2 * np.pi, m)
        p = np.stack([rad * np.cos(ang), np.full(m, PLANE_Y),
                      rad * np.sin(ang)], axis=1)
        pts.append(p)
        cols.append(_checker(p))
        mh = n // 8
        for fc, fr, col in lay.far_spheres:
            v = rng.normal(size=(mh // len(lay.far_spheres) + 1, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            v[:, 1] = np.abs(v[:, 1])          # upper hemisphere
            hp = fc + fr * v
            keep = hp[:, 1] > PLANE_Y - 0.05   # the part poking above ground
            pts.append(hp[keep])
            cols.append(np.broadcast_to(col, hp[keep].shape).copy())
    return np.concatenate(pts), np.clip(np.concatenate(cols), 0, 1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--views", type=int, default=32)
    ap.add_argument("--width", type=int, default=776)
    ap.add_argument("--height", type=int, default=584)
    ap.add_argument("--focal", type=float, default=700.0)
    ap.add_argument("--sfm_points", type=int, default=30000)
    ap.add_argument("--gt_points", type=int, default=200000)
    ap.add_argument("--unbounded", action="store_true",
                    help="M360-style: ground to the horizon + far hill ring")
    ap.add_argument("--float_sphere", action="store_true",
                    help="raise the sphere into the void (see Layout)")
    ap.add_argument("--write_masks", action="store_true",
                    help="write analytic GT object masks (per material id) "
                         "in the reference segments_{i:03d}.npz format to "
                         "<out>/masks_gt — a perfect-SAM stand-in for the "
                         "segmentation pipeline (--mask_backend precomputed "
                         "--mask_dir <out>/masks_gt --skip_camera_clustering)")
    ap.add_argument("--sparsify_sphere", type=float, default=0.0,
                    help="drop this FRACTION of the sphere's SfM points "
                         "(GT surface samples untouched) — builds the "
                         "under-sampled-object scene the segment-aware "
                         "densification A/B needs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to ray-trace (cuda unless asked otherwise)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    lay = make_layout(args.unbounded, args.float_sphere)

    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)
    sparse = os.path.join(args.out, "sparse/0")
    os.makedirs(sparse, exist_ok=True)

    cams = camera_ring(args.views)
    intr = {1: ColmapCamera(1, "PINHOLE", args.width, args.height,
                            np.array([args.focal, args.focal,
                                      args.width / 2, args.height / 2]))}
    write_cameras_text(os.path.join(sparse, "cameras.txt"), intr)

    images = {}
    for i, (R, t, eye) in enumerate(cams):
        rgb = render_view(R, eye, args.width, args.height, args.focal, lay, device=device)
        name = f"r_{i:02d}.png"
        write_png(os.path.join(args.out, "images", name), (rgb * 255).astype(np.uint8))
        images[i + 1] = ColmapImage(i + 1, rotmat2qvec(R), t, 1, name)
        if args.write_masks:
            save_masks_npz(object_masks(R, eye, args.width, args.height, args.focal, lay,
                                        device=device),
                           os.path.join(args.out, "masks_gt", f"segments_{i:03d}.npz"))
        print(f"rendered {name}")
    write_images_text(os.path.join(sparse, "images.txt"), images)

    # SfM-like sparse cloud: surface samples + noise + a few outliers
    pts, cols = sample_surface(args.sfm_points, rng, lay)
    if args.sparsify_sphere > 0.0:
        on_sphere = (np.abs(np.linalg.norm(pts - lay.sphere_c, axis=1)
                            - SPHERE_R) < 1e-6)
        drop = on_sphere & (rng.random(len(pts)) < args.sparsify_sphere)
        pts, cols = pts[~drop], cols[~drop]
        print(f"sparsified sphere: dropped {int(drop.sum())} of "
              f"{int(on_sphere.sum())} sphere SfM points")
    pts = pts + rng.normal(0, 0.004, pts.shape)
    n_out = max(1, len(pts) // 200)
    outliers = rng.uniform(-4, 4, (n_out, 3))
    pts = np.concatenate([pts, outliers])
    cols = np.concatenate([cols, rng.uniform(0, 1, (n_out, 3))])
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for j, (p, c) in enumerate(zip(pts, cols)):
            r, g, b = (np.clip(c, 0, 1) * 255).astype(int)
            f.write(f"{j} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {r} {g} {b} 0.5\n")

    # nerf-format exports so the segmentation preprocessing pipeline
    # (`python -m gaussmart_tpu_torch.semantics.pipeline -t nerf`) can run on
    # this scene: poses_bounds.npy rows = flattened 4x4 c2w + focal (the
    # 17-col layout of reference identification/camera_loader.py:61-105,
    # which assumes 1024x1024 principal point — generate with
    # --width/height 1024 when alignment matters), and sparse/0/points3D.ply.
    rows = []
    for R, t, eye in cams:
        c2w = np.eye(4)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = eye
        rows.append(np.concatenate([c2w.reshape(16), [args.focal]]))
    np.save(os.path.join(args.out, "poses_bounds.npy"),
            np.asarray(rows, np.float64))
    rgb8 = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
    write_ply(os.path.join(sparse, "points3D.ply"),
              {"x": pts[:, 0].astype(np.float32),
               "y": pts[:, 1].astype(np.float32),
               "z": pts[:, 2].astype(np.float32),
               "nx": np.zeros(len(pts), np.float32),
               "ny": np.zeros(len(pts), np.float32),
               "nz": np.zeros(len(pts), np.float32),
               "red": rgb8[:, 0], "green": rgb8[:, 1], "blue": rgb8[:, 2]})

    gt_pts, _ = sample_surface(args.gt_points, rng, lay)
    np.save(os.path.join(args.out, "gt_surface_points.npy"),
            gt_pts.astype(np.float32))
    print(f"scene written to {args.out}: {args.views} views, "
          f"{len(pts)} sfm points, {len(gt_pts)} GT surface samples")


if __name__ == "__main__":
    main()
