"""TSDF fusion in torch on the maps' device (counterpart of
gaussmart_tpu/mesh/tsdf.py).

Two modes, as in the reference's meshing paths (utils/mesh_utils.py):

 * **Bounded grid fusion** (`TSDFVolume`): projective TSDF over a dense
   uniform voxel grid (open3d `ScalableTSDFVolume.integrate`,
   mesh_utils.py:140-181). The grid is one tensor per field on the device,
   20 B/voxel, updated in place CHUNK voxels at a time, so the temporaries
   of one update stay bounded; voxel coordinates come from the flat index.

 * **Sample-based unbounded fusion** (`fuse_samples`): the fused TSDF at
   arbitrary query points with Mip-NeRF-360 contraction-adaptive
   truncation (mesh_utils.py:184-279), used by the blockwise marching pass.

Every step rounds as the JAX package's does (float32, the same order of
operations), so the CPU agrees with it and the card with the CPU: depth is
sampled at the nearest pixel, and a last-bit difference in a projected
coordinate would move that pixel.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from gaussmart_tpu_torch.cameras import CameraParams


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as the fused multiply-add that XLA
    emits wherever the JAX package adds a product: computed in float64,
    where the product of two float32s is exact and the sum is exact or
    rounded once more only at magnitudes these operands never reach, then
    rounded to float32."""
    return (a.double() * b.double() + c.double()).float()


def _project_xyz(x, y, z, full_proj: torch.Tensor):
    """Row-vector NDC projection of points given by coordinate: returns
    (ndc_x, ndc_y, z_view). The [N,4] x [4,4] product is written as
    elementwise products added in pairs, (x P0 + y P1) + (z P2 + P3), the
    order of XLA's CPU dot: a BLAS matmul adds in an order of its own,
    which differs between the CPU and the card."""
    P = full_proj

    def col(j):
        return (x * P[0, j] + y * P[1, j]) + (z * P[2, j] + P[3, j])
    w = col(3)
    safe = torch.where(w.abs() < 1e-9, _f32(1e-9, w.device), w)
    return col(0) / safe, col(1) / safe, w


def _project(points: torch.Tensor, full_proj: torch.Tensor):
    """Row-vector NDC projection: returns (ndc_xy [N,2], z_view [N])."""
    nx, ny, z = _project_xyz(points[:, 0], points[:, 1], points[:, 2], full_proj)
    return torch.stack([nx, ny], dim=1), z


def _bilinear(img: torch.Tensor, ndc: torch.Tensor) -> torch.Tensor:
    """Sample [C,H,W] at NDC coords (align_corners=True, border padding)."""
    C, H, W = img.shape
    x = (ndc[:, 0] * 0.5 + 0.5) * (W - 1)
    y = (ndc[:, 1] * 0.5 + 0.5) * (H - 1)
    x = torch.clamp(x, 0, W - 1)
    y = torch.clamp(y, 0, H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 2)
    y0 = torch.clamp(torch.floor(y), 0, H - 2)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    v00 = img[:, y0, x0]
    v01 = img[:, y0, x0 + 1]
    v10 = img[:, y0 + 1, x0]
    v11 = img[:, y0 + 1, x0 + 1]
    # v00 (1-fx)(1-fy) + v01 fx (1-fy) + v10 (1-fx) fy + v11 fx fy, each
    # add fused with its left product as XLA fuses the JAX package's
    a = _fma(v00 * (1 - fx), 1 - fy, v01 * fx * (1 - fy))
    a = _fma(v10 * (1 - fx), fy, a)
    return _fma(v11 * fx, fy, a)


def _nearest_index(nx: torch.Tensor, ny: torch.Tensor, H: int, W: int):
    """Nearest pixel (row, col) of NDC coords, rounding half to even as
    jnp.round does (open3d parity: depth must NOT be bilinearly blended —
    interpolating across a mask/silhouette boundary manufactures phantom
    depths like d/2 that pass the d>0 test and float spurious geometry in
    front of the surface)."""
    x = torch.clamp(torch.round((nx * 0.5 + 0.5) * (W - 1)), 0, W - 1).long()
    y = torch.clamp(torch.round((ny * 0.5 + 0.5) * (H - 1)), 0, H - 1).long()
    return y, x


CHUNK = 8_388_608   # voxels per inner step; bounds transient memory


def _integrate_chunk(tsdf, weight, color, base: int, dims, origin, voxel_size,
                     depth, rgb, full_proj, sdf_trunc, depth_trunc):
    """One frame of projective TSDF integration over the voxels
    [base, base + len(tsdf)) of the grid, written into the given views of
    its fields."""
    dev = tsdf.device
    idx = torch.arange(base, base + tsdf.shape[0], dtype=torch.int32, device=dev)
    dy, dz = dims[1], dims[2]
    iz = idx % dz
    iy = torch.div(idx, dz, rounding_mode="floor") % dy
    ix = torch.div(idx, dz * dy, rounding_mode="floor")
    del idx
    px, py, pz = (_fma(i, voxel_size, o) for i, o in zip((ix, iy, iz), origin))
    del ix, iy, iz
    nx, ny, z = _project_xyz(px, py, pz, full_proj)
    del px, py, pz
    in_img = (nx.abs() < 1.0) & (ny.abs() < 1.0) & (z > 0)
    row, col = _nearest_index(nx, ny, depth.shape[0], depth.shape[1])
    del nx, ny
    d = depth[row, col]
    c = rgb[:, row, col].T                                     # [M,3]
    del row, col
    valid_d = (d > 0) & (d <= depth_trunc)
    sdf = d - z
    upd = in_img & valid_d & (sdf > -sdf_trunc)
    sdf = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
    w_new = weight + upd
    safe = torch.clamp_min(w_new, 1.0)
    tsdf.copy_(torch.where(upd, _fma(tsdf, weight, sdf) / safe, tsdf))
    color.copy_(torch.where(upd[:, None],
                            _fma(color, weight[:, None], c) / safe[:, None], color))
    weight.copy_(w_new)


class TSDFVolume:
    """Dense bounded TSDF grid: tsdf (init 1), weight and colour (init 0),
    float32, on `device`."""

    def __init__(self, bounds_min, bounds_max, voxel_size: float,
                 sdf_trunc: float, max_voxels: int = None, device="cuda"):
        if max_voxels is None:
            # grid state is 20 B/voxel (tsdf+weight+rgb f32): 200M = 4 GB
            max_voxels = int(os.environ.get("GAUSSMART_TSDF_MAX_VOXELS",
                                            200_000_000))
        # the JAX package's cap: voxel coordinates come from a 32-bit flat
        # index; kept because the cap decides voxel_size and sdf_trunc
        max_voxels = min(max_voxels, 2**31 - CHUNK)
        self.device = torch.device(device)
        self.voxel_size = float(voxel_size)
        self.sdf_trunc = float(sdf_trunc)
        self.origin = np.asarray(bounds_min, np.float64)
        dims = np.ceil((np.asarray(bounds_max) - self.origin)
                       / voxel_size).astype(int) + 1
        if int(np.prod(dims)) > max_voxels:
            scale = (np.prod(dims) / max_voxels) ** (1 / 3)
            self.voxel_size *= float(scale)
            # keep the truncation band the caller asked for in VOXELS
            # (callers compute sdf_trunc = k*voxel_size; a fixed band over
            # coarser voxels thins below one voxel and punches holes)
            self.sdf_trunc *= float(scale)
            dims = np.ceil((np.asarray(bounds_max) - self.origin)
                           / self.voxel_size).astype(int) + 1
            print(f"[tsdf] grid capped: voxel_size -> {self.voxel_size:.5f} "
                  f"(sdf_trunc scaled with it -> {self.sdf_trunc:.5f})")
        self.dims = tuple(int(d) for d in dims)
        n = int(np.prod(self.dims))
        self._n = n
        self._chunks = [min(CHUNK, n - b) for b in range(0, n, CHUNK)]
        self.tsdf = torch.ones(n, dtype=torch.float32, device=self.device)
        self.weight = torch.zeros(n, dtype=torch.float32, device=self.device)
        self.color = torch.zeros((n, 3), dtype=torch.float32, device=self.device)

    def _spans(self):
        base = 0
        for c in self._chunks:
            yield base, c
            base += c

    @torch.no_grad()
    def integrate(self, depth: torch.Tensor, rgb: torch.Tensor,
                  cam: CameraParams, depth_trunc: float):
        """Fuse one view: depth [H,W] and rgb [3,H,W] on the grid's device."""
        dev = self.device
        depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=dev)
        proj = torch.as_tensor(cam.full_proj, dtype=torch.float32, device=dev)
        origin = _f32(self.origin.astype(np.float32), dev)
        voxel_size = _f32(self.voxel_size, dev)
        sdf_trunc = _f32(self.sdf_trunc, dev)
        depth_trunc = _f32(depth_trunc, dev)
        for base, c in self._spans():
            _integrate_chunk(self.tsdf[base:base + c], self.weight[base:base + c],
                             self.color[base:base + c], base, self.dims, origin,
                             voxel_size, depth, rgb, proj, sdf_trunc, depth_trunc)

    @torch.no_grad()
    def quantized(self) -> np.ndarray:
        """int8 grid on the host: sdf in [-1,1] quantized to 1/127, -128 =
        unobserved (1 B/voxel, what marching needs)."""
        q = torch.empty(self._n, dtype=torch.int8, device=self.device)
        for base, c in self._spans():
            t = self.tsdf[base:base + c]
            qc = torch.round(torch.clamp(t, -1.0, 1.0) * 127.0).to(torch.int8)
            q[base:base + c] = torch.where(self.weight[base:base + c] > 0, qc,
                                           torch.full_like(qc, -128))
        return q.cpu().numpy().reshape(self.dims)

    def extract_mesh(self):
        from gaussmart_tpu_torch.mesh.marching import marching_tetrahedra
        from gaussmart_tpu_torch.mesh.meshing import TriMesh

        q = self.quantized()
        # Unobserved voxels must not generate surface (open3d skips them):
        # mark NaN; marching drops any TET touching a NaN corner. float32
        # throughout (at the 200M-voxel cap a float64 grid is a 1.6 GB
        # transient that the native core would copy to float32 again).
        vol = np.where(q == np.int8(-128), np.float32(np.nan),
                       q.astype(np.float32) / np.float32(127.0))
        v, f = marching_tetrahedra(vol, level=0.0,
                                   spacing=(self.voxel_size,) * 3,
                                   origin=self.origin)
        mesh = TriMesh(v, f).merge_vertices(digits=6)
        if len(mesh.vertices):
            mesh.vertex_colors = self.sample_colors(mesh.vertices)
        return mesh

    @torch.no_grad()
    def sample_colors(self, verts: np.ndarray) -> np.ndarray:
        """Trilinear colour lookup at world positions: the eight corners
        added in (dx, dy, dz) order into a float32 sum, gathered on the
        grid's device."""
        g = (np.asarray(verts) - self.origin) / self.voxel_size
        g = np.clip(g, 0, np.array(self.dims) - 1.001)
        i0 = np.floor(g).astype(np.int64)
        dev = self.device
        fr = torch.as_tensor((g - i0).astype(np.float32), device=dev)
        dy, dz = self.dims[1], self.dims[2]
        flat = torch.as_tensor((i0[:, 0] * dy + i0[:, 1]) * dz + i0[:, 2], device=dev)
        out = torch.zeros((len(g), 3), dtype=torch.float32, device=dev)
        for dx in (0, 1):
            for dyy in (0, 1):
                for dzz in (0, 1):
                    wgt = ((fr[:, 0] if dx else 1 - fr[:, 0])
                           * (fr[:, 1] if dyy else 1 - fr[:, 1])
                           * (fr[:, 2] if dzz else 1 - fr[:, 2]))
                    vals = self.color[flat + ((dx * dy + dyy) * dz + dzz)]
                    out += wgt[:, None] * vals
        return out.cpu().numpy()


# ---------------------------------------------------------------------------
# unbounded (contraction) fusion at query samples
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def contract(x: torch.Tensor) -> torch.Tensor:
    mag = _norm(x)
    safe = torch.clamp_min(mag, 1e-9)
    return torch.where(mag < 1, x, (2 - 1 / safe) * (x / safe))


def uncontract(y: torch.Tensor) -> torch.Tensor:
    mag = _norm(y)
    return torch.where(mag < 1, y,
                       y / torch.clamp_min(mag, 1e-9) / torch.clamp_min(2 - mag, 1e-2))


@torch.no_grad()
def _fuse_batch(samples, depths, rgbs, full_projs, voxel_size: float, center,
                radius: float, adaptive: bool):
    """Fuse all frames at the given contracted-space samples
    (mesh_utils.py:195-243 semantics: running weighted mean starting at
    tsdf=1, weight=1), one frame after another on the device."""
    dev = samples.device
    n = samples.shape[0]
    vs = _f32(voxel_size, dev)
    if adaptive:
        mag = _norm(samples)[:, 0]
        sdf_trunc = 5 * vs * torch.ones_like(mag)
        sdf_trunc = torch.where(mag > 1,
                                sdf_trunc / (2 - torch.clamp(mag, max=1.9)), sdf_trunc)
        # uncontract(samples), whose two divisions XLA's simplifier folds
        # into one (A / B / C -> A / (B * C)) inside the JAX package's jit
        mag3 = mag[:, None]
        unc = torch.where(mag3 < 1, samples, samples / (torch.clamp_min(mag3, 1e-9)
                                                        * torch.clamp_min(2 - mag3, 1e-2)))
        world = _fma(unc, _f32(radius, dev), center)
    else:
        sdf_trunc = 5 * vs * torch.ones(n, dtype=torch.float32, device=dev)
        world = samples
    tsdf = torch.ones(n, dtype=torch.float32, device=dev)
    rgb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    weight = torch.ones(n, dtype=torch.float32, device=dev)
    for depth, rgb, fp in zip(depths, rgbs, full_projs):
        ndc, z = _project(world, fp)
        mask_proj = (ndc.abs() < 1.0).all(dim=1) & (z > 0)
        d = _bilinear(depth[None], ndc)[0]
        c = _bilinear(rgb, ndc).T
        sdf = d - z
        mask = mask_proj & (sdf > -sdf_trunc)
        sdf = torch.clamp(sdf / sdf_trunc, -1.0, 1.0)
        wp = weight + 1.0
        tsdf = torch.where(mask, _fma(tsdf, weight, sdf) / wp, tsdf)
        rgb_acc = torch.where(mask[:, None],
                              _fma(rgb_acc, weight[:, None], c) / wp[:, None], rgb_acc)
        weight = torch.where(mask, wp, weight)
    return tsdf, rgb_acc


def fuse_samples(samples: np.ndarray, depths: torch.Tensor, rgbs: torch.Tensor,
                 full_projs: torch.Tensor, voxel_size: float,
                 center: np.ndarray, radius: float,
                 adaptive: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The fused TSDF and colour at `samples` [N,3] from depths [V,H,W],
    rgbs [V,3,H,W] and full_projs [V,4,4], computed on their device."""
    dev = depths.device
    tsdf, rgb = _fuse_batch(
        torch.as_tensor(np.asarray(samples, np.float32), device=dev), depths, rgbs,
        full_projs, voxel_size, _f32(np.asarray(center, np.float32), dev), radius,
        adaptive)
    return tsdf.cpu().numpy(), rgb.cpu().numpy()
