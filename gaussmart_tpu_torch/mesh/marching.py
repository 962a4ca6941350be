"""Isosurface extraction: vectorized marching tetrahedra + a blockwise pass
(counterpart of gaussmart_tpu/mesh/marching.py, the same numpy body).

Replaces the reference's skimage `measure.marching_cubes` + trimesh merge
(utils/mcube_utils.py:17-95) with a dependency-free, fully vectorized
marching-tetrahedra pass: each grid cell is split into 6 tetrahedra along
the main diagonal; the 2^4 sign cases reduce to three templates (1-inside
triangle, 2-inside quad, 3-inside flipped triangle) whose edge
interpolations are emitted with numpy fancy indexing — no per-cell Python
loop. Produces a watertight isosurface equivalent to marching cubes (about
2x triangle count), which is what the Chamfer/F-score evaluation consumes.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from gaussmart_tpu_torch.mesh.meshing import TriMesh

# Kuhn/Freudenthal 6-tetrahedra cube decomposition around the 0-7 diagonal:
# one tet per bit-insertion order 0 -> 7. Cube corners indexed bit-wise:
# corner c = (x=c&1, y=(c>>1)&1, z=(c>>2)&1).
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
], dtype=np.int64)

_CORNER_OFFSETS = np.array(
    [[(c & 1), ((c >> 1) & 1), ((c >> 2) & 1)] for c in range(8)],
    dtype=np.int64)


def _interp(p_a, p_b, f_a, f_b, level):
    t = (level - f_a) / np.where(np.abs(f_b - f_a) < 1e-30, 1e-30, f_b - f_a)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return p_a + t * (p_b - p_a)


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        origin: Sequence[float] = (0.0, 0.0, 0.0),
                        use_native: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of a [X,Y,Z] scalar grid.

    Returns (vertices [V,3], faces [F,3]); vertices in world units
    (origin + index*spacing). Vertices are NOT welded (use
    TriMesh.merge_vertices). Runs the C++ core (mesh/native.py), built at
    first use; a failed build raises. The numpy body below is its plain
    twin, run only with use_native=False.
    """
    if use_native:
        from gaussmart_tpu_torch.mesh import native
        return native.marching_tetrahedra_native(volume, level, spacing, origin)
    X, Y, Z = volume.shape
    f = volume

    # corner values per cell, per tet corner — build index grids lazily
    xs = np.arange(X - 1)
    ys = np.arange(Y - 1)
    zs = np.arange(Z - 1)
    cx, cy, cz = np.meshgrid(xs, ys, zs, indexing="ij")
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # [C,3]
    n_cells = base.shape[0]

    verts_out = []
    spacing = np.asarray(spacing, np.float64)
    origin = np.asarray(origin, np.float64)

    for tet in _TETS:
        idx = base[:, None, :] + _CORNER_OFFSETS[tet][None, :, :]   # [C,4,3]
        vals = f[idx[..., 0], idx[..., 1], idx[..., 2]]             # [C,4]
        inside = vals < level                                       # [C,4]
        code = (inside * (1 << np.arange(4))).sum(axis=1)           # [C]
        active = (code > 0) & (code < 15)
        if not active.any():
            continue
        idx = idx[active]
        vals = vals[active]
        code = code[active]
        pos = origin + idx * spacing                                # [A,4,3]

        for c in range(1, 15):
            m = code == c
            if not m.any():
                continue
            p = pos[m]
            v = vals[m]
            ins = [i for i in range(4) if (c >> i) & 1]
            outs = [i for i in range(4) if not (c >> i) & 1]
            if len(ins) == 1:
                a = ins[0]
                e = [_interp(p[:, a], p[:, o], v[:, a], v[:, o], level)
                     for o in outs]
                verts_out.append(np.stack(e, axis=1))               # [M,3,3]
            elif len(ins) == 3:
                a = outs[0]
                e = [_interp(p[:, i], p[:, a], v[:, i], v[:, a], level)
                     for i in ins]
                verts_out.append(np.stack(e, axis=1))
            else:  # two inside -> quad -> two triangles
                a, b = ins
                c0, d0 = outs
                e_ac = _interp(p[:, a], p[:, c0], v[:, a], v[:, c0], level)
                e_ad = _interp(p[:, a], p[:, d0], v[:, a], v[:, d0], level)
                e_bc = _interp(p[:, b], p[:, c0], v[:, b], v[:, c0], level)
                e_bd = _interp(p[:, b], p[:, d0], v[:, b], v[:, d0], level)
                verts_out.append(np.stack([e_ac, e_ad, e_bd], axis=1))
                verts_out.append(np.stack([e_ac, e_bd, e_bc], axis=1))

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tris = np.concatenate(verts_out, axis=0)                        # [T,3,3]
    # drop triangles that touched unobserved (NaN) corners
    tris = tris[np.isfinite(tris).all(axis=(1, 2))]
    verts = tris.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, faces


def marching_cubes_with_contraction(
    sdf: Callable[[np.ndarray], np.ndarray],
    resolution: int = 512,
    bounding_box_min=(-1.0, -1.0, -1.0),
    bounding_box_max=(1.0, 1.0, 1.0),
    level: float = 0.0,
    inv_contraction: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    max_range: float = 32.0,
    block: int = 128,
) -> TriMesh:
    """Blockwise isosurface over a chunked SDF evaluation with optional
    inverse scene contraction of the output vertices (mcube_utils.py:17-95
    contract; block size adapted to host memory)."""
    assert resolution % block == 0
    N = resolution // block
    gmin = np.asarray(bounding_box_min, np.float64)
    gmax = np.asarray(bounding_box_max, np.float64)
    edges = [np.linspace(gmin[d], gmax[d], N + 1) for d in range(3)]

    meshes = []
    for i in range(N):
        for j in range(N):
            for k in range(N):
                lo = np.array([edges[0][i], edges[1][j], edges[2][k]])
                hi = np.array([edges[0][i + 1], edges[1][j + 1],
                               edges[2][k + 1]])
                axes = [np.linspace(lo[d], hi[d], block) for d in range(3)]
                xx, yy, zz = np.meshgrid(*axes, indexing="ij")
                pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
                z = np.asarray(sdf(pts.astype(np.float32))).reshape(
                    block, block, block)
                if z.min() > level or z.max() < level:
                    continue
                spacing = (hi - lo) / (block - 1)
                v, f = marching_tetrahedra(z.astype(np.float64), level,
                                           spacing=spacing, origin=lo)
                if len(v):
                    meshes.append(TriMesh(v, f))

    if not meshes:
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    verts = np.concatenate([m.vertices for m in meshes])
    offs = np.cumsum([0] + [len(m.vertices) for m in meshes[:-1]])
    faces = np.concatenate([m.faces + o for m, o in zip(meshes, offs)])
    mesh = TriMesh(verts, faces).merge_vertices(digits=6)

    if inv_contraction is not None:
        mesh.vertices = np.clip(inv_contraction(mesh.vertices),
                                -max_range, max_range)
    return mesh
