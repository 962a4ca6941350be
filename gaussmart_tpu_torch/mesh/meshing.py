"""Triangle-mesh container + post-processing (no open3d/trimesh deps);
counterpart of gaussmart_tpu/mesh/meshing.py, numpy and scipy, the same
PLY bytes.

Covers the mesh-side capabilities the reference gets from open3d/trimesh:
PLY export/import with faces, vertex merging, and the keep-N-largest-
clusters floater filter (mesh_utils.py:22-43).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray                   # [V,3] f64/f32
    faces: np.ndarray                      # [F,3] int
    vertex_colors: Optional[np.ndarray] = None  # [V,3] float in [0,1]

    def merge_vertices(self, digits: int = 6) -> "TriMesh":
        """Weld duplicate vertices (rounded to `digits` decimals)."""
        key = np.round(self.vertices, digits)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        verts = self.vertices[first]
        cols = self.vertex_colors[first] if self.vertex_colors is not None else None
        faces = inverse[self.faces]
        # drop degenerate faces
        good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                & (faces[:, 0] != faces[:, 2]))
        return TriMesh(verts, faces[good], cols)

    def remove_unreferenced(self) -> "TriMesh":
        used = np.unique(self.faces)
        remap = np.full(len(self.vertices), -1, np.int64)
        remap[used] = np.arange(len(used))
        cols = self.vertex_colors[used] if self.vertex_colors is not None else None
        return TriMesh(self.vertices[used], remap[self.faces], cols)

    def connected_triangle_clusters(self):
        """Label faces by vertex-connected components; returns
        (labels [F], cluster_sizes)."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        V = len(self.vertices)
        e = np.concatenate([self.faces[:, [0, 1]], self.faces[:, [1, 2]],
                            self.faces[:, [2, 0]]])
        g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(V, V))
        _, vlabel = connected_components(g, directed=False)
        flabel = vlabel[self.faces[:, 0]]
        sizes = np.bincount(flabel, minlength=vlabel.max() + 1)
        return flabel, sizes


def post_process_mesh(mesh: TriMesh, cluster_to_keep: int = 1000) -> TriMesh:
    """Drop small disconnected clusters (mesh_utils.py:22-43): keep clusters
    with at least max(size_of_kth_largest, 50) triangles."""
    if len(mesh.faces) == 0:
        return mesh
    labels, sizes = mesh.connected_triangle_clusters()
    k = min(cluster_to_keep, len(sizes))
    n_cluster = np.sort(sizes)[-k]
    n_cluster = max(n_cluster, 50)
    keep = sizes[labels] >= n_cluster
    out = TriMesh(mesh.vertices, mesh.faces[keep], mesh.vertex_colors)
    out = out.remove_unreferenced()
    print(f"num vertices raw {len(mesh.vertices)}")
    print(f"num vertices post {len(out.vertices)}")
    return out


def save_mesh_ply(path: str, mesh: TriMesh):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    v = np.asarray(mesh.vertices, np.float32)
    f = np.asarray(mesh.faces, np.int32)
    has_color = mesh.vertex_colors is not None
    with open(path, "wb") as fh:
        lines = ["ply", "format binary_little_endian 1.0",
                 f"element vertex {len(v)}",
                 "property float x", "property float y", "property float z"]
        if has_color:
            lines += ["property uchar red", "property uchar green",
                      "property uchar blue"]
        lines += [f"element face {len(f)}",
                  "property list uchar int vertex_indices", "end_header\n"]
        fh.write("\n".join(lines).encode("ascii"))
        if has_color:
            c = np.clip(np.asarray(mesh.vertex_colors) * 255, 0, 255).astype(np.uint8)
            rec = np.empty(len(v), dtype=[("x", "<f4"), ("y", "<f4"),
                                          ("z", "<f4"), ("r", "u1"),
                                          ("g", "u1"), ("b", "u1")])
            rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
            rec["r"], rec["g"], rec["b"] = c[:, 0], c[:, 1], c[:, 2]
        else:
            rec = np.empty(len(v), dtype=[("x", "<f4"), ("y", "<f4"),
                                          ("z", "<f4")])
            rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
        fh.write(rec.tobytes())
        frec = np.empty(len(f), dtype=[("n", "u1"), ("a", "<i4"),
                                       ("b", "<i4"), ("c", "<i4")])
        frec["n"] = 3
        frec["a"], frec["b"], frec["c"] = f[:, 0], f[:, 1], f[:, 2]
        fh.write(frec.tobytes())


def load_mesh_ply(path: str) -> TriMesh:
    with open(path, "rb") as fh:
        data = fh.read()
    hend = data.find(b"end_header\n")
    header = data[:hend].decode("ascii").splitlines()
    body = data[hend + len(b"end_header\n"):]
    n_v = n_f = 0
    v_props = []
    cur = None
    for line in header:
        p = line.split()
        if not p:
            continue
        if p[0] == "element":
            cur = p[1]
            if p[1] == "vertex":
                n_v = int(p[2])
            elif p[1] == "face":
                n_f = int(p[2])
        elif p[0] == "property" and cur == "vertex" and p[1] != "list":
            v_props.append((p[2], {"float": "<f4", "float32": "<f4",
                                   "double": "<f8", "float64": "<f8",
                                   "uchar": "u1", "uint8": "u1",
                                   "char": "i1", "short": "<i2",
                                   "ushort": "<u2", "int": "<i4",
                                   "int32": "<i4", "uint": "<u4",
                                   "uint32": "<u4"}[p[1]]))
    vdt = np.dtype(v_props)
    varr = np.frombuffer(body, dtype=vdt, count=n_v)
    off = vdt.itemsize * n_v
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    farr = np.frombuffer(body, dtype=fdt, count=n_f, offset=off)
    verts = np.stack([varr["x"], varr["y"], varr["z"]], axis=1).astype(np.float64)
    cols = None
    if "red" in vdt.names:
        cols = np.stack([varr["red"], varr["green"], varr["blue"]],
                        axis=1).astype(np.float64) / 255.0
    return TriMesh(verts, farr["idx"].astype(np.int64), cols)
