"""Self-contained PLY codec (binary-LE + ASCII), no external deps.

Replaces the reference's `plyfile` dependency. Supports the property types
used across the GauSSmart artifact surface: float32 point clouds with
uchar colors and int segment channels (dataset_readers.py:169-184), and the
48-channel float Gaussian snapshot layout (gaussian_model.py:305-342).

The port's own copy of gaussmart_tpu/io/ply.py: the port imports nothing of the JAX
package, so the codec is duplicated here and kept identical.
"""
from __future__ import annotations

import io
import os
from typing import Dict, List, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of column arrays."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    cur_props: List[Tuple[str, str]] = []
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur_props = []
            elements.append((parts[1], int(parts[2]), cur_props))
        elif parts[0] == "property":
            if parts[1] == "list":
                # variable-length rows: mark the element unreadable instead
                # of failing the whole file — a mesh PLY's face element must
                # not block reading its (earlier) vertex element
                cur_props.append((None, None))
            else:
                cur_props.append((parts[-1], _TYPES[parts[1]]))

    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, count, props in elements:
        has_list = any(p[0] is None for p in props)
        if name == "vertex" and has_list:
            raise ValueError("list properties unsupported in vertex reader")
        if fmt == "ascii":
            text = body.decode("ascii")
            rows = np.loadtxt(io.StringIO(text), max_rows=count, ndmin=2)
            if name == "vertex":
                for i, (pname, ptype) in enumerate(props):
                    out[pname] = rows[:, i].astype(ptype)
            break  # ascii multi-element unsupported (not needed)
        if has_list:
            # variable-length element (e.g. faces): rows cannot be skipped
            # with a fixed dtype; everything wanted (vertex) comes first
            break
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(p, endian + t) for p, t in props])
        n_bytes = dtype.itemsize * count
        arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
        offset += n_bytes
        if name == "vertex":
            for pname, _ in props:
                out[pname] = np.ascontiguousarray(arr[pname])
            break
    return out


def write_ply(path: str, columns: Dict[str, np.ndarray], ascii_fmt: bool = False):
    """Write a vertex-only PLY; column order preserved (dict order)."""
    names = list(columns)
    n = len(next(iter(columns.values())))
    cols = {k: np.asarray(v).reshape(n) for k, v in columns.items()}
    dtype = np.dtype([(k, "<" + cols[k].dtype.str[1:]) for k in names])

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        fmt = "ascii" if ascii_fmt else "binary_little_endian"
        lines = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
        for k in names:
            lines.append(f"property {_INV_TYPES[dtype[k].str[1:]]} {k}")
        lines.append("end_header\n")
        f.write("\n".join(lines).encode("ascii"))
        if ascii_fmt:
            mat = np.stack([cols[k].astype(np.float64) for k in names], axis=1)
            np.savetxt(f, mat, fmt="%.8g")
        else:
            rec = np.empty(n, dtype=dtype)
            for k in names:
                rec[k] = cols[k]
            f.write(rec.tobytes())


def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray,
                      segments: np.ndarray | None = None):
    """storePly parity (dataset_readers.py:169-184): xyz/normals f4, rgb u1,
    segment i4."""
    n = len(xyz)
    if segments is None:
        segments = np.zeros(n, np.int32)
    normals = np.zeros_like(xyz, dtype=np.float32)
    write_ply(path, {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
        "red": np.clip(rgb[:, 0], 0, 255).astype(np.uint8),
        "green": np.clip(rgb[:, 1], 0, 255).astype(np.uint8),
        "blue": np.clip(rgb[:, 2], 0, 255).astype(np.uint8),
        "segment": segments.astype(np.int32),
    })


def fetch_point_cloud(path: str):
    """fetchPly geometry part (dataset_readers.py:107-114); returns
    (points, colors[0..1], normals)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals
