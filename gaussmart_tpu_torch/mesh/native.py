"""ctypes loader of the native marching-tetrahedra core
(counterpart of gaussmart_tpu/mesh/native.py).

Compiles native/marching_tet.cpp with the JAX package's flags into
``build/gaussmart_tpu_torch/`` at first use, never beside the source,
through kernels.build_cxx. The library name carries a hash of the source,
the flags and the compiler's ``-march=native`` target, so an edited
source, or a checkout moved to another CPU, is rebuilt. A failed build
raises: there is no silent numpy path (mesh/marching.py's numpy body is
the plain twin, for tests).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from gaussmart_tpu_torch import kernels

SRC = Path(__file__).resolve().parents[2] / "native" / "marching_tet.cpp"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile the core unless it is built already; raise if g++ fails."""
    return kernels.build_cxx(SRC, "marching_tet")


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.mt_count.restype = ctypes.c_int64
            lib.mt_count.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float]
            lib.mt_extract.restype = ctypes.c_int64
            lib.mt_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_float,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
            _LIB = lib
        return _LIB


def marching_tetrahedra_native(volume: np.ndarray, level: float = 0.0,
                               spacing=(1.0, 1.0, 1.0),
                               origin=(0.0, 0.0, 0.0)
                               ) -> Tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    vol = np.ascontiguousarray(volume, np.float32)
    X, Y, Z = vol.shape
    vp = vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    n = lib.mt_count(vp, X, Y, Z, ctypes.c_float(level))
    if n == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    out = np.empty((n, 3, 3), np.float64)
    sp = np.ascontiguousarray(spacing, np.float64)
    og = np.ascontiguousarray(origin, np.float64)
    wrote = lib.mt_extract(
        vp, X, Y, Z, ctypes.c_float(level),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        og.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    out = out[:wrote]
    verts = out.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, faces
