"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` exporting a plain C function
``<name>`` that launches it on the stream it is given and returns
``cudaGetLastError()``. Sources are compiled with nvcc for Hopper
(sm_90a) into a shared library under ``build/gaussmart_tpu_torch/`` at
first use and loaded with ctypes; the library name carries a hash of the
source and flags, so an edited source is rebuilt. Nothing is built or
loaded at import time, and nothing here runs for CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gaussmart_tpu_torch"
# -fmad=false: no multiply-add contraction, so each kernel rounds exactly
# as its plain PyTorch version (one rounding per operation) and the two
# agree to the bit; -Xptxas -v reports registers and shared memory.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless it is built already. Returns nvcc's
    report (ptxas register and shared-memory use), empty when nothing was
    compiled."""
    out = library_path(name)
    if out.exists():
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return proc.stdout


def load(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of csrc/<name>.cu, building it first if
    needed. Every pointer and the stream are ``c_void_p`` in ``argtypes``."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return getattr(lib, name)
