"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exports plain C entry points (SIGNATURES)
that launch a kernel on the stream they are given, their last argument,
and return ``cudaGetLastError()``. ``launch`` is the one way in: it
compiles the entry's source with nvcc for Hopper (sm_90a) into a shared
library under ``build/gaussmart_tpu_torch/`` at first use, loads it with
ctypes and calls the entry on a device's current stream; the library name
carries a hash of the source, the headers beside it (csrc/*.cuh) and the
flags, so an edited source or header is rebuilt.
Nothing is built or loaded at import time, and nothing here runs for CPU
tensors.

The host libraries (the marching-tetrahedra core, the image codec
``csrc/imagecodec.cpp``) are built by g++ through ``build_cxx`` into the
same directory; their names hash the source, the flags and the compiler's
``-march=native`` target, and a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
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

# host C++ libraries (ctypes, no Python headers)
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# entry point -> (its source csrc/<source>.cu, the parameter types of its C
# prototype in order: pointers (None is NULL), int, long long, float; the
# stream last). tests/test_torch_launch.py holds each to its prototype.
SIGNATURES = {
    "raster_fwd": ("raster_fwd", (_P,) * 4 + (_I,) * 2 + (_P,) * 3),
    "raster_fwd_seeded": ("raster_fwd", (_P,) * 5 + (_I,) * 2 + (_P,) * 3),
    "raster_bwd": ("raster_bwd", (_P,) * 6 + (_I,) * 4 + (_P,) * 2),
    "raster_bwd_seeded": ("raster_bwd", (_P,) * 7 + (_I,) * 4 + (_P,) * 3),
    "segsum": ("segsum", (_P,) * 5 + (_I,) * 2 + (_P,) * 2),
    "preprocess_fwd": ("preprocess", (_I,) + (_P,) * 8 + (_I,) * 2 + (_P,) + (_I,) * 2
                       + (_P,) + (_I,) * 4 + (_F,) + (_P,) * 5),
    "preprocess_grad_fwd": ("preprocess_grad", (_I,) + (_P,) * 9 + (_I,) * 2 + (_P,)
                            + (_I,) * 2 + (_P,) + (_I,) * 4 + (_F,) + (_P,) * 5),
    "preprocess_bwd": ("preprocess_grad", (_I,) + (_P,) * 8 + (_I,) * 2 + (_P,) + (_I,) * 2
                       + (_P,) * 2 + (_I,) * 4 + (_F,) + (_P,) * 8),
    "bin_count": ("binning", (_P, _I) + (_P,) * 4 + (_I,) * 3 + (_P,) * 4),
    "bin_emit": ("binning", (_P, _I) + (_P,) * 4 + (_I,) * 3 + (_P,) * 6),
    "bin_finish": ("binning", (_P,) * 4 + (_L,) * 2 + (_I,) * 2 + (_P,) * 5),
}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, ctypes._CFuncPtr] = {}


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


def bind(lib: ctypes.CDLL, entry: str) -> ctypes._CFuncPtr:
    """`lib`'s C entry point `entry` with its SIGNATURES argument types and
    an int result."""
    fn = getattr(lib, entry)
    fn.argtypes = list(SIGNATURES[entry][1])
    fn.restype = ctypes.c_int
    return fn


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` (SIGNATURES) with `args` and the
    current stream of the CUDA `device`, inside its device guard; raise
    RuntimeError if it returns a CUDA error. Its library is built and
    loaded at the first launch; other devices raise before anything is.
    torch is imported here, not with the module, which io/jpeg.py and
    io/images.py import without torch."""
    import torch
    if device.type != "cuda":
        raise ValueError(f"{entry} launches on a CUDA device, not {device}")
    fn = _entries.get(entry)
    if fn is None:
        source = SIGNATURES[entry][0]
        lib = _libs.get(source)
        if lib is None:
            build(source)
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        fn = _entries[entry] = bind(lib, entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {err}")


def _run_cxx(cmd, src: Path):
    try:
        return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build {src.name}: {cmd[0]} not found") from e


@functools.lru_cache(maxsize=None)
def _cxx_target(src: Path) -> str:
    return _run_cxx(["g++", "-march=native", "-Q", "--help=target"], src).stdout


def cxx_library_path(src: Path, stem: str) -> Path:
    """Where g++'s build of `src` lives: lib<stem>-<hash>.so, the hash over
    the source, the flags and the target `-march=native` resolves to."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _cxx_target(src).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def build_cxx(src: Path, stem: str) -> Path:
    """Compile a host C++ source with g++ unless it is built already;
    raise if g++ fails. Returns the library's path."""
    out = cxx_library_path(src, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = _run_cxx(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)], src)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out


def check_tensors(tensors, device):
    """Raise unless each (name, tensor, dtype, ndim) is a contiguous
    tensor of that type and rank on `device`."""
    for name, x, dtype, ndim in tensors:
        if x.device != device or x.dtype != dtype or x.dim() != ndim \
                or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {ndim}-d {dtype} tensor "
                             f"on {device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
