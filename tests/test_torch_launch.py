"""kernels.launch's signature table against the C prototypes in csrc/*.cu:
a wrong count or type there would corrupt memory on the card without an
error, and the CPU tests never launch. Without JAX, so it also runs where
none is installed."""
import ctypes
import re

import pytest
import torch

from gaussmart_tpu_torch import kernels

ENTRIES = ["raster_fwd", "raster_fwd_seeded", "raster_bwd", "raster_bwd_seeded", "segsum",
           "preprocess_fwd", "bin_count", "bin_emit", "bin_finish"]


def _prototype(source, entry):
    """The parameter types of `extern "C" int <entry>(...)` in
    csrc/<source>.cu, the file's PARAMS macro expanded, as ctypes types."""
    text = (kernels.CSRC / f"{source}.cu").read_text()
    macro = re.search(r"#define PARAMS((?:[^\n]*\\\n)*[^\n]*)", text)
    if macro:
        text = text.replace("PARAMS)", macro.group(1).replace("\\\n", " ") + ")")
    found = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert found, f'no extern "C" int {entry}(...) in csrc/{source}.cu'
    types = []
    for param in found.group(1).split(","):
        decl = param.rsplit(None, 1)[0] if "*" not in param else "*"
        types.append({"*": ctypes.c_void_p, "int": ctypes.c_int,
                      "long long": ctypes.c_longlong, "float": ctypes.c_float}[decl.strip()])
    return types


@pytest.mark.parametrize("entry", ENTRIES)
def test_signature_matches_the_c_prototype(entry):
    """The table's parameter count and each type equal the prototype's,
    the stream (a pointer) last."""
    source, types = kernels.SIGNATURES[entry]
    assert list(types) == _prototype(source, entry)
    assert types[-1] is ctypes.c_void_p


def test_launch_off_cuda_raises_without_loading(monkeypatch):
    """A non-CUDA device raises before any library is built or loaded."""
    def no_build(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_entries", {})
    with pytest.raises(ValueError, match="segsum launches on a CUDA device"):
        kernels.launch("segsum", torch.device("cpu"), 0)
    assert kernels._libs == {} and kernels._entries == {}
