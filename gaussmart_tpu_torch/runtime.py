"""Process-level setup shared by the port's entry points."""
from __future__ import annotations

import torch


def setup():
    """Keep float32 matmuls and convolutions in full float32.

    TF32 keeps 10 mantissa bits. The splat->pixel projection in
    render/raster_common.preprocess multiplies camera matrices by
    image-sized coordinates, so at that precision projected centres move
    by a visible fraction of a pixel, which corrupts geometry and parity
    with the JAX package. The products are tiny, so full float32 costs
    nothing that matters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is
    none raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
