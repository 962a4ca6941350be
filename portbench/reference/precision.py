"""The matrix products of the reference, in float32 or one precision below.

The configurations state float32 with TF32 off. Their control runs the
reference with every matrix product's inputs rounded to TF32 (10 mantissa
bits, round to nearest even) and accumulated in float32, as a TF32 tensor
core does; the rounding passes gradients straight through. Written out so
that the control reads the same on any device."""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


def tf32_matmul(a, b):
    return torch.matmul(round_tf32(a), round_tf32(b))


MATMUL = {"float32": torch.matmul, "tf32": tf32_matmul}
