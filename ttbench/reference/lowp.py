"""The precisions the plain references compute in.

``float64`` is the reference.  The controls are the precision just below
the configuration's float32: ``tf32`` (operands rounded to TF32's 10-bit
mantissa, to nearest with ties away from zero as the card's
``cvt.rna.tf32.f32``; products and sums in float32) where the program's
float32 products would run on tensor cores, ``bfloat16`` (operands rounded
to bfloat16, sums in float32) elsewhere.  The rounding is written out, so a
control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32", "bfloat16")


def compute_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (1 sign, 8 exponent, 10 mantissa
    bits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def lower(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as an operand of a product computed in ``precision``."""
    if precision == "float64":
        return x.to(torch.float64)
    if precision == "tf32":
        return round_tf32(x)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")
