"""The precisions a plain reference computes in.

A reference applies ``rounding(name)`` to both operands of every matrix
product and einsum, and accumulates in float32 with TF32 off:

* ``float32``: the operands as they are, the reference proper;
* ``tf32``: each operand rounded to TF32's 10 mantissa bits (to nearest),
  what a TF32 tensor-core product reads: the control of a float32 cell;
* ``fp8``: each operand scaled into float8 e4m3's range and rounded to it
  (one scale per row of the last dim), what an fp8 product reads: the
  control of a bfloat16 cell.
"""
from __future__ import annotations

from typing import Callable

import torch

FP8_MAX = 448.0


def strict_float32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "float32": _identity, "tf32": _tf32, "fp8": _fp8}


def rounding(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ROUNDINGS:
        raise ValueError(f"unknown precision {name!r}; known: "
                         f"{sorted(ROUNDINGS)}")
    return ROUNDINGS[name]
