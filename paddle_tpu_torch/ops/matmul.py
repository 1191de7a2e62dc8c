"""Dense matmul ops with the compute-dtype policy.

Counterpart of ``paddle_tpu/ops/matmul.py``.  Operands are rounded to the
compute dtype and the product accumulates in float32.  PyTorch has no
bfloat16 x bfloat16 -> float32 matmul, so the rounded operands are widened
back to float32 first: every product of two bfloat16 values is exact in
float32, which makes this the reference's ``preferred_element_type=f32``
product.  These matmuls sit outside any kernel of the reference, so
``torch.matmul`` serves them (TF32 is off, ``device.resolve_device``).
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.ops.numerics import dot_dtype, mxu_cast

__all__ = ["matmul", "linear"]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, float32 accumulation, batch dims broadcast."""
    a, b = mxu_cast(a, b)
    acc = dot_dtype()
    return torch.matmul(a.to(acc), b.to(acc))


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) over the last axis; any leading batch/time dims."""
    y = matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
