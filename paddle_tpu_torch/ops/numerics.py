"""Numeric policy: parameter dtype vs matmul compute dtype.

Counterpart of ``paddle_tpu/ops/numerics.py``.  Parameters and
accumulations are float32; matmul operands are cast to the compute dtype
(bfloat16 by default, ``FLAGS.compute_dtype``), with float32 accumulation.
Tests set float32 explicitly (``compute_dtype_scope``).  ``--amp`` and the
backward policies (``bwd_mm``/``bwd_einsum``) wait for the training slice.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Union

import torch

from paddle_tpu_torch.utils.flags import FLAGS

__all__ = ["compute_dtype", "acc_dtype", "dot_dtype", "mxu_cast",
           "compute_dtype_scope"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_dtype(d: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(d, torch.dtype):
        if d not in _DTYPES.values():
            raise ValueError(f"unsupported compute dtype {d}")
        return d
    try:
        return _DTYPES[str(d)]
    except KeyError:
        raise ValueError(
            f"unsupported compute dtype {d!r} (use one of "
            f"{sorted(_DTYPES)})") from None


def compute_dtype() -> torch.dtype:
    return _as_dtype(FLAGS.compute_dtype)


def acc_dtype() -> torch.dtype:
    """Accumulation dtype for reductions and statistics: always float32."""
    return torch.float32


def dot_dtype() -> torch.dtype:
    """Output dtype of a matmul: float32 accumulation (``--amp``'s bfloat16
    outputs wait for the training slice)."""
    return torch.float32


def mxu_cast(*tensors: torch.Tensor):
    """Cast floating matmul operands to the compute dtype."""
    cd = compute_dtype()
    out = tuple(t.to(cd) if t.is_floating_point() else t for t in tensors)
    return out if len(out) > 1 else out[0]


@contextmanager
def compute_dtype_scope(dtype: Union[str, torch.dtype]) -> Iterator[None]:
    """Run a block under another compute dtype, restoring the old one."""
    old = FLAGS.compute_dtype
    FLAGS.compute_dtype = str(_as_dtype(dtype)).replace("torch.", "")
    try:
        yield
    finally:
        FLAGS.compute_dtype = old
