"""Numeric policy: parameter dtype vs matmul compute dtype.

Counterpart of ``paddle_tpu/ops/numerics.py``.  Parameters and
accumulations are float32; matmul operands are cast to the compute dtype
(bfloat16 by default, ``FLAGS.compute_dtype``), with float32 accumulation.
Tests set float32 explicitly (``compute_dtype_scope``).

The hand-written backward rules (the fused GRU, the attention decoder)
multiply through ``bwd_mm``/``bwd_einsum``: float32 operands and results,
the reference's policy with ``--amp`` off.  ``--amp`` (bfloat16 matmul
outputs and bfloat16 backward operands) is not ported.
``residual_dtype(H)`` is the dtype of the GRU's saved ``z``/``h_prev``
streams (``paddle_tpu/ops/rnn_fused.py:48-58``).

``pointwise(fn, x)`` applies a transcendental elementwise op so that each
element's bits do not depend on the tensor's size on the CPU: there
PyTorch runs the vector version of ``exp``/``tanh``/``sigmoid`` over whole
vectors and a scalar version, which may round differently, over a tail,
so an element's bits would depend on where the tail falls.  It is a cost
paid only for the CPU tests, which hold slot decode equal to solo decode
bit for bit; on the card it is ``fn(x)``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.utils.flags import FLAGS

__all__ = ["compute_dtype", "acc_dtype", "dot_dtype", "mxu_cast",
           "compute_dtype_scope", "bwd_mm", "bwd_einsum", "residual_dtype",
           "pointwise"]

#: ``pointwise`` on the CPU: elements per call (below ATen's parallel
#: grain, so one thread runs each call) and the multiple every call is
#: padded to (two 16-lane vectors, ATen's unrolled vector step)
_PIECE, _LANES = 16384, 32

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
    outputs are not ported)."""
    return torch.float32


def mxu_cast(*tensors: torch.Tensor):
    """Cast floating matmul operands to the compute dtype."""
    cd = compute_dtype()
    out = tuple(t.to(cd) if t.is_floating_point() else t for t in tensors)
    return out if len(out) > 1 else out[0]


def bwd_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul of a hand-written backward rule: float32 operands, float32
    result (TF32 is off on the card, ``device.resolve_device``)."""
    return torch.matmul(a.float(), b.float())


def bwd_einsum(expr: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Weight-gradient einsum with ``bwd_mm``'s policy: float32 operands and
    result."""
    return torch.einsum(expr, a.float(), b.float())


def residual_dtype(hidden: int) -> torch.dtype:
    """Dtype of the GRU's ``z``/``h_prev`` residual streams: bfloat16 under
    the bfloat16 compute policy for H <= 512 (half the backward's residual
    traffic), float32 otherwise, as the reference chooses."""
    cd = compute_dtype()
    return cd if (cd == torch.bfloat16 and hidden <= 512) else torch.float32


@contextmanager
def compute_dtype_scope(dtype: Union[str, torch.dtype]) -> Iterator[None]:
    """Run a block under another compute dtype, restoring the old one."""
    old = FLAGS.compute_dtype
    FLAGS.compute_dtype = str(_as_dtype(dtype)).replace("torch.", "")
    try:
        yield
    finally:
        FLAGS.compute_dtype = old


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``.  On the CPU ``x`` is run through
    ``fn`` flattened, in calls of at most ``_PIECE`` elements padded to a
    multiple of ``_LANES``, so that every element takes the vector path and
    a row's result does not depend on how many rows share the tensor (the
    slot table's batch invariance).  Elsewhere it is ``fn(x)``: a CUDA
    kernel computes every element alike."""
    if x.device.type != "cpu" or not x.is_floating_point():
        return fn(x)
    flat = x.reshape(-1)
    n = flat.numel()
    outs = []
    for p0 in range(0, max(n, 1), _PIECE):
        part = flat[p0:p0 + _PIECE]
        k = part.numel()
        pad = -k % _LANES
        outs.append(fn(F.pad(part, (0, pad)) if pad else part)[:k])
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(x.shape)
