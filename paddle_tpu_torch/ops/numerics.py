"""Numeric policy: parameter dtype vs matmul compute dtype.

Counterpart of ``paddle_tpu/ops/numerics.py``.  Parameters and
accumulations are float32; matmul operands are cast to the compute dtype
(bfloat16 by default, ``FLAGS.compute_dtype``), with float32 accumulation.
Tests set float32 explicitly (``compute_dtype_scope``).

``--amp`` (``FLAGS.amp``, the reference's mixed precision) makes the
policy end-to-end bfloat16: the compute dtype is bfloat16 whatever
``--compute_dtype`` says, and a matmul's output stays bfloat16
(``dot_dtype``) -- one rounding of the float32-accumulated product, so
activations and the cotangents that inherit their dtype never widen back
between products.  Parameters stay float32 (the masters), and the float32
allowlist (batch-norm statistics, softmax/logsumexp, the losses) casts up
at those sites.

The hand-written backward rules (the fused RNNs' and the attention
decoder's post-loop contractions) multiply through ``bwd_mm``/
``bwd_einsum``: float32 operands, or bfloat16-rounded ones under
``--amp``, and a float32 result either way.  The reference's Pallas
kernels keep float32 carries and float32 products whatever ``--amp`` says
(their callers cast at the boundary), and so do the port's kernels; their
plain versions run inside ``float32_products()``, where ``dot_dtype()`` is
float32 and ``bwd_mm``/``bwd_einsum`` take float32 operands under either
policy, so a kernel and its plain version agree under ``--amp`` too.  Only
the paths without a kernel (``scan_rnn`` and its cells) follow the
reference's scan semantics under ``--amp``: bfloat16 carries and
products.
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

import threading
from contextlib import contextmanager
from typing import Iterator, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.utils.flags import FLAGS

__all__ = ["amp_enabled", "compute_dtype", "acc_dtype", "dot_dtype",
           "mxu_cast", "compute_dtype_scope", "bwd_mm", "bwd_einsum",
           "float32_products", "residual_dtype", "pointwise"]

#: ``pointwise`` on the CPU: elements per call (below ATen's parallel
#: grain, so one thread runs each call) and the multiple every call is
#: padded to (two 16-lane vectors, ATen's unrolled vector step)
_PIECE, _LANES = 16384, 32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: the nesting depth of ``float32_products()`` in this thread
_SCOPE = threading.local()


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


def amp_enabled() -> bool:
    """Whether ``--amp`` mixed-precision training is on (read at call
    time, like every switch of this policy)."""
    return bool(FLAGS.amp)


def compute_dtype() -> torch.dtype:
    """The matmul operand dtype: bfloat16 under ``--amp`` whatever
    ``--compute_dtype`` says (tests pin float32 there, and amp must still
    mean bfloat16), else ``FLAGS.compute_dtype``."""
    if amp_enabled():
        return torch.bfloat16
    return _as_dtype(FLAGS.compute_dtype)


def acc_dtype() -> torch.dtype:
    """Accumulation dtype for reductions and statistics: always float32."""
    return torch.float32


def _amp_products() -> bool:
    """``--amp`` is on and no ``float32_products()`` scope is open."""
    return amp_enabled() and not getattr(_SCOPE, "depth", 0)


@contextmanager
def float32_products() -> Iterator[None]:
    """Inside, ``dot_dtype()`` is float32 and ``bwd_mm``/``bwd_einsum``
    take float32 operands whatever ``--amp`` says; the compute dtype is
    untouched.  The kernels' plain versions run inside (used as a
    decorator), as the kernels multiply into float32.  Per thread."""
    depth = getattr(_SCOPE, "depth", 0)
    _SCOPE.depth = depth + 1
    try:
        yield
    finally:
        _SCOPE.depth = depth


def dot_dtype() -> torch.dtype:
    """Output dtype of a matmul: float32, or bfloat16 under ``--amp`` (the
    float32-accumulated product rounded once) outside
    ``float32_products()``."""
    return torch.bfloat16 if _amp_products() else acc_dtype()


def mxu_cast(*tensors: torch.Tensor):
    """Cast floating matmul operands to the compute dtype."""
    cd = compute_dtype()
    out = tuple(t.to(cd) if t.is_floating_point() else t for t in tensors)
    return out if len(out) > 1 else out[0]


def _amp_operands(a: torch.Tensor, b: torch.Tensor):
    """Float32 operands, rounded to bfloat16 first under ``--amp`` (every
    product of two bfloat16 values is exact in float32, so the float32
    product that follows is the bfloat16 x bfloat16 -> float32 one)."""
    if _amp_products():
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return a.float(), b.float()


def bwd_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul of a hand-written backward rule: float32 operands, bfloat16-
    rounded under ``--amp``; float32 result either way (TF32 is off on the
    card, ``device.resolve_device``)."""
    return torch.matmul(*_amp_operands(a, b))


def bwd_einsum(expr: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Weight-gradient einsum with ``bwd_mm``'s policy (float32 result
    either way: weight gradients accumulate wide)."""
    return torch.einsum(expr, *_amp_operands(a, b))


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
