"""Dense matmul ops with the compute-dtype policy.

Counterpart of ``paddle_tpu/ops/matmul.py``.  Operands are rounded to the
compute dtype and the product accumulates in float32.  PyTorch has no
bfloat16 x bfloat16 -> float32 matmul, so the rounded operands are widened
back to float32 first: every product of two bfloat16 values is exact in
float32, which makes this the reference's ``preferred_element_type=f32``
product.  These matmuls sit outside any kernel of the reference, so
``torch.matmul`` serves them (TF32 is off, ``device.resolve_device``).

Batch invariance on the card.  cuBLAS picks its GEMM kernel (tile shape,
split of the k sum) by the problem's shape, so a row's float32 bits depend
on how many rows share the call; under bfloat16 operand rounding one
last-bit difference can move a later operand by a bf16 ulp and flip a
near-tie beam.  The reference promises that a request served through the
slot table decodes exactly as it would alone.  So on CUDA every product
whose row (or batch) count depends on the traffic runs as a sequence of
cuBLAS calls of ONE fixed shape: the rows are cut into chunks of
``ROW_CHUNK`` (``VECTOR_ROW_CHUNK`` for a single-column right operand;
batched products: ``BATCH_CHUNK`` matrices) and the last chunk is
zero-padded.  A row then meets the same kernel whatever else shares the
call.  A chunk may depend on the product's widths, never on its row count.
Chunk sizes, from both paths' shapes: 384 rows divide the serving table's
192 rows once (padded 2x, the price the serve path pays on each
traffic-dependent product of a table step) and the training shapes
exactly (the decoder's 384 rows a loop step; 12288 = 32 x 384 for the
time-batched products, which then take 32 calls).  The score product is a
matrix-vector product, cheap per row, so it takes 6144 rows a call: the
table's 192 x 32 rows in one call, the training batch's 12288 in two,
instead of 12 calls a decoder step.  The batched attention context
product takes 64 matrices a call: 192 and 384 are whole multiples.
``chip_probe.py chunks`` times the serve and training paths under each
setting; 384 and 1024 rows could not be told apart end to end there, 192
rows slowed training, and the 6144-row score chunk sped both paths up
(``PERF.md``).  The CPU's GEMM is not batch-invariant either (a row's
bits at 1, 3 or 7 rows differ from the same row among 12 for [*, 8] x
[8, 24]), so on the CPU the row products run as calls of at most
``CPU_ROW_CHUNK`` rows, each padded to a multiple of ``CPU_ROW_PAD``
rows.  That is a cost paid only for the CPU tests, which hold slot decode
equal to solo decode bit for bit: a 3-row product does 8 rows' work.
Products with batched right operands stay one call there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.numerics import dot_dtype, mxu_cast

__all__ = ["matmul", "linear", "rows_mm", "batch_bmm", "ROW_CHUNK",
           "VECTOR_ROW_CHUNK", "BATCH_CHUNK", "CPU_ROW_CHUNK", "CPU_ROW_PAD"]

#: rows of one cuBLAS call on the card (``rows_mm``)
ROW_CHUNK = 384
#: rows of one call when the right operand is a single column (the attention
#: score product, B*S rows of a matrix-vector product)
VECTOR_ROW_CHUNK = 6144
#: matrices of one batched cuBLAS call on the card (``batch_bmm``)
BATCH_CHUNK = 64
#: the most rows of one call on the CPU (``rows_mm``), and the multiple
#: each call's rows are padded to: a row's bits there are the same in every
#: call of 8 to 64 rows that is a multiple of 8 (PyTorch 2.13's CPU GEMM)
CPU_ROW_CHUNK, CPU_ROW_PAD = 64, 8


def _chunked(fn, a: torch.Tensor, chunk: int, *rest: torch.Tensor
             ) -> torch.Tensor:
    """``fn(a_chunk, *rest_chunks)`` over fixed-size chunks of the leading
    axis of ``a`` (and of each tensor in ``rest``), the last chunk
    zero-padded; the results are concatenated without the padding."""
    n = a.shape[0]
    outs = []
    for r0 in range(0, max(n, 1), chunk):
        parts = [t[r0:r0 + chunk].contiguous() for t in (a, *rest)]
        k = parts[0].shape[0]
        if k < chunk:
            parts = [F.pad(p, (0,) * (2 * (p.dim() - 1)) + (0, chunk - k))
                     for p in parts]
        outs.append(fn(*parts)[:k])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def rows_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] in calls whose shape does not depend on M (on
    CUDA ``ROW_CHUNK`` rows, ``VECTOR_ROW_CHUNK`` when N = 1; on the CPU
    M rounded up to ``CPU_ROW_PAD``, at most ``CPU_ROW_CHUNK``), so row i
    of the result does not depend on M."""
    if a.device.type == "cuda":
        chunk = VECTOR_ROW_CHUNK if b.shape[-1] == 1 else ROW_CHUNK
    else:
        chunk = min(CPU_ROW_CHUNK, max(1, -(-a.shape[0] // CPU_ROW_PAD))
                    * CPU_ROW_PAD)
    return _chunked(lambda x: torch.matmul(x, b), a, chunk)


def batch_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [Bt, M, K] @ b [Bt, K, N] batched; on CUDA as ``BATCH_CHUNK``-matrix
    calls of one shape, so matrix i of the result does not depend on Bt."""
    if a.device.type != "cuda":
        return torch.matmul(a, b)
    return _chunked(torch.bmm, a, BATCH_CHUNK, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, float32 accumulation.  a [..., K] against a
    matrix b [K, N] (leading dims of a are rows), or batch dims
    broadcast on the CPU."""
    a, b = mxu_cast(a, b)
    acc = dot_dtype()
    a, b = a.to(acc), b.to(acc)
    if a.device.type != "cuda" and b.dim() != 2:
        return torch.matmul(a, b)
    if b.dim() != 2:
        raise ValueError(f"matmul on the card takes a [K, N] matrix, got "
                         f"{tuple(b.shape)}")
    out = rows_mm(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) over the last axis; any leading batch/time dims."""
    y = matmul(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
