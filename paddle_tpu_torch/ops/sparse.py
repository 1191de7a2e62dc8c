"""Sparse-input compute — counterpart of ``paddle_tpu/ops/sparse.py``.

The on-device format is the reference's padded COO rows (ELL): per sample
a fixed-width id vector [B, N], a weight vector [B, N] and a validity mask
[B, N], N bucketed by the feeder as sequence lengths are.  A sparse x dense
product is then a row gather of the dense operand and a weighted sum over
N; its gradient into the dense operand is the gather's transpose, a dense
scatter-add that touches only the gathered rows, which is what the
optimizer's row-sparse update (``sparse_rows``) then keeps to those rows.

Every product here takes compute-dtype operands (``mxu_cast``), widened to
float32 and summed there (the product of two bfloat16 values is exact in
float32, and a row's sum does not depend on how many rows share the call),
and its result is rounded to the compute dtype and widened again, as the
reference's ``jnp.einsum`` of compute-dtype operands returns that dtype
before its ``astype(acc_dtype())``.
The gathers are ``F.embedding``, whose backward sums each id's rows in a
fixed order on the card.  ``CsrMatrix`` and ``CscMatrix`` are the
reference's host-side numpy containers, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.numerics import acc_dtype, mxu_cast

__all__ = ["sparse_gather_matmul", "sparse_to_dense",
           "selective_columns_matmul", "CsrMatrix", "CscMatrix",
           "csr_matmul", "matmul_dense_csc"]


def _dot(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``(a * b).sum(dim)`` (``b`` broadcast against ``a``) on compute-dtype
    operands, summed in float32, the result rounded to the compute dtype
    and returned in float32."""
    a, b = mxu_cast(a, b.to(a.dtype))
    cd, acc = a.dtype, acc_dtype()
    return (a.to(acc) * b.to(acc)).sum(dim).to(cd).to(acc)


def sparse_gather_matmul(ids: torch.Tensor, weights: torch.Tensor,
                         mask: torch.Tensor, w: torch.Tensor,
                         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Padded-sparse [..., N] x dense [V, D] -> [..., D]:
    ``out[b] = sum_n weights[b, n] * mask[b, n] * w[ids[b, n]]``.  Padding
    slots may carry any in-range id: only ``weights * mask`` zeroes them.
    Duplicate ids add up.  Leading dims are free (a sparse sequence passes
    ids [B, T, N] and gets [B, T, D])."""
    rows = F.embedding(ids.to(torch.long), w)          # [..., N, D]
    out = _dot(rows, (weights * mask).unsqueeze(-1), -2)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def sparse_to_dense(ids: torch.Tensor, weights: torch.Tensor,
                    mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Padded-sparse rows [B, N] -> dense [B, dim]; duplicate ids add up,
    as in COO."""
    B, N = ids.shape
    coef = (weights * mask).to(acc_dtype())
    rows = torch.arange(B, device=ids.device)[:, None].expand(B, N)
    out = torch.zeros((B, dim), dtype=acc_dtype(), device=ids.device)
    return out.index_put((rows.reshape(-1), ids.reshape(-1).to(torch.long)),
                         coef.reshape(-1), accumulate=True)


def selective_columns_matmul(x: torch.Tensor, sel_ids: torch.Tensor,
                             w: torch.Tensor,
                             b: Optional[torch.Tensor] = None,
                             sel_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Only the selected output columns: x [B, Din] against w [Din, V]
    gathered at sel_ids [B, C] -> [B, C] (column j scores candidate
    ``sel_ids[b, j]``), + the bias gathered the same way, times
    ``sel_mask`` where given."""
    cols = F.embedding(sel_ids.to(torch.long), w.t())   # [B, C, Din]
    out = _dot(cols, x[:, None, :], -1)
    if b is not None:
        out = out + b[sel_ids.to(torch.long)].to(out.dtype)
    if sel_mask is not None:
        out = out * sel_mask.to(out.dtype)
    return out


# ---------------------------------------------------------------------------
# CSR / CSC matrices
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CsrMatrix:
    """Compressed-sparse-row matrix on the host: numpy ``indptr`` [R+1],
    ``indices`` [nnz], ``data`` [nnz] (``data=None``: binary, all ones).
    Compute re-lays it out as padded rows (``to_padded``)."""

    shape: tuple
    indptr: np.ndarray
    indices: np.ndarray
    data: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @classmethod
    def from_rows(cls, rows: Sequence, ncols: int, *, binary: bool = False):
        """From per-row entries: id lists (binary) or (id, value) pairs."""
        indptr = np.zeros(len(rows) + 1, np.int64)
        ids, vals = [], []
        for i, row in enumerate(rows):
            row = list(row)
            indptr[i + 1] = indptr[i] + len(row)
            if binary:
                ids.extend(int(j) for j in row)
            else:
                for j, v in row:
                    ids.append(int(j))
                    vals.append(float(v))
        indices = np.asarray(ids, np.int32)
        data = None if binary else np.asarray(vals, np.float32)
        return cls((len(rows), ncols), indptr, indices, data)

    @classmethod
    def from_dense(cls, a) -> "CsrMatrix":
        a = np.asarray(a)
        mask = a != 0
        indptr = np.zeros(a.shape[0] + 1, np.int64)
        np.cumsum(mask.sum(1), out=indptr[1:])
        indices = np.nonzero(mask)[1].astype(np.int32)
        return cls(a.shape, indptr, indices, a[mask].astype(np.float32))

    def _values(self) -> np.ndarray:
        return (self.data if self.data is not None
                else np.ones(self.nnz, np.float32))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, np.float32)
        vals = self._values()
        for i in range(self.shape[0]):
            lo, hi = self.indptr[i], self.indptr[i + 1]
            np.add.at(out[i], self.indices[lo:hi], vals[lo:hi])
        return out

    def to_padded(self, width: Optional[int] = None):
        """-> (ids [R, N] int32, weights [R, N], mask [R, N]) numpy arrays.
        N defaults to the largest row's nnz (at least 1); a ``width`` below
        it raises ``ValueError`` (truncating would change the product)."""
        counts = np.diff(self.indptr)
        max_nnz = int(counts.max(initial=0))
        if width is not None and width < max_nnz:
            raise ValueError(
                f"to_padded(width={width}) would drop entries: a row has "
                f"{max_nnz} nonzeros")
        N = int(width or max(max_nnz, 1))
        R = self.shape[0]
        ids = np.zeros((R, N), np.int32)
        weights = np.zeros((R, N), np.float32)
        mask = np.zeros((R, N), np.float32)
        vals = self._values()
        for i in range(R):
            lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
            n = min(hi - lo, N)
            ids[i, :n] = self.indices[lo:lo + n]
            weights[i, :n] = vals[lo:lo + n]
            mask[i, :n] = 1.0
        return ids, weights, mask

    def transpose(self) -> "CscMatrix":
        """The CSR of M is the CSC of M^T: a view change."""
        return CscMatrix((self.shape[1], self.shape[0]), self.indptr,
                         self.indices, self.data)

    @property
    def T(self) -> "CscMatrix":
        return self.transpose()


@dataclass(frozen=True)
class CscMatrix:
    """Compressed-sparse-column matrix: ``indptr`` [C+1] over columns,
    ``indices`` row ids; stored as the CSR of its transpose."""

    shape: tuple
    indptr: np.ndarray
    indices: np.ndarray
    data: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @classmethod
    def from_dense(cls, a) -> "CscMatrix":
        return CsrMatrix.from_dense(np.asarray(a).T).transpose()

    def to_dense(self) -> np.ndarray:
        return self.to_csr_of_transpose().to_dense().T

    def to_csr_of_transpose(self) -> CsrMatrix:
        return CsrMatrix((self.shape[1], self.shape[0]), self.indptr,
                         self.indices, self.data)

    def transpose(self) -> CsrMatrix:
        return self.to_csr_of_transpose()

    @property
    def T(self) -> CsrMatrix:
        return self.transpose()


def csr_matmul(m: CsrMatrix, dense: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSR [R, C] x dense [C, D] -> [R, D] on ``dense``'s device: the
    padded re-layout on the host once, then ``sparse_gather_matmul``."""
    ids, weights, mask = (torch.from_numpy(a).to(dense.device)
                          for a in m.to_padded())
    return sparse_gather_matmul(ids, weights, mask, dense, b)


def matmul_dense_csc(x: torch.Tensor, m: CscMatrix,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dense x [B, R] x CSC [R, C] -> [B, C]:
    ``out[:, j] = sum_n w[j, n] * x[:, row_ids[j, n]]``."""
    ids, weights, mask = m.to_csr_of_transpose().to_padded()
    ids = torch.from_numpy(ids).to(x.device).to(torch.long)
    coef = torch.from_numpy(weights * mask).to(x.device)
    out = _dot(x[:, ids], coef, -1)                     # [B, C, N] -> [B, C]
    if b is not None:
        out = out + b.to(out.dtype)
    return out
