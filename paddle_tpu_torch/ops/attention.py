"""Bahdanau attention primitives — counterpart of
``paddle_tpu/ops/attention.py`` (``additive_attention_scores``, ``attend``).

Same math as the reference: scores in float32, a masked softmax filled with
``finfo.min`` and renormalised over the real positions, and compute-dtype
operands for the two contractions.  On the card both contractions run as
fixed-shape cuBLAS calls (``ops/matmul.py``: ``rows_mm``, ``batch_bmm``),
so a row's scores and context do not depend on the batch size.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddle_tpu_torch.ops.matmul import batch_bmm, linear, rows_mm
from paddle_tpu_torch.ops.numerics import acc_dtype, dot_dtype, mxu_cast

__all__ = ["additive_attention_scores", "attend", "score_product",
           "context_product"]


def score_product(pre: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('bsa,a->bs') of the compute-dtype ``pre`` [B, S, A] with
    ``v`` [A] rounded to pre's dtype, float32 accumulation."""
    acc = acc_dtype()
    vc = v.to(pre.dtype).to(acc)
    if pre.device.type != "cuda":
        return torch.matmul(pre.to(acc), vc)
    B, S, A = pre.shape
    return rows_mm(pre.to(acc).reshape(B * S, A), vc[:, None]).reshape(B, S)


def context_product(w: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """einsum('bs,bsd->bd') with compute-dtype operands, float32
    accumulation.  w [B, S], values [B, S, D] -> [B, D]."""
    wc, vc = mxu_cast(w, values)
    acc = dot_dtype()
    return batch_bmm(wc.to(acc)[:, None, :], vc.to(acc))[:, 0]


def additive_attention_scores(enc_proj: torch.Tensor, dec_state: torch.Tensor,
                              w_dec: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """tanh(enc_proj + dec_state @ w_dec) @ v.  enc_proj [B, S, A],
    dec_state [B, D], w_dec [D, A], v [A] -> [B, S] float32 scores."""
    q = linear(dec_state, w_dec)[:, None, :]
    enc_proj, q = mxu_cast(enc_proj, q)
    return score_product(torch.tanh(enc_proj + q), v)


def attend(scores: torch.Tensor, values: torch.Tensor,
           mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked softmax over S, then the weighted sum of values.
    scores [B, S], values [B, S, D], mask [B, S] -> (ctx [B, D], w [B, S])."""
    neg = torch.finfo(scores.dtype).min
    z = torch.where(mask > 0, scores, torch.full_like(scores, neg))
    w = torch.softmax(z, dim=-1) * mask.to(scores.dtype)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return context_product(w, values), w
