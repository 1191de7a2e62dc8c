"""Attention primitives — counterpart of ``paddle_tpu/ops/attention.py``:
Bahdanau's (``additive_attention_scores``, ``attend``) and the batched
multi-head ``dot_product_attention`` (exported as the reference exports
it; no layer of either package calls it).

Same math as the reference: scores in float32, a masked softmax filled with
``finfo.min`` and renormalised over the real positions, and compute-dtype
operands for the two contractions.  On the card both contractions run as
fixed-shape cuBLAS calls (``ops/matmul.py``: ``rows_mm``, ``batch_bmm``),
so a row's scores and context do not depend on the batch size.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.ops.matmul import batch_bmm, linear, rows_mm
from paddle_tpu_torch.ops.numerics import acc_dtype, dot_dtype, mxu_cast

__all__ = ["additive_attention_scores", "attend", "score_product",
           "context_product", "dot_product_attention"]


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
    accumulation, the result in ``dot_dtype()``.  w [B, S], values
    [B, S, D] -> [B, D]."""
    wc, vc = mxu_cast(w, values)
    ctx = batch_bmm(wc.float()[:, None, :], vc.float())[:, 0]
    # the context is an activation (the softmax before it stays float32):
    # it leaves at dot_dtype, bfloat16 under --amp
    return ctx.to(dot_dtype())


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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Batched multi-head attention: q [B, H, Tq, Dh], k/v [B, H, Tk, Dh];
    ``mask`` broadcastable to [B, H, Tq, Tk] (1 = attend).  Compute-dtype
    operands, float32 logits and softmax, returned in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = acc_dtype()
    qc, kc, vc = mxu_cast(q, k, v)
    logits = torch.matmul(qc.to(acc), kc.to(acc).transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask > 0, logits, torch.full(
            (), torch.finfo(logits.dtype).min, device=logits.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w.to(vc.dtype).float(), vc.float()).to(dot_dtype())
    return out.to(q.dtype)
