"""Losses — counterpart of ``paddle_tpu/ops/losses.py``: the cost family
(``cross_entropy``, ``soft_cross_entropy``, ``binary_cross_entropy``,
``multi_binary_label_cross_entropy``, ``mse``, ``huber``, ``smooth_l1``,
``rank_cost``), ``sequence_cross_entropy``, ``masked_token_mean`` and
``sequence_softmax_ce_readout``.

Every loss runs in float32 on float32 copies of its inputs, as the
reference's ``_f32`` does.  ``cross_entropy`` takes a float32 log-softmax
of the logits and gathers the label's entry (never log of probabilities);
the binary ones are the stable log-sigmoid form.

``sequence_softmax_ce_readout`` is the fused vocab readout + token
cross-entropy with the reference's TILED semantics (``:231-284``): the
``ce_readout_fwd`` kernel (K1) takes each row's logsumexp and label logit
from the float32 logits and keeps the logits in the compute dtype as the
backward's residual; the backward scales each row by
``d * mask / max(sum(mask), 1)`` and the ``ce_readout_bwd`` kernel (K2)
returns ``d_states``, ``d_w`` and ``d_b`` without storing ``d_logits``.
On the CPU both kernels run their plain versions.

With the module switch ``_USE_LSE_READOUT`` on (the reference's
``_USE_PALLAS_LSE_READOUT``, ``:122-195``; off by default as there) it
takes the logsumexp readout instead (``_CEReadoutLSE``): the logits are
built once in the compute dtype by a plain product (``_readout_logits``),
the ``logsumexp_rows`` kernel (K12) reads them once for each row's
statistics, and the backward materialises ``d_logits`` in the compute
dtype and takes two products.  The reference's ``gcd(B*T, 64) < 8``
fallback to an XLA reduction is a TPU sublane rule and is not ported: K12
takes any row count.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels.ce_readout import (ce_readout_bwd,
                                                     ce_readout_fwd)
from paddle_tpu_torch.ops.kernels.logsumexp import logsumexp_rows
from paddle_tpu_torch.ops.matmul import matmul
from paddle_tpu_torch.ops.numerics import bwd_einsum, compute_dtype, mxu_cast

__all__ = ["cross_entropy", "soft_cross_entropy", "binary_cross_entropy",
           "multi_binary_label_cross_entropy", "mse", "huber", "smooth_l1",
           "rank_cost", "sequence_cross_entropy", "masked_token_mean",
           "sequence_softmax_ce_readout"]


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.is_floating_point() else x


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-class CE from logits [..., C] and integer labels [...] ->
    per-example losses [...] (float32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lab = labels.to(torch.long).unsqueeze(-1)
    return -torch.gather(logp, -1, lab).squeeze(-1)


def soft_cross_entropy(logits: torch.Tensor,
                       target_probs: torch.Tensor) -> torch.Tensor:
    """CE against a target distribution: -sum(p * log_softmax(logits))."""
    logp = torch.log_softmax(_f32(logits), dim=-1)
    return -(_f32(target_probs) * logp).sum(-1)


def binary_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits, the stable log-sigmoid form."""
    logits, labels = _f32(logits), _f32(labels)
    z = torch.nn.functional.logsigmoid(logits)
    zneg = torch.nn.functional.logsigmoid(-logits)
    return -(labels * z + (1.0 - labels) * zneg)


def multi_binary_label_cross_entropy(logits: torch.Tensor,
                                     label_matrix: torch.Tensor
                                     ) -> torch.Tensor:
    """Independent BCE per class, summed over the classes."""
    return binary_cross_entropy(logits, label_matrix).sum(-1)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * sum of squares over the last axis."""
    return 0.5 * torch.square(_f32(pred) - _f32(target)).sum(-1)


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """Huber loss summed over the last axis: quadratic within ``delta``,
    linear beyond."""
    d = _f32(pred) - _f32(target)
    a = torch.abs(d)
    quad = 0.5 * torch.square(d)
    lin = delta * (a - 0.5 * delta)
    return torch.where(a <= delta, quad, lin).sum(-1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return huber(pred, target, delta=1.0)


def rank_cost(score_left: torch.Tensor, score_right: torch.Tensor,
              label: torch.Tensor, weight=None) -> torch.Tensor:
    """Pairwise rank cost: BCE of sigmoid(left - right) against the label
    in [0, 1], optionally weighted."""
    cost = binary_cross_entropy(score_left - score_right, label)
    if weight is not None:
        cost = cost * weight
    return cost


def masked_token_mean(per_token: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Mean over the real (mask > 0) positions — the sequence-cost
    reduction."""
    mask = mask.to(per_token.dtype)
    return (per_token * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sequence_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Token-level CE over a padded [B, T, C] batch, averaged over the real
    tokens."""
    return masked_token_mean(cross_entropy(logits, labels), mask)


class _CEReadout(torch.autograd.Function):
    """(states [B, T, D], w [D, V], b [V], labels, mask) -> scalar loss."""

    @staticmethod
    def forward(ctx, states, w, b, labels, mask):
        B, T, D = states.shape
        sc, wc = mxu_cast(states.reshape(B * T, D), w)
        lab = labels.reshape(B * T)
        per_tok, lse, logits = ce_readout_fwd(sc.contiguous(),
                                              wc.contiguous(), b, lab)
        loss = masked_token_mean(per_tok.reshape(B, T), mask)
        # the compute-dtype w is rebuilt in the backward rather than kept
        # alive across the step (the reference saves the primal w too)
        ctx.save_for_backward(sc, w, lab, lse, logits, mask)
        ctx.dtypes = (states.dtype, w.dtype, b.dtype)
        ctx.shape = (B, T, D)
        return loss

    @staticmethod
    def backward(ctx, d):
        sc, w, lab, lse, logits, mask = ctx.saved_tensors
        s_dt, w_dt, b_dt = ctx.dtypes
        B, T, D = ctx.shape
        mask_f = mask.float()
        scale = (d * mask_f / torch.clamp(mask_f.sum(), min=1.0)).reshape(-1)
        d_states, d_w, d_b = ce_readout_bwd(
            logits, sc, mxu_cast(w).contiguous(), lab, lse, scale)
        return (d_states.reshape(B, T, D).to(s_dt), d_w.to(w_dt),
                d_b.to(b_dt), None, None)


def _readout_logits(states: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """states [..., D] @ w [D, V] + b -> logits [..., V] in the compute
    dtype, as the reference's ``_readout_logits``: the product of
    compute-dtype operands accumulates in float32 and is rounded once to the
    compute dtype, and the bias is added in that dtype."""
    logits = matmul(states, w).to(compute_dtype())
    return logits + b.to(logits.dtype)


#: the logsumexp readout (``_CEReadoutLSE``, K12) in place of the tiled
#: K1/K2 pair; the reference's ``_USE_PALLAS_LSE_READOUT``, off as there
_USE_LSE_READOUT = False


class _CEReadoutLSE(torch.autograd.Function):
    """(states [B, T, D], w [D, V], b [V], labels, mask) -> scalar loss
    through materialised logits and the one-pass row logsumexp (K12)."""

    @staticmethod
    def forward(ctx, states, w, b, labels, mask):
        B, T, _ = states.shape
        logits = _readout_logits(states, w, b)              # [B, T, V]
        V = logits.shape[-1]
        lse = logsumexp_rows(logits.reshape(B * T, V)).reshape(B, T)
        lab = labels.long().unsqueeze(-1)
        tok = torch.gather(logits, -1, lab).squeeze(-1).float()
        loss = masked_token_mean(lse - tok, mask)
        ctx.save_for_backward(states, w, logits, lse, lab, mask)
        ctx.b_dtype = b.dtype
        return loss

    @staticmethod
    def backward(ctx, d):
        states, w, logits, lse, lab, mask = ctx.saved_tensors
        mask_f = mask.float()
        scale = d * mask_f / torch.clamp(mask_f.sum(), min=1.0)  # [B, T]
        # d_logits = (softmax - onehot) * scale, materialised once in the
        # compute dtype; the softmax is recomputed from the logits and lse
        # (in place on one float32 buffer)
        p = logits.float().sub_(lse[..., None]).exp_().mul_(scale[..., None])
        d_logits = p.to(logits.dtype)
        del p
        upd = (torch.gather(d_logits, -1, lab)
               - scale[..., None].to(d_logits.dtype))
        d_logits.scatter_(-1, lab, upd)
        dl_c, w_c, s_c = mxu_cast(d_logits, w, states)
        d_states = bwd_einsum("btv,dv->btd", dl_c, w_c)
        d_w = bwd_einsum("btd,btv->dv", s_c, dl_c)
        d_b = d_logits.sum(dim=(0, 1), dtype=torch.float32)
        return (d_states.to(states.dtype), d_w.to(w.dtype),
                d_b.to(ctx.b_dtype), None, None)


def sequence_softmax_ce_readout(states: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor, labels: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Fused vocab readout + token CE: states [B, T, D] x w [D, V] + b [V]
    against labels [B, T] int, averaged over mask [B, T] -> scalar loss
    (float32).  The [B*T, V] logits exist once, in the compute dtype; the
    float32 logits and ``d_logits`` never reach device memory.  With
    ``_USE_LSE_READOUT`` the logsumexp readout runs instead (K12)."""
    if _USE_LSE_READOUT:
        return _CEReadoutLSE.apply(states, w, b, labels, mask)
    return _CEReadout.apply(states, w, b, labels, mask)
