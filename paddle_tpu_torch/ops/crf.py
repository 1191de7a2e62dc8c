"""Linear-chain CRF — counterpart of ``paddle_tpu/ops/crf.py``: the
log-alpha recursion, ``crf_log_likelihood``, ``crf_nll`` and Viterbi
``crf_decode`` with backpointers, over padded [B, T, C] emissions with a
mask.  Weights: start transitions a [C], end transitions b [C], pairwise
w [C, C].

All in float32 log-space, as the reference's ``lax.scan``: the time loop
is a Python loop over T, batched over B; a masked step carries the
previous alpha (or delta) through, so each row stops at its own length.
Viterbi takes the first maximal index (``torch.argmax``, as
``jnp.argmax``) over candidates in the reference's order, a padded step
keeps an identity backpointer, and decoded tags are 0 on padding.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["crf_log_likelihood", "crf_nll", "crf_decode"]


def _scan_alpha(emissions: torch.Tensor, mask: torch.Tensor,
                start: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """The final log-alpha [B, C], at each row's last real step."""
    alpha = start[None, :] + emissions[:, 0]
    for t in range(1, emissions.shape[1]):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1)
        keep = mask[:, t, None] > 0
        alpha = torch.where(keep, nxt + emissions[:, t], alpha)
    return alpha


def crf_log_likelihood(emissions: torch.Tensor, tags: torch.Tensor,
                       mask: torch.Tensor, start: torch.Tensor,
                       end: torch.Tensor, trans: torch.Tensor
                       ) -> torch.Tensor:
    """Per-sequence log P(tags | emissions): emissions [B, T, C] (cast to
    float32), tags int [B, T], mask [B, T] -> [B]."""
    emissions = emissions.float()
    tags = tags.to(torch.long)
    m = mask.float()
    emit = torch.gather(emissions, -1, tags[..., None])[..., 0]
    score = (emit * m).sum(1) + start[tags[:, 0]]
    pair_m = m[:, 1:] * m[:, :-1]
    score = score + (trans[tags[:, :-1], tags[:, 1:]] * pair_m).sum(1)
    lengths = m.sum(1).to(torch.long)
    last = torch.gather(tags, 1, torch.clamp(lengths - 1, min=0)[:, None])
    score = score + end[last[:, 0]]
    alpha = _scan_alpha(emissions, m, start, trans)
    return score - torch.logsumexp(alpha + end[None, :], dim=-1)


def crf_nll(emissions: torch.Tensor, tags: torch.Tensor, mask: torch.Tensor,
            start: torch.Tensor, end: torch.Tensor,
            trans: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the batch."""
    return -crf_log_likelihood(emissions, tags, mask, start, end,
                               trans).mean()


def crf_decode(emissions: torch.Tensor, mask: torch.Tensor,
               start: torch.Tensor, end: torch.Tensor, trans: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi decode -> (best tags [B, T] int32, 0 on padding; best score
    [B])."""
    emissions = emissions.float()
    B, T, C = emissions.shape
    m = mask.float()
    ident = torch.arange(C, device=emissions.device)[None, :].expand(B, C)
    delta = start[None, :] + emissions[:, 0]
    bps = []
    for t in range(1, T):
        cand = delta[:, :, None] + trans[None]           # [B, prev, next]
        best, best_prev = cand.amax(dim=1), torch.argmax(cand, dim=1)
        keep = m[:, t, None] > 0
        delta = torch.where(keep, best + emissions[:, t], delta)
        bps.append(torch.where(keep, best_prev, ident))
    final = delta + end[None, :]
    best_score = final.max(-1).values
    tag = torch.argmax(final, dim=-1)
    out = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        out.append(tag)
    tags = torch.stack(out[::-1], 1)
    return (tags * m.to(tags.dtype)).to(torch.int32), best_score
