"""Optimizers — counterpart of ``paddle_tpu/param/optimizers.py`` for the
training slice: the ``Optimizer`` base (constant learning rate, global-norm
gradient clipping, L2/L1 decay applied to the gradient) and ``Adam``.

State has the reference's shape, ``{"step": int32 scalar tensor, "slots":
{name: per-parameter slot tuple}}``.  ``update`` runs under
``torch.no_grad()`` and advances the step counter and writes each parameter
and its slots IN PLACE (the returned dicts are the caller's): the reference
returns new arrays, and on the card the in-place update saves a copy of
every parameter and moment between steps.  Parameters that require grad stay
leaves that require grad, so the next step's ``torch.autograd.grad`` runs
on the same tensors.

Not ported here: learning-rate schedules other than constant, the
per-parameter ``lr_scales``/``decays``/``statics`` of the nn DSL's
ParamSpecs (no caller yet), ``clip=False``, the fused multi-tensor apply
(``fused=``), row-sparse updates (``sparse_rows=``), ``row_apply``, and the
other optimizers (SGD, Momentum, AdaGrad, AdaDelta, RMSProp,
DecayedAdaGrad, AdaMax) and ``ParameterAverager``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

__all__ = ["Optimizer", "Adam", "clip_by_global_norm"]

Params = Dict[str, torch.Tensor]


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global L2 norm) -> (new
    grads, the norm).  Squares are summed leaf by leaf in sorted-name order
    (the reference's leaf order)."""
    names = sorted(grads)
    sq = [grads[k].float().square().sum() for k in names]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: grads[k] * scale for k in grads}, gnorm


def _regularize(p: torch.Tensor, g: torch.Tensor, decay: float,
                l1: float) -> torch.Tensor:
    """L2 ``decay`` and L1 ``l1`` added to the gradient (the reference's
    Regularizer analog)."""
    if decay:
        g = g + decay * p
    if l1:
        g = g + l1 * torch.sign(p)
    return g


@dataclass
class Optimizer:
    """Base: learning rate, gradient clipping and weight decay.  Subclasses
    give the per-parameter rule (``init_leaf``, ``update_leaf``)."""

    learning_rate: float = 0.01
    gradient_clipping_threshold: float = 0.0   # 0 = off; global-norm clip
    l2_rate: float = 0.0
    l1_rate: float = 0.0

    def init_leaf(self, p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return ()

    def update_leaf(self, p: torch.Tensor, g: torch.Tensor, slots: Tuple,
                    lr: float, step: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """-> (new parameter, new slots) for one parameter."""
        raise NotImplementedError

    def init_state(self, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
        return {"step": torch.zeros((), dtype=torch.int32),
                "slots": {k: self.init_leaf(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Mapping[str, torch.Tensor],
               opt_state: Dict[str, Any]) -> Tuple[Params, Dict[str, Any]]:
        """One step, in place: global-norm clipping (when set), L2/L1
        decay, then the rule, for every parameter.  The step counter, the
        parameters and the slots all advance in place, so a caller may drop
        the returned pair (it holds the same ``params`` and ``opt_state``)."""
        step = opt_state["step"]
        step.add_(1)
        if self.gradient_clipping_threshold > 0:
            grads, _ = clip_by_global_norm(grads,
                                           self.gradient_clipping_threshold)
        for k, p in params.items():
            slots = opt_state["slots"][k]
            p2, s2 = self.update_leaf(
                p, _regularize(p, grads[k], self.l2_rate, self.l1_rate),
                slots, self.learning_rate, step)
            p.copy_(p2)
            for old, new in zip(slots, s2):
                old.copy_(new)
        return params, opt_state


@dataclass
class Adam(Optimizer):
    """Adam with bias correction (the reference's ``Adam``: float32 moment
    arithmetic; ``slot_dtype``, e.g. "bfloat16", stores the moments at
    reduced width and widens them for each step's arithmetic)."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    slot_dtype: Optional[str] = None

    def init_leaf(self, p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dt = getattr(torch, self.slot_dtype) if self.slot_dtype else p.dtype
        return (torch.zeros(p.shape, dtype=dt, device=p.device),
                torch.zeros(p.shape, dtype=dt, device=p.device))

    def update_leaf(self, p, g, slots, lr, step):
        m, v = slots
        g = g.float()
        m2 = self.beta1 * m.float() + (1 - self.beta1) * g
        v2 = self.beta2 * v.float() + (1 - self.beta2) * g.square()
        # bias corrections as float32 scalars, as the reference computes
        # them (a CPU scalar tensor combines with tensors on any device)
        t = step.to(torch.float32)
        bc1 = 1 - torch.tensor(self.beta1, dtype=torch.float32).pow(t)
        bc2 = 1 - torch.tensor(self.beta2, dtype=torch.float32).pow(t)
        mhat = m2 / bc1
        vhat = v2 / bc2
        p2 = p - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return p2.to(p.dtype), (m2.to(m.dtype), v2.to(v.dtype))
