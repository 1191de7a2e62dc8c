"""Bad-step guard — counterpart of ``paddle_tpu/resilience/guard.py``.

One NaN/Inf loss or gradient must not poison the parameters: the finite
checks run on the device (``torch.isfinite`` of the loss and of the
gradient global norm), and the update is committed through
``torch.where`` on that flag, so a bad step leaves the parameters, the
optimizer slots, the step counter and the layer state bit for bit as they
were.  The reference selects with ``lax.cond``; the port's optimizer
updates in place, so it selects each write.  Nothing here reads a device
value back: the trainer reads the skip flag once, after the whole step is
queued, as the reference does.

``--amp``'s dynamic loss scaling (``init_loss_scale``,
``scaled_guarded_update``) folds into the same selection: the scale state
is two device scalars, and its update is decided on the device too.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

__all__ = ["global_grad_norm", "guarded_update", "init_loss_scale",
           "scaled_guarded_update"]


def global_grad_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient, accumulated in float32 in sorted-name
    order (the reference's leaf order)."""
    names = sorted(grads)
    if not names:
        return torch.zeros((), dtype=torch.float32)
    total = grads[names[0]].float().square().sum()
    for k in names[1:]:
        total = total + grads[k].float().square().sum()
    return torch.sqrt(total)


def guarded_update(update_fn: Callable[[torch.Tensor], None], *,
                   loss: torch.Tensor, grads: Mapping[str, torch.Tensor],
                   new_state: Dict[str, Any], old_state: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Run ``update_fn(finite)``, which must commit the optimizer step
    where ``finite`` (a bool scalar on the device) is True and hold every
    value where it is False (``Optimizer.update(where=finite)``).  Returns
    ``(selected layer state, extras)``; extras holds device scalars:
    ``grad_norm`` and ``bad_step`` (1 when the update was skipped)."""
    gnorm = global_grad_norm(grads)
    finite = torch.isfinite(loss.detach()) & torch.isfinite(gnorm)
    update_fn(finite)
    sel_state = {k: (torch.where(finite, v, old_state[k])
                     if k in old_state and torch.is_tensor(v) else v)
                 for k, v in new_state.items()}
    return sel_state, {"grad_norm": gnorm,
                       "bad_step": (~finite).to(torch.int32)}


def init_loss_scale(scale: float, *,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Fresh loss-scale state: the scale (float32) and the count of
    consecutive finite steps the growth schedule runs on (int32), on
    ``device``.  The trainer keeps it in ``opt_state["amp"]``, so it rides
    checkpoints in the reference's format and a resumed ``--amp`` run
    continues the exact scale trajectory."""
    return {"scale": torch.tensor(float(scale), dtype=torch.float32,
                                  device=device),
            "good_steps": torch.zeros((), dtype=torch.int32, device=device)}


def scaled_guarded_update(
        update_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], None], *,
        loss: torch.Tensor, scaled_grads: Mapping[str, torch.Tensor],
        amp_state: Dict[str, torch.Tensor], new_state: Dict[str, Any],
        old_state: Dict[str, Any], growth_interval: int, max_scale: float,
        min_scale: float = 1.0
        ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor],
                   Dict[str, torch.Tensor]]:
    """The bad-step guard with dynamic loss scaling folded in (the
    reference's mixed-precision state machine):

    - ``scaled_grads`` are d(scale * loss)/dp.  A finite step unscales them
      (a float32 multiply by 1/scale) and ``update_fn(grads, finite)``
      commits; the good-steps count advances and, every
      ``growth_interval`` consecutive finite steps, the scale doubles
      (capped at ``max_scale``);
    - an overflow (a non-finite scaled-gradient norm, or a non-finite
      loss) holds the parameters, the slots, the step counter and the
      layer state, and halves the scale (floored at ``min_scale``).  The
      unscale factor is 0 then, so the held branch's operands stay finite.

    ``update_fn`` must commit where ``finite`` (a bool scalar on the
    device) is True and hold every value where it is False.  Returns
    ``(selected layer state, new amp state, extras)``; extras holds device
    scalars: ``grad_norm`` (unscaled; inf on overflow), ``bad_step`` (1
    only for a non-finite LOSS: the abort signal), ``amp_overflow`` (1 for
    any overflow: a rescale event that must not count toward
    ``max_bad_steps``) and ``loss_scale`` (the new scale)."""
    scale = amp_state["scale"]
    gnorm_s = global_grad_norm(scaled_grads)
    loss_finite = torch.isfinite(loss.detach())
    finite = torch.isfinite(gnorm_s) & loss_finite
    inv = torch.where(finite, 1.0 / scale, torch.zeros_like(scale))
    grads = {k: (g.float() * inv).to(g.dtype)
             for k, g in scaled_grads.items()}
    update_fn(grads, finite)
    sel_state = {k: (torch.where(finite, v, old_state[k])
                     if k in old_state and torch.is_tensor(v) else v)
                 for k, v in new_state.items()}
    good = torch.where(finite, amp_state["good_steps"] + 1,
                       torch.zeros_like(amp_state["good_steps"]))
    grow = ((good >= growth_interval) if growth_interval > 0
            else torch.zeros_like(finite))
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(scale * 2.0, max=max_scale), scale),
        torch.clamp(scale * 0.5, min=min_scale))
    new_amp = {"scale": new_scale,
               "good_steps": torch.where(grow, torch.zeros_like(good),
                                         good)}
    extras = {"grad_norm": torch.where(
                  finite, gnorm_s * inv,
                  torch.full_like(gnorm_s, float("inf"))),
              "bad_step": (~loss_finite).to(torch.int32),
              "amp_overflow": (~finite).to(torch.int32),
              "loss_scale": new_scale}
    return sel_state, new_amp, extras
