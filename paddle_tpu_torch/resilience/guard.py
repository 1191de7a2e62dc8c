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

Not ported here: ``init_loss_scale`` and ``scaled_guarded_update`` come
with ``--amp`` (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

__all__ = ["global_grad_norm", "guarded_update"]


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
