"""Numerical gradient checking — counterpart of
``paddle_tpu/trainer/checkgrad.py`` (``paddle_trainer --job=checkgrad``).

Reference: Trainer::checkGradient perturbs each parameter and compares
finite differences against backward() gradients (paddle/trainer/
Trainer.cpp checkGradient; --checkgrad_eps paddle/utils/Flags.cpp:61).
The check guards the hand-written backward rules of the kernels and the
masked-sequence semantics: it samples a few coordinates per parameter
(the reference's sampling: one ``RandomState(seed)``, ``samples_per_param``
coordinates per parameter in the parameters' order), perturbs each in
float64 and rounds the perturbed value to the parameter's dtype, as the
reference does.  Gradients come from ``torch.autograd.grad``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import logger

__all__ = ["check_gradients"]


def check_gradients(loss_fn: Callable[[Dict[str, torch.Tensor]],
                                      torch.Tensor],
                    params: Dict[str, torch.Tensor], *,
                    eps: Optional[float] = None, samples_per_param: int = 3,
                    rtol: float = 5e-2, atol: float = 1e-3, seed: int = 0
                    ) -> Dict[str, float]:
    """Compare ``torch.autograd.grad(loss_fn)`` to central finite
    differences at randomly sampled coordinates.  Returns {param_name:
    max_abs_err}; raises ``AssertionError`` on a failure."""
    eps = eps or FLAGS.checkgrad_eps
    rng = np.random.RandomState(seed)
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = loss_fn(leaves)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                 allow_unused=True)))
    report: Dict[str, float] = {}
    with torch.no_grad():
        for name, p in params.items():
            p_np = p.detach().cpu().double().numpy()
            g = grads[name]
            g_np = (np.zeros_like(p_np) if g is None
                    else g.detach().cpu().double().numpy())
            worst = 0.0
            for _ in range(samples_per_param):
                idx = (tuple(rng.randint(0, d) for d in p_np.shape)
                       if p_np.shape else ())
                delta = np.zeros_like(p_np)
                if idx == ():
                    delta = np.float64(eps)
                else:
                    delta[idx] = eps

                def at(arr):
                    return torch.from_numpy(np.asarray(arr)).to(
                        device=p.device, dtype=p.dtype)

                fd = (float(loss_fn({**params, name: at(p_np + delta)}))
                      - float(loss_fn({**params, name: at(p_np - delta)}))
                      ) / (2 * eps)
                an = float(g_np[idx]) if idx != () else float(g_np)
                err = abs(fd - an)
                if err > atol + rtol * max(abs(fd), abs(an)):
                    raise AssertionError(
                        f"gradient check failed for {name}{list(idx)}: "
                        f"analytic={an:.6g} fd={fd:.6g} err={err:.3g}")
                worst = max(worst, err)
            report[name] = worst
    logger.info("checkgrad passed for %d parameters", len(report))
    return report
