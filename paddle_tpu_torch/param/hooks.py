"""Parameter updater hooks — counterpart of ``paddle_tpu/param/hooks.py``
(the reference's ParameterUpdaterHook).

The only shipped hook is ``StaticPruningHook``: a keep-mask built once from
the weight magnitudes (keep the largest ``1 - sparsity_ratio`` fraction)
and re-applied after every update
(paddle/parameter/ParameterUpdaterHook.cpp:36-78).  Masks are tensors on
the parameters' device; ``SGDTrainer`` multiplies them in after each
update, before the bad-step guard's selection.  Configured per parameter
with ``ParamAttr(pruning_ratio=...)``.
"""

from __future__ import annotations

from typing import Dict

import torch

from paddle_tpu_torch.utils.registry import Registry

__all__ = ["PARAM_HOOKS", "StaticPruningHook", "build_masks", "apply_masks"]

PARAM_HOOKS: Registry = Registry("param_hook")


@PARAM_HOOKS.register("pruning")
class StaticPruningHook:
    """Magnitude pruning: zero the smallest ``sparsity_ratio`` fraction of
    a parameter (mask fixed from the weights present at hook creation)."""

    def __init__(self, sparsity_ratio: float = 0.6):
        if not 0.0 <= sparsity_ratio < 1.0:
            raise ValueError(
                f"sparsity_ratio must be in [0, 1), got {sparsity_ratio}")
        self.sparsity_ratio = sparsity_ratio

    @torch.no_grad()
    def init_mask(self, value: torch.Tensor) -> torch.Tensor:
        mag = value.detach().abs().reshape(-1).float()
        k = int(round(mag.numel() * self.sparsity_ratio))
        if k <= 0:
            return torch.ones(value.shape, dtype=value.dtype,
                              device=value.device)
        # prune exactly k entries: a stable sort breaks magnitude ties by
        # position, as the reference's argsort does
        order = torch.argsort(mag, stable=True)
        mask = torch.ones(mag.numel(), dtype=value.dtype, device=value.device)
        mask[order[:k]] = 0
        return mask.reshape(value.shape)

    def apply(self, p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return p * mask


def build_masks(params: Dict[str, torch.Tensor],
                pruning_ratios: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Masks for every parameter with a nonzero pruning ratio."""
    return {name: StaticPruningHook(ratio).init_mask(params[name])
            for name, ratio in pruning_ratios.items() if ratio}


def apply_masks(params: Dict[str, torch.Tensor],
                masks: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if not masks:
        return params
    return {k: (p * masks[k] if k in masks else p)
            for k, p in params.items()}
