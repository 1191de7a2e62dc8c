"""paddle_tpu_torch.param — optimizers, schedules, clipping, parameter
averaging and the pruning hook (counterpart of ``paddle_tpu/param``), and
``params_from_jax``, which carries a JAX parameter dict across for every
model of the port."""

from paddle_tpu_torch.param.convert import params_from_jax
from paddle_tpu_torch.param.hooks import (StaticPruningHook, apply_masks,
                                          build_masks)
from paddle_tpu_torch.param.optimizers import (LR_SCHEDULES, OPTIMIZERS, SGD,
                                               AdaDelta, AdaGrad, Adam,
                                               AdaMax, DecayedAdaGrad,
                                               Momentum, Optimizer,
                                               ParameterAverager, RMSProp,
                                               clip_by_global_norm,
                                               clip_by_value, lr_schedule)

__all__ = ["Optimizer", "SGD", "Momentum", "AdaGrad", "AdaDelta", "RMSProp",
           "DecayedAdaGrad", "Adam", "AdaMax", "OPTIMIZERS", "LR_SCHEDULES",
           "lr_schedule", "clip_by_global_norm", "clip_by_value",
           "ParameterAverager", "StaticPruningHook", "build_masks",
           "apply_masks", "params_from_jax"]
