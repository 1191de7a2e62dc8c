"""paddle_tpu_torch.param — optimizers (counterpart of
``paddle_tpu/param``) and ``params_from_jax``, which carries a JAX parameter
dict across for every model of the port."""

from paddle_tpu_torch.param.convert import params_from_jax
from paddle_tpu_torch.param.optimizers import (Adam, Optimizer,
                                               clip_by_global_norm)

__all__ = ["Adam", "Optimizer", "clip_by_global_norm", "params_from_jax"]
