"""paddle_tpu_torch.param — optimizers (counterpart of
``paddle_tpu/param``)."""

from paddle_tpu_torch.param.optimizers import (Adam, Optimizer,
                                               clip_by_global_norm)

__all__ = ["Adam", "Optimizer", "clip_by_global_norm"]
