"""Utilities of the port: the settings the ported slices read, and the
errors of the nn DSL."""

from paddle_tpu_torch.utils.error import (ConfigError, PaddleTpuError,
                                          ShapeError, layer_scope)
from paddle_tpu_torch.utils.flags import FLAGS

__all__ = ["FLAGS", "ConfigError", "PaddleTpuError", "ShapeError",
           "layer_scope"]
