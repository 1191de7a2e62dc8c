"""Utilities of the port: the settings the ported slice reads."""

from paddle_tpu_torch.utils.flags import FLAGS

__all__ = ["FLAGS"]
