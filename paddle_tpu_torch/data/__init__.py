"""Data helpers of the port (the reference's ``paddle_tpu/data``)."""

from paddle_tpu_torch.data.feeder import bucket_length

__all__ = ["bucket_length"]
