"""``paddle.v2.data_feeder`` — counterpart of
``paddle_tpu/v2/data_feeder.py``: the ``DataFeeder`` built from slot kinds
and a feeding order."""

from paddle_tpu_torch.data.feeder import DataFeeder  # noqa: F401

__all__ = ["DataFeeder"]
