"""``paddle.v2.minibatch`` — counterpart of ``paddle_tpu/v2/minibatch.py``:
the one ``batch`` function."""

from paddle_tpu_torch.data.reader import batch  # noqa: F401

__all__ = ["batch"]
