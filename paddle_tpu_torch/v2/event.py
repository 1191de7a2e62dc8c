"""``paddle.v2.event`` — counterpart of ``paddle_tpu/v2/event.py``: the
trainer's events under the reference's names."""

from paddle_tpu_torch.trainer.events import (  # noqa: F401
    BeginIteration,
    BeginPass,
    EndIteration,
    EndPass,
    TestResult,
)

__all__ = ["BeginIteration", "BeginPass", "EndIteration", "EndPass",
           "TestResult"]
