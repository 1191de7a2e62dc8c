"""``paddle.v2.optimizer`` — counterpart of ``paddle_tpu/v2/optimizer.py``
(python/paddle/v2/optimizer.py over trainer_config_helpers/optimizers.py):
the reference's constructor signatures (regularization objects,
model_average, learning-rate schedules) mapped onto the port's optimizer
dataclasses (``param/optimizers.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from paddle_tpu_torch.param import optimizers as _opt

__all__ = [
    "L1Regularization", "L2Regularization", "ModelAverage",
    "Momentum", "Adam", "AdaGrad", "AdaDelta", "RMSProp", "AdaMax",
    "DecayedAdaGrad",
]


@dataclass(frozen=True)
class L1Regularization:
    rate: float


@dataclass(frozen=True)
class L2Regularization:
    rate: float


@dataclass(frozen=True)
class ModelAverage:
    average_window: float = 0.999


def _apply_common(opt, *, regularization=None, gradient_clipping_threshold=0.0,
                  learning_rate_schedule: Optional[str] = None,
                  learning_rate_decay_a: Optional[float] = None,
                  learning_rate_decay_b: Optional[float] = None):
    if isinstance(regularization, L2Regularization):
        opt.l2_rate = regularization.rate
    elif isinstance(regularization, L1Regularization):
        opt.l1_rate = regularization.rate
    if gradient_clipping_threshold:
        opt.gradient_clipping_threshold = gradient_clipping_threshold
    if learning_rate_schedule:
        opt.learning_rate_schedule = learning_rate_schedule
        args = {}
        if learning_rate_decay_a is not None:
            args["decay_a"] = learning_rate_decay_a
        if learning_rate_decay_b is not None:
            args["decay_b"] = learning_rate_decay_b
        opt.schedule_args = args
    return opt


def Momentum(momentum: float = 0.9, learning_rate: float = 0.01,
             sparse: bool = False, **kw):
    return _apply_common(
        _opt.Momentum(learning_rate=learning_rate, momentum=momentum), **kw)


def Adam(learning_rate: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, **kw):
    return _apply_common(
        _opt.Adam(learning_rate=learning_rate, beta1=beta1, beta2=beta2,
                  epsilon=epsilon), **kw)


def AdaGrad(learning_rate: float = 0.01, epsilon: float = 1e-6, **kw):
    return _apply_common(
        _opt.AdaGrad(learning_rate=learning_rate, epsilon=epsilon), **kw)


def AdaDelta(rho: float = 0.95, epsilon: float = 1e-6,
             learning_rate: float = 1.0, **kw):
    return _apply_common(
        _opt.AdaDelta(learning_rate=learning_rate, rho=rho, epsilon=epsilon),
        **kw)


def RMSProp(learning_rate: float = 0.01, rho: float = 0.95,
            epsilon: float = 1e-6, **kw):
    return _apply_common(
        _opt.RMSProp(learning_rate=learning_rate, rho=rho, epsilon=epsilon),
        **kw)


def AdaMax(learning_rate: float = 1e-3, beta1: float = 0.9,
           beta2: float = 0.999, **kw):
    return _apply_common(
        _opt.AdaMax(learning_rate=learning_rate, beta1=beta1, beta2=beta2),
        **kw)


def DecayedAdaGrad(learning_rate: float = 0.01, rho: float = 0.95,
                   epsilon: float = 1e-6, **kw):
    return _apply_common(
        _opt.DecayedAdaGrad(learning_rate=learning_rate, rho=rho,
                            epsilon=epsilon), **kw)
