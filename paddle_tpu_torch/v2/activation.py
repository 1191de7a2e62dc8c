"""Activation objects — counterpart of ``paddle_tpu/v2/activation.py``
(the reference's trainer_config_helpers/activations.py):
``act=paddle.activation.Softmax()``.  Each instance stringifies to the
layer DSL's activation name."""

__all__ = ["Linear", "Relu", "Sigmoid", "Softmax", "Tanh", "STanh", "BRelu",
           "SquareActivation", "Exp", "Log", "Abs", "SequenceSoftmax"]


class _Act(str):
    def __new__(cls):
        return str.__new__(cls, cls.name)


def _make(name_):
    return type(name_.capitalize(), (_Act,), {"name": name_})


Linear = _make("linear")
Relu = _make("relu")
Sigmoid = _make("sigmoid")
Softmax = _make("softmax")
Tanh = _make("tanh")
STanh = _make("stanh")
BRelu = _make("brelu")
SquareActivation = _make("square")
Exp = _make("exponential")
Log = _make("log")
Abs = _make("abs")
SequenceSoftmax = _make("sequence_softmax")
