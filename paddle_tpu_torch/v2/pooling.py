"""Pooling objects — counterpart of ``paddle_tpu/v2/pooling.py`` (the
reference's trainer_config_helpers/poolings.py):
``pooling_type=paddle.pooling.Max()`` stringifies to the DSL's name."""

__all__ = ["Max", "Avg", "Sum", "SquareRootN"]


class _Pool(str):
    def __new__(cls):
        return str.__new__(cls, cls.name)


Max = type("Max", (_Pool,), {"name": "max"})
Avg = type("Avg", (_Pool,), {"name": "avg"})
Sum = type("Sum", (_Pool,), {"name": "sum"})
SquareRootN = type("SquareRootN", (_Pool,), {"name": "sqrt"})
