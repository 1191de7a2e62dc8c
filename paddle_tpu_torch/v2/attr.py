"""``paddle.v2.attr`` — counterpart of ``paddle_tpu/v2/attr.py``:
``Param``/``ParamAttr`` are the DSL's ``ParamAttr``; ``Extra`` holds its
keywords (dropout is a layer of its own here)."""

from paddle_tpu_torch.nn.graph import ParamAttr

__all__ = ["Param", "ParamAttr", "Extra", "ExtraAttr"]

Param = ParamAttr


class Extra:
    """The reference's ExtraLayerAttribute, kept for its signature."""

    def __init__(self, **kw):
        self.kw = kw


ExtraAttr = Extra
