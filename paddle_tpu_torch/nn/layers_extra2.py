"""Counterpart of ``paddle_tpu/nn/layers_extra2.py``, holding
``img_conv_transpose`` and ``get_output`` (an aux output of a layer, such
as ``lstm_step``'s cell state).

The reference module's other layers (prelu, trans, resize, data_norm,
conv_shift, the linear/convex combinations, cos_vm, lambda_cost, selective_fc, spp, priorbox, eos_id, mdlstmemory,
cross_channel_norm, print_value) are reached here under their names, and
each raises ``ConfigError`` naming ROADMAP.md Queue 1 item 3 when it is
called.
"""

from __future__ import annotations

from typing import Optional

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import Act, LayerOutput, ParamSpec, next_name
from paddle_tpu_torch.nn.layers import AttrLike, _bias_attr, _pa, _spatial
from paddle_tpu_torch.nn.layers_extra import refusing
from paddle_tpu_torch.utils.error import ConfigError

#: the reference module's layers that are not ported yet
NOT_PORTED = ("prelu", "trans", "resize", "data_norm", "conv_shift",
              "linear_comb", "convex_comb", "cos_vm", "lambda_cost",
              "selective_fc", "spp", "priorbox", "eos_id", "mdlstmemory",
              "cross_channel_norm", "print_value")

__all__ = ["img_conv_transpose", "get_output", *NOT_PORTED]


def img_conv_transpose(input: LayerOutput, *, filter_size: int,
                       num_filters: int, stride: int = 1, act: str = "relu",
                       name: Optional[str] = None,
                       param_attr: AttrLike = None,
                       bias_attr: AttrLike = True) -> LayerOutput:
    """Transposed convolution with SAME padding (``ops.conv2d_transpose``):
    output H, W = input H, W * stride; weight ``w0`` [filter_size,
    filter_size, C, num_filters], bias ``wbias``."""
    name = name or next_name("convt")
    h, w = _spatial(input)
    pa = _pa(param_attr, f"_{name}.w0")
    wspec = ParamSpec(name=pa.name, shape=(filter_size, filter_size,
                                           input.size, num_filters), attr=pa)
    specs = [wspec]
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(num_filters,), attr=ba))
    act_fn = O.get_activation(act)

    def forward(ctx, params, a: Act) -> Act:
        y = O.conv2d_transpose(a.value, params[wspec.name],
                               stride=(stride, stride), padding="SAME")
        if ba:
            y = y + params[ba.name].to(y.dtype)
        return Act(value=act_fn(y))

    out = LayerOutput(name, "convt", num_filters, [input], forward, specs)
    out.meta["hw"] = (h * stride, w * stride)
    return out


def get_output(input: LayerOutput, key: str, *, size: Optional[int] = None,
               name: Optional[str] = None) -> LayerOutput:
    """The aux output ``key`` of a layer (its ``Act.state[key]``), e.g.
    ``lstm_step``'s cell state ``'state'``."""
    name = name or next_name("get_output")

    def forward(ctx, params, a: Act) -> Act:
        if key not in a.state:
            raise ConfigError(
                f"get_output: {input.name!r} has no aux output {key!r}; "
                f"available: {sorted(a.state)}")
        return Act(value=a.state[key])

    return LayerOutput(name, "get_output", size or input.size, [input],
                       forward, [])


globals().update({n: refusing(n, "paddle_tpu/nn/layers_extra2.py")
                  for n in NOT_PORTED})
