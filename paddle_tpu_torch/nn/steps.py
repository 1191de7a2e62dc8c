"""Single-step cell layers — counterpart of ``paddle_tpu/nn/steps.py``
(``lstm_step``, ``gru_step``).

A step layer is not recurrent by itself: it computes one frame's cell
update from a pre-projected input and an explicit state layer, so that a
``recurrent_group`` or ``beam_search`` step can compose a custom cell
(the seqToseq attention decoder) out of ordinary layers.  ``lstm_step``'s
input is the [B, 4H] sum of the input and the recurrent projections (both
in a preceding ``mixed`` layer); it owns only the gate bias, has no
peepholes, and its aux output ``state`` is c_t.  ``gru_step``'s input is
the [B, 3H] input projection only; the layer owns the recurrent
weight [H, 3H] (the reset gate multiplies h before the candidate product,
so it cannot be hoisted) and the gate bias.
"""

from __future__ import annotations

from typing import Optional

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import Act, LayerOutput, ParamSpec, next_name
from paddle_tpu_torch.nn.layers import AttrLike, _bias_attr, _pa
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["lstm_step", "gru_step"]


def lstm_step(input: LayerOutput, state: LayerOutput,
              size: Optional[int] = None, *, act: str = "tanh",
              gate_act: str = "sigmoid", state_act: str = "tanh",
              bias_attr: AttrLike = True,
              name: Optional[str] = None) -> LayerOutput:
    """One LSTM gate update.  ``input`` [B, 4H] carries the x- and
    h-projections pre-summed (gate layout [i, f, o, g]); ``state`` [B, H]
    is c_{t-1}.  Returns h_t with aux ``state`` = c_t."""
    name = name or next_name("lstm_step")
    H = size or input.size // 4
    if input.size != 4 * H:
        raise ConfigError(
            f"lstm_step: input.size must be 4*size ({4 * H}), got "
            f"{input.size}")
    if state.size != H:
        raise ConfigError(
            f"lstm_step: state.size must be {H}, got {state.size}")
    specs = []
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(4 * H,), attr=ba))
    ga, sa, aa = (O.get_activation(gate_act), O.get_activation(state_act),
                  O.get_activation(act))

    def forward(ctx, params, ia: Act, ca: Act) -> Act:
        z = ia.value
        if ba:
            z = z + params[ba.name].to(z.dtype)
        i, f, o, g = z.chunk(4, dim=-1)
        c_new = ga(f) * ca.value + ga(i) * aa(g)
        h_new = ga(o) * sa(c_new)
        return Act(value=h_new, state={"state": c_new})

    return LayerOutput(name, "lstm_step", H, [input, state], forward, specs)


def gru_step(input: LayerOutput, output_mem: LayerOutput,
             size: Optional[int] = None, *, act: str = "tanh",
             gate_act: str = "sigmoid", param_attr: AttrLike = None,
             bias_attr: AttrLike = True,
             name: Optional[str] = None) -> LayerOutput:
    """One GRU update.  ``input`` [B, 3H] is the x-projection (gate layout
    [r, u, c]); ``output_mem`` [B, H] is h_{t-1}.  The bias is added to the
    x-projection, then ``ops.gru_step`` applies the cell."""
    name = name or next_name("gru_step")
    H = size or input.size // 3
    if input.size != 3 * H:
        raise ConfigError(
            f"gru_step: input.size must be 3*size ({3 * H}), got {input.size}")
    if output_mem.size != H:
        raise ConfigError(
            f"gru_step: output_mem.size must be {H}, got {output_mem.size}")
    pa = _pa(param_attr, f"_{name}.w0")
    wh = ParamSpec(name=pa.name, shape=(H, 3 * H), attr=pa)
    specs = [wh]
    ba = _bias_attr(bias_attr, f"_{name}.wbias")
    if ba:
        specs.append(ParamSpec(name=ba.name, shape=(3 * H,), attr=ba))

    def forward(ctx, params, ia: Act, ha: Act) -> Act:
        xp = ia.value
        if ba:
            xp = xp + params[ba.name].to(xp.dtype)
        return Act(value=O.gru_step(xp, ha.value, params[wh.name], act=act,
                                    gate_act=gate_act))

    return LayerOutput(name, "gru_step", H, [input, output_mem], forward,
                       specs)


# record constructor calls on the returned nodes so Topologies serialize to
# ModelConfig protos (config/config_parser.py)
from paddle_tpu_torch.config.capture import wrap_module as _wrap_module  # noqa: E402

_wrap_module(globals(), __all__)
