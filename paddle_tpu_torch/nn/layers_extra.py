"""Counterpart of ``paddle_tpu/nn/layers_extra.py``, holding the linear-chain
CRF (``crf_cost``, ``crf_decoding``; ``ops/crf.py``) and
``slice_channels`` (GoogLeNet's ``fused_reduce`` slices one merged 1x1
conv into its three branches).

The reference module's other layers (CTC, NCE, hierarchical sigmoid,
sampling, multiplex, pad, rotate, the feature-map and block expansions,
sub-sequences, reshape, eos trimming) are reached here under their names,
and each raises ``ConfigError`` naming ROADMAP.md Queue 1 item 3 when it is
called.
"""

from __future__ import annotations

from typing import Callable, Optional

from paddle_tpu_torch.nn.graph import (Act, LayerOutput, ParamAttr,
                                       ParamSpec, next_name)
from paddle_tpu_torch.nn.layers import _inherit_meta, _refuse_packed
from paddle_tpu_torch.ops.crf import crf_decode, crf_nll
from paddle_tpu_torch.utils.error import ConfigError, not_ported

#: the reference module's layers that are not ported yet
NOT_PORTED = ("ctc_cost", "warp_ctc", "nce_cost", "hsigmoid_cost",
              "sampling_id", "multiplex", "pad", "rotate", "featmap_expand",
              "block_expand", "sub_seq", "seq_reshape", "eos_trim")

__all__ = ["crf_cost", "crf_decoding", "slice_channels", *NOT_PORTED]


def _crf_specs(name: str, C: int):
    """``_{name}.start`` [C], ``.end`` [C], ``.trans`` [C, C], zeros."""

    def mk(suffix, shape):
        return ParamSpec(name=f"_{name}.{suffix}", shape=shape,
                         attr=ParamAttr(name=f"_{name}.{suffix}",
                                        init="zeros"))

    return mk("start", (C,)), mk("end", (C,)), mk("trans", (C, C))


def crf_cost(input: LayerOutput, label: LayerOutput, *,
             size: Optional[int] = None, name: Optional[str] = None,
             param_attr=None) -> LayerOutput:
    """Linear-chain CRF negative log-likelihood, the batch mean:
    ``input`` the per-step emissions [B, T, C] (a sequence), ``label`` the
    int tags [B, T].  ``param_attr`` is accepted for the reference's
    signature; the weights are named after the layer."""
    name = name or next_name("crf_cost")
    C = size or input.size
    s_start, s_end, s_trans = _crf_specs(name, C)

    def forward(ctx, params, emis: Act, lab: Act) -> Act:
        _refuse_packed(emis, name, "crf_cost")
        return Act(value=crf_nll(emis.value, lab.value, emis.mask,
                                 params[s_start.name], params[s_end.name],
                                 params[s_trans.name]))

    return LayerOutput(name, "crf_cost", 1, [input, label], forward,
                       [s_start, s_end, s_trans])


def crf_decoding(input: LayerOutput, *, size: Optional[int] = None,
                 name: Optional[str] = None,
                 share_with: Optional[str] = None) -> LayerOutput:
    """Viterbi decode -> int32 tags [B, T] (0 on padding), ``state['score']``
    the best path's score [B].  ``share_with`` names the ``crf_cost``
    layer whose weights it reads."""
    name = name or next_name("crf_decoding")
    C = size or input.size
    s_start, s_end, s_trans = _crf_specs(share_with or name, C)

    def forward(ctx, params, emis: Act) -> Act:
        _refuse_packed(emis, name, "crf_decoding")
        tags, score = crf_decode(emis.value, emis.mask, params[s_start.name],
                                 params[s_end.name], params[s_trans.name])
        return Act(value=tags, lengths=emis.lengths, mask=emis.mask,
                   state={"score": score})

    return LayerOutput(name, "crf_decoding", 1, [input], forward,
                       [s_start, s_end, s_trans])


def slice_channels(input: LayerOutput, start: int, end: int,
                   name: Optional[str] = None) -> LayerOutput:
    """Channel/feature sub-range [start, end) of a layer (the reference's
    slice projection); for feature maps, of the last (channel) axis."""
    name = name or next_name("slice")
    if not (0 <= start < end <= input.size):
        raise ConfigError(
            f"slice_channels {name!r}: range [{start}, {end}) invalid for "
            f"input size {input.size}")

    def forward(ctx, params, a: Act) -> Act:
        return Act(value=a.value[..., start:end], lengths=a.lengths,
                   mask=a.mask)

    return _inherit_meta(LayerOutput(name, "slice_channels", end - start,
                                     [input], forward, []), input)


def refusing(name: str, module: str) -> Callable:
    """A stand-in for the reference layer ``name`` of ``module`` that raises
    the "not ported" ``ConfigError`` when called."""

    def layer(*args, **kwargs):
        raise not_ported(f"the {name} layer ({module})", 3)

    layer.__name__ = layer.__qualname__ = name
    layer.__doc__ = "Not ported yet: calling it raises ``ConfigError``."
    return layer


globals().update({n: refusing(n, "paddle_tpu/nn/layers_extra.py")
                  for n in NOT_PORTED})
