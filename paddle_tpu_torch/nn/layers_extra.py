"""Counterpart of ``paddle_tpu/nn/layers_extra.py``, holding only
``slice_channels`` for now (GoogLeNet's ``fused_reduce`` slices one merged
1x1 conv into its three branches).

The reference module's other layers (CRF, CTC, NCE, hierarchical sigmoid,
sampling, multiplex, pad, rotate, the feature-map and block expansions,
sub-sequences, reshape, eos trimming) are reached here under their names,
and each raises ``ConfigError`` naming ROADMAP.md Queue 1 item 3 when it is
called.
"""

from __future__ import annotations

from typing import Callable, Optional

from paddle_tpu_torch.nn.graph import Act, LayerOutput, next_name
from paddle_tpu_torch.nn.layers import _inherit_meta
from paddle_tpu_torch.utils.error import ConfigError, not_ported

#: the reference module's layers that are not ported yet
NOT_PORTED = ("crf_cost", "crf_decoding", "ctc_cost", "warp_ctc",
              "nce_cost", "hsigmoid_cost", "sampling_id", "multiplex", "pad",
              "rotate", "featmap_expand", "block_expand", "sub_seq",
              "seq_reshape", "eos_trim")

__all__ = ["slice_channels", *NOT_PORTED]


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
