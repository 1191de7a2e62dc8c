"""Mixed layers and projections — counterpart of
``paddle_tpu/nn/projections.py`` for ``full_matrix_projection``.

A mixed layer sums the outputs of its projections, then adds its bias and
applies its activation.  Projections defer creating their parameters until
the owning ``mixed`` layer seals, so the names follow the reference's
``_{mixed}.w{idx}`` / ``_{mixed}.wbias``.  Both of the reference's build
styles work::

    m = mixed(size=256, input=[full_matrix_projection(a),
                               full_matrix_projection(b)])

    with mixed(size=256) as m:
        m += full_matrix_projection(input=a)

Not ported yet: the other projections and the operators, and the
recording of each call for config serialization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import Act, LayerOutput, ParamSpec, next_name
from paddle_tpu_torch.nn.layers import (AttrLike, _bias_attr, _flat_in_size,
                                        _pa, _seq_like)
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["Projection", "MixedLayer", "mixed", "full_matrix_projection"]


@dataclass
class Projection:
    """One summand of a mixed layer.  The owning layer calls
    ``finalize(mixed_name, input_index, mixed_size)``, which returns
    ``(out_size, param_specs, forward)`` with
    ``forward(ctx, params, *acts) -> contribution``."""

    kind: str
    origins: List[LayerOutput]
    finalize: Callable[[str, int, int], tuple]


def full_matrix_projection(input: LayerOutput, size: int = 0,
                           param_attr: AttrLike = None) -> Projection:
    """out += x @ W, W: [in_size, size]."""

    def finalize(mixed_name, idx, mixed_size):
        out = size or mixed_size
        if out <= 0:
            raise ConfigError(
                "full_matrix_projection needs size= (own or mixed)")
        pa = _pa(param_attr, f"_{mixed_name}.w{idx}")
        spec = ParamSpec(name=pa.name, shape=(_flat_in_size(input), out),
                         attr=pa)

        def fwd(ctx, params, a: Act):
            v = a.value
            if not a.is_seq and v.dim() > 2:
                v = v.reshape(v.shape[0], -1)
            return O.linear(v, params[spec.name])

        return out, [spec], fwd

    return Projection("full_matrix", [input], finalize)


class MixedLayer(LayerOutput):
    """A mixed layer under construction, usable as a context manager
    (``with mixed(size=...) as m: m += proj``).  Once sealed it is an
    ordinary ``LayerOutput``."""

    def __init__(self, name, size, act, bias_attr):
        super().__init__(name=name, layer_type="mixed", size=size,
                         parents=[], forward=None, param_specs=[])
        self._act = act
        self._bias_attr = bias_attr
        self._inputs: List[Projection] = []
        self._finalized = False

    def __iadd__(self, other: Projection):
        if self._finalized:
            raise ConfigError(f"mixed layer {self.name!r} is sealed")
        if not isinstance(other, Projection):
            raise ConfigError(
                f"mixed layer inputs must be projections, got "
                f"{type(other).__name__}; wrap layers explicitly, e.g. "
                f"full_matrix_projection(input=layer)")
        self._inputs.append(other)
        return self

    def __enter__(self):
        if self._inputs:
            raise ConfigError("mixed context manager must start empty")
        return self

    def __exit__(self, exc_type, exc_value, tb):
        if exc_value is None:
            self._seal()
        return False

    def _seal(self):
        if self._finalized:
            return
        if not self._inputs:
            raise ConfigError(f"mixed layer {self.name!r} has no inputs")
        self._finalized = True
        specs: List[ParamSpec] = []
        fwds, sizes, offsets, parents = [], [], [], []
        for idx, proj in enumerate(self._inputs):
            out, pspecs, fwd = proj.finalize(self.name, idx, self.size)
            specs.extend(pspecs)
            fwds.append(fwd)
            sizes.append(out)
            offsets.append((len(parents), len(parents) + len(proj.origins)))
            parents.extend(proj.origins)
        want = self.size or sizes[0]
        if any(s != want for s in sizes):
            raise ConfigError(
                f"mixed layer {self.name!r}: input sizes {sizes} do not all "
                f"match layer size {want}")
        self.size = want
        ba = _bias_attr(self._bias_attr, f"_{self.name}.wbias")
        if ba:
            specs.append(ParamSpec(name=ba.name, shape=(want,), attr=ba))
        act_fn = O.get_activation(self._act)

        def forward(ctx, params, *acts: Act) -> Act:
            out = None
            for fwd, (lo, hi) in zip(fwds, offsets):
                y = fwd(ctx, params, *acts[lo:hi])
                out = y if out is None else out + y
            if ba:
                out = out + params[ba.name].to(out.dtype)
            out = act_fn(out)
            ref = next((a for a in acts if a.is_seq), None)
            # mask iff out has a time axis matching the sequence input (id
            # inputs are [B, T] while their projection output is [B, T, D])
            if ref is not None and out.dim() == ref.mask.dim() + 1:
                return _seq_like(ref, out * ref.mask[..., None].to(out.dtype))
            return Act(value=out)

        self.parents = parents
        self.param_specs = specs
        self.forward = forward


def mixed(size: int = 0,
          input: Optional[Union[Projection, Sequence[Projection]]] = None,
          *, act: str = "linear", name: Optional[str] = None,
          bias_attr: AttrLike = False) -> MixedLayer:
    """Mixed layer: the sum of its projections, then bias and activation
    (defaults as the reference's: linear, no bias).  With ``input=None``
    returns a context-manager builder; otherwise the layer is sealed at
    once."""
    name = name or next_name("mixed")
    m = MixedLayer(name, size, act, bias_attr)
    if input is None:
        return m
    items = [input] if isinstance(input, (Projection, LayerOutput)) \
        else list(input)
    for it in items:
        m += it  # a bare layer raises ConfigError
    m._seal()
    return m
