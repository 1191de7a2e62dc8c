"""Mixed layers, projections and operators — counterpart of
``paddle_tpu/nn/projections.py``.

A mixed layer sums the outputs of its projections (one input, with or
without a weight of their own) and operators (several inputs, no weight),
then adds its bias and applies its activation.  Projections defer creating
their parameters until the owning ``mixed`` layer seals, so the names
follow the reference's ``_{mixed}.w{idx}`` / ``_{mixed}.wbias``.  Both of
the reference's build styles work::

    m = mixed(size=256, input=[full_matrix_projection(a),
                               identity_projection(b)])

    with mixed(size=256) as m:
        m += full_matrix_projection(input=a)
        m += dotmul_operator(a=x, b=y, scale=0.5)

Image-shaped terms (``conv_projection``, ``conv_operator``) carry their
output's spatial dims, which the sealed layer takes.  Each factory records
its call on the projection it returns (``Projection.config``), and a sealed
mixed layer records its own, so mixed layers serialize through the config
tier (``config/config_parser.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import torch

import paddle_tpu_torch.ops as O
from paddle_tpu_torch.nn.graph import (Act, LayerOutput, ParamAttr,
                                       ParamSpec, next_name)
from paddle_tpu_torch.nn.layers import (AttrLike, _bias_attr, _flat_in_size,
                                        _pa, _seq_like)
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["Projection", "Operator", "MixedLayer", "mixed",
           "full_matrix_projection", "trans_full_matrix_projection",
           "table_projection", "identity_projection", "dotmul_projection",
           "scaling_projection", "context_projection_input",
           "conv_projection", "dotmul_operator", "conv_operator"]


@dataclass
class Projection:
    """One summand of a mixed layer.  The owning layer calls
    ``finalize(mixed_name, input_index, mixed_size)``, which returns
    ``(out_size, param_specs, forward)`` with
    ``forward(ctx, params, *acts) -> contribution``.  ``hw`` is the (oh,
    ow) of an image-shaped contribution."""

    kind: str
    origins: List[LayerOutput]
    finalize: Callable[[str, int, int], tuple]
    hw: Optional[tuple] = None
    #: the recorded factory call {fn, kwargs}, for config serialization
    config: Optional[dict] = None


class Operator(Projection):
    """A term that takes several inputs and owns no weight."""


def _recorded(fn):
    """Record the factory call on the returned Projection, so a mixed layer
    serializes its inputs as replayable factory calls."""
    import functools
    import inspect

    from paddle_tpu_torch.config.capture import bound_arguments

    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        proj = fn(*args, **kwargs)
        proj.config = {"fn": fn.__name__,
                       "kwargs": bound_arguments(sig, args, kwargs)}
        return proj

    return wrapper


def _flat(a: Act) -> torch.Tensor:
    v = a.value
    if not a.is_seq and v.dim() > 2:
        v = v.reshape(v.shape[0], -1)
    return v


@_recorded
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
            return O.linear(_flat(a), params[spec.name])

        return out, [spec], fwd

    return Projection("full_matrix", [input], finalize)


@_recorded
def trans_full_matrix_projection(input: LayerOutput, size: int = 0,
                                 param_attr: AttrLike = None) -> Projection:
    """out += x @ W^T, W: [size, in_size]."""

    def finalize(mixed_name, idx, mixed_size):
        out = size or mixed_size
        if out <= 0:
            raise ConfigError("trans_full_matrix_projection needs size=")
        pa = _pa(param_attr, f"_{mixed_name}.w{idx}")
        spec = ParamSpec(name=pa.name, shape=(out, _flat_in_size(input)),
                         attr=pa)

        def fwd(ctx, params, a: Act):
            return O.matmul(_flat(a), params[spec.name].t())

        return out, [spec], fwd

    return Projection("trans_full_matrix", [input], finalize)


@_recorded
def table_projection(input: LayerOutput, size: int = 0,
                     param_attr: AttrLike = None) -> Projection:
    """out += table[ids]: an embedding as a projection.  ``input`` is an
    integer id layer whose ``size`` is the vocabulary; the table is
    normal(0.01) by default."""

    def finalize(mixed_name, idx, mixed_size):
        out = size or mixed_size
        if out <= 0:
            raise ConfigError("table_projection needs size=")
        pa = _pa(param_attr, f"_{mixed_name}.w{idx}", initial_std=0.01,
                 init="normal")
        spec = ParamSpec(name=pa.name, shape=(input.size, out), attr=pa)

        def fwd(ctx, params, a: Act):
            ids = a.value
            if not a.is_seq and ids.dim() == 2 and ids.shape[1] == 1:
                ids = ids[:, 0]
            return O.embedding_lookup(params[spec.name], ids)

        return out, [spec], fwd

    return Projection("table", [input], finalize)


@_recorded
def identity_projection(input: LayerOutput, offset: Optional[int] = None,
                        size: int = 0) -> Projection:
    """out += x, or x[..., offset:offset + size] when ``offset`` is
    given."""

    def finalize(mixed_name, idx, mixed_size):
        if offset is None:
            return input.size, [], lambda ctx, params, a: a.value
        out = size or mixed_size
        if out <= 0:
            raise ConfigError("identity_projection with offset needs size=")
        if offset + out > input.size:
            raise ConfigError(
                f"identity_projection slice [{offset}, {offset + out}) "
                f"exceeds input size {input.size}")
        return out, [], lambda ctx, params, a: a.value[..., offset:offset
                                                       + out]

    hw = input.meta.get("hw") if offset is None else None
    return Projection("identity", [input], finalize, hw=hw)


@_recorded
def dotmul_projection(input: LayerOutput,
                      param_attr: AttrLike = None) -> Projection:
    """out += x * w, an elementwise weight w [size] (ones at init)."""

    def finalize(mixed_name, idx, mixed_size):
        pa = _pa(param_attr, f"_{mixed_name}.w{idx}", init="ones")
        spec = ParamSpec(name=pa.name, shape=(input.size,), attr=pa)

        def fwd(ctx, params, a: Act):
            return a.value * params[spec.name].to(a.value.dtype)

        return input.size, [spec], fwd

    return Projection("dotmul", [input], finalize)


@_recorded
def scaling_projection(input: LayerOutput,
                       param_attr: AttrLike = None) -> Projection:
    """out += w * x with one scalar weight [1] (one at init)."""

    def finalize(mixed_name, idx, mixed_size):
        pa = _pa(param_attr, f"_{mixed_name}.w{idx}", init="ones")
        spec = ParamSpec(name=pa.name, shape=(1,), attr=pa)

        def fwd(ctx, params, a: Act):
            return a.value * params[spec.name][0].to(a.value.dtype)

        return input.size, [spec], fwd

    return Projection("scaling", [input], finalize)


@_recorded
def context_projection_input(input: LayerOutput, context_len: int,
                             context_start: Optional[int] = None,
                             padding_attr: AttrLike = False) -> Projection:
    """The sliding context window as a mixed-layer term (the reference's
    ``context_projection`` inside a mixed layer).  With ``padding_attr`` a
    ``ParamAttr`` the boundary padding rows are trainable: ``w{idx}``
    [begin_pad + end_pad, D] (zeros at init), ``begin_pad = max(0,
    -start)``, ``end_pad = max(0, start + context_len - 1)``."""
    start = -(context_len - 1) // 2 if context_start is None         else context_start
    trainable = isinstance(padding_attr, ParamAttr)

    def finalize(mixed_name, idx, mixed_size):
        if not input.size:
            raise ConfigError(
                "context projection needs a sized sequence input")
        out = input.size * context_len
        spec = None
        if trainable:
            begin_pad = max(0, -start)
            end_pad = max(0, start + context_len - 1)
            pa = _pa(padding_attr, f"_{mixed_name}.w{idx}", init="zeros")
            spec = ParamSpec(name=pa.name,
                             shape=(begin_pad + end_pad, input.size),
                             attr=pa)

        def fwd(ctx, params, a: Act):
            if not a.is_seq:
                raise ConfigError(
                    "context projection input must be a sequence")
            if spec is None:
                return O.context_projection(a.value, a.mask, context_len,
                                            start)
            return O.context_projection_trainable(
                a.value, a.lengths, a.mask, context_len, start,
                params[spec.name])

        return out, [spec] if spec else [], fwd

    return Projection("context", [input], finalize)


def _conv_out(h: int, w: int, filter_size: int, stride: int, padding: int,
              trans: bool, what: str):
    if trans:
        oh = (h - 1) * stride + filter_size - 2 * padding
        ow = (w - 1) * stride + filter_size - 2 * padding
    else:
        oh = (h + 2 * padding - filter_size) // stride + 1
        ow = (w + 2 * padding - filter_size) // stride + 1
    if oh <= 0 or ow <= 0:
        raise ConfigError(f"{what} output dims ({oh}, {ow}) not positive")
    return oh, ow


def _dilate(x: torch.Tensor, stride: int) -> torch.Tensor:
    """stride - 1 zeros between the spatial elements of an NHWC map (the
    lhs dilation of a transposed conv)."""
    if stride == 1:
        return x
    B, H, W, C = x.shape
    out = x.new_zeros(B, (H - 1) * stride + 1, (W - 1) * stride + 1, C)
    out[:, ::stride, ::stride] = x
    return out


def _conv(x: torch.Tensor, wgt: torch.Tensor, filter_size: int, stride: int,
          padding: int, trans: bool, groups: int = 1) -> torch.Tensor:
    """The conv of a projection or operator, NHWC x HWIO; ``trans`` as the
    reference computes it: a conv of the stride-dilated input with the
    kernel flipped and its in/out axes swapped."""
    if trans:
        p = filter_size - 1 - padding
        return O.conv2d(_dilate(x, stride), wgt.flip(0, 1).transpose(2, 3),
                        stride=(1, 1), padding=[(p, p), (p, p)],
                        groups=groups)
    return O.conv2d(x, wgt, stride=(stride, stride),
                    padding=[(padding, padding)] * 2, groups=groups)


@_recorded
def conv_projection(input: LayerOutput, filter_size: int, num_filters: int,
                    num_channels: Optional[int] = None, stride: int = 1,
                    padding: int = 0, groups: int = 1,
                    param_attr: AttrLike = None,
                    trans: bool = False) -> Projection:
    """A convolution as a mixed-layer term with its own HWIO weight
    (``ops.conv2d``); the contribution is [B, oh, ow, num_filters], so
    several conv projections sum like inception branches."""
    if "hw" not in input.meta:
        raise ConfigError("conv_projection input needs spatial meta (hw)")
    if trans and groups != 1:
        raise ConfigError("conv_projection: groups>1 with trans=True is not "
                          "supported; use groups=1")
    h, w = input.meta["hw"]
    cin = num_channels or input.size
    oh, ow = _conv_out(h, w, filter_size, stride, padding, trans,
                       "conv_projection")

    def finalize(mixed_name, idx, mixed_size):
        pa = _pa(param_attr, f"_{mixed_name}.w{idx}")
        shape = ((filter_size, filter_size, cin, num_filters) if trans
                 else (filter_size, filter_size, cin // groups, num_filters))
        spec = ParamSpec(name=pa.name, shape=shape, attr=pa)

        def fwd(ctx, params, a: Act):
            return _conv(a.value, params[spec.name], filter_size, stride,
                         padding, trans, groups)

        return num_filters, [spec], fwd

    return Projection("conv_trans" if trans else "conv", [input], finalize,
                      hw=(oh, ow))


@_recorded
def dotmul_operator(a: LayerOutput = None, b: LayerOutput = None,
                    scale: float = 1.0, **kwargs) -> Operator:
    """out += scale * (a * b); ``x=``/``y=`` name the inputs too."""
    a = kwargs.get("x", a)
    b = kwargs.get("y", b)
    if a.size and b.size and a.size != b.size:
        raise ConfigError(
            f"dotmul_operator sizes differ: {a.size} vs {b.size}")

    def finalize(mixed_name, idx, mixed_size):
        def fwd(ctx, params, aa: Act, bb: Act):
            return scale * aa.value * bb.value

        return a.size, [], fwd

    return Operator("dotmul_op", [a, b], finalize)


@_recorded
def conv_operator(img: LayerOutput, filter: LayerOutput, filter_size: int,
                  num_filters: int, num_channels: Optional[int] = None,
                  stride: int = 1, padding: int = 0,
                  trans: bool = False) -> Operator:
    """A per-sample convolution: row i of ``filter`` ([kh * kw * Cin * F],
    reshaped to HWIO) is sample i's kernel.  One grouped ``ops.conv2d``
    call with the batch as its groups."""
    if "hw" not in img.meta:
        raise ConfigError("conv_operator img needs spatial meta (hw)")
    h, w = img.meta["hw"]
    cin = num_channels or img.size
    oh, ow = _conv_out(h, w, filter_size, stride, padding, trans,
                       "conv_operator")
    expect = filter_size * filter_size * cin * num_filters
    if filter.size and filter.size != expect:
        raise ConfigError(
            f"conv_operator filter layer size {filter.size} != "
            f"kh*kw*Cin*F = {expect}")

    def finalize(mixed_name, idx, mixed_size):
        def fwd(ctx, params, ia: Act, fa: Act):
            x = ia.value
            B, H, W, C = x.shape
            k, F = filter_size, num_filters
            # samples as groups: channels b-major on one image, each
            # sample's kernel its group's
            xg = x.permute(1, 2, 0, 3).reshape(1, H, W, B * C)
            wg = fa.value.reshape(B, k, k, cin, F)
            if trans:
                wg = wg.flip(1, 2).transpose(3, 4)
            wg = wg.permute(1, 2, 3, 0, 4).reshape(k, k, wg.shape[3],
                                                   B * wg.shape[4])
            if trans:
                p = k - 1 - padding
                y = O.conv2d(_dilate(xg, stride), wg, stride=(1, 1),
                             padding=[(p, p), (p, p)], groups=B)
            else:
                y = O.conv2d(xg, wg, stride=(stride, stride),
                             padding=[(padding, padding)] * 2, groups=B)
            _, yh, yw, _ = y.shape
            return y.reshape(yh, yw, B, -1).permute(2, 0, 1, 3)

        return num_filters, [], fwd

    return Operator("conv_trans_op" if trans else "conv_op", [img, filter],
                    finalize, hw=(oh, ow))


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
        hw = None
        for idx, proj in enumerate(self._inputs):
            out, pspecs, fwd = proj.finalize(self.name, idx, self.size)
            specs.extend(pspecs)
            fwds.append(fwd)
            sizes.append(out)
            offsets.append((len(parents), len(parents) + len(proj.origins)))
            parents.extend(proj.origins)
            if proj.hw is not None:
                if hw is not None and hw != proj.hw:
                    raise ConfigError(
                        f"mixed layer {self.name!r}: image inputs disagree "
                        f"on spatial dims {hw} vs {proj.hw}")
                hw = proj.hw
        if hw is not None and any(p.hw is None for p in self._inputs):
            raise ConfigError(
                f"mixed layer {self.name!r} mixes image-shaped and flat "
                f"inputs; split them into separate layers")
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
        if hw is not None:
            self.meta["hw"] = hw
        # record the sealed constructor call for config serialization (both
        # the eager and the context-manager build styles end here)
        from paddle_tpu_torch.config.capture import _call_counter

        self.meta["config"] = {
            "fn": "mixed",
            "kwargs": {"input": list(self._inputs), "size": self.size,
                       "act": self._act, "bias_attr": self._bias_attr,
                       "name": self.name},
            "call_id": next(_call_counter),
            "out": -1,
        }


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
