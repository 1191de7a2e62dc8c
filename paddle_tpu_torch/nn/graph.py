"""The layer graph core — counterpart of ``paddle_tpu/nn/graph.py``.

Layer functions build a symbolic DAG of ``LayerOutput`` nodes; ``Topology``
walks it in topological order as two functions over plain dicts of tensors:

    init(seed)                               -> (params, state)
    apply(params, state, feed, train=...)    -> (outputs, new_state)

``apply`` is eager PyTorch, so ``torch.autograd.grad`` over the params gives
the training step's gradients.  Activations between layers are ``Act``
records (value + sequence lengths/mask).  Parameter names, shapes and the
auto-generated layer names are the reference's, so a JAX parameter dict
carries across unchanged (``params_from_jax``).

Sparse data layers feed padded COO rows (``_coerce_feed``); only the
sparse-aware layers (``Topology.SPARSE_AWARE``) may consume them.  A nested
data layer takes ``(value, outer_lengths, sub_lengths)``; a packed sequence
slot (``--data_pack``) the 5-tuple ``(ids, lengths, seg_ids, positions,
seg_lengths)``, whose pack state rides ``Act.state``.

``apply(param_overrides=)`` substitutes parameter values by name for one
call: the pserver tier hands in a ``pserver.TableProxy`` for each routed
table, whose ``pserver_lookup`` the embedding layer takes.

Not ported here, and refused with a ``ConfigError`` that says so:
``device_pin`` and ``apply(device_specs=)`` (model-parallel placement,
ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.ops.sequence import PACK_KEYS, mask_from_lengths
from paddle_tpu_torch.utils.error import ConfigError, layer_scope, not_ported
from paddle_tpu_torch.utils.registry import Registry

__all__ = ["Act", "ParamAttr", "ParamSpec", "LayerOutput", "ApplyContext",
           "Topology", "StepTopology", "next_name", "reset_naming",
           "naming_scope", "device_pin", "PACK_KEYS", "LAYER_TYPES"]

def _not_ported(what: str, item: int = 3) -> ConfigError:
    """``item``: the ROADMAP.md Queue 1 item that ports it (3, groups,
    feeds and config, unless the caller names another)."""
    return not_ported(what, item)


def device_pin(node: "LayerOutput", tag: str) -> "LayerOutput":
    """The reference's model-parallel layer pin; not ported."""
    raise _not_ported("device_pin (model-parallel layer placement, with "
                      "the pipeline tier)", 8)


#: the layer-type registry of the reference's ``nn/graph.py`` (its
#: ``REGISTER_LAYER`` analogue), empty there as here
LAYER_TYPES: Registry = Registry("layer_type")


# ---------------------------------------------------------------------------
# Runtime activation record
# ---------------------------------------------------------------------------


@dataclass
class Act:
    """Value flowing between layers.

    value: [B, D] (non-seq), [B, T, D] (sequence) or int ids [B, T].
    lengths/mask present iff the activation is a sequence.  ``state``
    carries auxiliary outputs (e.g. an RNN's final cell state) and a packed
    row's ``PACK_KEYS``.

    Nested sequences (the reference's sub-sequence start positions):
    value is [B, To, Ti(, D)], ``lengths``/``mask`` index the outer level
    (sub-sequences) and ``sub_lengths`` [B, To] holds each sub-sequence's
    tokens."""

    value: Any
    lengths: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    sub_lengths: Optional[torch.Tensor] = None
    state: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_seq(self) -> bool:
        return self.lengths is not None

    @property
    def is_nested(self) -> bool:
        return self.sub_lengths is not None


#: the ``Act.state`` key where a cost layer reports what its value averages
#: over: a count known from the shapes (a Python number: the rows), or one
#: taken from the data (a tensor: a sequence cost's real tokens), or
#: ``None`` for a sum.  A data-parallel step weights each rank's cost by
#: it (``parallel.api.loss_shares``), so the step's loss is the global
#: batch's.
COST_NORM = "cost_norm"


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamAttr:
    """Per-parameter attributes (the reference's ParameterConfig): shared
    name, init scheme, learning-rate scale, decay, static flag.
    ``SGDTrainer`` reads ``learning_rate``, ``l2_decay``, ``is_static``,
    ``pruning_ratio`` and ``sparse_grad`` (the table's untouched rows and
    slots are held at each update: ``Optimizer.update(sparse_rows=)``)."""

    name: Optional[str] = None
    initial_std: Optional[float] = None
    initial_mean: float = 0.0
    #: 'normal' | 'uniform' | 'xavier' | 'zeros' | 'ones'
    init: Optional[str] = None
    learning_rate: float = 1.0
    l2_decay: float = 0.0
    is_static: bool = False
    sparse_grad: bool = False
    pruning_ratio: float = 0.0


@dataclass(frozen=True)
class ParamSpec:
    name: str
    shape: Tuple[int, ...]
    attr: ParamAttr
    is_state: bool = False  # True for running stats etc. (not optimized)

    def initializer(self) -> Callable:
        """-> init(generator, shape, dtype): the reference's distributions
        (xavier by default, ``normal``, ``uniform``, ``zeros``, ``ones``)
        drawn from a ``torch.Generator`` (other numbers than
        ``jax.random``'s)."""
        attr = self.attr
        kind = attr.init or ("normal" if attr.initial_std is not None
                             else "xavier")

        def init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
            if kind == "zeros":
                return torch.zeros(shape, dtype=dtype)
            if kind == "ones":
                return torch.ones(shape, dtype=dtype)
            if kind == "normal":
                std = attr.initial_std if attr.initial_std is not None \
                    else 0.01
                return attr.initial_mean + std * torch.randn(
                    shape, generator=gen, dtype=dtype)
            if kind == "uniform":
                a = attr.initial_std if attr.initial_std is not None else 0.05
                return (2 * torch.rand(shape, generator=gen, dtype=dtype)
                        - 1) * a
            # xavier/glorot: std = sqrt(2 / (fan_in + fan_out))
            fan_in, fan_out = shape[0], shape[-1]
            if len(shape) == 4:  # HWIO conv kernels
                rf = shape[0] * shape[1]
                fan_in, fan_out = rf * shape[2], rf * shape[3]
            std = (2.0 / (fan_in + fan_out)) ** 0.5
            return std * torch.randn(shape, generator=gen, dtype=dtype)

        return init


# ---------------------------------------------------------------------------
# Symbolic layer node
# ---------------------------------------------------------------------------

_naming = threading.local()


def next_name(prefix: str) -> str:
    if not hasattr(_naming, "counters"):
        _naming.counters = {}
    c = _naming.counters.get(prefix, 0)
    _naming.counters[prefix] = c + 1
    return f"__{prefix}_{c}__"


def reset_naming() -> None:
    _naming.counters = {}


class naming_scope:
    """Context manager: fresh auto-name counters inside, the caller's
    counters restored on exit."""

    def __enter__(self):
        self._saved = getattr(_naming, "counters", {})
        _naming.counters = {}
        return self

    def __exit__(self, *exc):
        _naming.counters = self._saved
        return False


@dataclass
class LayerOutput:
    """Symbolic node in the layer DAG."""

    name: str
    layer_type: str
    size: int
    parents: List["LayerOutput"]
    forward: Optional[Callable]  # (ctx, params, *parent_acts) -> Act
    param_specs: List[ParamSpec] = field(default_factory=list)
    is_data: bool = False
    data_spec: Optional[dict] = None
    #: layer metadata, e.g. {'hw': (H, W)} for image layers
    meta: dict = field(default_factory=dict)

    def __repr__(self) -> str:
        return f"<{self.layer_type} {self.name} size={self.size}>"

    def __add__(self, other: "LayerOutput") -> "LayerOutput":
        """``a + b`` is ``addto([a, b])``."""
        from paddle_tpu_torch.nn.layers import addto

        return addto(input=[self, other])


class ApplyContext:
    """Per-apply runtime context: the train flag and a random generator
    that hands out a fresh generator per call of ``next_rng``."""

    def __init__(self, train: bool,
                 rng: Optional[Union[int, torch.Generator]]):
        self.train = train
        if rng is None or isinstance(rng, int):
            rng = torch.Generator().manual_seed(rng or 0)
        self._rng = rng
        self.updated_state: Dict[str, Any] = {}

    def next_rng(self) -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))
        return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# Topology: DAG -> functions
# ---------------------------------------------------------------------------


class Topology:
    """Compiled view of a layer DAG.  ``device`` (default ``cuda``) is where
    ``init`` puts the parameters and ``apply`` the feed; without a card,
    leaving it unset raises."""

    #: layer types with a sparse-input compute path; any other layer fed by
    #: a sparse data layer is a config error (it would misread the ids)
    SPARSE_AWARE = frozenset({"fc", "selective_fc"})

    def __init__(self, outputs: Union[Sequence[LayerOutput], LayerOutput], *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device: Optional[torch.device] = resolve_device(device)
        self._build(outputs)

    def _build(self, outputs: Union[Sequence[LayerOutput], LayerOutput]
               ) -> None:
        if isinstance(outputs, LayerOutput):
            outputs = [outputs]
        self.outputs: List[LayerOutput] = list(outputs)
        self.layers: List[LayerOutput] = self._toposort(self.outputs)
        self.data_layers = [l for l in self.layers if l.is_data]
        for layer in self.layers:
            for p in layer.parents:
                if (p.meta.get("sparse")
                        and layer.layer_type not in self.SPARSE_AWARE):
                    raise ConfigError(
                        f"layer {layer.name!r} ({layer.layer_type}) cannot "
                        f"consume sparse input {p.name!r}; sparse-aware "
                        f"layers: {sorted(self.SPARSE_AWARE)}")
        self.param_specs: Dict[str, ParamSpec] = {}
        for layer in self.layers:
            for spec in layer.param_specs:
                prev = self.param_specs.get(spec.name)
                if prev is not None and prev.shape != spec.shape:
                    raise ConfigError(
                        f"shared parameter {spec.name!r} has conflicting "
                        f"shapes {prev.shape} vs {spec.shape}")
                self.param_specs.setdefault(spec.name, spec)

    @staticmethod
    def _toposort(outputs: Sequence[LayerOutput]) -> List[LayerOutput]:
        order: List[LayerOutput] = []
        seen: Dict[int, int] = {}  # id -> 0 visiting, 1 done

        def visit(node: LayerOutput) -> None:
            mark = seen.get(id(node))
            if mark == 1:
                return
            if mark == 0:
                raise ConfigError(f"cycle in layer graph at {node.name!r}")
            seen[id(node)] = 0
            for p in node.parents:
                visit(p)
            seen[id(node)] = 1
            order.append(node)

        for out in outputs:
            visit(out)
        names: Dict[str, LayerOutput] = {}
        for l in order:
            if l.name in names and names[l.name] is not l:
                raise ConfigError(f"duplicate layer name {l.name!r}")
            names[l.name] = l
        return order

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 0, dtype=None, skip: Sequence[str] = ()
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Create (params, state) dicts of tensors on ``self.device``.

        Specs are taken in sorted-name order, each from its own generator
        (numpy ``SeedSequence(seed)``'s children), so the values do not
        depend on the device and ``skip`` (names NOT to materialize)
        leaves the other parameters' values unchanged."""
        dt = torch.float32 if dtype is None else (
            getattr(torch, dtype) if isinstance(dtype, str) else dtype)
        skipped = set(skip)
        params: Dict[str, torch.Tensor] = {}
        state: Dict[str, torch.Tensor] = {}
        specs = sorted(self.param_specs.values(), key=lambda s: s.name)
        children = np.random.SeedSequence(seed).spawn(max(len(specs), 1))
        for child, spec in zip(children, specs):
            if spec.name in skipped:
                continue
            gen = torch.Generator().manual_seed(
                int(child.generate_state(1, np.uint64)[0] >> np.uint64(1)))
            arr = spec.initializer()(gen, spec.shape, dt).to(self.device)
            (state if spec.is_state else params)[spec.name] = arr
        return params, state

    # -- apply --------------------------------------------------------------

    def apply(self, params: Dict[str, torch.Tensor],
              state: Dict[str, torch.Tensor], feed: Dict[str, Any], *,
              train: bool = False,
              rng: Optional[Union[int, torch.Generator]] = None,
              outputs: Optional[Sequence[str]] = None,
              device_specs: Optional[Dict[str, Any]] = None,
              param_overrides: Optional[Dict[str, Any]] = None
              ) -> Tuple[Dict[str, Act], Dict[str, torch.Tensor]]:
        """Run the graph.  ``feed`` maps data-layer name -> Act | array |
        (value, lengths).  ``param_overrides`` maps parameter names to
        values used in this call in place of ``params``' (the pserver
        tier's table proxies).  Returns ({layer_name: Act}, new_state)."""
        if device_specs is not None:
            raise _not_ported("apply(device_specs=) (model-parallel "
                              "placement, with the pipeline tier)", 8)
        ctx = ApplyContext(train, rng)
        env: Dict[str, Act] = {}
        all_params = {**params, **state, **(param_overrides or {})}
        needed = (self.layers if outputs is None
                  else self._needed_layers(set(outputs)))
        for layer in needed:
            with layer_scope(layer.name):
                if layer.is_data:
                    act = _coerce_feed(layer, feed, self.device)
                else:
                    parent_acts = [env[p.name] for p in layer.parents]
                    local = {s.name: all_params[s.name]
                             for s in layer.param_specs}
                    act = layer.forward(ctx, local, *parent_acts)
                env[layer.name] = act
        new_state = {**state, **ctx.updated_state}
        result = {l.name: env[l.name] for l in self.layers if l.name in env}
        return result, new_state

    def _needed_layers(self, want: set) -> List[LayerOutput]:
        by_name = {l.name: l for l in self.layers}
        missing = want - set(by_name)
        if missing:
            raise ConfigError(f"unknown output layers {sorted(missing)}")
        return Topology._toposort([by_name[n] for n in want])


class StepTopology(Topology):
    """The step net of a recurrent group or ``beam_search``: a graph with
    no device of its own.  It runs wherever the outer ``apply`` runs,
    since every feed it takes is an ``Act`` already there; any other feed
    raises."""

    def __init__(self, outputs: Union[Sequence[LayerOutput], LayerOutput]):
        self.device = None
        self._build(outputs)


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                           device=device)


def _sparse_feed(layer: LayerOutput, v, device: torch.device) -> Act:
    """A sparse data layer's feed as padded COO rows.  Non-sequence:
    ``(ids [B, N], nnz [B])`` (binary) or ``(ids, weights [B, N], nnz)``
    (float) -> ``Act(ids, mask=[B, N] validity, state={"weights"})``.
    Sequence (one bag a step): ``(ids [B, T, N], nnz [B, T], lengths)`` or
    ``(ids, weights, nnz, lengths)`` -> a sequence ``Act`` with
    ``state={"weights", "nnz_mask"}`` (its ``mask`` is the [B, T]
    sequence mask).  Binary weights are the validity mask."""
    if (layer.data_spec or {}).get("is_seq"):
        if not isinstance(v, tuple) or len(v) not in (3, 4):
            raise ConfigError(
                f"sparse sequence data layer {layer.name!r} expects "
                f"(ids, nnz, lengths) or (ids, weights, nnz, lengths), got "
                f"{type(v).__name__} of len "
                f"{len(v) if isinstance(v, tuple) else '?'}")
        ids = _as_tensor(v[0], device)
        nnz = _as_tensor(v[-2], device)
        lengths = _as_tensor(v[-1], device)
        valid = (torch.arange(ids.shape[-1], device=device)[None, None, :]
                 < nnz[:, :, None]).to(torch.float32)
        weights = _as_tensor(v[1], device) if len(v) == 4 else valid
        return Act(value=ids, lengths=lengths,
                   mask=mask_from_lengths(lengths, ids.shape[1]),
                   state={"weights": weights, "nnz_mask": valid})
    if not isinstance(v, tuple) or len(v) not in (2, 3):
        raise ConfigError(
            f"sparse data layer {layer.name!r} expects (ids, nnz) or "
            f"(ids, weights, nnz), got {type(v).__name__}")
    ids = _as_tensor(v[0], device)
    nnz = _as_tensor(v[-1], device)
    valid = (torch.arange(ids.shape[1], device=device)[None, :]
             < nnz[:, None]).to(torch.float32)
    weights = _as_tensor(v[1], device) if len(v) == 3 else valid
    return Act(value=ids, mask=valid, state={"weights": weights})


def _coerce_feed(layer: LayerOutput, feed: Dict[str, Any],
                 device: Optional[torch.device]) -> Act:
    if layer.name not in feed:
        raise ConfigError(f"missing feed for data layer {layer.name!r}")
    v = feed[layer.name]
    if (layer.data_spec or {}).get("sparse") and device is not None \
            and not isinstance(v, Act):
        return _sparse_feed(layer, v, device)
    if isinstance(v, Act):
        act = v
    elif device is None:
        raise ConfigError(f"a step net's feed {layer.name!r} must be an Act")
    elif isinstance(v, tuple):
        nested = (layer.data_spec or {}).get("nested")
        if len(v) == 3 and nested:
            value, lengths, sub_lengths = v
            act = Act(value=_as_tensor(value, device),
                      lengths=_as_tensor(lengths, device),
                      sub_lengths=_as_tensor(sub_lengths, device))
        elif len(v) == 5:
            # a packed row: several whole sequences share it, and the
            # pack-aware layers read seg_ids/positions/seg_lengths from
            # the Act's state
            value, lengths, seg_ids, positions, seg_lengths = v
            act = Act(value=_as_tensor(value, device),
                      lengths=_as_tensor(lengths, device),
                      state={"seg_ids": _as_tensor(seg_ids, device),
                             "positions": _as_tensor(positions, device),
                             "seg_lengths": _as_tensor(seg_lengths, device)})
        elif len(v) == 2:
            value, lengths = v
            act = Act(value=_as_tensor(value, device),
                      lengths=_as_tensor(lengths, device))
        else:
            hint = ("" if nested or len(v) != 3 else
                    " (a nested feed needs data(nested=True))")
            raise ConfigError(
                f"data layer {layer.name!r} takes (value, lengths), a "
                f"nested (value, outer_lengths, sub_lengths) or a packed "
                f"(ids, lengths, seg_ids, positions, seg_lengths) tuple, "
                f"got a {len(v)}-tuple{hint}")
    else:
        act = Act(value=_as_tensor(v, device))
    if act.is_seq and act.mask is None:
        act = Act(value=act.value, lengths=act.lengths,
                  mask=mask_from_lengths(act.lengths, act.value.shape[1]),
                  sub_lengths=act.sub_lengths, state=act.state)
    return act
