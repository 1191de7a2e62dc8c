"""Topology <-> ModelConfig proto — counterpart of
``paddle_tpu/config/config_parser.py``.

The DSL builds a live ``Topology``; each node carries its recorded
constructor call (``config/capture.py``); ``dump_model_config`` serializes
calls and parameter specs into the proto (``paddle_tpu_torch/proto``, the
port's own codec of the reference's schema); ``build_topology`` replays the
calls to rebuild an equivalent Topology in a fresh process, the deploy path
(a bundle is the config proto plus the parameters, ``config/deploy.py``).
``protostr`` gives the deterministic text form the golden tests diff: the
port's text of a net equals the reference's ``tests/golden`` file.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict

import numpy as np
import torch

from paddle_tpu_torch.nn.graph import LayerOutput, ParamAttr, Topology
from paddle_tpu_torch.proto import model_config_pb2 as pb
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["SerializationError", "dump_model_config", "build_topology",
           "protostr", "parse_protostr", "dump_trainer_config",
           "build_optimizer", "FRAMEWORK_VERSION"]

#: ``ModelConfig.framework_version`` of the port's dumps
FRAMEWORK_VERSION = "paddle_tpu_torch 0.1.0"


class SerializationError(ConfigError):
    pass


# ---------------------------------------------------------------------------
# kwargs JSON encoding
# ---------------------------------------------------------------------------

_PA_DEFAULTS = ParamAttr()


def _encode(v: Any, where: str) -> Any:
    from paddle_tpu_torch.nn.projections import Projection

    if isinstance(v, LayerOutput):
        return {"__ref__": v.name}
    if isinstance(v, Projection):
        # a mixed layer's input: its recorded factory call, replayed on
        # rebuild (its origins become __ref__ entries)
        if not v.config:
            raise SerializationError(
                f"layer {where!r}: projection {v.kind!r} carries no recorded "
                f"factory call and cannot be serialized")
        return {"__projection__": {
            "fn": v.config["fn"],
            "kwargs": {k: _encode(x, where)
                       for k, x in v.config["kwargs"].items()},
        }}
    if isinstance(v, ParamAttr):
        return {"__param_attr__": {
            f.name: getattr(v, f.name) for f in dataclasses.fields(ParamAttr)
            if getattr(v, f.name) != getattr(_PA_DEFAULTS, f.name)}}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode(x, where) for x in v]}
    if isinstance(v, list):
        return [_encode(x, where) for x in v]
    if isinstance(v, dict):
        return {str(k): _encode(x, where) for k, x in v.items()}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray) or torch.is_tensor(v):
        arr = (v.detach().cpu().numpy() if torch.is_tensor(v)
               else np.asarray(v))
        return {"__array__": {"dtype": str(arr.dtype), "data": arr.tolist()}}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise SerializationError(
        f"layer {where!r}: cannot serialize constructor argument of type "
        f"{type(v).__name__} — pass serializable values (or rebuild this "
        f"graph programmatically instead of from config)")


def _decode(v: Any, env: Dict[str, LayerOutput]) -> Any:
    if isinstance(v, dict):
        if "__ref__" in v:
            try:
                return env[v["__ref__"]]
            except KeyError:
                raise ConfigError(
                    f"config references unknown layer {v['__ref__']!r}")
        if "__param_attr__" in v:
            return ParamAttr(**v["__param_attr__"])
        if "__projection__" in v:
            import paddle_tpu_torch.nn as nn

            pj = v["__projection__"]
            fn = getattr(nn, pj["fn"], None)
            if fn is None or not callable(fn):
                raise ConfigError(f"unknown projection factory {pj['fn']!r}")
            return fn(**{k: _decode(x, env) for k, x in pj["kwargs"].items()})
        if "__tuple__" in v:
            return tuple(_decode(x, env) for x in v["__tuple__"])
        if "__array__" in v:
            a = v["__array__"]
            return np.asarray(a["data"], dtype=a["dtype"])
        return {k: _decode(x, env) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x, env) for x in v]
    return v


def _canonical_json(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


# ---------------------------------------------------------------------------
# dump
# ---------------------------------------------------------------------------


def _policy_name() -> str:
    """The compute policy as the reference writes it (numpy's name:
    ``"float32"``, ``"bfloat16"``)."""
    from paddle_tpu_torch.ops.numerics import compute_dtype

    return str(compute_dtype()).replace("torch.", "")


def dump_model_config(topology: Topology, name: str = "model"
                      ) -> pb.ModelConfig:
    """Serialize a Topology into a ModelConfig proto."""
    mc = pb.ModelConfig(name=name, framework_version=FRAMEWORK_VERSION)
    mc.dtype_policy = _policy_name()
    call_renumber: Dict[int, int] = {}  # process-wide call ids -> dump-local
    for node in topology.layers:
        cfg = node.meta.get("config")
        if cfg is None:
            raise SerializationError(
                f"layer {node.name!r} (type {node.layer_type!r}) was not built "
                "by a recorded DSL constructor and cannot be serialized "
                "(recurrent_group step networks are rebuilt programmatically)")
        lc = mc.layers.add(name=node.name, type=cfg["fn"],
                           size=int(node.size),
                           inputs=[p.name for p in node.parents])
        kwargs = dict(cfg["kwargs"])
        # force the recorded name so a replay regenerates the same node and
        # parameter names even where it was auto-generated.  A composite
        # helper (lstmemory_group, ...) derives its node's name FROM the
        # passed name, so an explicit name stays as recorded
        if cfg["out"] == -1 and kwargs.get("name") is None:
            kwargs["name"] = node.name
        lc.config_json = _canonical_json(
            {k: _encode(v, node.name) for k, v in kwargs.items()})
        lc.output_index = cfg["out"]
        lc.call_id = call_renumber.setdefault(cfg["call_id"],
                                              len(call_renumber))
        _fill_typed(lc, node, kwargs)
    for pname in sorted(topology.param_specs):
        spec = topology.param_specs[pname]
        a = spec.attr
        mc.parameters.add(
            name=spec.name, shape=list(spec.shape), init=a.init or "",
            initial_mean=a.initial_mean, initial_std=a.initial_std or 0.0,
            learning_rate=a.learning_rate, l2_decay=a.l2_decay,
            is_static=a.is_static, sparse_grad=a.sparse_grad,
            is_state=spec.is_state, pruning_ratio=a.pruning_ratio)
    mc.input_layer_names.extend(l.name for l in topology.data_layers)
    mc.output_layer_names.extend(o.name for o in topology.outputs)
    return mc


#: cost-layer constructors covered by the generic CostConf typed contract
#: (crf/ctc/nce/hsigmoid get their own richer typed confs)
_COST_TYPES = frozenset({
    "classification_cost", "cross_entropy_cost", "soft_cross_entropy_cost",
    "cross_entropy_with_selfnorm", "mse_cost", "huber_cost", "smooth_l1_cost",
    "multi_binary_label_cross_entropy", "sum_cost", "rank_cost", "lambda_cost",
})

#: sequence-structure ops covered by SeqOpConf
_SEQ_OPS = frozenset({
    "pooling", "last_seq", "first_seq", "expand", "seq_reverse",
    "seq_concat", "context_projection",
})


def _has_bias(kwargs: Dict[str, Any]) -> bool:
    b = kwargs.get("bias_attr", True)
    return b is not False and b is not None


def _fill_typed(lc, node, kwargs: Dict[str, Any]) -> None:
    """Populate the typed oneof for the top layer families: a schema-level
    contract on top of the complete JSON record."""
    t = lc.type
    if t == "fc":
        lc.fc.size = int(node.size)
        lc.fc.act = str(kwargs.get("act", "tanh"))
        lc.fc.has_bias = _has_bias(kwargs)
    elif t == "img_conv":
        lc.conv.filter_size = int(kwargs.get("filter_size", 3))
        lc.conv.num_filters = int(kwargs.get("num_filters", node.size))
        lc.conv.stride = int(kwargs.get("stride", 1))
        lc.conv.padding = str(kwargs.get("padding", "SAME"))
        lc.conv.groups = int(kwargs.get("groups", 1))
        lc.conv.act = str(kwargs.get("act", "tanh"))
        lc.conv.has_bias = _has_bias(kwargs)
    elif t == "img_pool":
        lc.pool.pool_type = str(kwargs.get("pool_type", "max"))
        lc.pool.pool_size = int(kwargs.get("pool_size", 2))
        lc.pool.stride = int(kwargs.get("stride", kwargs.get("pool_size", 2)))
        lc.pool.padding = str(kwargs.get("padding", "VALID"))
    elif t == "batch_norm":
        lc.batch_norm.act = str(kwargs.get("act", "relu"))
        lc.batch_norm.momentum = float(kwargs.get("momentum", 0.9))
        lc.batch_norm.epsilon = float(kwargs.get("epsilon", 1e-5))
    elif t in ("lstmemory", "grumemory"):
        dst = lc.lstm if t == "lstmemory" else lc.gru
        dst.size = int(node.size)
        dst.act = str(kwargs.get("act", "tanh"))
        dst.gate_act = str(kwargs.get("gate_act", "sigmoid"))
        if t == "lstmemory":
            dst.state_act = str(kwargs.get("state_act", "tanh"))
        dst.reverse = bool(kwargs.get("reverse", False))
    elif t == "embedding":
        lc.embedding.emb_dim = int(node.size)
        lc.embedding.vocab_size = int(kwargs.get("vocab_size") or 0)
    elif t in _SEQ_OPS:
        lc.seq.op = t
        if t == "pooling":
            lc.seq.pooling_type = str(kwargs.get("pooling_type", "max"))
        if t == "context_projection":
            clen = int(kwargs.get("context_len", 3))
            lc.seq.context_len = clen
            cs = kwargs.get("context_start")
            lc.seq.context_start = int(cs if cs is not None else -(clen // 2))
    elif t == "dropout":
        lc.dropout.rate = float(kwargs.get("rate",
                                           kwargs.get("dropout_rate", 0.5)))
    elif t in ("addto", "concat"):
        lc.elem.op = t
        lc.elem.act = str(kwargs.get("act", "linear"))
    elif t == "img_cmrnorm":
        lc.norm.size = int(kwargs.get("size", 5))
        lc.norm.scale = float(kwargs.get("scale", 1e-4))
        lc.norm.power = float(kwargs.get("power", 0.75))
    elif t == "crf_cost":
        lc.crf.num_classes = int(kwargs.get("size") or node.parents[0].size)
    elif t in ("ctc_cost", "warp_ctc"):
        lc.ctc.num_classes = int(node.parents[0].size)
        b = kwargs.get("blank")
        if b is None:  # ctc_layer convention: blank is the last index
            b = node.parents[0].size - 1 if t == "ctc_cost" else 0
        lc.ctc.blank = int(b)
    elif t in ("nce_cost", "hsigmoid_cost"):
        lc.sampled_cost.cost_type = t
        lc.sampled_cost.num_classes = int(
            kwargs.get("num_classes") or kwargs.get("size") or 0)
        if t == "nce_cost":
            lc.sampled_cost.num_neg_samples = int(
                kwargs.get("num_neg_samples", 10))
    elif t == "mixed":
        lc.mixed.size = int(node.size)
        lc.mixed.act = str(kwargs.get("act", "linear"))
        lc.mixed.has_bias = _has_bias(
            {"bias_attr": kwargs.get("bias_attr", False)})
        projs = kwargs.get("input") or []
        if not isinstance(projs, (list, tuple)):
            projs = [projs]
        for p in projs:
            cfg = getattr(p, "config", None) or {}
            pk = cfg.get("kwargs", {})
            pc = lc.mixed.projections.add(
                kind=cfg.get("fn", p.kind).replace("_projection", "")
                .replace("context_input", "context"))
            if pk.get("size"):
                pc.size = int(pk["size"])
            off = pk.get("offset")
            pc.offset = int(off) if off is not None else -1
            if "context_len" in pk:
                pc.context_len = int(pk["context_len"])
                cs = pk.get("context_start")
                pc.context_start = int(
                    cs if cs is not None else -(pc.context_len // 2))
            for fld in ("filter_size", "num_filters", "stride"):
                if pk.get(fld) is not None:
                    setattr(pc, fld, int(pk[fld]))
            if pk.get("padding") is not None:
                pc.padding = str(pk["padding"])
    elif t in ("lstmemory_group", "gru_group"):
        lc.group_rnn.cell = "lstm" if t == "lstmemory_group" else "gru"
        lc.group_rnn.size = int(node.size)
        lc.group_rnn.act = str(kwargs.get("act", "tanh"))
        lc.group_rnn.gate_act = str(kwargs.get("gate_act", "sigmoid"))
        if t == "lstmemory_group":
            lc.group_rnn.state_act = str(kwargs.get("state_act", "tanh"))
        lc.group_rnn.reverse = bool(kwargs.get("reverse", False))
    elif t in ("lstm_step", "gru_step"):
        lc.step.size = int(node.size)
        lc.step.act = str(kwargs.get("act", "tanh"))
        lc.step.gate_act = str(kwargs.get("gate_act", "sigmoid"))
        if t == "lstm_step":
            lc.step.state_act = str(kwargs.get("state_act", "tanh"))
    elif t in _COST_TYPES:
        lc.cost.cost_type = t


def _check_typed(lc, node) -> None:
    """Schema-level validation of a rebuilt node against the typed contract
    (detects a tampered or mismatched config_json)."""
    which = lc.WhichOneof("typed")
    if which is None:
        return  # an uncovered layer type: the JSON plane alone
    sizes = {"fc": lc.fc.size, "conv": lc.conv.num_filters,
             "lstm": lc.lstm.size, "gru": lc.gru.size,
             "embedding": lc.embedding.emb_dim, "mixed": lc.mixed.size,
             "group_rnn": lc.group_rnn.size, "step": lc.step.size}
    label = {"conv": "conv.num_filters", "embedding": "embedding.emb_dim"}
    if which in sizes and sizes[which] != node.size:
        raise ConfigError(
            f"layer {lc.name!r}: typed {label.get(which, which + '.size')}="
            f"{sizes[which]} != rebuilt size={node.size}")
    if which == "cost" and lc.cost.cost_type != lc.type:
        raise ConfigError(
            f"layer {lc.name!r}: typed cost_type={lc.cost.cost_type!r} != "
            f"type={lc.type!r}")
    if which == "crf" and lc.crf.num_classes != node.parents[0].size:
        raise ConfigError(
            f"layer {lc.name!r}: typed crf.num_classes={lc.crf.num_classes} "
            f"!= emission size={node.parents[0].size}")
    if which == "ctc" and lc.ctc.num_classes != node.parents[0].size:
        raise ConfigError(
            f"layer {lc.name!r}: typed ctc.num_classes={lc.ctc.num_classes} "
            f"!= logits size={node.parents[0].size}")
    if which == "sampled_cost" and lc.sampled_cost.cost_type != lc.type:
        raise ConfigError(
            f"layer {lc.name!r}: typed sampled cost_type="
            f"{lc.sampled_cost.cost_type!r} != type={lc.type!r}")


# ---------------------------------------------------------------------------
# rebuild
# ---------------------------------------------------------------------------


def _constructor(fn_name: str) -> Callable:
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2.networks as networks

    fn = getattr(nn, fn_name, None)
    if fn is None:  # composite helpers (lstmemory_group, simple_gru2, ...)
        fn = getattr(networks, fn_name, None)
    if fn is None or not callable(fn):
        raise ConfigError(f"unknown layer constructor {fn_name!r} in config")
    return fn


def build_topology(mc: pb.ModelConfig, *, device=None) -> Topology:
    """Rebuild a Topology (on ``device``, ``cuda`` by default) by replaying
    the recorded constructor calls.

    The replay runs inside a ``naming_scope``, so the caller's auto-name
    counters are untouched.  A layer pinned to a model-parallel device
    group (``LayerConf.device``) replays through ``device_pin``, which the
    port does not have yet."""
    from paddle_tpu_torch.nn.graph import device_pin, naming_scope

    with naming_scope():
        env: Dict[str, LayerOutput] = {}
        done_calls: Dict[int, Any] = {}  # multi-output calls run once
        for lc in mc.layers:
            if lc.name in env:
                continue
            if not lc.config_json:
                raise ConfigError(
                    f"layer {lc.name!r} has no recorded constructor")
            if lc.output_index >= 0 and lc.call_id in done_calls:
                out = done_calls[lc.call_id][lc.output_index]
            else:
                kwargs = {k: _decode(v, env)
                          for k, v in json.loads(lc.config_json).items()}
                out = _constructor(lc.type)(**kwargs)
                if lc.output_index >= 0:
                    done_calls[lc.call_id] = out
                    out = out[lc.output_index]
            _check_rebuilt(lc, out)
            if lc.device:
                device_pin(out, lc.device)
            env[lc.name] = out
        missing = [n for n in mc.output_layer_names if n not in env]
        if missing:
            raise ConfigError(f"config outputs {missing} were not rebuilt")
        topo = Topology([env[n] for n in mc.output_layer_names],
                        device=device)
    _check_params(mc, topo)
    return topo


def _check_rebuilt(lc, out: LayerOutput) -> None:
    if out.name != lc.name:
        raise ConfigError(
            f"replaying {lc.type!r} produced node {out.name!r}, expected "
            f"{lc.name!r} — constructor does not honor the name argument")
    if out.size != lc.size:
        raise ConfigError(
            f"layer {lc.name!r}: rebuilt size {out.size} != recorded "
            f"{lc.size}")
    _check_typed(lc, out)


def _check_params(mc: pb.ModelConfig, topo: Topology) -> None:
    rebuilt = {n: tuple(s.shape) for n, s in topo.param_specs.items()}
    recorded = {p.name: tuple(p.shape) for p in mc.parameters}
    if rebuilt != recorded:
        only_new = sorted(set(rebuilt) - set(recorded))
        only_old = sorted(set(recorded) - set(rebuilt))
        diff = [f"{n}: {recorded[n]} -> {rebuilt[n]}" for n in recorded
                if n in rebuilt and rebuilt[n] != recorded[n]]
        raise ConfigError(
            "rebuilt parameters disagree with config: "
            f"missing={only_old} extra={only_new} reshaped={diff}")


# ---------------------------------------------------------------------------
# text form (golden tests) + trainer config
# ---------------------------------------------------------------------------


def protostr(msg) -> str:
    return pb.message_to_string(msg)


def parse_protostr(text: str, msg_cls=pb.ModelConfig):
    return pb.parse(text, msg_cls())


def dump_trainer_config(topology: Topology, optimizer, *,
                        batch_size: int = 0, num_passes: int = 0,
                        seed: int = 0, save_dir: str = "", mesh=None,
                        name: str = "model") -> pb.TrainerConfig:
    tc = pb.TrainerConfig(batch_size=batch_size, num_passes=num_passes,
                          seed=seed, save_dir=save_dir)
    tc.model.CopyFrom(dump_model_config(topology, name))
    oc = tc.optimizer
    oc.type = type(optimizer).__name__
    hyper = {}
    for f in dataclasses.fields(optimizer):
        v = getattr(optimizer, f.name)
        if f.name in ("learning_rate_schedule", "schedule_args"):
            continue
        if isinstance(v, (bool, int, float, str)):
            hyper[f.name] = v
    oc.config_json = _canonical_json(hyper)
    oc.schedule = optimizer.learning_rate_schedule
    oc.schedule_json = _canonical_json(optimizer.schedule_args)
    oc.clip = "global_norm" if optimizer.gradient_clipping_threshold > 0 else ""
    oc.clip_threshold = optimizer.gradient_clipping_threshold
    if mesh is not None:
        # a parallel.MeshConfig or a bound Mesh: the axis names and sizes
        tc.mesh_axes.extend(mesh.axis_names)
        tc.mesh_shape.extend(mesh.shape[n] for n in mesh.axis_names)
    return tc


def build_optimizer(oc: pb.OptimizerConf):
    from paddle_tpu_torch.param.optimizers import OPTIMIZERS

    cls = next((OPTIMIZERS.get(n) for n in OPTIMIZERS.names()
                if OPTIMIZERS.get(n).__name__ == oc.type), None)
    if cls is None:
        raise ConfigError(f"unknown optimizer type {oc.type!r}")
    opt = cls(**(json.loads(oc.config_json) if oc.config_json else {}))
    opt.learning_rate_schedule = oc.schedule or "constant"
    opt.schedule_args = json.loads(oc.schedule_json) if oc.schedule_json else {}
    return opt
