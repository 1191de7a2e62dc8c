"""The port's config tier (``paddle_tpu_torch/proto``, ``config/capture.py``
and ``config/config_parser.py``) against the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_config.py -q

- The codec: the port's message classes carry the reference schema's
  fields; for each of the 23 golden nets (``tests/torch_golden_nets.py``)
  the port's ``SerializeToString`` of its dump equals the reference
  ``_pb2``'s bytes of the JAX package's dump of the same net, each package
  parses the other's bytes, and the text round-trips; a ``TrainerConfig``
  too; one hypothesis property over random messages (negative ``int32``,
  empty oneof members, non-ASCII and control characters, inf/nan/-0.0
  doubles, packed ``shape``, ``uint64`` seeds) holds bytes and text equal
  to ``google.protobuf``'s.  Only this test imports ``google.protobuf``.
- The goldens: the port's ``protostr`` of each net, with
  ``framework_version`` and ``dtype_policy`` blanked as
  ``tests/test_golden_configs.py`` does, equals ``tests/golden/<name>
  .protostr``.  The shared builders record the same arguments in both
  packages, so no net is held to another dump.  ``simple_net`` (the
  reference's ``tests/test_config.py`` net) too.
- Rebuild equivalence (loss at rtol 1e-5 / atol 1e-6), the typed-oneof
  coverage (>= 0.8), the typed contract's checks, the recording itself.

Compute is float32 (``compute_dtype_scope``).
"""

import functools
import json
import math
import os
import struct

import jax
import numpy as np
import pytest
import torch
from google.protobuf import text_format
from hypothesis import given, settings
from hypothesis import strategies as st

import paddle_tpu.nn as jnn
import paddle_tpu.v2.networks as jnet
from paddle_tpu.config import dump_model_config as jdump
from paddle_tpu.config import dump_trainer_config as jdump_trainer
from paddle_tpu.param.optimizers import Adam as JAdam
from paddle_tpu.proto import model_config_pb2 as ref

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.v2.networks as tnet
from paddle_tpu_torch import config as tconfig
from paddle_tpu_torch.config import (SerializationError, build_optimizer,
                                     build_topology, dump_model_config,
                                     dump_trainer_config, parse_protostr,
                                     protostr)
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.proto import model_config_pb2 as pb
from paddle_tpu_torch.utils.error import ConfigError

import torch_golden_nets as G

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
NETS = sorted(G.GOLDEN_NETS)


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


def _blank(mc):
    mc.framework_version = ""
    mc.dtype_policy = ""
    return mc


@functools.lru_cache(maxsize=None)
def _port(name):
    with compute_dtype_scope("float32"):
        tnn.reset_naming()
        topo, feed_fn = G.GOLDEN_NETS[name](tnn, tnet, "cpu")
        return topo, feed_fn, _blank(dump_model_config(topo, name))


@functools.lru_cache(maxsize=None)
def _reference(name):
    jnn.reset_naming()
    topo, _ = G.GOLDEN_NETS[name](jnn, jnet)
    return _blank(jdump(topo, name))


def _simple_net(nn, device=None):
    """``tests/test_config.py::_simple_net`` for either package."""
    nn.reset_naming()
    img = nn.data("img", size=1, height=8, width=8)
    conv = nn.img_conv(img, filter_size=3, num_filters=4, act="relu",
                       name="conv1")
    pool = nn.img_pool(conv, pool_size=2, stride=2, name="pool1")
    h = nn.fc(pool, 32, act="tanh", name="hidden")
    out = nn.fc(h, 10, act="softmax", name="output")
    lbl = nn.data("label", size=10, dtype="int32")
    cost = nn.classification_cost(input=out, label=lbl, name="cost")
    return (nn.Topology(cost) if device is None
            else nn.Topology(cost, device=device))


# ---------------------------------------------------------------------------
# the codec against google.protobuf
# ---------------------------------------------------------------------------


def test_schema_matches_the_reference_descriptor():
    assert list(pb.MESSAGES) == [
        m.name for m in ref.DESCRIPTOR.message_types_by_name.values()]
    for name, cls in pb.MESSAGES.items():
        d = getattr(ref, name).DESCRIPTOR
        want = [(f.name, f.number, f.is_repeated,
                 f.containing_oneof.name if f.containing_oneof else None,
                 f.message_type.name if f.message_type else None)
                for f in d.fields]
        got = [(f.name, f.number, f.repeated, f.oneof,
                f.cls.__name__ if f.is_message else None)
               for f in cls._fields.values()]
        assert got == want, name


@pytest.mark.parametrize("name", NETS)
def test_golden_net_bytes_equal_the_reference_pb2(name):
    """The port's dump serializes to the reference ``_pb2``'s bytes of the
    JAX package's dump; each parses the other's bytes and re-serializes
    them unchanged; the text form round-trips in both codecs."""
    mine = _port(name)[2]
    theirs = _reference(name)
    b = mine.SerializeToString()
    assert b == theirs.SerializeToString()
    back = ref.ModelConfig()
    back.ParseFromString(b)
    assert back == theirs
    again = pb.ModelConfig()
    again.ParseFromString(theirs.SerializeToString())
    assert again == mine and again.SerializeToString() == b
    text = protostr(mine)
    assert text == text_format.MessageToString(theirs)
    assert parse_protostr(text) == mine
    assert text_format.Parse(text, ref.ModelConfig()) == theirs


def test_trainer_config_bytes_equal_the_reference_pb2():
    jnn.reset_naming()
    jt = _simple_net(jnn)
    jopt = JAdam(learning_rate=3e-4, beta1=0.85,
                 gradient_clipping_threshold=5.0)
    jopt.learning_rate_schedule = "poly"
    jopt.schedule_args = {"decay_a": 1e-3}
    theirs = jdump_trainer(jt, jopt, batch_size=32, num_passes=2,
                           seed=2 ** 63 + 7, save_dir="ck/é")
    _blank(theirs.model)
    tt = _simple_net(tnn, "cpu")
    opt = Adam(learning_rate=3e-4, beta1=0.85,
               gradient_clipping_threshold=5.0)
    opt.learning_rate_schedule = "poly"
    opt.schedule_args = {"decay_a": 1e-3}
    mine = dump_trainer_config(tt, opt, batch_size=32, num_passes=2,
                               seed=2 ** 63 + 7, save_dir="ck/é")
    _blank(mine.model)
    assert json.loads(mine.optimizer.config_json) == json.loads(
        theirs.optimizer.config_json)
    assert mine.SerializeToString() == theirs.SerializeToString()
    assert protostr(mine) == text_format.MessageToString(theirs)
    assert parse_protostr(protostr(mine), pb.TrainerConfig) == mine
    opt2 = build_optimizer(mine.optimizer)
    assert type(opt2) is Adam and opt2.beta1 == pytest.approx(0.85)
    assert opt2.learning_rate_schedule == "poly"
    step = torch.tensor(100.0)
    assert float(opt2.lr_at(step)) == pytest.approx(float(opt.lr_at(step)))
    # the mesh's axis names and sizes, as the reference writes a built mesh
    from paddle_tpu_torch.parallel import MeshConfig

    meshed = dump_trainer_config(tt, opt, mesh=MeshConfig.of(data=4,
                                                             model=2))
    assert list(meshed.mesh_axes) == ["data", "model"]
    assert list(meshed.mesh_shape) == [4, 2]
    assert parse_protostr(protostr(meshed), pb.TrainerConfig) == meshed
    # the reference reads a built mesh's axis names and device array shape
    from types import SimpleNamespace

    theirs_meshed = jdump_trainer(
        jt, jopt, mesh=SimpleNamespace(axis_names=("data", "model"),
                                       devices=np.empty((4, 2))))
    _blank(meshed.model)
    _blank(theirs_meshed.model)
    assert meshed.SerializeToString() == theirs_meshed.SerializeToString()


_TEXT = st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)),
                max_size=12)
_DOUBLE = st.one_of(st.floats(allow_nan=True, allow_infinity=True),
                    st.sampled_from([0.0, -0.0, 1e-5, 1e300, 5e-324]))
_I64 = st.integers(-(2 ** 63), 2 ** 63 - 1)
_I32 = st.integers(-(2 ** 31), 2 ** 31 - 1)
_TYPED = ["fc", "conv", "pool", "batch_norm", "lstm", "gru", "embedding",
          "cost", "seq", "dropout", "elem", "norm", "crf", "ctc",
          "sampled_cost", "mixed", "group_rnn", "step", None]


def _value(ftype, draw):
    return draw({"int32": _I32, "int64": _I64, "uint64":
                 st.integers(0, 2 ** 64 - 1), "bool": st.booleans(),
                 "double": _DOUBLE, "string": _TEXT}[ftype])


@st.composite
def _message_spec(draw, cls, depth=0):
    """{field: value | [values] | spec}: a random message of ``cls``."""
    spec = {}
    oneof_pick = {o: draw(st.sampled_from(list(names) + [None]))
                  for o, names in cls._oneofs.items()}
    for f in cls._fields.values():
        if f.oneof is not None:
            if oneof_pick[f.oneof] == f.name:
                spec[f.name] = draw(_message_spec(f.cls, depth + 1))
            continue
        if not draw(st.booleans()):
            continue
        if f.is_message:
            if depth >= 2:
                continue
            if f.repeated:
                spec[f.name] = [draw(_message_spec(f.cls, depth + 1))
                                for _ in range(draw(st.integers(0, 2)))]
            else:
                spec[f.name] = draw(_message_spec(f.cls, depth + 1))
        elif f.repeated:
            spec[f.name] = [_value(f.type, draw)
                            for _ in range(draw(st.integers(0, 3)))]
        else:
            spec[f.name] = _value(f.type, draw)
    return spec


def _build(msg, spec):
    """Apply a spec to a message of either codec (same API)."""
    for k, v in spec.items():
        if isinstance(v, dict):
            sub = getattr(msg, k)
            sub.SetInParent()  # an empty oneof member is still set
            _build(sub, v)
        elif isinstance(v, list):
            for x in v:
                if isinstance(x, dict):
                    _build(getattr(msg, k).add(), x)
                else:
                    getattr(msg, k).append(x)
        else:
            setattr(msg, k, v)
    return msg


@settings(max_examples=150, deadline=None)
@given(st.sampled_from(["ModelConfig", "LayerConf", "ParameterConf",
                        "TrainerConfig", "MixedConf"]).flatmap(
    lambda n: st.tuples(st.just(n), _message_spec(pb.MESSAGES[n]))))
def test_random_messages_match_google_protobuf(named_spec):
    name, spec = named_spec
    mine = _build(pb.MESSAGES[name](), spec)
    theirs = _build(getattr(ref, name)(), spec)
    b = theirs.SerializeToString()
    assert mine.SerializeToString() == b
    text = text_format.MessageToString(theirs)
    assert pb.message_to_string(mine) == text
    back = pb.MESSAGES[name]()
    back.ParseFromString(b)
    assert back.SerializeToString() == b
    # a NaN's payload does not survive the text form, in either codec
    assert pb.parse(text, pb.MESSAGES[name]()).SerializeToString() == \
        text_format.Parse(text, getattr(ref, name)()).SerializeToString()
    if name == "LayerConf":
        assert mine.WhichOneof("typed") == theirs.WhichOneof("typed")


def test_codec_edge_cases():
    # a oneof member set to an empty message is written; reading is not
    lc = pb.LayerConf(output_index=-1)
    _ = lc.fc.size
    assert lc.WhichOneof("typed") is None
    lc.cost.cost_type = ""
    assert lc.WhichOneof("typed") == "cost"
    assert lc.SerializeToString() == (b"0" + b"\xff" * 9 + b"\x01"
                                      + b"\x82\x01\x00")
    lc.fc.size = 3  # setting another member clears the first
    assert lc.WhichOneof("typed") == "fc" and not lc.HasField("cost")
    # an unpacked repeated int64 parses too; unknown fields are skipped
    unpacked = b"\x10\x05\x10\x07" + b"\xa0\x06\x01" + b"\x0a\x01p"
    p = pb.ParameterConf()
    p.ParseFromString(unpacked)
    assert list(p.shape) == [5, 7] and p.name == "p"
    for bad in (b"\x0a\x05ab", b"\x10", b"\x0b"):
        with pytest.raises(pb.DecodeError):
            pb.ParameterConf().ParseFromString(bad)
    with pytest.raises(TypeError):
        p.name = 3
    with pytest.raises(ValueError):
        pb.LayerConf().output_index = 2 ** 31
    with pytest.raises(AttributeError):
        p.shape = [1]
    with pytest.raises(pb.ParseError):
        parse_protostr('name: "a"\nname: "b"\n')
    # -0.0 is written (its bits are not zero), as google.protobuf writes it
    assert pb.ParameterConf(initial_mean=-0.0).SerializeToString() \
        == b"!" + struct.pack("<d", -0.0)
    assert math.isnan(parse_protostr("initial_std: nan\n",
                                     pb.ParameterConf).initial_std)


# ---------------------------------------------------------------------------
# goldens, rebuild, typed contract
# ---------------------------------------------------------------------------


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.protostr")) as f:
        return f.read()


@pytest.mark.parametrize("name", NETS + ["simple_net"])
def test_golden_protostr(name):
    if name == "simple_net":
        mc = _blank(dump_model_config(_simple_net(tnn, "cpu"), name))
    else:
        mc = _port(name)[2]
    assert protostr(mc) == _golden(name)


@pytest.mark.parametrize("name", NETS)
def test_golden_rebuild_equivalence(name):
    topo, feed_fn, mc = _port(name)
    topo2 = build_topology(mc, device="cpu")
    assert [l.name for l in topo2.layers] == [l.name for l in topo.layers]
    assert {n: s.shape for n, s in topo2.param_specs.items()} == {
        n: s.shape for n, s in topo.param_specs.items()}
    params, state = topo.init(3)
    feed = feed_fn(np.random.RandomState(0))
    o1, _ = topo.apply(params, state, feed, rng=1)
    o2, _ = topo2.apply(params, state, feed, rng=1)
    cost = topo.outputs[0].name
    np.testing.assert_allclose(o2[cost].value.detach().numpy(),
                               o1[cost].value.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_typed_coverage_across_goldens():
    covered = total = 0
    for name in NETS:
        for lc in _port(name)[2].layers:
            if lc.type == "data":
                continue
            total += 1
            covered += bool(lc.WhichOneof("typed"))
    assert covered / total >= 0.8, (covered, total)


def test_typed_fields_validated_and_optional():
    mc = dump_model_config(_simple_net(tnn, "cpu"), "m")
    old = pb.ModelConfig()
    old.CopyFrom(mc)
    for lc in old.layers:
        if lc.WhichOneof("typed"):
            lc.ClearField(lc.WhichOneof("typed"))
    topo = build_topology(old, device="cpu")
    assert [o.name for o in topo.outputs] == list(mc.output_layer_names)
    bad = pb.ModelConfig()
    bad.CopyFrom(mc)
    next(lc for lc in bad.layers if lc.WhichOneof("typed") == "fc"
         ).fc.size += 1
    with pytest.raises(ConfigError, match="typed fc.size"):
        build_topology(bad, device="cpu")
    pinned = pb.ModelConfig()
    pinned.CopyFrom(mc)
    pinned.layers[1].device = "tp"
    # device_pin waits for the pipeline part of item 8
    with pytest.raises(ConfigError, match="pipeline.*Queue 1 item 8"):
        build_topology(pinned, device="cpu")
    reshaped = pb.ModelConfig()
    reshaped.CopyFrom(mc)
    reshaped.parameters[0].shape[0] += 1
    with pytest.raises(ConfigError, match="reshaped"):
        build_topology(reshaped, device="cpu")
    unknown = pb.ModelConfig()
    unknown.CopyFrom(mc)
    unknown.layers[1].type = "no_such_layer"
    with pytest.raises(ConfigError, match="unknown layer constructor"):
        build_topology(unknown, device="cpu")


def test_recording_keeps_only_the_passed_arguments():
    tnn.reset_naming()
    x = tnn.data("x", size=4)
    h = tnn.fc(x, 3, act="relu")
    cfg = h.meta["config"]
    assert cfg["fn"] == "fc" and cfg["out"] == -1
    assert set(cfg["kwargs"]) == {"input", "size", "act"}
    # the context-manager mixed layer records its sealed call
    with tnn.mixed(size=3, name="m") as m:
        m += tnn.full_matrix_projection(input=x)
        m += tnn.identity_projection(input=h)
    assert m.meta["config"]["fn"] == "mixed"
    proj = m.meta["config"]["kwargs"]["input"]
    assert [p.config["fn"] for p in proj] == ["full_matrix_projection",
                                              "identity_projection"]
    mc = dump_model_config(tnn.Topology(m, device="cpu"))
    assert [p.kind for p in mc.layers[-1].mixed.projections] == [
        "full_matrix", "identity"]
    assert tnn.graph.LAYER_TYPES.names() == []


def test_unserializable_graph_and_policy_fields():
    tnn.reset_naming()
    x = tnn.data("x", size=4)
    node = tnn.LayerOutput("custom", "custom", 4, [x], lambda c, p, a: a)
    with pytest.raises(SerializationError):
        dump_model_config(tnn.Topology(node, device="cpu"))
    mc = dump_model_config(_simple_net(tnn, "cpu"))
    assert mc.dtype_policy == "float32"
    assert mc.framework_version.startswith("paddle_tpu_torch")
    with compute_dtype_scope("bfloat16"):
        assert dump_model_config(_simple_net(tnn, "cpu")).dtype_policy \
            == "bfloat16"


@pytest.mark.parametrize("name,item", [
    ("export_aot", 10), ("export_aot_hlo", 10), ("load_exported", 10),
    ("build_aot_host", 10), ("BundleAotCache", 7), ("CompileCacheDir", 7),
    ("open_cache", 7), ("warm_bundle", 7)])
def test_config_exports_not_ported_name_their_item(name, item):
    """The AOT exports still raise naming item 10; the compile cache's
    exports (item 7) are ported: each resolves to the port's own
    ``config.compile_cache`` object instead of a refusal."""
    assert name in tconfig.__all__
    if item == 7:
        from paddle_tpu_torch.config import compile_cache

        assert getattr(tconfig, name) is getattr(compile_cache, name)
        return
    with pytest.raises(ConfigError, match=f"Queue 1 item {item}\\b"):
        getattr(tconfig, name)()


def test_rebuilt_params_apply_like_the_reference():
    """A config the JAX package dumped rebuilds in the port, and the
    rebuilt graph computes the JAX graph's loss from the same weights."""
    from paddle_tpu_torch.nn import params_from_jax

    jnn.reset_naming()
    jt, feed_fn = G.GOLDEN_NETS["lstm_textclf"](jnn, jnet)
    mc = pb.ModelConfig()
    mc.ParseFromString(jdump(jt, "m").SerializeToString())
    tt = build_topology(mc, device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(0))
    feed = feed_fn(np.random.RandomState(0))
    jo, _ = jt.apply(jp, js, feed)
    to, _ = tt.apply(params_from_jax(jp, device="cpu"),
                     params_from_jax(js, device="cpu"), feed)
    np.testing.assert_allclose(float(to["cost"].value),
                               float(np.asarray(jo["cost"].value)),
                               rtol=1e-5, atol=1e-6)
