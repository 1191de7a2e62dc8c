"""The port's DSL generation path (paddle_tpu_torch/nn: ``concat``,
``grumemory``, ``first_seq``/``last_seq``, ``mixed`` with
``full_matrix_projection``, ``gru_step``, ``recurrent_group``,
``beam_search``, ``SequenceGenerator``; paddle_tpu_torch/v2/networks)
against the JAX package.

Each graph is built twice from the same code, once with ``paddle_tpu.nn``
and once with ``paddle_tpu_torch.nn``; the JAX ``Topology.init``'s
parameters are carried across by ``params_from_jax`` and the same numpy
feed goes through both.  Float32 policy on both sides.  Layer outputs
within rtol 1e-5 / atol 1e-6 (``tests/test_torch_nn.py``'s); generated ids
equal and scores within 1e-5 (``tests/test_recurrent_group.py``'s); the
golden fixture as ``tests/test_recurrent_group.py`` reads it (ids exact,
scores 1e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.ops as JO
import paddle_tpu.v2.networks as jnet
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
import paddle_tpu_torch.v2.networks as tnet
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.utils.error import ConfigError
from torch_seqtoseq_net import seqtoseq_generator

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "beam_golden.npz")


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _both(build, seed=1):
    """Build with each package's DSL (fresh names each) -> (JAX topology,
    port topology on the CPU, JAX params with nonzero biases, port params,
    the two output layers)."""
    jnn.reset_naming()
    jout = build(jnn, jnet)
    tnn.reset_naming()
    tout = build(tnn, tnet)
    jtopo = jnn.Topology(jout)
    ttopo = tnn.Topology(tout, device="cpu")
    jp, _ = jtopo.init(jax.random.PRNGKey(seed))
    r = np.random.RandomState(seed)
    jp = {k: (jnp.asarray((0.3 * r.randn(*v.shape)).astype(np.float32))
              if k.endswith(".wbias") else v) for k, v in jp.items()}
    assert set(jp) == set(ttopo.param_specs)
    tp = tnn.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                             "cpu")
    return jtopo, ttopo, jp, tp, jout, tout


def _feeds(feed):
    jf = {k: tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
          else jnp.asarray(v) for k, v in feed.items()}
    return jf, feed


def _seq(r, B, T, D, lens):
    return (r.randn(B, T, D).astype(np.float32), np.asarray(lens, np.int32))


# ---------------------------------------------------------------------------
# layers, one at a time
# ---------------------------------------------------------------------------

B, T = 3, 5
LENS = [5, 3, 1]


def _attention(nn, net):
    enc = nn.data("enc", size=8, is_seq=True)
    proj = nn.data("proj", size=4, is_seq=True)
    st = nn.data("st", size=6)
    return net.simple_attention(enc, proj, st, name="att")


def _mixed_ctx(nn, net):
    x = nn.data("x", size=5, is_seq=True)
    y = nn.data("y", size=3, is_seq=True)
    with nn.mixed(6, act="tanh", bias_attr=True, name="mx") as m:
        m += nn.full_matrix_projection(x)
        m += nn.full_matrix_projection(y)
    return m


LAYERS = {
    "concat": lambda nn, net: nn.concat(
        [nn.data("x", size=5, is_seq=True), nn.data("y", size=3,
                                                    is_seq=True)]),
    "grumemory": lambda nn, net: nn.grumemory(
        nn.data("x", size=5, is_seq=True), 6, name="g"),
    "grumemory_reverse": lambda nn, net: nn.grumemory(
        nn.data("x", size=5, is_seq=True), 6, reverse=True, name="g"),
    "grumemory_projected": lambda nn, net: nn.grumemory(
        nn.data("p", size=18, is_seq=True), projected_input=True,
        reverse=True, name="g"),
    "first_seq": lambda nn, net: nn.first_seq(nn.data("x", size=5,
                                                      is_seq=True)),
    "last_seq": lambda nn, net: nn.last_seq(nn.data("x", size=5,
                                                    is_seq=True)),
    "mixed_eager": lambda nn, net: nn.mixed(
        6, input=[nn.full_matrix_projection(nn.data("u", size=4)),
                  nn.full_matrix_projection(nn.data("w", size=2))],
        bias_attr=True, name="mx"),
    "mixed_context_manager": _mixed_ctx,
    "gru_step": lambda nn, net: nn.gru_step(
        nn.data("xp", size=18), nn.data("h", size=6), name="gs"),
    "simple_attention": _attention,
    "gru_unit": lambda nn, net: net.gru_unit(
        nn.data("xp", size=18), nn.data("h", size=6), size=6,
        gru_bias_attr=False, name="gu"),
    "gru_group": lambda nn, net: net.gru_group(
        nn.data("p", size=18, is_seq=True), 6, name="gg"),
    "gru_group_reverse": lambda nn, net: net.gru_group(
        nn.data("p", size=18, is_seq=True), 6, reverse=True, name="gg"),
    "simple_gru": lambda nn, net: net.simple_gru(
        nn.data("x", size=5, is_seq=True), 6, name="sg"),
    "bidirectional_gru": lambda nn, net: net.bidirectional_gru(
        nn.data("x", size=5, is_seq=True), 6, name="bg"),
}


def _layer_feed(r):
    return {"x": _seq(r, B, T, 5, LENS), "y": _seq(r, B, T, 3, LENS),
            "p": _seq(r, B, T, 18, LENS),
            "enc": _seq(r, B, T, 8, LENS), "proj": _seq(r, B, T, 4, LENS),
            "u": r.randn(B, 4).astype(np.float32),
            "w": r.randn(B, 2).astype(np.float32),
            "xp": r.randn(B, 18).astype(np.float32),
            "h": r.randn(B, 6).astype(np.float32),
            "st": r.randn(B, 6).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_forward_matches_the_reference(case):
    jtopo, ttopo, jp, tp, jout, tout = _both(LAYERS[case])
    names = {l.name for l in ttopo.data_layers}
    feed = {k: v for k, v in _layer_feed(np.random.RandomState(2)).items()
            if k in names}
    jf, tf = _feeds(feed)
    jo, _ = jtopo.apply(jp, {}, jf, train=False)
    to, _ = ttopo.apply(tp, {}, tf, train=False)
    got, want = to[tout.name], jo[jout.name]
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-5, atol=1e-6)
    assert got.is_seq == (want.lengths is not None)
    if case == "simple_attention":
        np.testing.assert_allclose(got.state["weights"].numpy(),
                                   np.asarray(want.state["weights"]),
                                   rtol=1e-5, atol=1e-6)


def test_layer_config_errors():
    tnn.reset_naming()
    x = tnn.data("x", size=5, is_seq=True)
    with pytest.raises(ConfigError, match="projected_input"):
        tnn.grumemory(x, 6, projected_input=True)
    with pytest.raises(ConfigError, match="projections"):
        tnn.mixed(6, input=[x])
    with tnn.mixed(6) as m:
        m += tnn.full_matrix_projection(x)
    with pytest.raises(ConfigError, match="sealed"):
        m += tnn.full_matrix_projection(x)
    with pytest.raises(ConfigError, match="3\\*size"):
        tnn.gru_step(tnn.data("xp", size=10), tnn.data("h", size=3))


# ---------------------------------------------------------------------------
# recurrent groups
# ---------------------------------------------------------------------------


def _flat_group(nn, net):
    x = nn.data("x", size=5, is_seq=True)

    def step(x_t, h_prev):
        proj = nn.fc([x_t, h_prev], 5, act="tanh", bias_attr=False,
                     name="step_fc")
        return [proj, proj]

    return nn.recurrent_group(step, input=[x], memories=[nn.Memory("h", 5)],
                              name="group")


def _static_boot_group(nn, net):
    x = nn.data("x", size=5, is_seq=True)
    ctx_in = nn.data("u", size=4)
    boot = nn.fc(ctx_in, 6, act="tanh", name="boot_fc")

    def step(x_t, ctx_t, h_prev):
        s = nn.concat([x_t, ctx_t], name="mix")
        proj = nn.fc([s, h_prev], 6, act="tanh", name="sfc")
        return [proj, proj]

    return nn.recurrent_group(
        step, input=[x, nn.StaticInput(ctx_in)],
        memories=[nn.Memory("h", 6, boot=boot)], reverse=True, name="g")


@pytest.mark.parametrize("build", [_flat_group, _static_boot_group],
                         ids=["flat", "static_and_boot_reverse"])
def test_recurrent_group_matches_the_reference(build):
    jtopo, ttopo, jp, tp, jout, tout = _both(build)
    feed = {k: v for k, v in _layer_feed(np.random.RandomState(3)).items()
            if k in ("x", "u")}
    jf, tf = _feeds(feed)
    jo, _ = jtopo.apply(jp, {}, jf, train=False)
    to, _ = ttopo.apply(tp, {}, tf, train=False)
    np.testing.assert_allclose(to[tout.name].value.numpy(),
                               np.asarray(jo[jout.name].value), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(to[tout.name].lengths, torch.tensor(LENS,
                                                           dtype=torch.int32))


def test_group_decoder_matches_the_ports_attention_decoder():
    """``tests/test_seq2seq_group_decoder.py`` in the port: the reference's
    seqToseq decoder step (simple_attention + mixed + gru_unit) in a
    recurrent_group equals ``ops.attention_gru_decoder``."""
    Bd, S, Td = 2, 5, 4
    E, H2, A, D = 6, 8, 4, 4
    tnn.reset_naming()
    y = tnn.data("y_emb", size=E, is_seq=True)
    enc_l = tnn.data("enc", size=H2, is_seq=True)
    encp_l = tnn.data("enc_proj", size=A, is_seq=True)
    s0_l = tnn.data("s0", size=D)

    def step(y_t, enc_s, encp_s, s_mem):
        ctx = tnet.simple_attention(enc_s, encp_s, s_mem, name="att")
        m = tnn.mixed(3 * D, input=[tnn.full_matrix_projection(y_t),
                                    tnn.full_matrix_projection(ctx)],
                      bias_attr=True, name="dec_in")
        h = tnet.gru_unit(m, s_mem, size=D, gru_bias_attr=False,
                          name="dec_gru")
        return [h, h]

    grp = tnn.recurrent_group(
        step, input=[y, tnn.StaticInput(enc_l), tnn.StaticInput(encp_l)],
        memories=[tnn.Memory("s", D, boot=s0_l)], name="dec")
    topo = tnn.Topology(grp, device="cpu")
    params, _ = topo.init(1)
    params["_dec_in.wbias"] = 0.3 * torch.randn(3 * D)
    r = np.random.RandomState(0)
    y_emb, enc = r.randn(Bd, Td, E), r.randn(Bd, S, H2)
    enc_proj, s0 = r.randn(Bd, S, A), r.randn(Bd, D)
    src_len, trg_len = np.array([S, 3]), np.array([Td, 2])
    f = {k: v.astype(np.float32) for k, v in dict(
        y_emb=y_emb, enc=enc, enc_proj=enc_proj, s0=s0).items()}
    outs, _ = topo.apply(params, {}, {
        "y_emb": (f["y_emb"], trg_len), "enc": (f["enc"], src_len),
        "enc_proj": (f["enc_proj"], src_len), "s0": f["s0"]})
    got = outs["dec"].value
    src_mask = TO.mask_from_lengths(torch.from_numpy(src_len), S)
    trg_mask = TO.mask_from_lengths(torch.from_numpy(trg_len), Td)
    want = TO.attention_gru_decoder(
        torch.from_numpy(f["y_emb"]), torch.from_numpy(f["s0"]),
        torch.from_numpy(f["enc"]), torch.from_numpy(f["enc_proj"]),
        src_mask, trg_mask, params["_att.w0"], params["_att.v"],
        torch.cat([params["_dec_in.w0"], params["_dec_in.w1"]], 0),
        params["_dec_in.wbias"], params["_dec_gru.w0"])
    m = trg_mask[..., None]
    torch.testing.assert_close(got * m, want * m, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# SequenceGenerator
# ---------------------------------------------------------------------------


def _lm(V=20, H=8, seed=0, scale=(0.1, 0.5, 0.5, 0.5)):
    """Functional GRU LM for the generator protocol, in both packages,
    from numpy weights."""
    r = np.random.RandomState(seed)
    p = {"emb": scale[0] * r.randn(V, H), "wx": scale[1] * r.randn(H, 3 * H),
         "wh": scale[2] * r.randn(H, 3 * H), "out": scale[3] * r.randn(H, V)}
    p = {k: v.astype(np.float32) for k, v in p.items()}

    def j_step(params, tokens, mems):
        e = jnp.take(params["emb"], tokens, axis=0)
        h2 = JO.gru_step(JO.linear(e, params["wx"]), mems["h"], params["wh"])
        return JO.linear(h2, params["out"]), {"h": h2}

    def t_step(params, tokens, mems):
        e = TO.embedding_lookup(params["emb"], tokens)
        h2 = TO.gru_step(TO.linear(e, params["wx"]), mems["h"], params["wh"])
        return TO.linear(h2, params["out"]), {"h": h2}

    return ({k: jnp.asarray(v) for k, v in p.items()}, j_step,
            {k: torch.from_numpy(v) for k, v in p.items()}, t_step)


def _generate_both(V, K, L, h0, *, lm=None, **kw):
    jp, j_step, tp, t_step = lm or _lm(V=V)
    Bg = h0.shape[0]
    jr = jnn.SequenceGenerator(j_step, vocab_size=V).generate(
        jp, {"h": jnp.asarray(h0)}, batch_size=Bg, beam_size=K, max_len=L,
        **kw.get("j", {}))
    tr = tnn.SequenceGenerator(t_step, vocab_size=V).generate(
        tp, {"h": torch.from_numpy(h0)}, batch_size=Bg, beam_size=K,
        max_len=L, **kw.get("t", {}))
    return jr, tr


def _assert_generated_same(jr, tr, atol=1e-5):
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    np.testing.assert_allclose(tr[1].numpy(), np.asarray(jr[1]), rtol=1e-5,
                               atol=atol)


# (V, K, L, length penalty, early exit): K=20 > 16 takes the readout's
# unfused statistics, K=1 is greedy through the beam engine
@pytest.mark.parametrize("V,K,L,lp,early", [
    (20, 3, 7, 0.0, True), (20, 4, 7, 0.6, False), (40, 20, 5, 0.0, True),
    (20, 1, 6, 0.0, None)])
def test_generator_matches_the_reference(V, K, L, lp, early):
    h0 = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    opts = dict(length_penalty=lp, early_exit=early)
    jr, tr = _generate_both(V, K, L, h0, j=opts, t=opts)
    _assert_generated_same(jr, tr)
    assert tr[0].dtype == torch.int64


def _callbacks(kind):
    """The same beam-control callback in both packages."""
    if kind == "adjust":
        return (dict(candidate_adjust_fn=lambda lp, tokens, t:
                     lp.at[:, :, 7].set(-1e9)),
                dict(candidate_adjust_fn=lambda lp, tokens, t:
                     lp.index_fill(2, torch.tensor([7]), -1e9)))
    if kind == "drop":
        return (dict(drop_fn=lambda tokens, scores, t: jnp.tile(
                    (jnp.arange(scores.shape[1]) > 0)[None],
                    (scores.shape[0], 1))),
                dict(drop_fn=lambda tokens, scores, t: (
                    torch.arange(scores.shape[1]) > 0)[None].expand_as(
                        scores)))
    return dict(return_trace=True), dict(return_trace=True)


@pytest.mark.parametrize("kind", ["adjust", "drop", "trace"])
def test_generator_callbacks_match_the_reference(kind):
    h0 = np.random.RandomState(2).randn(2, 8).astype(np.float32)
    j_opts, t_opts = _callbacks(kind)
    jr, tr = _generate_both(20, 3, 6, h0, j=j_opts, t=t_opts)
    _assert_generated_same(jr, tr)
    if kind == "adjust":
        assert not (tr[0] == 7).any()
    if kind == "drop":
        assert (tr[1][:, 1:] <= -1e8).all() and (tr[1][:, 0] > -1e8).all()
    if kind == "trace":
        for key in ("parent", "token", "order"):
            np.testing.assert_array_equal(tr[2][key].numpy(),
                                          np.asarray(jr[2][key]))
        np.testing.assert_allclose(tr[2]["score"].numpy(),
                                   np.asarray(jr[2]["score"]), rtol=1e-5,
                                   atol=1e-5)
        assert tuple(tr[2]["parent"].shape) == (6, 2, 3)


def _oracle_lm():
    """``tests/test_recurrent_group.py``'s TestBeamOracle LM: V=4, H=8,
    RandomState(42), stable forever."""
    r = np.random.RandomState(42)
    V, H = 4, 8
    p = {"emb": r.randn(V, H), "wx": 0.5 * r.randn(H, 3 * H),
         "wh": 0.5 * r.randn(H, 3 * H), "out": r.randn(H, V)}
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}

    def step(params, tokens, mems):
        e = TO.embedding_lookup(params["emb"], tokens)
        h2 = TO.gru_step(TO.linear(e, params["wx"]), mems["h"], params["wh"])
        return TO.linear(h2, params["out"]), {"h": h2}

    return p, step


def test_exhaustive_beam_equals_brute_force():
    """Beam width V^L = 64 holds every path: the search finds the global
    best and the exact score of every genuine path (the reference's
    oracle, scores within 1e-5)."""
    import itertools

    V, L, K = 4, 3, 64
    params, step = _oracle_lm()
    gen = tnn.SequenceGenerator(step, vocab_size=V)
    toks, scores = gen.generate(params, {"h": torch.zeros(1, 8)},
                                batch_size=1, beam_size=K, max_len=L)
    toks, scores = toks[0].numpy(), scores[0].numpy()
    seqs = np.array(list(itertools.product(range(V), repeat=L)))
    N = len(seqs)
    h, prev = torch.zeros(N, 8), torch.zeros(N, dtype=torch.long)
    total = np.zeros(N)
    alive, genuine = np.ones(N, bool), np.ones(N, bool)
    for t in range(L):
        logits, mems = step(params, prev, {"h": h})
        lp = torch.log_softmax(logits, -1).numpy()
        tok = seqs[:, t]
        total += np.where(alive, lp[np.arange(N), tok], 0.0)
        genuine &= alive | (tok == 1)
        alive &= tok != 1
        h, prev = mems["h"], torch.from_numpy(tok)
    oracle = {tuple(s): total[i] for i, s in enumerate(seqs) if genuine[i]}
    best = max(oracle, key=oracle.get)
    assert tuple(toks[0]) == best
    found = {tuple(toks[k]): scores[k] for k in range(K) if scores[k] > -1e8}
    assert len(found) == sum(scores > -1e8) and set(found) == set(oracle)
    for key, s in found.items():
        np.testing.assert_allclose(s, oracle[key], rtol=1e-5, atol=1e-5)


def test_golden_fixture():
    """``tests/golden/beam_golden.npz``, read as data: RandomState(42)
    model, two initial states from RandomState(7), beam 4, length 5; ids
    exact, scores within 1e-4."""
    params, step = _oracle_lm()
    h0 = torch.from_numpy(np.random.RandomState(7).randn(2, 8).astype(
        np.float32))
    toks, scores = tnn.SequenceGenerator(step, vocab_size=4).generate(
        params, {"h": h0}, batch_size=2, beam_size=4, max_len=5)
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(toks.numpy(), g["tokens"])
    np.testing.assert_allclose(scores.numpy(), g["scores"], rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the beam_search layer
# ---------------------------------------------------------------------------


def _lm_layer_net(nn, V=15, H=8, E=6):
    """``tests/test_recurrent_group.py``'s TestBeamSearchLayer net."""
    ctx_in = nn.data("ctx", size=H)

    def step(prev_tok, ctx_static, mem):
        e = nn.embedding(prev_tok, E, name="gen_emb")
        h = nn.fc(nn.concat([e, ctx_static, mem]), H, act="tanh",
                  name="gen_h")
        return [nn.fc(h, V, act="linear", name="gen_out"), h]

    return nn.beam_search(
        step, input=[nn.GeneratedInput(size=V), nn.StaticInput(ctx_in)],
        memories=[nn.Memory("m", H, boot=ctx_in)], beam_size=3,
        max_length=7)


def test_beam_search_layer_equals_the_generator_on_its_step():
    """The layer produces exactly what ``SequenceGenerator`` produces when
    driven by the same step written as a function."""
    tnn.reset_naming()
    out = _lm_layer_net(tnn)
    topo = tnn.Topology([out], device="cpu")
    params, _ = topo.init(1)
    ctx = torch.from_numpy(np.random.RandomState(1).randn(2, 8).astype(
        np.float32))
    outs, _ = topo.apply(params, {}, {"ctx": ctx}, train=False)
    K = 3
    ctx_t = ctx.repeat_interleave(K, 0)

    def step_fn(p, tokens, mems):
        e = TO.embedding_lookup(p["_gen_emb.w0"], tokens)
        x = torch.cat([e, ctx_t, mems["m"]], -1)
        h = torch.tanh(TO.linear(x, p["_gen_h.w0"], p["_gen_h.wbias"]))
        return TO.linear(h, p["_gen_out.w0"], p["_gen_out.wbias"]), {"m": h}

    toks, scores = tnn.SequenceGenerator(step_fn, vocab_size=15).generate(
        params, {"m": ctx}, batch_size=2, beam_size=K, max_len=7)
    assert torch.equal(outs[out.name].value, toks)
    assert torch.equal(outs[out.name].state["scores"], scores)
    assert tuple(toks.shape) == (2, 3, 7)
    assert (scores[:, :-1] >= scores[:, 1:]).all()          # best first


def test_step_net_decides_no_device(monkeypatch):
    """Building a group decides no device (no card is needed to build one)
    and its step runs where the outer topology runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tnn.reset_naming()
    out = _lm_layer_net(tnn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.Topology([out])
    topo = tnn.Topology([out], device="cpu")
    params, _ = topo.init(0)
    outs, _ = topo.apply(params, {}, {"ctx": np.zeros((1, 8), np.float32)})
    assert outs[out.name].value.device.type == "cpu"


def test_beam_search_config_errors():
    tnn.reset_naming()

    def step(prev_tok, mem):
        e = tnn.embedding(prev_tok, 4)
        h = tnn.fc(tnn.concat([e, mem]), 6, act="tanh")
        return [tnn.fc(h, 10, act="linear"), h]

    with pytest.raises(ConfigError, match="batch size"):
        tnn.beam_search(step, input=[tnn.GeneratedInput(size=10)],
                        memories=[tnn.Memory("m", 6)])
    boot = tnn.data("b", size=6)
    with pytest.raises(ConfigError, match="vocab-size"):
        tnn.beam_search(step, input=[tnn.GeneratedInput(size=11)],
                        memories=[tnn.Memory("m", 6, boot=boot)])
    with pytest.raises(ConfigError, match="exactly one"):
        tnn.beam_search(step, input=[], memories=[tnn.Memory("m", 6,
                                                             boot=boot)])
    with pytest.raises(ConfigError, match="memory updates"):
        tnn.recurrent_group(lambda x_t, m: [x_t],
                            input=[tnn.data("x", size=6, is_seq=True)],
                            memories=[tnn.Memory("m", 6)])


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_seqtoseq_generation_matches_the_reference(seed):
    """The slice end to end: JAX-initialised parameters (biases nonzero,
    the readout scaled up so that beams part early), the same sources
    through both packages' ``beam_search`` layers: the same parameter
    names, identical ids, scores within rtol 1e-5."""
    jtopo, ttopo, jp, tp, jout, tout = _both(seqtoseq_generator, seed=seed)
    jp = dict(jp, **{"_readout.w0": jp["_readout.w0"] * 8.0})
    tp["_readout.w0"] = tp["_readout.w0"] * 8.0
    r = np.random.RandomState(seed)
    src = r.randint(3, 40, (3, 7)).astype(np.int32)
    lens = np.array([7, 4, 2], np.int32)
    jo, _ = jtopo.apply(jp, {}, {"src": (jnp.asarray(src),
                                         jnp.asarray(lens))}, train=False)
    to, _ = ttopo.apply(tp, {}, {"src": (src, lens)}, train=False)
    np.testing.assert_array_equal(to["gen"].value.numpy(),
                                  np.asarray(jo["gen"].value))
    np.testing.assert_allclose(to["gen"].state["scores"].numpy(),
                               np.asarray(jo["gen"].state["scores"]),
                               rtol=1e-5)
    assert len(set(map(tuple, to["gen"].value[:, 0].tolist()))) > 1
