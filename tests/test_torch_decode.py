"""The port's decode engine (paddle_tpu_torch/ops/decode.py) against the
JAX package's (paddle_tpu/ops/decode.py) on a toy GRU LM.

The same numpy weights go through both packages; both read the same
``LinearReadout`` (the JAX one takes its XLA top-k path on the CPU, the
port's its plain readout).  Ids must match exactly and scores within 1e-5,
the tolerance ``tests/test_decode.py`` pins against its reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
import paddle_tpu.ops.decode as JD
import paddle_tpu_torch.ops as TO
import paddle_tpu_torch.ops.decode as TD
from paddle_tpu_torch.ops.numerics import compute_dtype_scope

V, H = 12, 8


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _lm(rng, eos_boost=3.0):
    """EOS-prone toy GRU LM (beams really finish) in both packages."""
    p = {
        "emb": (0.5 * rng.randn(V, H)).astype(np.float32),
        "wx": (0.5 * rng.randn(H, 3 * H)).astype(np.float32),
        "wh": (0.5 * rng.randn(H, 3 * H)).astype(np.float32),
        "out": rng.randn(H, V).astype(np.float32),
        "outb": (np.eye(1, V, 1)[0] * eos_boost).astype(np.float32),
    }
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    def j_step(tokens, state):
        e = jnp.take(jp["emb"], tokens, axis=0)
        h2 = JO.gru_step(JO.linear(e, jp["wx"]), state["h"], jp["wh"])
        return h2, {"h": h2}

    def t_step(tokens, state):
        e = TO.embedding_lookup(tp["emb"], tokens)
        h2 = TO.gru_step(TO.linear(e, tp["wx"]), state["h"], tp["wh"])
        return h2, {"h": h2}

    return (j_step, JD.LinearReadout(jp["out"], jp["outb"]),
            t_step, TD.LinearReadout(tp["out"], tp["outb"]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("K,L,lp,early", [(3, 10, 0.0, True),
                                          (4, 7, 0.6, True),
                                          (1, 6, 0.0, True),
                                          (3, 9, 0.0, False),
                                          (13, 5, 0.0, True)])
def test_beam_decode_matches_jax(rng, K, L, lp, early):
    j_step, j_ro, t_step, t_ro = _lm(rng)
    h0 = rng.randn(3, H).astype(np.float32)
    kw = dict(batch_size=3, beam_size=K, vocab_size=V, max_len=L,
              length_penalty=lp, early_exit=early)
    jt, js = JD.beam_decode(j_step, j_ro, {"h": jnp.asarray(h0)}, **kw)
    tt, ts = TD.beam_decode(t_step, t_ro, {"h": torch.from_numpy(h0)}, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("early", [True, False])
def test_greedy_decode_matches_jax_and_beam1(rng, early):
    j_step, j_ro, t_step, t_ro = _lm(rng)
    h0 = rng.randn(4, H).astype(np.float32)
    kw = dict(batch_size=4, vocab_size=V, max_len=9, early_exit=early)
    jt, js = JD.greedy_decode(j_step, j_ro, {"h": jnp.asarray(h0)}, **kw)
    tt, ts = TD.greedy_decode(t_step, t_ro, {"h": torch.from_numpy(h0)}, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    bt, bs = TD.beam_decode(t_step, t_ro, {"h": torch.from_numpy(h0)},
                            beam_size=1, **kw)
    np.testing.assert_array_equal(tt.numpy(), bt[:, 0].numpy())
    np.testing.assert_allclose(ts.numpy(), bs[:, 0].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_early_exit_equals_full_length_and_finished_beams_emit_eos(rng):
    _, _, t_step, t_ro = _lm(rng, eos_boost=8.0)
    h0 = {"h": torch.from_numpy(rng.randn(2, H).astype(np.float32))}
    kw = dict(batch_size=2, beam_size=3, vocab_size=V, max_len=12)
    te, se = TD.beam_decode(t_step, t_ro, h0, early_exit=True, **kw)
    tf, sf = TD.beam_decode(t_step, t_ro, h0, early_exit=False, **kw)
    assert torch.equal(te, tf) and torch.equal(se, sf)
    toks = te.numpy()
    assert (toks == 1).any()
    for row in toks.reshape(-1, toks.shape[-1]):
        if (row == 1).any():
            assert np.all(row[int(np.argmax(row == 1)):] == 1), row


@pytest.mark.parametrize("vocab,k,eos", [(12, 3, 1), (12, 1, 1), (5, 5, 0),
                                         (3, 3, 2)])
def test_eos_candidates_match_jax(vocab, k, eos):
    jt, jv = JD._eos_candidates(vocab, k, eos)
    tt, tv = TD._eos_candidates(vocab, k, eos, "cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert TD.NEG == JD.NEG == -1e9


def test_beam_gather_matches_jax(rng):
    B, K = 3, 4
    ix = rng.randint(0, K, (B, K))
    tree = {"s": rng.randn(B * K, 5).astype(np.float32),
            "tokens": rng.randint(0, 9, (B, K, 7)),
            "h2": rng.randn(B * K, 2, 3).astype(np.float32),
            "fin": rng.rand(B, K) > 0.5}
    jg = JD.beam_gather({k: jnp.asarray(v) for k, v in tree.items()},
                        jnp.asarray(ix))
    tg = TD.beam_gather({k: torch.from_numpy(v) for k, v in tree.items()},
                        torch.from_numpy(ix))
    for name in tree:
        np.testing.assert_array_equal(tg[name].numpy(), np.asarray(jg[name]),
                                      err_msg=name)
    with pytest.raises(ValueError):
        TD.beam_gather({"bad": torch.zeros(B * K + 1, 2)},
                       torch.from_numpy(ix))


def _assert_carry_equal(tc, jc, *, rtol=1e-5, atol=1e-5):
    for key in ("tokens", "finished", "active", "step"):
        np.testing.assert_array_equal(_np(tc[key]), _np(jc[key]),
                                      err_msg=key)
    np.testing.assert_allclose(_np(tc["logp"]), _np(jc["logp"]), rtol=rtol,
                               atol=atol)
    for key in tc["state"]:
        np.testing.assert_allclose(_np(tc["state"][key]),
                                   _np(jc["state"][key]), rtol=rtol,
                                   atol=atol, err_msg=key)


def test_slot_api_matches_jax_on_the_same_carry(rng):
    """init_slot_carry / write_slot / decode_step / release_slot /
    finalize_slots move both packages' carries identically, including
    slots admitted mid-flight and a freed slot held frozen."""
    j_step, j_ro, t_step, t_ro = _lm(rng)
    S, K, L = 3, 3, 6
    tpl = rng.randn(1, H).astype(np.float32)
    jc = JD.init_slot_carry({"h": jnp.asarray(tpl)}, slots=S, beam_size=K,
                            max_len=L)
    tc = TD.init_slot_carry({"h": torch.from_numpy(tpl)}, slots=S,
                            beam_size=K, max_len=L)
    _assert_carry_equal(tc, jc)
    feeds = rng.randn(2, H).astype(np.float32)

    def write(slot, row):
        nonlocal jc
        jc = JD.write_slot(jc, slot, {"h": jnp.asarray(feeds)}, row=row)
        TD.write_slot(tc, slot, {"h": torch.from_numpy(feeds)}, row=row)

    def step():
        nonlocal jc, tc
        jc = JD.decode_step(j_step, j_ro, jc, vocab_size=V)
        before = {k: v.clone() for k, v in tc.items() if k != "state"}
        tc_new = TD.decode_step(t_step, t_ro, tc, vocab_size=V)
        for k, v in before.items():       # the input carry is untouched
            assert torch.equal(v, tc[k]), k
        tc = tc_new

    write(2, 0)
    step()
    write(0, 1)
    step()
    step()
    _assert_carry_equal(tc, jc)
    jc = JD.release_slot(jc, 2)
    TD.release_slot(tc, 2)
    frozen = tc["tokens"][2].clone()
    step()
    _assert_carry_equal(tc, jc)
    assert torch.equal(tc["tokens"][2], frozen)
    for lp in (0.0, 0.7):
        jt, js = JD.finalize_slots(jc, length_penalty=lp)
        tt, ts = TD.finalize_slots(tc, length_penalty=lp)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)


def test_finalize_sorts_ties_stably_like_jax_argsort():
    tokens = np.tile(np.arange(4)[None, :, None], (2, 1, 5)).astype(np.int64)
    logp = np.array([[-1.0, -0.5, -1.0, -0.5], [-2.0, -2.0, -2.0, -2.0]],
                    np.float32)
    jt, js = JD._finalize(jnp.asarray(tokens.astype(np.int32)),
                          jnp.asarray(logp), eos=1, length_penalty=0.0)
    tt, ts = TD._finalize(torch.from_numpy(tokens), torch.from_numpy(logp),
                          eos=1, length_penalty=0.0)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
