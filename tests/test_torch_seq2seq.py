"""The port's flagship model (paddle_tpu_torch/models/seq2seq.py) against the
JAX package's Seq2SeqAttention, with the JAX parameters carried across by
``params_from_jax``.

Small widths, mixed source lengths.  Encoder outputs rtol 1e-5 (the
tolerance of ``tests/test_rnn_fused.py``); generated ids exactly; scores
within 1e-5 (``tests/test_decode.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
from paddle_tpu.models import Seq2SeqAttention as JaxSeq2Seq
from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention, params_from_jax
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.ops.sequence import mask_from_lengths

CFG = dict(src_vocab=90, trg_vocab=300, emb_dim=16, enc_dim=24, dec_dim=32,
           att_dim=20)


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


@pytest.fixture(scope="module")
def pair():
    jm = JaxSeq2Seq(**CFG)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = Seq2SeqAttention(**CFG, device="cpu")
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, jp, tm, tp


def _src(rng, B=5, S=9):
    src = rng.randint(3, CFG["src_vocab"], (B, S)).astype(np.int32)
    src_len = rng.randint(1, S + 1, (B,)).astype(np.int32)
    src_len[0] = S
    return src, src_len


def test_params_from_jax_keeps_names_layouts_and_values(pair):
    jm, jp, tm, tp = pair
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == tuple(v.shape), k
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))
    own = tm.init(seed=0)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def test_encode_matches_jax(pair, rng):
    jm, jp, tm, tp = pair
    src, src_len = _src(rng)
    S = src.shape[1]
    j_enc, j_proj, j_s0 = jm.encode(
        jp, jnp.asarray(src), JO.mask_from_lengths(jnp.asarray(src_len), S))
    t_enc, t_proj, t_s0 = tm.encode(
        tp, torch.from_numpy(src).long(),
        mask_from_lengths(torch.from_numpy(src_len), S))
    for t, j in ((t_enc, j_enc), (t_proj, j_proj), (t_s0, j_s0)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("K,L,lp", [(3, 8, 0.0), (4, 6, 0.6), (1, 7, 0.0)])
def test_beam_search_matches_jax(pair, rng, K, L, lp):
    jm, jp, tm, tp = pair
    src, src_len = _src(rng)
    jt, js = jm.beam_search(jp, jnp.asarray(src), jnp.asarray(src_len),
                            beam_size=K, max_len=L, length_penalty=lp)
    tt, ts = tm.beam_search(tp, src, src_len, beam_size=K, max_len=L,
                            length_penalty=lp)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_greedy_decode_matches_jax_and_beam1(pair, rng):
    jm, jp, tm, tp = pair
    src, src_len = _src(rng, B=4)
    jt, js = jm.greedy_decode(jp, jnp.asarray(src), jnp.asarray(src_len),
                              max_len=7)
    tt, ts = tm.greedy_decode(tp, src, src_len, max_len=7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    bt, bs = tm.beam_search(tp, src, src_len, beam_size=1, max_len=7)
    np.testing.assert_array_equal(tt.numpy(), bt[:, 0].numpy())


def test_bf16_policy_generates_finite_scores(pair, rng):
    """The default bf16 compute policy runs the same path end to end:
    enc/enc_proj leave the encoder in bf16, scores stay finite f32."""
    _, _, tm, tp = pair
    src, src_len = _src(rng, B=3)
    with compute_dtype_scope("bfloat16"):
        enc, proj, s0 = tm.encode(
            tp, torch.from_numpy(src).long(),
            mask_from_lengths(torch.from_numpy(src_len), src.shape[1]))
        toks, scores = tm.beam_search(tp, src, src_len, beam_size=3,
                                      max_len=5)
    assert enc.dtype == proj.dtype == torch.bfloat16
    assert s0.dtype == torch.float32
    assert toks.shape == (3, 3, 5) and scores.dtype == torch.float32
    assert torch.isfinite(scores).all()
    assert (toks < CFG["trg_vocab"]).all() and (toks >= 0).all()
