"""The port's slot table (paddle_tpu_torch/serving/slots.py) on the CPU.

The contract of ``tests/test_serving_slots.py``: every request served
through the table equals a solo ``beam_search`` of that request, whatever
its admission order, slot or neighbours; slots recycle; ``merge_feeds``'
replicated pad rows never take a slot or surface as a result.  One table
run is also held against the JAX ``SlotScheduler`` on the same requests.
"""

import jax
import numpy as np
import pytest

from paddle_tpu.models import Seq2SeqAttention as JaxSeq2Seq
from paddle_tpu.serving import Seq2SeqSlotBackend as JaxBackend
from paddle_tpu.serving import SlotScheduler as JaxScheduler
from paddle_tpu.serving.batching import Request as JaxRequest
from paddle_tpu.serving.batching import ServingFuture as JaxFuture
from paddle_tpu.serving.batching import canonicalize_feed as jax_canon
from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention, params_from_jax
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.serving import (Request, Seq2SeqSlotBackend,
                                      ServingFuture, SlotScheduler,
                                      canonicalize_feed, merge_feeds)

CFG = dict(src_vocab=80, trg_vocab=120, emb_dim=16, enc_dim=16, dec_dim=24,
           att_dim=16)
K = 3


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


@pytest.fixture(scope="module")
def models():
    jm = JaxSeq2Seq(**CFG)
    jp = jm.init(jax.random.PRNGKey(5))
    tm = Seq2SeqAttention(**CFG, device="cpu")
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jm, jp, tm, tp


def _feed(rng, rows=1, T=None):
    T = T or int(rng.randint(3, 9))
    ids = rng.randint(3, CFG["src_vocab"], (rows, T)).astype(np.int32)
    lens = rng.randint(1, T + 1, (rows,)).astype(np.int32)
    return {"src": (ids, lens)}


def _request(feed, *, max_len=None, canon=canonicalize_feed, req=Request,
             fut=ServingFuture):
    c, rows, sig = canon(feed)
    return req(feed=c, rows=rows, signature=sig, future=fut(),
               deadline=None, t_submit=0.0, max_len=max_len)


def _serve(sched, reqs):
    """Admit in order as slots free up, step, harvest until all answered."""
    results = {}
    pending = list(reqs)
    while pending or sched.occupied():
        for req, out, _ in sched.harvest():
            results[id(req)] = out
        while pending and sched.free_count() >= pending[0].rows:
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()
    return results


def _solo(tm, tp, feed, limit):
    ids, lens = feed["src"]
    toks, scores = tm.beam_search(tp, ids, lens, beam_size=K, max_len=limit)
    return toks.numpy(), scores.numpy()


@pytest.mark.parametrize("order", ["forward", "reversed"],
                         ids=["admit_in_order", "admit_reversed"])
def test_slot_outputs_equal_solo_beam_search_any_admission_order(models, rng,
                                                                  order):
    _, _, tm, tp = models
    be = Seq2SeqSlotBackend(tm, tp, src_len=8, beam_size=K, max_len=10)
    feeds = [_feed(rng) for _ in range(5)]
    limits = [6, 10, 4, 10, 7]
    reqs = [_request(f, max_len=l) for f, l in zip(feeds, limits)]
    if order == "reversed":
        reqs, feeds, limits = reqs[::-1], feeds[::-1], limits[::-1]
    sched = SlotScheduler(be, slots=2)
    results = _serve(sched, reqs)
    assert len(results) == len(reqs)
    for req, feed, limit in zip(reqs, feeds, limits):
        solo_t, solo_s = _solo(tm, tp, feed, limit)
        got = results[id(req)]
        np.testing.assert_array_equal(got["tokens"], solo_t)
        np.testing.assert_array_equal(got["scores"], solo_s)
    # capacity 2 served 5 requests: slots were recycled, not grown
    assert sched.recycled == len(reqs) == sched.admitted
    assert sched.free_count() == 2 and sched.occupied() == 0


def test_multirow_request_pad_rows_never_surface(models, rng):
    _, _, tm, tp = models
    be = Seq2SeqSlotBackend(tm, tp, src_len=8, beam_size=K, max_len=6)
    feed = _feed(rng, rows=3, T=8)
    req = _request(feed, max_len=6)
    merged, slices, rows = merge_feeds([req], 4)
    assert rows == 3 and slices == [(0, 3)]
    assert merged["src"][0].shape[0] == 4                  # padded bucket
    np.testing.assert_array_equal(merged["src"][0][3], merged["src"][0][2])
    sched = SlotScheduler(be, slots=4)
    assert sched.admit([req]) == 3
    assert sched.occupied() == 3          # the replica took no slot
    out = _serve(sched, [])[id(req)]
    assert out["tokens"].shape == (3, K, 6)
    solo_t, solo_s = _solo(tm, tp, feed, 6)
    np.testing.assert_array_equal(out["tokens"], solo_t)
    np.testing.assert_array_equal(out["scores"], solo_s)


def test_capacity_one_table_and_reset(models, rng):
    _, _, tm, tp = models
    be = Seq2SeqSlotBackend(tm, tp, src_len=8, beam_size=K, max_len=5)
    feeds = [_feed(rng) for _ in range(3)]
    reqs = [_request(f, max_len=5) for f in feeds]
    sched = SlotScheduler(be, slots=1)
    results = _serve(sched, reqs)
    for req, feed in zip(reqs, feeds):
        solo_t, solo_s = _solo(tm, tp, feed, 5)
        np.testing.assert_array_equal(results[id(req)]["tokens"], solo_t)
        np.testing.assert_array_equal(results[id(req)]["scores"], solo_s)
    assert sched.recycled == 3
    # a reset drops residents and hands back a fresh table
    sched.admit([_request(feeds[0])])
    dropped = sched.reset()
    assert len(dropped) == 1 and sched.free_count() == 1
    assert not sched.carry["active"].any()


def test_step_not_committed_keeps_the_table(models, rng):
    _, _, tm, tp = models
    be = Seq2SeqSlotBackend(tm, tp, src_len=8, beam_size=K, max_len=5)
    sched = SlotScheduler(be, slots=2)
    assert sched.admit([_request(_feed(rng))], commit=lambda: False) == 0
    assert sched.free_count() == 2
    sched.admit([_request(_feed(rng))])
    carry = sched.carry
    assert sched.step(commit=lambda: False) is False
    assert sched.carry is carry and sched.steps_run == 0
    assert int(sched.carry["step"].max()) == 0


def test_backend_rejects_non_bucket_src_len_and_overlong_sources(models, rng):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="feeder bucket"):
        Seq2SeqSlotBackend(tm, tp, src_len=4)
    be = Seq2SeqSlotBackend(tm, tp, src_len=8, beam_size=K, max_len=3)
    with pytest.raises(ValueError, match="src_len"):
        be.prefill({"src": (np.full((1, 16), 3, np.int32),
                            np.array([16], np.int32))})


def test_slot_table_matches_jax_slot_scheduler(models, rng):
    """The same requests through the JAX and the port's slot tables: ids
    exactly, scores within 1e-5."""
    jm, jp, tm, tp = models
    feeds = [_feed(rng) for _ in range(4)]
    limits = [5, 8, 3, 8]
    jbe = JaxBackend(jm, jp, src_len=8, beam_size=K, max_len=8)
    jreqs = [_request(f, max_len=l, canon=jax_canon, req=JaxRequest,
                      fut=JaxFuture) for f, l in zip(feeds, limits)]
    jres = _serve(JaxScheduler(jbe, slots=2), jreqs)
    tbe = Seq2SeqSlotBackend(tm, tp, src_len=8, beam_size=K, max_len=8)
    treqs = [_request(f, max_len=l) for f, l in zip(feeds, limits)]
    tres = _serve(SlotScheduler(tbe, slots=2), treqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tres[id(tr)]["tokens"],
                                      jres[id(jr)]["tokens"])
        np.testing.assert_allclose(tres[id(tr)]["scores"],
                                   jres[id(jr)]["scores"], rtol=1e-5,
                                   atol=1e-5)
