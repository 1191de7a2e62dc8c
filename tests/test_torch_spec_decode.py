"""Speculative decoding, the prefix cache and host paging of the port's slot
table (paddle_tpu_torch/ops/decode.py ``spec_verify_step``,
``extract_slot``, ``restore_slot``; serving/slots.py; serving/server.py)
on the CPU, held against the JAX package.

The intent of every test of ``tests/test_spec_decode.py``, on the port, at
its size (V=48, D=16, SRC=8, L=12), with the weights carried from JAX by
``params_from_jax``:

- one wide step of the port's ``spec_verify_step`` against the JAX
  package's on the same carry and drafts: ``emitted``, ``n`` and
  ``accepted`` bit-equal, ``logp`` and state within rtol 1e-5 / atol 1e-6
  (``tests/test_rnn_fused.py``'s f32 tolerance);
- bit identity: with speculation, the prefix cache and paging on, under
  both admission orders, every request's tokens AND scores equal the
  port's plain scheduler's and the port's solo ``greedy_decode``; tokens
  also equal the JAX package's solo ``beam_decode`` and scores are within
  the tolerance above of it;
- the trace on which the reference's scheduler decodes one token past a
  request's budget (its gated plain step after a budget-filling wide step,
  +ln V on the score) gives the solo score in the port;
- the proposer hooks, chaos faults, keys, gating, acceptance and the
  server's lifted settings.

Every test runs under a hard ``signal.alarm`` and closes its servers.
"""

import math
import signal
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops.decode import beam_decode as jax_beam_decode
from paddle_tpu.ops.decode import decode_step as jax_decode_step
from paddle_tpu.ops.decode import init_slot_carry as jax_init_carry
from paddle_tpu.ops.decode import spec_verify_step as jax_spec_verify
from paddle_tpu.ops.decode import write_slot as jax_write_slot
from paddle_tpu.serving import SlotScheduler as JaxScheduler
from paddle_tpu.serving.batching import Request as JaxRequest
from paddle_tpu.serving.batching import ServingFuture as JaxFuture
from paddle_tpu.serving.batching import canonicalize_feed as jax_canon
from paddle_tpu.serving.slots import example_slot_backend
from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention, params_from_jax
from paddle_tpu_torch.ops.decode import (decode_step, extract_slot,
                                         greedy_decode, init_slot_carry,
                                         restore_slot, spec_verify_step,
                                         write_slot)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.ops.speculative import (AdversarialProposer,
                                              CallableDraftProposer,
                                              NGramProposer)
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import slots as slots_mod
from paddle_tpu_torch.serving import (InferenceServer, Request,
                                      Seq2SeqSlotBackend, ServingFuture,
                                      SlotScheduler, canonicalize_feed)
from paddle_tpu_torch.utils.error import ConfigError

HARD_TIMEOUT_S = 300
SRC, L, V, D = 8, 12, 48, 16
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def hard_timeout():
    def _abort(signum, frame):
        raise RuntimeError(f"spec test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


@pytest.fixture(scope="module")
def jax_backend():
    """The reference test's backend: ``example_slot_backend`` at V=48,
    D=16, beam 1, its parameters from ``PRNGKey(0)``."""
    return example_slot_backend(beam_size=1, src_len=SRC, max_len=L,
                                vocab=V, dim=D)


@pytest.fixture(scope="module")
def backend(jax_backend):
    """The port's backend over the reference backend's weights."""
    m = Seq2SeqAttention(src_vocab=V, trg_vocab=V, emb_dim=D, enc_dim=D,
                         dec_dim=D, att_dim=D, device="cpu")
    p = params_from_jax({k: np.asarray(v)
                         for k, v in jax_backend.params.items()}, "cpu")
    return Seq2SeqSlotBackend(m, p, src_len=SRC, beam_size=1, max_len=L)


def _request(feed, *, max_len=L):
    canon, rows, sig = canonicalize_feed(feed)
    return Request(feed=canon, rows=rows, signature=sig,
                   future=ServingFuture(), deadline=None, t_submit=0.0,
                   max_len=max_len)


def _feeds(n, distinct, seed=0):
    """n single-row requests over ``distinct`` repeated sources — the
    template/session traffic speculation and the prefix cache target (the
    reference test's generator, same draws)."""
    rng = np.random.RandomState(seed)
    motifs = [rng.randint(3, V, (1, SRC)).astype(np.int32)
              for _ in range(distinct)]
    return [{"src": (motifs[i % distinct], np.asarray([SRC], np.int32))}
            for i in range(n)]


def _solo(backend, feed, max_len=L):
    """The port's oracle: the request alone through ``greedy_decode``."""
    canon, _, _ = canonicalize_feed(feed)
    toks, scores = greedy_decode(
        backend.step_fn, backend.readout, backend.prefill(canon),
        batch_size=1, vocab_size=backend.vocab_size, max_len=max_len,
        bos=backend.bos, eos=backend.eos)
    return toks.numpy(), scores.numpy()


def _jax_solo(jax_backend, feed, max_len=L):
    """The reference's oracle: solo ``beam_decode`` at beam 1."""
    canon, _, _ = jax_canon(feed)
    toks, scores = jax_beam_decode(
        jax_backend.step_fn, jax_backend.readout, jax_backend.prefill(canon),
        batch_size=1, beam_size=1, vocab_size=V, max_len=max_len,
        bos=jax_backend.bos, eos=jax_backend.eos)
    return np.asarray(toks)[:, 0], np.asarray(scores)[:, 0]


def _drive(sched, reqs, hook=None):
    """The continuous loop: page in / harvest / admit / step until drained.
    ``hook(sched, cycle)`` runs once per cycle (chaos injection)."""
    results = {}
    pending = list(reqs)
    cycle = 0
    while (pending or sched.occupied()
           or (sched.pager is not None and len(sched.pager))):
        if hook is not None:
            hook(sched, cycle)
        cycle += 1
        if sched.pager is not None:
            sched.page_in()
        for req, out, _steps in sched.harvest():
            results[id(req)] = out
        while pending and sched.free_count() >= pending[0].rows:
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()
    return results


def _assert_same(results_a, results_b, reqs_a, reqs_b):
    for ra, rb in zip(reqs_a, reqs_b):
        np.testing.assert_array_equal(results_a[id(ra)]["tokens"],
                                      results_b[id(rb)]["tokens"])
        np.testing.assert_array_equal(results_a[id(ra)]["scores"],
                                      results_b[id(rb)]["scores"])


def _assert_solo(backend, jax_backend, feeds, reqs, got):
    """Each request against the port's solo greedy decode (bit for bit)
    and the JAX package's solo beam decode (ids, scores within tol)."""
    for f, r in zip(feeds, reqs):
        solo_t, solo_s = _solo(backend, f)
        np.testing.assert_array_equal(got[id(r)]["tokens"][:, 0], solo_t)
        np.testing.assert_array_equal(got[id(r)]["scores"][:, 0], solo_s)
        ref_t, ref_s = _jax_solo(jax_backend, f)
        np.testing.assert_array_equal(got[id(r)]["tokens"][:, 0], ref_t)
        np.testing.assert_allclose(got[id(r)]["scores"][:, 0], ref_s,
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# one wide step against the JAX package
# ---------------------------------------------------------------------------


def _carries(backend, jax_backend, slots, pre_steps):
    """The same table on both packages: ``slots - 1`` requests admitted
    (the last slot stays free) and ``pre_steps`` plain steps run."""
    feeds = _feeds(slots - 1, slots - 1, seed=4)
    canon = [canonicalize_feed(f)[0] for f in feeds]
    tpl = backend.prefill(backend.example_feed(1))
    c = init_slot_carry(tpl, slots=slots, beam_size=1, max_len=L)
    jtpl = jax.eval_shape(jax_backend.prefill, jax_backend.example_feed(1))
    jc = jax_init_carry(jtpl, slots=slots, beam_size=1, max_len=L)
    for slot, f in enumerate(canon):
        write_slot(c, slot, backend.prefill(f))
        jc = jax_write_slot(jc, slot, jax_backend.prefill(f))
    for _ in range(pre_steps):
        c = decode_step(backend.step_fn, backend.readout, c, vocab_size=V)
        jc = jax_decode_step(jax_backend.step_fn, jax_backend.readout, jc,
                             vocab_size=V)
    return feeds, c, jc


def test_spec_verify_step_matches_the_jax_package(backend, jax_backend):
    """One wide step from the same carry with the same drafts (slot 0:
    its own greedy continuation, all accepted; slot 1: one right then
    wrong; slot 2: wrong at once; slot 3: a cap of 2 on right drafts;
    slot 4 free): ``emitted``, ``n`` and ``accepted`` bit-equal, tokens
    equal, ``logp`` and the state within f32 tolerance."""
    k, S = 4, 5
    feeds, c, jc = _carries(backend, jax_backend, S, pre_steps=2)
    drafts = np.zeros((S, k), np.int64)
    for slot in range(S - 1):
        toks, _ = _solo(backend, feeds[slot])
        drafts[slot] = toks[0, 2:2 + k]           # the model's own tokens
    drafts[1, 1:] = (drafts[1, 1:] + 1) % V
    drafts[2] = (drafts[2] + 1) % V
    cap = np.array([L, L, L, 2, 0], np.int64)

    new, aux = spec_verify_step(backend.step_fn, backend.readout, c, drafts,
                                cap, vocab_size=V)
    jnew, jaux = jax_spec_verify(jax_backend.step_fn, jax_backend.readout,
                                 jc, drafts.astype(np.int32),
                                 cap.astype(np.int32), vocab_size=V)
    for name in ("emitted", "n", "accepted"):
        np.testing.assert_array_equal(aux[name].numpy(),
                                      np.asarray(jaux[name]))
    np.testing.assert_array_equal(aux["n"].numpy(), [k + 1, 2, 1, 2, 0])
    np.testing.assert_array_equal(aux["accepted"].numpy(), [k, 1, 0, 1, 0])
    np.testing.assert_array_equal(new["tokens"].numpy(),
                                  np.asarray(jnew["tokens"]))
    np.testing.assert_array_equal(new["step"].numpy(),
                                  np.asarray(jnew["step"]))
    np.testing.assert_array_equal(new["finished"].numpy(),
                                  np.asarray(jnew["finished"]))
    np.testing.assert_allclose(new["logp"].numpy(), np.asarray(jnew["logp"]),
                               rtol=RTOL, atol=ATOL)
    for name in ("s", "enc", "enc_proj", "mask"):
        np.testing.assert_allclose(new["state"][name].numpy(),
                                   np.asarray(jnew["state"][name]),
                                   rtol=RTOL, atol=ATOL)
    # the pass-through leaves are the input's own tensors, not copies
    for name in ("enc", "enc_proj", "mask"):
        assert new["state"][name] is c["state"][name]
    # the input carry is untouched; the free slot is frozen bit for bit
    assert torch.equal(new["state"]["s"][4], c["state"]["s"][4])
    assert int(c["step"][0]) == 2


def test_spec_verify_step_equals_one_token_steps(backend):
    """Greedy verify IS the greedy rule: a wide step that accepts every
    draft lands on the carry of k+1 one-token steps, bit for bit (tokens,
    logp, step, every state leaf)."""
    k, S = 3, 3
    feeds = _feeds(S, S, seed=6)
    tpl = backend.prefill(backend.example_feed(1))
    c = init_slot_carry(tpl, slots=S, beam_size=1, max_len=L)
    for slot, f in enumerate(feeds):
        write_slot(c, slot, backend.prefill(canonicalize_feed(f)[0]))
    drafts = np.stack([_solo(backend, f)[0][0, :k] for f in feeds])
    wide, aux = spec_verify_step(backend.step_fn, backend.readout, c, drafts,
                                 np.full(S, L), vocab_size=V)
    one = c
    for _ in range(k + 1):
        one = decode_step(backend.step_fn, backend.readout, one, vocab_size=V)
    assert aux["n"].tolist() == [k + 1] * S
    for name in ("tokens", "logp", "step", "finished"):
        assert torch.equal(wide[name], one[name]), name
    for name in one["state"]:
        assert torch.equal(wide["state"][name], one["state"][name]), name


def test_spec_verify_step_rejects_beam_tables(backend):
    tpl = backend.prefill(backend.example_feed(1))
    c = init_slot_carry(tpl, slots=2, beam_size=3, max_len=L)
    with pytest.raises(ValueError, match="beam_size must be 1"):
        spec_verify_step(backend.step_fn, backend.readout, c,
                         np.zeros((2, 2), np.int64), np.ones(2, np.int64),
                         vocab_size=V)


def test_extract_restore_slot_round_trip_bit_exact(backend):
    """A slot's context copied to the host and written back into the same
    slot of a table that has since been overwritten gives the original
    table back, bit for bit; the snapshot matches the JAX layout."""
    S = 3
    feeds = _feeds(S, S, seed=8)
    tpl = backend.prefill(backend.example_feed(1))
    c = init_slot_carry(tpl, slots=S, beam_size=1, max_len=L)
    for slot, f in enumerate(feeds):
        write_slot(c, slot, backend.prefill(canonicalize_feed(f)[0]))
    for _ in range(3):
        c = decode_step(backend.step_fn, backend.readout, c, vocab_size=V)
    saved = extract_slot(c, 1)
    assert saved["tokens"].shape == (1, 1, L + 1)
    assert saved["state"]["enc"].shape[0] == 1
    host = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.cpu()) for k, v in saved.items()}
    orig = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in c.items()}
    # overwrite slot 1 with another request at step 0, inactive
    write_slot(c, 1, backend.prefill(canonicalize_feed(feeds[0])[0]))
    c["active"][1] = False
    restore_slot(c, 1, host)
    for name in ("tokens", "logp", "finished", "active", "step"):
        assert torch.equal(c[name], orig[name]), name
    for name in orig["state"]:
        assert torch.equal(c["state"][name], orig["state"][name]), name


# ---------------------------------------------------------------------------
# bit identity of the scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["forward", "reversed"],
                         ids=["admit_in_order", "admit_reversed"])
def test_spec_outputs_bit_identical_to_plain_and_solo(backend, jax_backend,
                                                      order):
    """Spec ON vs spec OFF over the identical repetitive trace, both
    admission orders: tokens and scores bit-equal, equal to the port's solo
    greedy decode of each prompt, and held against the JAX solo decode."""
    feeds = _feeds(6, 2)
    if order == "reversed":
        feeds = feeds[::-1]
    reqs_p = [_request(f) for f in feeds]
    reqs_s = [_request(f) for f in feeds]
    got_p = _drive(SlotScheduler(backend, slots=2), reqs_p)
    spec = SlotScheduler(backend, slots=2, spec_k=4)
    got_s = _drive(spec, reqs_s)
    assert spec.spec_steps > 0 and spec.spec_accepted > 0
    _assert_same(got_p, got_s, reqs_p, reqs_s)
    _assert_solo(backend, jax_backend, feeds, reqs_s, got_s)


def test_budget_filling_wide_step_is_not_stepped_past_its_budget(
        backend, jax_backend, monkeypatch):
    """The reference's fault, on its own trace (``_feeds(6, 2)``, 2
    slots, spec_k=4): after a wide step fills a request's budget, the
    reference's ``done_slots`` (host accounting one step behind) misses
    it, and when no draft is confident the gated plain step decodes one
    more token into the finished request's score (+ln V: -50.2469 where
    solo gives -46.3813).  The port freezes such a slot, so every score
    equals solo.  The JAX arm runs too, to show the trace reaches the
    fault."""
    feeds = _feeds(6, 2)
    reqs = [_request(f) for f in feeds]
    spec = SlotScheduler(backend, slots=2, spec_k=4)
    frozen_steps = []

    def watching_step(step_fn, readout, carry, **kw):
        # a gated plain step that froze an occupied slot
        if not torch.equal(carry["active"], spec.carry["active"]):
            frozen_steps.append(int(spec.carry["active"].sum()
                                    - carry["active"].sum()))
        return decode_step(step_fn, readout, carry, **kw)

    monkeypatch.setattr(slots_mod, "decode_step", watching_step)
    got = _drive(spec, reqs)
    for f, r in zip(feeds, reqs):
        solo_t, solo_s = _solo(backend, f)
        np.testing.assert_array_equal(got[id(r)]["tokens"][:, 0], solo_t)
        np.testing.assert_array_equal(got[id(r)]["scores"][:, 0], solo_s)
    # ... and the trace did reach a gated plain step beside a slot whose
    # budget was spent (the step the reference overruns)
    assert frozen_steps

    jreqs = []
    for f in feeds:
        canon, rows, sig = jax_canon(f)
        jreqs.append(JaxRequest(feed=canon, rows=rows, signature=sig,
                                future=JaxFuture(), deadline=None,
                                t_submit=0.0, max_len=L))
    jgot = _drive(JaxScheduler(jax_backend, slots=2, spec_k=4), jreqs)
    over = [float(jgot[id(r)]["scores"][0, 0]) - float(_jax_solo(
        jax_backend, f)[1][0]) for f, r in zip(feeds, jreqs)]
    # the reference's overrun: one more token's log-prob, about -ln V
    assert any(abs(d + math.log(V)) < 0.1 for d in over), over


def test_spec_with_prefix_cache_and_paging_bit_identical(backend,
                                                         jax_backend):
    """All three at once — speculation, the prefix cache and a host
    page-out forced every few cycles — reproduce the plain arm bit for
    bit and the solo decodes."""
    feeds = _feeds(8, 2)
    reqs_p = [_request(f) for f in feeds]
    reqs_s = [_request(f) for f in feeds]
    got_p = _drive(SlotScheduler(backend, slots=2), reqs_p)
    spec = SlotScheduler(backend, slots=2, spec_k=4, prefix_cache_mb=8.0,
                         page_pool_mb=8.0)
    paged = []

    def hook(s, cycle):
        if cycle % 3 == 2 and s.page_out_victim():
            paged.append(cycle)

    got_s = _drive(spec, reqs_s, hook=hook)
    assert paged, "the hook never parked a slot"
    _assert_same(got_p, got_s, reqs_p, reqs_s)
    _assert_solo(backend, jax_backend, feeds, reqs_s, got_s)
    assert spec.prefix_cache.hits > 0
    st = spec.pager.stats()
    assert st["paged_out"] == st["paged_in"] == len(paged)
    assert st["parked"] == 0 and st["bytes"] == 0


@pytest.mark.parametrize("order", ["forward", "reversed"],
                         ids=["admit_in_order", "admit_reversed"])
def test_cache_and_paging_without_spec_bit_identical(backend, order):
    """The prefix cache and paging on the plain (spec off) table: outputs
    bit-identical to the plain arm, the cache hit, pages out = in."""
    feeds = _feeds(8, 3, seed=2)
    if order == "reversed":
        feeds = feeds[::-1]
    reqs_p = [_request(f) for f in feeds]
    reqs_s = [_request(f) for f in feeds]
    got_p = _drive(SlotScheduler(backend, slots=2), reqs_p)
    sched = SlotScheduler(backend, slots=2, prefix_cache_mb=8.0,
                          page_pool_mb=8.0)
    got_s = _drive(sched, reqs_s,
                   hook=lambda s, cyc: cyc % 4 == 3 and s.page_out_victim())
    _assert_same(got_p, got_s, reqs_p, reqs_s)
    assert sched.prefix_cache.hits == len(feeds) - 3
    assert sched.pager.paged_out == sched.pager.paged_in > 0
    assert sched.recycled == len(feeds)


def test_page_out_readmit_round_trip_bit_exact(backend):
    """A request parked in the host pool mid-generation and re-admitted
    finishes bit-identical to one that never left the table."""
    feeds = _feeds(2, 2, seed=3)
    reqs_a = [_request(f) for f in feeds]
    reqs_b = [_request(f) for f in feeds]
    got_a = _drive(SlotScheduler(backend, slots=2, spec_k=4), reqs_a)
    sched = SlotScheduler(backend, slots=2, spec_k=4, page_pool_mb=8.0)
    sched.admit(reqs_b)
    sched.step()
    sched.step()
    assert sched.page_out_victim()          # one resident goes to host
    assert len(sched.pager) == 1 and sched.free_count() == 1
    assert sched.pager.bytes_used() > 0
    got_b = _drive(sched, [])               # page_in + finish both
    assert len(got_b) == 2
    _assert_same(got_a, got_b, reqs_a, reqs_b)
    # a paged request is in flight, not recycled: 2 harvests only
    assert sched.recycled == 2


def test_victim_is_the_most_budget_left_and_paged_at_most_twice(backend):
    """The victim: the occupied slot with the most budget left, at least
    one step old; a record paged twice is never chosen again."""
    feeds = _feeds(2, 2, seed=12)
    sched = SlotScheduler(backend, slots=2, page_pool_mb=8.0)
    sched.admit([_request(feeds[0], max_len=4)])
    assert not sched.page_out_victim()      # admitted this step: too young
    sched.admit([_request(feeds[1], max_len=L)])
    sched.step()
    assert sched.page_out_victim()
    rec = sched.pager._queue[0]
    assert rec.limit == L and rec.pages == 1   # the longer budget went
    assert sched.page_in() == 1
    sched.step()
    assert sched.page_out_victim() and sched.page_in() == 1
    sched.step()
    # both paged once... the L-budget one twice: only the other qualifies
    entries = [e for e in sched._entries if e is not None]
    assert sorted(e.pages for e in entries) == [0, 2]
    assert sched.page_out_victim()
    assert sched.pager._queue[0].limit == 4


def test_expired_and_dropped_requests_leave_the_pager(backend):
    """A parked request's deadline keeps running: ``evict_expired`` drops
    it from the pool; ``reset`` clears the pool."""
    sched = SlotScheduler(backend, slots=1, page_pool_mb=8.0,
                          clock=lambda: 0.0)
    req = _request(_feeds(1, 1)[0])
    req.deadline = 5.0
    sched.admit([req])
    sched.step()
    assert sched.page_out_victim() and len(sched.pager) == 1
    assert sched.evict_expired(1.0) == []
    assert sched.evict_expired(6.0) == [(req, 0)]
    assert len(sched.pager) == 0 and sched.resident_requests() == []
    sched.admit([_request(_feeds(1, 1)[0])])
    sched.step()
    assert sched.page_out_victim()
    assert len(sched.reset()) == 1 and len(sched.pager) == 0


# ---------------------------------------------------------------------------
# acceptance, gating, proposers
# ---------------------------------------------------------------------------


def test_acceptance_positive_and_near_ceiling_on_repeat_trace(backend):
    """After one warm pass (the proposer learns each completed trajectory
    under its request key), a second identical pass drafts by positional
    replay: acceptance > 0 overall and above 0.5 on the warm pass (the
    loss to 1.0 is structural: a just-finished slot is seen done one
    cycle late and pays one zero-cap wide step of drafts)."""
    sched = SlotScheduler(backend, slots=2, spec_k=3)
    _drive(sched, [_request(f) for f in _feeds(4, 2)])
    base = (sched.spec_drafted, sched.spec_accepted)
    _drive(sched, [_request(f) for f in _feeds(4, 2)])
    drafted = sched.spec_drafted - base[0]
    accepted = sched.spec_accepted - base[1]
    assert sched.spec_accepted > 0 and drafted > 0
    assert accepted / drafted > 0.5


def test_cold_table_gates_to_plain_step(backend):
    """First step of a fresh request with an empty corpus: nothing
    predictive (history is just BOS), so the table takes the plain
    one-token step — no drafts counted, ``last_spec`` None."""
    sched = SlotScheduler(backend, slots=2, spec_k=4)
    sched.admit([_request(_feeds(1, 1)[0])])
    sched.step()
    assert sched.last_spec is None
    assert sched.spec_drafted == 0 and sched.spec_steps == 0
    assert sched.steps_run == 1


def test_spec_turned_off_for_beam_tables(backend):
    be3 = Seq2SeqSlotBackend(backend.model, backend.params, src_len=SRC,
                             beam_size=3, max_len=L)
    sched = SlotScheduler(be3, slots=2, spec_k=4)
    assert sched.spec_k == 0 and sched.proposer is None


def test_callable_proposer_is_draft_model_hook(backend):
    """A CallableDraftProposer (the small-model hook) drives wide steps
    (always confident) and stays bit-identical even when its drafts are
    nonsense."""
    feeds = _feeds(3, 1, seed=5)
    reqs_p = [_request(f) for f in feeds]
    reqs_s = [_request(f) for f in feeds]
    got_p = _drive(SlotScheduler(backend, slots=2), reqs_p)
    calls = []

    def tiny_model(history, k):
        calls.append(len(history))
        return [(history[-1] + 1) % V] * k

    spec = SlotScheduler(backend, slots=2, spec_k=3,
                         draft=CallableDraftProposer(tiny_model))
    got_s = _drive(spec, reqs_s)
    assert calls, "draft callable never consulted"
    assert spec.spec_drafted > 0 and spec.spec_steps == spec.steps_run
    _assert_same(got_p, got_s, reqs_p, reqs_s)


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------


def test_bad_draft_chaos_degrades_throughput_not_output(backend):
    """chaos.bad_draft: always-wrong drafts make the wide verify reject
    every position — each step still emits >= 1 token (the model's own)
    and the outputs stay bit-identical."""
    feeds = _feeds(4, 2, seed=7)
    reqs_p = [_request(f) for f in feeds]
    reqs_s = [_request(f) for f in feeds]
    got_p = _drive(SlotScheduler(backend, slots=2), reqs_p)
    used = {int(t) for r in reqs_p
            for t in np.asarray(got_p[id(r)]["tokens"]).ravel()}
    token = next(t for t in range(V - 1, -1, -1) if t not in used)
    spec = SlotScheduler(backend, slots=2, spec_k=4)
    displaced = chaos.bad_draft(spec, token=token)
    assert isinstance(displaced, NGramProposer)
    assert isinstance(spec.proposer, AdversarialProposer)
    got_s = _drive(spec, reqs_s)
    assert spec.spec_drafted > 0            # wide steps actually ran
    assert spec.spec_accepted == 0          # every draft rejected
    assert spec.steps_run <= 4 * L
    _assert_same(got_p, got_s, reqs_p, reqs_s)
    with pytest.raises(ValueError, match="spec_k > 0"):
        chaos.bad_draft(SlotScheduler(backend, slots=1))


def test_corrupt_prefix_cache_detected_quarantined_served(backend):
    """chaos.corrupt_prefix_cache: a bit-flipped cached prefill is caught
    by the entry crc on the next lookup — counted ``poisoned``, treated as
    a miss, and the request prefilled afresh (the poisoned payload never
    reaches a slot)."""
    feeds = _feeds(4, 1, seed=9)
    sched = SlotScheduler(backend, slots=2, prefix_cache_mb=8.0)
    reqs = [_request(feeds[0])]
    got_a = _drive(sched, reqs)
    assert sched.prefix_cache.stats()["entries"] == 1
    assert chaos.corrupt_prefix_cache(sched) == 1
    reqs_b = [_request(feeds[1])]           # same source: would be a hit
    got_b = _drive(sched, reqs_b)
    st = sched.prefix_cache.stats()
    assert st["poisoned"] == 1 and st["hits"] == 0 and st["misses"] == 2
    _assert_same(got_a, got_b, reqs, reqs_b)
    # the fresh prefill re-seeded the cache: the next one hits
    reqs_c = [_request(feeds[2])]
    _assert_same(got_a, _drive(sched, reqs_c), reqs, reqs_c)
    assert sched.prefix_cache.stats()["hits"] == 1
    with pytest.raises(ValueError, match="prefix cache"):
        chaos.corrupt_prefix_cache(SlotScheduler(backend, slots=1))


# ---------------------------------------------------------------------------
# keys and the fingerprint
# ---------------------------------------------------------------------------


def test_corpus_and_cache_keys_scope_to_model_fingerprint(backend):
    """The draft corpus key and the prefix cache key both embed the model
    fingerprint, so a new model generation can never replay or re-admit
    the old model's state; ``session_id`` scopes chat turns to their
    session; multi-row requests are not cached."""
    sched = SlotScheduler(backend, slots=2, spec_k=2, prefix_cache_mb=8.0)
    req = _request(_feeds(1, 1)[0])
    k_corpus = sched._corpus_key(req, 0)
    k_cache = sched._cache_key(req)
    assert k_corpus and k_cache and k_corpus != k_cache
    assert sched._corpus_key(req, 1) != k_corpus
    real_fp = backend.fingerprint()
    try:
        backend._fingerprint = "other-model-generation"
        assert sched._corpus_key(req, 0) != k_corpus
        assert sched._cache_key(req) != k_cache
    finally:
        backend._fingerprint = real_fp
    req_sess = _request(_feeds(1, 1)[0])
    req_sess.session_id = "chat-1"
    assert sched._corpus_key(req_sess, 0) != k_corpus
    assert sched._cache_key(req_sess) != k_cache
    two = _request({"src": (np.full((2, SRC), 5, np.int32),
                            np.full((2,), SRC, np.int32))})
    assert sched._cache_key(two) is None
    # spec off: no corpus key; cache off: no cache key
    plain = SlotScheduler(backend, slots=1)
    assert plain._corpus_key(req, 0) is None
    assert plain._cache_key(req) is None


def test_fingerprint_covers_weights_and_settings(backend):
    fp = backend.fingerprint()
    assert fp.startswith("seq2seq:") and backend.fingerprint() is fp
    m, p = backend.model, backend.params
    same = Seq2SeqSlotBackend(m, p, src_len=SRC, beam_size=1, max_len=L)
    assert same.fingerprint() == fp
    other_len = Seq2SeqSlotBackend(m, p, src_len=SRC, beam_size=1,
                                   max_len=L - 1)
    assert other_len.fingerprint() != fp
    q = dict(p)
    q["out_b"] = p["out_b"].clone()
    q["out_b"][3] += 1e-6
    assert Seq2SeqSlotBackend(m, q, src_len=SRC, beam_size=1,
                              max_len=L).fingerprint() != fp
    bf = {k: v.to(torch.bfloat16) for k, v in p.items()}
    fb = Seq2SeqSlotBackend(m, bf, src_len=SRC, beam_size=1,
                            max_len=L).fingerprint()
    bf["out_w"] = bf["out_w"].clone()
    bf["out_w"][0, 0] = -bf["out_w"][0, 0] + 1
    assert fb != fp and Seq2SeqSlotBackend(
        m, bf, src_len=SRC, beam_size=1, max_len=L).fingerprint() != fb


# ---------------------------------------------------------------------------
# the server's lifted settings
# ---------------------------------------------------------------------------


def _server(backend, **kw):
    return InferenceServer(backend, mode="generation", slots=2,
                           batch_delay_ms=0.0, max_queue=32,
                           default_deadline_ms=60000.0, **kw)


def test_server_serves_with_spec_cache_and_paging(backend):
    """``spec_k``, ``prefix_cache_mb`` and ``slot_page_pool_mb`` on
    ``InferenceServer(mode="generation")``: 8 requests submitted at once
    to a 2-slot table — the queue outruns the table, so the server pages
    residents out by itself — answer as the plain scheduler does, and
    healthz mirrors the speculation, cache and paging counters."""
    feeds = _feeds(8, 2, seed=1)
    reqs = [_request(f) for f in feeds]
    want = _drive(SlotScheduler(backend, slots=2), reqs)
    srv = _server(backend, spec_k=4, prefix_cache_mb=8.0,
                  slot_page_pool_mb=8.0)
    with srv:
        srv.start(warmup_feed=feeds[0])
        hz0 = srv.healthz()
        assert hz0["counters"]["prefix_cache_hits"] == 0
        assert hz0["counters"]["spec_draft_tokens_total"] == 0
        futs = [srv.submit(f) for f in feeds]
        outs = [f.result(60) for f in futs]
        hz = srv.healthz()
    for r, out in zip(reqs, outs):
        np.testing.assert_array_equal(out["tokens"], want[id(r)]["tokens"])
        np.testing.assert_array_equal(out["scores"], want[id(r)]["scores"])
    c = hz["counters"]
    assert c["completed"] == 8
    assert c["prefix_cache_hits"] > 0 and c["prefix_cache_misses"] > 0
    assert c["prefix_cache_hits"] + c["prefix_cache_misses"] == 8
    assert c["slots_paged_out"] == c["slots_paged_in"] > 0
    assert c["spec_draft_tokens_total"] > 0
    assert c["spec_accepted_tokens_total"] > 0
    assert c["spec_emitted_tokens_total"] > 0
    sched = srv._scheduler
    assert c["spec_accepted_tokens_total"] == sched.spec_accepted
    assert c["slots_paged_out"] == sched.pager.paged_out


def test_server_swap_keeps_the_decode_settings_and_clears_the_cache(
        backend):
    """A generation hot-swap builds the new table with the old one's
    speculation, cache and pool settings, and clears the old cache at the
    flip (its keys embed the retired fingerprint)."""
    feeds = _feeds(2, 1, seed=13)
    srv = _server(backend, spec_k=3, prefix_cache_mb=4.0,
                  slot_page_pool_mb=2.0)
    with srv:
        srv.start(warmup=False)
        first = srv.submit(feeds[0]).result(60)
        old = srv._scheduler
        assert old.prefix_cache.stats()["entries"] == 1
        twin = Seq2SeqSlotBackend(backend.model, backend.params, src_len=SRC,
                                  beam_size=1, max_len=L)
        srv.swap_model(twin, info={"version": 2})
        deadline = time.monotonic() + 30
        while srv._scheduler is old and time.monotonic() < deadline:
            time.sleep(0.005)          # the worker flips on an empty table
        new = srv._scheduler
        second = srv.submit(feeds[1]).result(60)
    assert new is not old and srv.model is twin
    assert new.spec_k == 3 and new.proposer is old.proposer
    assert new.prefix_cache.max_bytes == old.prefix_cache.max_bytes
    assert new.pager.max_bytes == 2 * (1 << 20)
    assert old.prefix_cache.stats()["entries"] == 0
    np.testing.assert_array_equal(first["tokens"], second["tokens"])
    np.testing.assert_array_equal(first["scores"], second["scores"])


def test_server_item_7_and_9_options_still_raise(backend):
    srv = _server(backend, spec_k=2)
    with srv:
        with pytest.raises(ConfigError, match="Queue 1 item 7\\b"):
            srv.start(compile_cache=object())
        with pytest.raises(ConfigError, match="Queue 1 item 9\\b"):
            srv.start(preflight=True)
        srv.start(warmup=False)
        with pytest.raises(ConfigError, match="Queue 1 item 9\\b"):
            srv.submit(_feeds(1, 1)[0], trace_attrs={"tenant": "a"})
