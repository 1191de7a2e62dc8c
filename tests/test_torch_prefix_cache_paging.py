"""The port's framework-free decode-speed modules on their own:
``paddle_tpu_torch/serving/prefix_cache.py`` (``PrefixCache``, ``feed_key``),
``serving/paging.py`` (``SlotPager``) and ``ops/speculative.py`` (the draft
proposers), each held against the JAX package's copy where the two share
an interface: the same keys for the same numpy parts, the same drafts for
the same histories.  Payloads here are host tensors, bf16 included, which
the reference's numpy payloads cannot hold.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops.speculative import NGramProposer as JaxNGram
from paddle_tpu.serving.prefix_cache import feed_key as jax_feed_key
from paddle_tpu_torch.ops.speculative import (AdversarialProposer,
                                              CallableDraftProposer,
                                              DraftProposer, NGramProposer)
from paddle_tpu_torch.serving import PrefixCache, SlotPager, feed_key
from paddle_tpu_torch.serving.paging import PagedSlot, payload_bytes
from paddle_tpu_torch.serving.prefix_cache import tensor_bytes


def _payload(n_f32, n_bf16=0, fill=1.0):
    """A payload of ``4 * n_f32 + 2 * n_bf16`` bytes."""
    p = {"leaf0": torch.full((1, n_f32), fill, dtype=torch.float32)}
    if n_bf16:
        p["leaf1"] = torch.full((1, n_bf16), fill, dtype=torch.bfloat16)
    return p


# ---------------------------------------------------------------------------
# feed_key and the raw bytes of a tensor
# ---------------------------------------------------------------------------


def test_feed_key_equals_the_reference_on_numpy_parts():
    parts = ["seq2seq:abc", "session:s1", "src",
             np.arange(12, dtype=np.int32).reshape(1, 12),
             np.asarray([12], np.int32), b"raw"]
    assert feed_key(*parts) == jax_feed_key(*parts)
    # dtype and shape take part: an i32 and an i64 feed never collide
    assert feed_key(np.arange(4, dtype=np.int32)) != feed_key(
        np.arange(4, dtype=np.int64))
    assert feed_key(np.zeros((2, 2))) != feed_key(np.zeros((4,)))
    # a tensor part hashes its dtype, shape and bytes
    t = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert feed_key(t) == feed_key(t.clone())
    assert feed_key(t) != feed_key(t.to(torch.int64))
    assert feed_key(t) != feed_key(t.reshape(3, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.bool])
def test_tensor_bytes_are_the_raw_bytes(dtype):
    t = (torch.arange(10) % 3).to(dtype).reshape(2, 5)
    raw = tensor_bytes(t)
    assert len(raw) == t.numel() * t.element_size()
    if dtype == torch.bfloat16:
        want = t.view(torch.int16).numpy().tobytes()
    else:
        want = t.numpy().tobytes()
    assert raw == want
    # a strided view reads as its contiguous copy
    assert tensor_bytes(t.T) == tensor_bytes(t.T.contiguous())


# ---------------------------------------------------------------------------
# PrefixCache
# ---------------------------------------------------------------------------


def test_prefix_cache_lru_by_bytes():
    c = PrefixCache(max_mb=3 * 4096 / (1 << 20))        # 3 x 4 KiB
    for i in range(3):
        assert c.put(f"k{i}", _payload(1024, fill=i))  # 4 KiB each
    assert c.stats()["bytes"] == 3 * 4096 and c.stats()["entries"] == 3
    assert c.get("k0") is not None                      # k0 now newest
    assert c.put("k3", _payload(1024))                  # evicts k1 (LRU)
    assert c.keys() == ["k2", "k0", "k3"]
    assert c.stats()["evictions"] == 1
    # a re-put refreshes the position and replaces the bytes
    assert c.put("k2", _payload(512))
    assert c.keys() == ["k0", "k3", "k2"]
    assert c.stats()["bytes"] == 2 * 4096 + 2048
    # a payload alone over the budget is refused, nothing evicted
    assert not c.put("big", _payload(4 * 1024))
    assert c.stats()["entries"] == 3
    st = c.stats()
    assert (st["hits"], st["misses"]) == (1, 0)
    assert c.get("k1") is None and c.stats()["misses"] == 1
    c.clear()
    assert c.stats()["entries"] == 0 and c.stats()["bytes"] == 0


def test_prefix_cache_payloads_move_to_the_host_and_mix_dtypes():
    c = PrefixCache(max_mb=1.0)
    p = _payload(8, n_bf16=16, fill=0.5)
    assert c.put("k", p)
    assert c.stats()["bytes"] == 8 * 4 + 16 * 2
    got = c.get("k")
    assert got["leaf1"].dtype == torch.bfloat16
    assert got["leaf0"].device.type == "cpu"
    for name in p:
        assert torch.equal(got[name], p[name])
    # the entry holds its own copy: a later write to the source is not
    # seen (an in-place admission into the table must not reach the cache)
    p["leaf0"][0, 0] = 7.0
    assert float(c.get("k")["leaf0"][0, 0]) == 0.5


@pytest.mark.parametrize("leaf", ["leaf0", "leaf1"])
def test_prefix_cache_crc_catches_one_flipped_bit(leaf):
    """One flipped bit anywhere in the restored bytes — an f32 or a bf16
    leaf — fails the crc: the entry is dropped, counted poisoned and a
    miss, and never returned."""
    c = PrefixCache(max_mb=1.0)
    c.put("k", _payload(8, n_bf16=16))
    raw = c.peek("k")[leaf].reshape(-1).view(torch.uint8)
    raw[5] ^= 0x01
    assert c.get("k") is None
    st = c.stats()
    assert (st["poisoned"], st["misses"], st["hits"]) == (1, 1, 0)
    assert st["entries"] == 0 and st["bytes"] == 0
    # the crc covers the key too: an entry under another key's name fails
    c.put("a", _payload(8))
    c._entries["b"] = c._entries.pop("a")
    assert c.get("b") is None and c.stats()["poisoned"] == 2


def test_prefix_cache_crc_covers_shape_and_dtype():
    c = PrefixCache(max_mb=1.0)
    c.put("k", _payload(8))
    p = c.peek("k")
    p["leaf0"] = p["leaf0"].reshape(2, 4)         # same bytes, new shape
    assert c.get("k") is None and c.stats()["poisoned"] == 1


# ---------------------------------------------------------------------------
# SlotPager
# ---------------------------------------------------------------------------


def _record(tag, nbytes_f32=256):
    return PagedSlot(request=tag, row=0, limit=8, t_admit=0.0,
                     history=[0], tokens_done=1,
                     payload={"tokens": torch.zeros(1, 1, 9,
                                                    dtype=torch.long),
                              "state": {"s": torch.zeros(1, nbytes_f32 // 4),
                                        "b": torch.zeros(
                                            1, 8, dtype=torch.bfloat16)}})


def test_payload_bytes_counts_every_leaf():
    rec = _record("a")
    assert payload_bytes(rec.payload) == 9 * 8 + 256 + 8 * 2


def test_pager_fifo_room_and_budget():
    one = payload_bytes(_record("a").payload)
    pager = SlotPager(max_mb=2.5 * one / (1 << 20))    # room for 2
    assert pager.has_room(one) and len(pager) == 0
    assert pager.park(_record("a")) and pager.park(_record("b"))
    assert not pager.has_room(one)
    assert not pager.park(_record("c"))                # over budget
    assert pager.bytes_used() == 2 * one
    assert pager.pop().request == "a"                  # FIFO
    assert pager.park(_record("c"))
    assert [pager.pop().request for _ in range(2)] == ["b", "c"]
    assert pager.pop() is None
    assert pager.stats() == {"parked": 0, "bytes": 0, "paged_out": 3,
                             "paged_in": 3}


def test_pager_sweep_drop_and_clear():
    pager = SlotPager(max_mb=1.0)
    for tag in "abcd":
        pager.park(_record(tag))
    swept = pager.sweep_expired(lambda r: r.request in ("b", "d"))
    assert [r.request for r in swept] == ["b", "d"]
    assert len(pager) == 2
    assert pager.drop_request("a") and not pager.drop_request("zz")
    assert [r.request for r in pager.clear()] == ["c"]
    assert pager.stats()["bytes"] == 0 and len(pager) == 0
    # swept and dropped records are not page-ins
    assert pager.stats()["paged_in"] == 0


# ---------------------------------------------------------------------------
# the proposers
# ---------------------------------------------------------------------------


def test_proposer_positional_replay_and_fallbacks():
    """NGramProposer's keyed behaviour: exact-prefix positional replay wins
    and is confident; a diverged history falls back; learn() without a
    key still feeds the shared n-gram table."""
    p = NGramProposer(order=3)
    seq = [0, 5, 6, 7, 8, 9, 10]
    p.learn(seq, key="req-A")
    drafts, conf = p.propose_with_confidence([0, 5, 6], 3, key="req-A")
    assert (drafts, conf) == ([7, 8, 9], True)
    drafts, conf = p.propose_with_confidence([0, 5, 6], 8, key="req-A")
    assert len(drafts) == 8 and drafts[:4] == [7, 8, 9, 10] and conf
    drafts, conf = p.propose_with_confidence([0, 99, 5, 6], 2, key="req-A")
    assert (drafts, conf) == ([7, 8], True)
    drafts, conf = p.propose_with_confidence([0, 41, 42], 2, key="nope")
    assert conf is False and len(drafts) == 2
    # in-history suffix match: the slot's own repeated n-gram
    q = NGramProposer(order=2)
    assert q.propose_with_confidence([0, 3, 4, 9, 3, 4], 2) == ([9, 3],
                                                               True)
    base = DraftProposer()
    base.learn(seq, key="x")
    assert base.propose_with_confidence([0, 1], 2, key="x") == ([1, 1],
                                                                False)
    with pytest.raises(ValueError, match="order"):
        NGramProposer(order=0)


def test_ngram_proposer_drafts_as_the_reference(rng):
    """The same learned corpus and histories give the reference's drafts
    and confidence, keyed and unkeyed."""
    ours, ref = NGramProposer(order=3), JaxNGram(order=3)
    seqs = [[0] + list(rng.randint(2, 9, 14)) for _ in range(6)]
    for i, s in enumerate(seqs):
        ours.learn(s, key=f"k{i % 3}")
        ref.learn(s, key=f"k{i % 3}")
    for i in range(40):
        s = seqs[i % len(seqs)]
        h = s[:1 + i % 12] if i % 4 else [0] + list(rng.randint(2, 9, 5))
        key = f"k{i % 3}" if i % 2 else None
        for k in (1, 3, 5):
            assert (ours.propose_with_confidence(h, k, key=key)
                    == ref.propose_with_confidence(h, k, key=key))
            assert ours.propose(h, k) == ref.propose(h, k)


def test_ngram_proposer_tables_stay_bounded():
    p = NGramProposer(order=2, max_entries=10, max_seqs=2)
    for i in range(5):
        p.learn([0, i, i + 1, i + 2, i + 3], key=f"k{i}")
        assert len(p._seqs) <= 3
        assert len(p._index) <= 10 + 2 * 4
    assert p._seqs  # the newest completion survives a clear


def test_callable_and_adversarial_proposers():
    cp = CallableDraftProposer(lambda h, k: [7, 8, 9, 10, 11])
    assert cp.propose([0, 1], 3) == [7, 8, 9]          # truncated
    assert cp.propose([0, 1], 7) == [7, 8, 9, 10, 11, 11, 11]  # padded
    assert cp.propose_with_confidence([0], 2) == ([7, 8], True)
    empty = CallableDraftProposer(lambda h, k: [])
    assert empty.propose([0, 4], 3) == [4, 4, 4]       # base fallback
    adv = AdversarialProposer(token=5)
    assert adv.propose_with_confidence([0, 1, 2], 4) == ([5] * 4, True)
