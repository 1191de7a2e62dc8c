"""The port's sharded data pipeline (``paddle_tpu_torch.datapipe``) on the
CPU: every behaviour of ``tests/test_datapipe.py`` but the two gang tests
(the gang is ROADMAP.md Queue 1 item 9) and the ``bench.py`` README unit,
on the port's modules, the trainer's cursor resume included; ``.ptshard``
sets written by either package read by the other record for record, with
equal manifests and CRCs; the ``data`` subcommand; and the permutation,
cursor and split arithmetic against the JAX package's on the same
arguments.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_datapipe.py -q

Tolerance: none.  Records, permutations, cursors, losses and parameters
are compared for equality (the cursor resume bit for bit).
"""

import json
import os
import signal
import time
from collections import Counter

import numpy as np
import pytest
import torch

import paddle_tpu.datapipe as jdp

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.datapipe import (ShardDataset, ShardSource,
                                       is_checkpointable_source,
                                       pass_permutation, pass_rng_word,
                                       split_positions, write_shard_set)
from paddle_tpu_torch.datapipe.shards import ShardCorruptError, ShardError
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.resilience import PreemptionHandler, chaos
from paddle_tpu_torch.trainer import SGDTrainer, events as ev
from paddle_tpu_torch.utils.flags import FLAGS

HARD_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def hard_timeout():
    def _abort(signum, frame):
        raise RuntimeError(f"datapipe test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def fresh_names():
    nn.reset_naming()
    with compute_dtype_scope("float32"):
        yield


def _sample(i):
    return ([i, i + 1, i + 2], i % 3)


def _make_set(tmp_path, n=37, shards=3, name="set", writer=write_shard_set):
    out = os.path.join(str(tmp_path), name)
    writer(out, lambda: iter(_sample(i) for i in range(n)),
           num_shards=shards)
    return out


# ---------------------------------------------------------------------------
# shard format
# ---------------------------------------------------------------------------


def test_shard_roundtrip_preserves_stream_order(tmp_path):
    out = _make_set(tmp_path, n=37, shards=3)
    ds = ShardDataset(out)
    assert len(ds) == 37
    assert [ds.read(g) for g in range(37)] == [_sample(i) for i in range(37)]
    assert ds.read(29) == _sample(29)
    summary = ds.validate()
    assert summary["records"] == 37 and summary["shards"] == 3


def _manifest_wo_time(root):
    with open(os.path.join(root, "manifest.json")) as f:
        m = json.load(f)
    m.pop("wall_time")
    return m


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
def test_shard_sets_cross_between_the_packages(tmp_path, direction):
    """A set written by one package reads record for record through the
    other, verifies there, and both packages' sets of the same stream are
    the same bytes: manifests (but the wall time) and every shard file's
    CRC equal."""
    rs = np.random.RandomState(0)
    samples = [(rs.randint(0, 50, rs.randint(1, 9)).tolist(),
                int(rs.randint(0, 2)), rs.randn(3).astype(np.float32))
               for _ in range(29)]
    wj = os.path.join(str(tmp_path), "j")
    wp = os.path.join(str(tmp_path), "p")
    jdp.write_shard_set(wj, lambda: iter(samples), num_shards=4)
    write_shard_set(wp, lambda: iter(samples), num_shards=4)
    src, reader = ((wj, ShardDataset) if direction == "jax_writes"
                   else (wp, jdp.ShardDataset))
    ds = reader(src)
    got = [ds.read(g) for g in range(len(ds))]
    assert len(got) == len(samples)
    for g, s in zip(got, samples):
        assert g[:2] == s[:2]
        np.testing.assert_array_equal(g[2], s[2])
    assert ds.validate()["records"] == len(samples)
    assert _manifest_wo_time(wj) == _manifest_wo_time(wp)
    for entry in _manifest_wo_time(wj)["shards"]:
        with open(os.path.join(wj, entry["file"]), "rb") as a, \
                open(os.path.join(wp, entry["file"]), "rb") as b:
            assert a.read() == b.read(), entry["file"]


def test_shard_pack_is_atomic_and_refuses_overwrite(tmp_path):
    out = _make_set(tmp_path, name="s1")
    with pytest.raises(ShardError, match="already exists"):
        write_shard_set(out, lambda: iter([_sample(0)]))

    def bad_reader():
        yield _sample(0)
        raise IOError("disk on fire")

    out2 = os.path.join(str(tmp_path), "s2")
    with pytest.raises(IOError):
        write_shard_set(out2, bad_reader)
    assert not os.path.exists(out2)
    assert not [d for d in os.listdir(str(tmp_path)) if d.startswith(".tmp-")]


def test_corrupt_record_raises_typed_error_naming_shard_and_record(tmp_path):
    out = _make_set(tmp_path, n=20, shards=2)
    path = chaos.corrupt_shard(out, shard=1, record=3)
    ds = ShardDataset(out)
    with pytest.raises(ShardCorruptError) as ei:
        ds.read(7)
    assert ei.value.path == path and ei.value.record == 3
    assert "record 3" in str(ei.value) and path in str(ei.value)
    with pytest.raises(ShardCorruptError) as ei:
        ShardDataset(out).validate()
    assert ei.value.path == path
    # the JAX package's reader names the same address for the port's
    # damage (and the port's error is the port's ReaderError)
    from paddle_tpu_torch.resilience import ReaderError

    assert isinstance(ei.value, ReaderError)
    with pytest.raises(jdp.ShardCorruptError) as ji:
        jdp.ShardDataset(out).read(7)
    assert ji.value.path == path and ji.value.record == 3


def test_truncated_shard_fails_on_open(tmp_path):
    out = _make_set(tmp_path, n=20, shards=2)
    path = chaos.truncate_shard(out, shard=0)
    with pytest.raises(ShardCorruptError) as ei:
        ShardDataset(out).read(0)
    assert ei.value.path == path


def test_skip_corrupt_counts_dropped_records(tmp_path):
    out = _make_set(tmp_path, n=24, shards=2)
    chaos.corrupt_shard(out, shard=0, record=2)
    src = ShardSource(out, batch_size=4, seed=0, shuffle=False,
                      skip_corrupt=True)
    got = [x for b in src() for x in b]
    assert src.dropped_records == 1
    assert len(got) == 23
    assert _sample(4) not in got


def test_fully_corrupt_batch_window_fails_loudly_not_silently(tmp_path):
    out = _make_set(tmp_path, n=24, shards=2)
    for shard, rec in [(0, 2), (0, 3), (1, 2), (1, 3)]:
        chaos.corrupt_shard(out, shard=shard, record=rec)
    src = ShardSource(out, batch_size=4, seed=0, shuffle=False,
                      skip_corrupt=True)
    it = iter(src())
    assert len(next(it)) == 4
    with pytest.raises(ShardCorruptError, match="every record"):
        next(it)
    assert src.dropped_records == 4


def test_slow_shard_paces_reads(tmp_path):
    out = _make_set(tmp_path, n=8, shards=1)
    src = ShardSource(out, batch_size=4, seed=0, shuffle=False)
    chaos.slow_shard(src, delay_s=0.02)
    t0 = time.monotonic()
    list(src())
    assert time.monotonic() - t0 >= 8 * 0.02


def test_shard_read_counters_land_in_registry(tmp_path):
    from paddle_tpu_torch.obs import get_registry

    out = _make_set(tmp_path, n=10, shards=2)
    reg = get_registry()
    c = reg.counter("data_shard_records_total",
                    "records decoded from shard files")
    before = c.value
    ShardDataset(out).read(0)
    assert c.value == before + 1
    assert reg.counter("data_shard_read_bytes_total",
                       "payload bytes read from shard files").value > 0


# ---------------------------------------------------------------------------
# deterministic shuffle + host split
# ---------------------------------------------------------------------------


def test_pass_permutation_deterministic_per_seed_and_pass():
    p0 = pass_permutation(100, seed=5, pass_id=0)
    assert np.array_equal(p0, pass_permutation(100, seed=5, pass_id=0))
    assert not np.array_equal(p0, pass_permutation(100, seed=5, pass_id=1))
    assert not np.array_equal(p0, pass_permutation(100, seed=6, pass_id=0))
    assert np.array_equal(np.sort(p0), np.arange(100))
    assert np.array_equal(pass_permutation(10, 0, 0, shuffle=False),
                          np.arange(10))


@pytest.mark.parametrize("n,seed,pass_id", [(1, 0, 0), (100, 5, 0),
                                            (100, 5, 3), (1037, 11, 2)])
def test_sampler_equals_the_jax_packages(n, seed, pass_id):
    np.testing.assert_array_equal(pass_permutation(n, seed, pass_id),
                                  jdp.pass_permutation(n, seed, pass_id))
    assert pass_rng_word(seed, pass_id) == jdp.pass_rng_word(seed, pass_id)
    for w in (1, 3):
        for r in range(w):
            assert list(split_positions(n, 2, w, r)) == \
                list(jdp.split_positions(n, 2, w, r))


def test_split_positions_disjoint_and_complete():
    W = 4
    seen = Counter()
    for r in range(W):
        seen.update(split_positions(103, 7, W, r))
    assert all(v == 1 for v in seen.values())
    assert set(seen) == set(range(7, 103))


def test_source_batches_deterministic_and_world_split_disjoint(tmp_path):
    out = _make_set(tmp_path, n=48, shards=3)
    a = [x for b in ShardSource(out, batch_size=4, seed=9)() for x in b]
    b = [x for b_ in ShardSource(out, batch_size=4, seed=9)() for x in b_]
    assert a == b
    # the JAX package's source gives the same batches in the same order
    assert a == [x for b_ in jdp.ShardSource(out, batch_size=4, seed=9)()
                 for x in b_]
    ids = Counter()
    for r in range(4):
        s = ShardSource(out, batch_size=3, seed=9, world=4, index=r)
        for batch in s():
            ids.update(x[0][0] for x in batch)
    assert all(v == 1 for v in ids.values())
    assert len(ids) == 48


def test_elastic_reshard_resplits_same_permutation_no_dup_no_drop(tmp_path):
    N = 64
    out = _make_set(tmp_path, n=N, shards=4)
    consumed = Counter()
    pair = [ShardSource(out, batch_size=2, seed=11, world=2, index=r)
            for r in range(2)]
    its = [iter(s()) for s in pair]
    for _ in range(3):
        for it in its:
            consumed.update(x[0][0] for x in next(it))
    survivor = pair[0]
    survivor.reshard(1, 0, pass_id=0, next_batch=3)
    it = iter(survivor())
    for _ in range(4):
        consumed.update(x[0][0] for x in next(it))
    cur = survivor.cursor_for(0, 7)
    grown = []
    for r in range(2):
        s = ShardSource(out, batch_size=2, seed=11)
        s.restore(cur)
        s.bind_world(2, r)
        grown.append(s)
    for s in grown:
        for batch in s():
            consumed.update(x[0][0] for x in batch)
    assert all(v == 1 for v in consumed.values()), \
        {k: v for k, v in consumed.items() if v > 1}
    assert len(consumed) == N
    perm = pass_permutation(N, 11, 0)
    assert set(consumed) == {_sample(int(i))[0][0] for i in perm}


def test_cursor_for_is_read_ahead_proof(tmp_path):
    out = _make_set(tmp_path, n=40, shards=2)
    src = ShardSource(out, batch_size=4, seed=1)
    it = iter(src())
    for _ in range(5):
        next(it)
    cur = src.cursor_for(0, 2)
    assert cur["offset"] == 8 and cur["next_batch"] == 2
    # the cursor is the JAX package's, key for key
    jsrc = jdp.ShardSource(out, batch_size=4, seed=1)
    assert cur == jsrc.cursor_for(0, 2)
    s2 = ShardSource(out, batch_size=4, seed=1)
    s2.restore(cur)
    ref = [x for b in ShardSource(out, batch_size=4, seed=1)() for x in b]
    got = [x for b in s2() for x in b]
    assert got == ref[8:]


def test_cursor_survives_read_ahead_pass_rollover(tmp_path):
    out = _make_set(tmp_path, n=16, shards=2)
    src = ShardSource(out, batch_size=4, seed=2)
    list(src())
    assert src.pass_id == 1
    cur = src.cursor_for(0, 3)
    assert cur["offset"] == 12 and cur["pass"] == 0
    assert src.cursor_for(1, 0)["offset"] == 0
    src.reshard(2, 0, pass_id=0, next_batch=3)
    assert src.pass_id == 0
    assert src.cursor_for(0, 3)["offset"] == 12


def test_source_pass_rollover_and_seek(tmp_path):
    out = _make_set(tmp_path, n=16, shards=2)
    src = ShardSource(out, batch_size=4, seed=2)
    p0 = list(src())
    assert src.pass_id == 1
    p1 = list(src())
    assert p0 != p1
    src.seek(0)
    assert list(src()) == p0
    assert is_checkpointable_source(src)
    assert not is_checkpointable_source(lambda: iter([]))


def test_source_seed_defaults_to_the_shuffle_seed_flag(tmp_path,
                                                       monkeypatch):
    out = _make_set(tmp_path, n=16, shards=2)
    monkeypatch.setattr(FLAGS, "shuffle_seed", 7)
    assert ShardSource(out, batch_size=4).seed == 7


# ---------------------------------------------------------------------------
# trainer integration: the cursor resume
# ---------------------------------------------------------------------------


def _xy_set(tmp_path, n=48):
    rs = np.random.RandomState(0)
    samples = [(rs.randn(4).astype(np.float32).tolist(),
                rs.randn(2).astype(np.float32).tolist()) for _ in range(n)]
    out = os.path.join(str(tmp_path), "xy")
    write_shard_set(out, lambda: iter(samples), num_shards=2)
    return out


def _xy_feeder(batch):
    return {"x": np.asarray([b[0] for b in batch], np.float32),
            "y": np.asarray([b[1] for b in batch], np.float32)}


def _xy_trainer():
    nn.reset_naming()
    x = nn.data("x", size=4)
    y = nn.data("y", size=2)
    cost = nn.mse_cost(input=nn.fc(x, 2, act="relu", name="h"), label=y)
    return SGDTrainer(cost, Adam(learning_rate=0.05), seed=0, device="cpu")


def _record_losses(losses):
    def rec(e):
        if isinstance(e, ev.EndIteration):
            losses[f"{e.pass_id}:{e.batch_id}"] = float(e.cost)

    return rec


def test_cursor_resume_zero_replay_bitwise_losses(tmp_path, monkeypatch):
    """Preempt mid-pass with a datapipe source; resume="auto" restores the
    cursor: zero fast-forwarded batches, zero re-read samples (the shard
    read counter), and the completed run's losses and parameters equal the
    uninterrupted run's bit for bit.  The manifest's ``data_cursor`` is
    the reference's key and cursor."""
    from paddle_tpu_torch.obs import get_registry
    from paddle_tpu_torch.resilience import pass_dir, read_manifest

    out = _xy_set(tmp_path)
    monkeypatch.setattr(FLAGS, "log_period", 0)
    monkeypatch.setattr(FLAGS, "save_dir", "")
    ref_losses = {}
    tr = _xy_trainer()
    tr.train(ShardSource(out, batch_size=4, seed=3), num_passes=2,
             event_handler=_record_losses(ref_losses), feeder=_xy_feeder)
    ref_params = {k: v.detach().clone() for k, v in tr.params.items()}

    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path / "ck"))
    got = {}
    tr1 = _xy_trainer()
    h = PreemptionHandler()
    tr1.train(ShardSource(out, batch_size=4, seed=3), num_passes=2,
              event_handler=chaos.preempt_at(h, batch=2, pass_id=1,
                                             inner=_record_losses(got)),
              feeder=_xy_feeder, preemption=h, resume="auto")
    assert tr1.preempted
    meta = read_manifest(pass_dir(str(tmp_path / "ck"), 1))["meta"]
    jsrc = jdp.ShardSource(out, batch_size=4, seed=3)
    jsrc.seek(1)
    assert meta["data_cursor"] == jsrc.cursor_for(1, 3)
    assert meta["data_cursor"]["offset"] == 12

    reads = get_registry().counter("data_shard_records_total",
                                   "records decoded from shard files")
    reads_before = reads.value
    tr2 = _xy_trainer()
    tr2.train(ShardSource(out, batch_size=4, seed=3), num_passes=2,
              event_handler=_record_losses(got), feeder=_xy_feeder,
              resume="auto")
    assert tr2.resume_replayed_batches == 0
    remaining = len([k for k in ref_losses if k.startswith("1:")]) - 3
    assert reads.value - reads_before == remaining * 4

    assert set(got) == set(ref_losses)
    for k, v in ref_losses.items():
        assert got[k] == v, (k, got[k], v)
    for k, v in ref_params.items():
        assert torch.equal(tr2.params[k].detach(), v), k


def test_plain_reader_keeps_fast_forward_fallback(tmp_path, monkeypatch):
    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path / "ck"))
    monkeypatch.setattr(FLAGS, "log_period", 0)
    rs = np.random.RandomState(0)
    feeds = [{"x": rs.randn(4, 4).astype(np.float32),
              "y": rs.randn(4, 2).astype(np.float32)} for _ in range(6)]
    tr = _xy_trainer()
    h = PreemptionHandler()
    tr.train(lambda: iter(feeds), num_passes=2,
             event_handler=chaos.preempt_at(h, batch=3, pass_id=1),
             preemption=h, resume="auto")
    assert tr.preempted
    tr2 = _xy_trainer()
    tr2.train(lambda: iter(feeds), num_passes=2, resume="auto")
    assert tr2.resume_replayed_batches > 0


def test_dropped_records_surfaced_in_last_extras(tmp_path, monkeypatch):
    out = _xy_set(tmp_path, n=24)
    chaos.corrupt_shard(out, shard=0, record=1)
    monkeypatch.setattr(FLAGS, "save_dir", "")
    monkeypatch.setattr(FLAGS, "log_period", 0)
    tr = _xy_trainer()
    src = ShardSource(out, batch_size=4, seed=0, shuffle=False,
                      skip_corrupt=True)
    tr.train(src, num_passes=1, feeder=_xy_feeder)
    assert src.dropped_records == 1
    assert tr._last_extras["dropped_records"] == 1


def test_corrupt_record_without_skip_attributed_as_reader_error(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.resilience import ReaderError

    out = _xy_set(tmp_path, n=24)
    chaos.corrupt_shard(out, shard=0, record=1)
    monkeypatch.setattr(FLAGS, "save_dir", "")
    monkeypatch.setattr(FLAGS, "log_period", 0)
    tr = _xy_trainer()
    src = ShardSource(out, batch_size=4, seed=0, shuffle=False)
    with pytest.raises(ReaderError):
        tr.train(src, num_passes=1, feeder=_xy_feeder)


# ---------------------------------------------------------------------------
# the data subcommand
# ---------------------------------------------------------------------------


def test_data_subcommand_packs_and_verifies(tmp_path, capsys, monkeypatch):
    """``python -m paddle_tpu_torch data pack --config ... --shards`` then
    ``data verify``: the set holds the config's samples in stream order;
    a damaged record makes verify exit 2 naming the file."""
    from paddle_tpu_torch.__main__ import main

    for k, v in (("VOCAB", 48), ("EMB", 8), ("HID", 12), ("BATCH", 6),
                 ("T", 10), ("N", 18)):
        monkeypatch.setenv(f"TORCH_TEXTCLF_{k}", str(v))
    conf = os.path.join(os.path.dirname(__file__), "torch_textclf_conf.py")
    out = str(tmp_path / "set")
    assert main(["data", "pack", out, "--config", conf, "--shards", "4"]) == 0
    assert "packed 18 record(s) into 4 shard(s)" in capsys.readouterr().out
    assert main(["data", "verify", out]) == 0
    assert "verified 18 record(s) across 4 shard(s)" in \
        capsys.readouterr().out
    import paddle_tpu_torch.data as data

    want = list(data.datasets.imdb("train", vocab_size=48, n=18)())
    ds = ShardDataset(out)
    assert [ds.read(g) for g in range(18)] == [tuple(s) for s in want]
    path = chaos.corrupt_shard(out, shard=2, record=1)
    assert main(["data", "verify", out]) == 2
    assert path in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["data", "pack", str(tmp_path / "x"), "--reader", "nocolon"])
