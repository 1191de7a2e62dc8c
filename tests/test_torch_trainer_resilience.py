"""Fault-tolerant training on the port (the checkpoint, guard, reader and
preemption cases of tests/test_resilience.py).

Checkpoints are the reference's format: the JAX package's
``save_checkpoint`` and the port's read each other's directories, bf16
leaves included.  The bad-step guard holds the parameters, the slots and
the step counter bit for bit.  Comparisons of two runs of the port are
exact (``torch.equal``): both run the same CPU arithmetic.  Signals are
driven through ``PreemptionHandler.request()``; the one real SIGTERM runs
in a subprocess with its own timeout.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.resilience import checkpoint_io as jckpt

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam, slot_leaves
from paddle_tpu_torch.resilience import (CheckpointError, PreemptionHandler,
                                         ReaderError, TooManyBadSteps, chaos,
                                         latest_pass, load_checkpoint,
                                         prune_checkpoints, read_manifest,
                                         resilient_reader, save_checkpoint,
                                         validate_checkpoint)
from paddle_tpu_torch.resilience.checkpoint_io import pass_dir, save_pytree
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.trainer import events as ev
from paddle_tpu_torch.utils.flags import FLAGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setattr(FLAGS, "log_period", 0)
    monkeypatch.setattr(FLAGS, "save_dir", "")


def _params():
    return {"w": torch.ones((4, 8), dtype=torch.bfloat16),
            "b": torch.arange(6, dtype=torch.float32)}


def _like_f32():
    return {"w": torch.zeros((4, 8)), "b": torch.zeros(6)}


def _trainer(seed=0, **kw):
    nn.reset_naming()
    x = nn.data("x", size=4)
    lab = nn.data("label", size=1, dtype="int32")
    h = nn.fc(x, 6, act="tanh", name="h")
    cost = nn.classification_cost(nn.fc(h, 3, act="linear", name="out"),
                                  lab, name="cost")
    return SGDTrainer(cost, Adam(learning_rate=0.05), seed=seed,
                      device="cpu", **kw)


def _feeds(n=6, batch=4):
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(batch, 4).astype(np.float32),
             "label": rs.randint(0, 3, (batch, 1))} for _ in range(n)]


def _snapshot(tr):
    return ({k: v.detach().clone() for k, v in tr.params.items()},
            {k: [s.clone() for s in slot_leaves(v)]
             for k, v in tr.opt_state["slots"].items()},
            tr.opt_state["step"].clone())


def _assert_same(a, b):
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
        for x, y in zip(a[1][k], b[1][k]):
            assert torch.equal(x, y), k
    assert torch.equal(a[2], b[2])


# ---------------------------------------------------------------------------
# atomic, verified checkpoints
# ---------------------------------------------------------------------------


def test_atomic_save_manifest_and_no_temp_leftovers(tmp_path):
    d = save_checkpoint(str(tmp_path), 3, params=_params(),
                        meta={"note": "x"})
    assert os.path.basename(d) == "pass-00003"
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]
    m = read_manifest(d)
    assert m["version"] == 1 and m["pass_id"] == 3 and m["time"] > 0
    assert m["meta"]["note"] == "x"
    w = m["files"]["params.npz"]["arrays"]["['w']"]
    assert w["orig_dtype"] == "bfloat16" and w["stored_dtype"] == "float32"
    assert w["shape"] == [4, 8] and isinstance(w["crc32"], int)
    assert validate_checkpoint(d) is None


def test_orig_dtype_restored_from_manifest(tmp_path):
    save_checkpoint(str(tmp_path), 0, params=_params())
    p, _, _ = load_checkpoint(str(tmp_path), 0, params=_like_f32())
    assert p["w"].dtype == torch.bfloat16 and p["b"].dtype == torch.float32
    assert torch.equal(p["w"].float(), torch.ones(4, 8))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages_with_bf16(tmp_path, writer):
    """Either package's checkpoint validates and loads in the other, with
    the same keys, CRCs, original dtypes and values."""
    rs = np.random.RandomState(1)
    w = rs.randn(3, 5).astype(np.float32)
    tree = {"params": {"w": w, "b": np.arange(4, dtype=np.int32)},
            "slots": {"w": (w * 2, w * 3), "b": ()}, "step": np.int32(7)}
    if writer == "jax":
        jtree = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                            "b": jnp.asarray(tree["params"]["b"])},
                 "slots": {"w": tuple(jnp.asarray(s)
                                      for s in tree["slots"]["w"]),
                           "b": ()},
                 "step": jnp.asarray(7, jnp.int32)}
        jckpt.save_checkpoint(str(tmp_path), 2, params=jtree["params"],
                              opt_state={"slots": jtree["slots"],
                                         "step": jtree["step"]},
                              keep_last_n=0)
        assert validate_checkpoint(pass_dir(str(tmp_path), 2)) is None
        like = {"w": torch.zeros(3, 5), "b": torch.zeros(4,
                                                         dtype=torch.int32)}
        like_o = {"slots": {"w": (torch.zeros(3, 5), torch.zeros(3, 5)),
                            "b": ()}, "step": torch.zeros((),
                                                          dtype=torch.int32)}
        p, _, o = load_checkpoint(str(tmp_path), 2, params=like,
                                  opt_state=like_o)
        assert p["w"].dtype == torch.bfloat16
        assert torch.equal(p["w"].float(), torch.from_numpy(
            np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)))
        assert torch.equal(o["slots"]["w"][1], torch.from_numpy(w * 3))
        assert int(o["step"]) == 7 and o["slots"]["b"] == ()
    else:
        save_checkpoint(str(tmp_path), 2, params={
            "w": torch.from_numpy(w).to(torch.bfloat16),
            "b": torch.from_numpy(tree["params"]["b"])},
            opt_state={"slots": {"w": tuple(torch.from_numpy(s) for s in
                                            tree["slots"]["w"]), "b": ()},
                       "step": torch.tensor(7, dtype=torch.int32)},
            keep_last_n=0)
        assert jckpt.validate_checkpoint(pass_dir(str(tmp_path), 2)) is None
        like = {"w": np.zeros((3, 5), np.float32),
                "b": np.zeros(4, np.int32)}
        like_o = {"slots": {"w": (np.zeros((3, 5), np.float32),) * 2,
                            "b": ()}, "step": np.int32(0)}
        p, _, o = jckpt.load_checkpoint(str(tmp_path), 2, params=like,
                                        opt_state=like_o)
        assert str(np.asarray(p["w"]).dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(o["slots"]["w"][1]), w * 3)
        assert int(o["step"]) == 7


def test_latest_pass_accepts_six_digit_ids(tmp_path):
    save_checkpoint(str(tmp_path), 7, params=_params())
    save_checkpoint(str(tmp_path), 123456, params=_params())
    assert latest_pass(str(tmp_path)) == 123456
    assert sorted(os.listdir(tmp_path)) == ["pass-00007", "pass-123456"]


@pytest.mark.parametrize("damage", [
    lambda d: chaos.corrupt_checkpoint(d, mode="corrupt"),
    lambda d: chaos.corrupt_checkpoint(d, mode="truncate"),
    lambda d: chaos.corrupt_checkpoint(d, mode="delete"),
    lambda d: os.remove(os.path.join(d, "manifest.json")),
    lambda d: chaos.truncate_file(os.path.join(d, "manifest.json"),
                                  keep_bytes=10),
], ids=["corrupt", "truncate", "delete", "no_manifest", "torn_manifest"])
def test_latest_pass_skips_damaged_and_falls_back(tmp_path, damage):
    save_checkpoint(str(tmp_path), 1, params=_params())
    save_checkpoint(str(tmp_path), 2, params=_params())
    damage(pass_dir(str(tmp_path), 2))
    assert validate_checkpoint(pass_dir(str(tmp_path), 2)) is not None
    assert latest_pass(str(tmp_path)) == 1
    with pytest.raises(CheckpointError):
        load_checkpoint(str(tmp_path), 2, params=_like_f32())
    p, _, _ = load_checkpoint(str(tmp_path), 1, params=_like_f32())
    assert p["w"].dtype == torch.bfloat16


def test_crc_catches_silent_bitflip(tmp_path):
    d = save_checkpoint(str(tmp_path), 0, params=_params())
    assert validate_checkpoint(d) is None
    chaos.corrupt_file(os.path.join(d, "params.npz"), nbytes=8)
    assert validate_checkpoint(d) is not None


def test_legacy_checkpoint_dir_still_loads(tmp_path):
    d = tmp_path / "pass-00004"
    d.mkdir()
    save_pytree(str(d / "params.npz"), _like_f32())
    (d / "manifest.json").write_text(json.dumps(
        {"pass_id": 4, "has_state": False, "has_opt": False}))
    assert validate_checkpoint(str(d)) is None
    assert latest_pass(str(tmp_path)) == 4
    p, _, _ = load_checkpoint(str(tmp_path), 4, params=_like_f32())
    assert p["w"].dtype == torch.float32


def test_quarantined_dir_is_refused(tmp_path):
    from paddle_tpu_torch.resilience import quarantine_checkpoint

    save_checkpoint(str(tmp_path), 0, params=_params())
    save_checkpoint(str(tmp_path), 1, params=_params())
    quarantine_checkpoint(pass_dir(str(tmp_path), 1), "bit rot")
    assert "bit rot" in validate_checkpoint(pass_dir(str(tmp_path), 1))
    assert latest_pass(str(tmp_path)) == 0


def test_resave_same_pass_publishes_new_without_destroying_old(tmp_path):
    save_checkpoint(str(tmp_path), 0, params=_params(), meta={"v": 1})
    save_checkpoint(str(tmp_path), 0, params=_params(), meta={"v": 2})
    assert sorted(os.listdir(tmp_path)) == ["pass-00000"]
    assert validate_checkpoint(pass_dir(str(tmp_path), 0)) is None
    assert read_manifest(pass_dir(str(tmp_path), 0))["meta"]["v"] == 2


def test_keep_last_n_retention_and_tmp_sweep(tmp_path):
    for i in range(5):
        save_checkpoint(str(tmp_path), i, params=_params())
    junk = tmp_path / ".tmp-pass-00099-dead"
    junk.mkdir()
    os.utime(junk, (1, 1))  # debris of a long-crashed save
    save_checkpoint(str(tmp_path), 5, params=_params(), keep_last_n=2)
    assert sorted(os.listdir(tmp_path)) == ["pass-00004", "pass-00005"]
    assert not junk.exists()
    removed = prune_checkpoints(str(tmp_path), 1)
    assert sorted(os.listdir(tmp_path)) == ["pass-00005"] and removed


def test_prune_leaves_inflight_tmp_dirs_alone(tmp_path):
    save_checkpoint(str(tmp_path), 0, params=_params())
    inflight = tmp_path / ".tmp-pass-00001-beef1234"
    inflight.mkdir()
    old = tmp_path / ".tmp-pass-00001-dead5678"
    old.mkdir()
    os.utime(old, (1, 1))
    slow = tmp_path / ".tmp-pass-00002-slow9abc"
    slow.mkdir()
    (slow / "params.npz").write_bytes(b"partial")  # a fresh file inside
    os.utime(slow, (1, 1))
    removed = prune_checkpoints(str(tmp_path), 1)
    assert inflight.exists() and slow.exists() and not old.exists()
    assert str(old) in removed
    assert prune_checkpoints(str(tmp_path / "nope"), 1) == []


def test_trainer_save_load_roundtrip_restores_rng_stream(tmp_path):
    """``save``/``load`` restore parameters, slots, the step and the random
    stream: the next step after a restore equals the original's."""
    feeds = _feeds(2)
    t1 = _trainer(seed=5)
    t1.train_batch(feeds[0])
    t1.save(str(tmp_path), 0)
    t2 = _trainer(seed=99)
    t2.load(str(tmp_path), 0)
    _assert_same(_snapshot(t1), _snapshot(t2))
    assert torch.equal(t1._gen.get_state(), t2._gen.get_state())
    assert torch.equal(t1.train_batch(feeds[1]), t2.train_batch(feeds[1]))
    _assert_same(_snapshot(t1), _snapshot(t2))


# ---------------------------------------------------------------------------
# bad-step guard
# ---------------------------------------------------------------------------


def test_nan_batch_skipped_everything_held_counter_incremented():
    tr = _trainer()
    feeds = _feeds(3)
    tr.train_batch(feeds[0])
    before = _snapshot(tr)
    loss = tr.train_batch(chaos.nan_feed(feeds[1]))
    assert not np.isfinite(float(loss))
    assert tr.bad_steps_total == 1 and tr.bad_steps_streak == 1
    assert int(tr._last_extras["bad_step"]) == 1
    _assert_same(before, _snapshot(tr))
    assert int(tr.opt_state["step"]) == 1
    after = float(tr.train_batch(feeds[2]))
    assert np.isfinite(after) and tr.bad_steps_streak == 0
    assert int(tr.opt_state["step"]) == 2


def test_skipped_step_leaves_the_unpoisoned_run_unchanged():
    """A run with a NaN batch in the middle continues exactly as the run
    without it: the skip held every bit."""
    feeds = _feeds(4)
    a, b = _trainer(), _trainer()
    for f in feeds:
        a.train_batch(f)
    for i, f in enumerate(feeds):
        if i == 2:
            b.train_batch(chaos.nan_feed(f))
        b.train_batch(f)
    _assert_same(_snapshot(a), _snapshot(b))


def test_nan_injection_mid_pass_training_recovers():
    tr = _trainer()
    reader = chaos.inject_nan_batches(lambda: iter(_feeds(6)), {2})
    costs = []
    tr.train(reader, num_passes=1,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, ev.EndIteration) else None)
    assert len(costs) == 6
    assert not np.isfinite(costs[2]) and np.isfinite(costs[3])
    assert tr.bad_steps_total == 1


def test_abort_after_consecutive_bad_steps():
    tr = _trainer(max_bad_steps=3)
    bad = chaos.nan_feed(_feeds(1)[0])
    tr.train_batch(bad)
    tr.train_batch(bad)
    with pytest.raises(TooManyBadSteps):
        tr.train_batch(bad)
    assert tr.bad_steps_total == 3


def test_abort_mid_pass_emits_endpass():
    tr = _trainer(max_bad_steps=2)
    reader = chaos.inject_nan_batches(lambda: iter(_feeds(6)), {1, 2, 3})
    seen = []
    with pytest.raises(TooManyBadSteps):
        tr.train(reader, num_passes=1, event_handler=seen.append)
    assert isinstance(seen[-1], ev.EndPass)


def test_guard_off_keeps_plain_step():
    tr = _trainer(guard_nonfinite=False)
    tr.train_batch(_feeds(1)[0])
    assert "bad_step" not in tr._last_extras


def test_registry_counts_batches_bad_steps_and_checkpoints(tmp_path):
    from paddle_tpu_torch.obs import get_registry

    reg = get_registry()
    c = {n: reg.counter(n).value for n in
         ("train_batches_total", "train_bad_steps_total",
          "train_checkpoints_total")}
    tr = _trainer()
    f = _feeds(2)
    tr.train_batch(f[0])
    tr.train_batch(chaos.nan_feed(f[1]))
    tr.save(str(tmp_path), 0)
    assert reg.counter("train_batches_total").value == \
        c["train_batches_total"] + 2
    assert reg.counter("train_bad_steps_total").value == \
        c["train_bad_steps_total"] + 1
    assert reg.counter("train_checkpoints_total").value == \
        c["train_checkpoints_total"] + 1


# ---------------------------------------------------------------------------
# resilient reader
# ---------------------------------------------------------------------------


def test_resilient_reader_retries_with_exponential_backoff():
    feeds = list(range(6))
    sleeps, errors = [], []
    rr = resilient_reader(
        chaos.flaky_reader(lambda: iter(feeds), fail_at=2, times=2),
        max_retries=3, backoff=0.1, sleep=sleeps.append,
        on_error=lambda e, i: errors.append(i))
    assert list(rr()) == feeds
    assert sleeps == [0.1, 0.2] and errors == [2, 2]


def test_resilient_reader_budget_exhausted_raises_reader_error():
    rr = resilient_reader(
        chaos.flaky_reader(lambda: iter(range(4)), fail_at=1, times=99),
        max_retries=2, backoff=0.0, sleep=lambda s: None)
    with pytest.raises(ReaderError):
        list(rr())


def test_resilient_reader_skip_bad_and_replay_policy():
    rr = resilient_reader(
        chaos.flaky_reader(lambda: iter(range(5)), fail_at=2, times=99),
        max_retries=1, backoff=0.0, skip_bad=True, sleep=lambda s: None)
    assert list(rr()) == [0, 1, 3, 4]
    persistent = chaos.flaky_reader(lambda: iter(range(8)), fail_at=4,
                                    times=99)
    transient = chaos.flaky_reader(persistent, fail_at=6, times=1)
    rr = resilient_reader(transient, max_retries=1, backoff=0.0,
                          skip_bad=True, sleep=lambda s: None)
    assert list(rr()) == [0, 1, 2, 3, 5, 6, 7]


def test_resilient_reader_budget_resets_after_progress():
    feeds = list(range(10))
    flaky = chaos.flaky_reader(
        chaos.flaky_reader(lambda: iter(feeds), fail_at=1, times=2),
        fail_at=7, times=2)
    rr = resilient_reader(flaky, max_retries=2, backoff=0.0,
                          sleep=lambda s: None)
    assert list(rr()) == feeds


def test_reader_crash_mid_pass_emits_endpass_and_reader_error():
    tr = _trainer()
    feeds = _feeds(3)

    def bad_reader():
        yield feeds[0]
        raise IOError("shard went away")

    seen = []
    with pytest.raises(ReaderError) as ei:
        tr.train(lambda: bad_reader(), num_passes=1,
                 event_handler=seen.append)
    assert "shard went away" in str(ei.value)
    assert isinstance(ei.value.__cause__, IOError)
    assert isinstance(seen[-1], ev.EndPass)
    assert any(isinstance(e, ev.EndIteration) for e in seen)


def test_reader_creation_failure_attributed_too():
    tr = _trainer()

    def broken_creator():
        raise RuntimeError("cannot open dataset")

    seen = []
    with pytest.raises(ReaderError):
        tr.train(broken_creator, num_passes=1, event_handler=seen.append)
    assert [type(e).__name__ for e in seen] == ["BeginPass", "EndPass"]


def test_trainer_with_resilient_reader_absorbs_flaky_source():
    tr = _trainer()
    rr = resilient_reader(
        chaos.flaky_reader(lambda: iter(_feeds(5)), fail_at=3, times=1),
        max_retries=2, backoff=0.0, sleep=lambda s: None)
    n = []
    tr.train(rr, num_passes=1, event_handler=lambda e: n.append(e)
             if isinstance(e, ev.EndIteration) else None)
    assert len(n) == 5


# ---------------------------------------------------------------------------
# preemption + auto-resume
# ---------------------------------------------------------------------------


def _losses(into):
    return lambda e: (into.append(e.cost)
                      if isinstance(e, ev.EndIteration) else None)


def test_preemption_checkpoint_resumes_to_identical_loss(tmp_path,
                                                         monkeypatch):
    """Preempted in pass 1 at batch 2: ``resume="auto"`` restores params,
    slots, the step and the random stream and lands on exactly the
    uninterrupted run's losses and parameters."""
    feeds = _feeds(6)

    def reader():
        return iter(feeds)

    losses_a = []
    tr_a = _trainer()
    tr_a.train(reader, num_passes=3, event_handler=_losses(losses_a))

    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    tr_b = _trainer()
    h = PreemptionHandler()
    tr_b.train(reader, num_passes=3, preemption=h,
               event_handler=chaos.preempt_at(h, batch=2, pass_id=1))
    assert tr_b.preempted
    m = read_manifest(pass_dir(str(tmp_path), 1))
    # the request lands at batch 2's BeginIteration; batch 2 is stepped and
    # the checkpoint is written at the next boundary
    assert m["meta"]["preempted"] and m["meta"]["next_batch"] == 3
    assert m["meta"]["torch_rng_state"]

    losses_c = []
    tr_c = _trainer()
    tr_c.train(reader, num_passes=3, resume="auto",
               event_handler=_losses(losses_c))
    assert tr_c.resume_replayed_batches == 3
    assert losses_c == losses_a[-len(losses_c):] and len(losses_c) == 9
    _assert_same(_snapshot(tr_a), _snapshot(tr_c))


def test_real_sigterm_produces_resumable_checkpoint(tmp_path):
    """A real SIGTERM mid-pass (in a subprocess with its own timeout)
    checkpoints at the batch boundary, exits cleanly and restores the
    previous handler; a second run resumes and completes the pass."""
    code = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {ROOT!r})
        sys.path.insert(0, {os.path.join(ROOT, "tests")!r})
        import test_torch_trainer_resilience as T
        from paddle_tpu_torch.resilience.checkpoint_io import (
            latest_pass, pass_dir, read_manifest)
        from paddle_tpu_torch.trainer import events as ev
        from paddle_tpu_torch.utils.flags import FLAGS
        FLAGS.log_period = 0
        FLAGS.save_dir = {str(tmp_path)!r}
        feeds = T._feeds(5)
        tr = T._trainer(seed=3)
        def handler(e):
            if isinstance(e, ev.BeginIteration) and e.batch_id == 1:
                os.kill(os.getpid(), signal.SIGTERM)
        prev = signal.getsignal(signal.SIGTERM)
        tr.train(lambda: iter(feeds), num_passes=1, event_handler=handler)
        assert tr.preempted
        assert signal.getsignal(signal.SIGTERM) == prev
        assert latest_pass({str(tmp_path)!r}) == 0
        meta = read_manifest(pass_dir({str(tmp_path)!r}, 0))["meta"]
        assert meta["preempted"] and meta["next_batch"] == 2
        tr2 = T._trainer(seed=3)
        tr2.train(lambda: iter(feeds), num_passes=1, resume="auto")
        assert not tr2.preempted
        print("SIGTERM-OK")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SIGTERM-OK" in out.stdout


def test_second_signal_escalates_to_default_disposition():
    """One signal latches the request; a second restores the previous
    handlers and re-delivers (so Ctrl-C regains its meaning)."""
    import time as _time

    h = PreemptionHandler(signals=(signal.SIGINT,))
    prev = signal.getsignal(signal.SIGINT)
    with h:
        os.kill(os.getpid(), signal.SIGINT)
        for _ in range(200):
            if h.requested:
                break
            _time.sleep(0.005)
        assert h.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
            _time.sleep(0.5)
    assert signal.getsignal(signal.SIGINT) == prev


def test_auto_resume_skips_corrupt_newest_and_uses_previous(tmp_path,
                                                            monkeypatch):
    """Passes 0 and 1 checkpointed, pass 1 truncated: ``resume="auto"``
    falls back to pass 0, reruns pass 1 from pass 0's values, and re-saves
    pass 1."""
    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    feeds = _feeds(4)
    tr = _trainer()
    tr.train(lambda: iter(feeds), num_passes=2)
    final = _snapshot(tr)
    assert latest_pass(str(tmp_path)) == 1
    chaos.corrupt_checkpoint(pass_dir(str(tmp_path), 1), mode="truncate")
    tr2 = _trainer(seed=7)
    begun = []
    tr2.train(lambda: iter(feeds), num_passes=2, resume="auto",
              event_handler=lambda e: begun.append(e.pass_id)
              if isinstance(e, ev.BeginPass) else None)
    assert begun == [1]
    assert validate_checkpoint(pass_dir(str(tmp_path), 1)) is None
    _assert_same(final, _snapshot(tr2))


def test_auto_resume_fresh_start_and_nothing_left_to_do(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    begun = []
    tr = _trainer()
    tr.train(lambda: iter(_feeds(2)), num_passes=1, resume="auto",
             event_handler=lambda e: begun.append(e.pass_id)
             if isinstance(e, ev.BeginPass) else None)
    assert begun == [0]
    stepped = []
    _trainer().train(lambda: iter(_feeds(2)), num_passes=1, resume="auto",
                     event_handler=lambda e: stepped.append(e)
                     if isinstance(e, ev.EndIteration) else None)
    assert stepped == []
    with pytest.raises(ValueError, match="resume"):
        _trainer().train(lambda: iter(()), resume="always")


def test_keep_last_n_and_saving_period_through_train(tmp_path, monkeypatch):
    monkeypatch.setattr(FLAGS, "save_dir", str(tmp_path))
    monkeypatch.setattr(FLAGS, "keep_last_n", 2)
    monkeypatch.setattr(FLAGS, "saving_period", 2)
    _trainer().train(lambda: iter(_feeds(2)), num_passes=6)
    assert sorted(os.listdir(tmp_path)) == ["pass-00003", "pass-00005"]
