"""The port's continuous publication and hot reload
(``paddle_tpu_torch/publish``, ``serving/reload.py``) on the CPU, against
the JAX package where both packages compute the same thing.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_publish.py -q

- The seven contracts of ``tests/test_publish.py`` on the port, each
  opening with the reference test it mirrors: the gate's typed, journaled
  refusals; a corrupt publish skipped while the previous version serves;
  zero dropped requests across three reload cycles, every reply equal to
  the answering version's own bundle (bit for bit: both run the same plain
  versions on the same rows); a NaN-poisoned version rolled back within
  probation; a worker killed mid-swap strands no request; the freshness
  chain from the journal; a table reader's stalled reload rolling the
  version back (the reference's own ``TableReader`` is the pserver tier,
  ROADMAP.md Queue 1 item 8; here any object with ``hot_reload`` and
  ``last_stop``).
- Version directories cross the packages both ways: one the JAX package
  publishes loads, serves and hot-swaps in the port, one the port publishes
  loads in the JAX package; served outputs agree within rtol 1e-5 / atol
  1e-6 (the deploy tests' tolerance).  ``validate_version``, the manifest
  schema, the architecture fingerprint and ``freshness_from_journal`` give
  equal results in both packages on the same files and records.

Compute is float32; every test runs under a hard ``signal.alarm``.  The
reference's reload test fails in this repository's tier-1 runs (ROADMAP.md
Queue 3: its shared compile cache), so the port is held to its contract,
not to its pass/fail.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.obs.journal import (close_journal, journal_path,
                                          read_journal)
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import Adam
from paddle_tpu_torch.publish import (PublishRefused, freshness_from_journal,
                                      publish_cache_dir,
                                      publish_from_checkpoints,
                                      read_version_manifest,
                                      validate_version, version_dir)
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import InferenceFailed, InferenceServer
from paddle_tpu_torch.serving.reload import HotSwapManager, load_published
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.flags import FLAGS

HARD_TIMEOUT_S = 120
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def hard_timeout_and_f32():
    def _abort(signum, frame):
        raise RuntimeError(f"publish test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    with compute_dtype_scope("float32"):
        yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture
def journal(tmp_path, monkeypatch):
    d = str(tmp_path / "j")
    monkeypatch.setattr(FLAGS, "obs_journal", d)
    yield d
    close_journal()


def _net(nn):
    nn.reset_naming()
    x = nn.data("x", size=6, is_seq=True)
    pool = nn.pooling(nn.fc(x, 8, act="relu", name="h"),
                      pooling_type="max", name="pool")
    logits = nn.fc(pool, 3, act="linear", name="logits")
    label = nn.data("label", size=1, dtype="int32")
    return nn.classification_cost(logits, label, name="cost")


def _tiny_trainer():
    return SGDTrainer(_net(tnn), Adam(learning_rate=0.05), seed=0,
                      device="cpu")


def _batch(rng):
    xs = rng.randn(4, 5, 6).astype(np.float32)
    lens = np.array([5, 3, 4, 5], np.int32)
    return {"x": (xs, lens), "label": np.zeros((4, 1), np.int32)}


def _req(batch):
    xs, lens = batch["x"]
    return {"x": (xs[:1], lens[:1])}


def _publish(pub, tr, save, **kw):
    return publish_from_checkpoints(pub, tr.topology, save, device="cpu",
                                    **kw)


def _boot(pub, **mgr_kw):
    """A server from the newest published version with the publish dir's
    shared cache, plus its HotSwapManager."""
    model, info, v = load_published(pub, device="cpu")
    srv = InferenceServer(model, outputs=["logits"], max_batch=4,
                          batch_delay_ms=1.0, max_queue=64,
                          default_deadline_ms=60000.0,
                          breaker_threshold=50)
    srv.start(compile_cache=publish_cache_dir(pub))
    mgr = HotSwapManager(srv, pub, **mgr_kw)
    mgr.attach_current(v, info)
    return srv, mgr


def _expected(pub, version, req):
    """The version's own reply, from its bundle directly."""
    from paddle_tpu_torch.config import load_inference_model

    m = load_inference_model(
        os.path.join(version_dir(pub, version), "model.ptz"), device="cpu")
    return m.infer(req, outputs=["logits"])["logits"]


def _records(jdir):
    close_journal()
    recs, torn = read_journal(journal_path(jdir, 0))
    assert torn == 0
    return recs


# ---------------------------------------------------------------------------
# the publication gate
# ---------------------------------------------------------------------------


def test_publish_gate_refusals_typed_and_journaled(tmp_path, journal, rng):
    """tests/test_publish.py::test_publish_gate_refusals_typed_and_journaled:
    an unverified or quarantined pass is unpublishable, every refusal is
    journaled with its signal, the default pass follows the verified tip,
    and a quantized export whose error gate fails refuses as
    ``export_gate``."""
    tr = _tiny_trainer()
    batch = _batch(rng)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    with pytest.raises(PublishRefused) as ei:
        _publish(pub, tr, save)
    assert ei.value.reason == "no_verified_pass"

    tr.train_batch(batch)
    tr.save(save, 0)
    tr.train_batch(batch)
    tr.save(save, 1)
    with open(os.path.join(save, "scrub.json"), "w") as f:
        json.dump({"latest_verified_pass": 0,
                   "passes": {"0": "ok", "1": "ok"}}, f)
    with pytest.raises(PublishRefused) as ei:
        _publish(pub, tr, save, pass_id=1)
    assert ei.value.reason == "pass_not_verified" and ei.value.pass_id == 1

    vdir = _publish(pub, tr, save)
    manifest = read_version_manifest(vdir)
    assert manifest["version"] == 1 and manifest["pass_id"] == 0
    assert manifest["train_commit_time"] > 0
    assert manifest["files"]["model.ptz"]["crc32"]
    assert validate_version(vdir) is None

    with pytest.raises(PublishRefused) as ei:
        _publish(pub, tr, save, quantize="bf16", quantize_tol=1e-12)
    assert ei.value.reason == "export_gate"

    from paddle_tpu_torch.resilience.checkpoint_io import (
        pass_dir, quarantine_checkpoint)

    quarantine_checkpoint(pass_dir(save, 0), "sdc quarantine (test)")
    with pytest.raises(PublishRefused) as ei:
        _publish(pub, tr, save, pass_id=0)
    assert ei.value.reason == "pass_quarantined"
    # a refused publish leaves no version and no temp dir behind
    assert sorted(os.listdir(pub)) == ["ccache", "v-00001"]

    recs = _records(journal)
    refused = [r for r in recs if r["kind"] == "publish_refused"]
    assert [r["reason"] for r in refused] == [
        "no_verified_pass", "pass_not_verified", "export_gate",
        "pass_quarantined"]
    commits = [r for r in recs if r["kind"] == "publish_commit"]
    assert len(commits) == 1 and commits[0]["version"] == 1


def test_corrupt_publish_skipped_previous_version_keeps_serving(
        tmp_path, journal, rng):
    """tests/test_publish.py::
    test_corrupt_publish_skipped_previous_version_keeps_serving."""
    tr = _tiny_trainer()
    batch = _batch(rng)
    req = _req(batch)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    tr.train_batch(batch)
    tr.save(save, 0)
    _publish(pub, tr, save)
    srv, mgr = _boot(pub, probation_requests=2)
    try:
        want1 = _expected(pub, 1, req)
        tr.train_batch(batch)
        tr.save(save, 1)
        _publish(pub, tr, save)
        vdir = chaos.corrupt_publish(pub)
        assert vdir is not None and vdir.endswith("v-00002")

        assert mgr.poll() is None          # nothing swappable
        assert mgr.current_version == 1 and 2 in mgr.rejected
        out = srv.submit(req).result(60)["logits"]
        assert np.array_equal(out, want1)
        assert srv.metrics.count("reload_skipped_corrupt") == 1
        mgr.poll()                         # rejected versions never re-journal
        assert srv.metrics.count("reload_skipped_corrupt") == 1
        # a booting replica skips it too and takes v1
        _, _, v = load_published(pub, device="cpu")
        assert v == 1

        _publish(pub, tr, save)            # the fix is a republish
        for _ in range(100):
            mgr.poll()
            if mgr.current_version == 3:
                break
            srv.submit(req).result(60)
        assert mgr.current_version == 3
        assert srv.healthz()["model"]["version"] == 3
    finally:
        srv.close()
    recs = _records(journal)
    skipped = [r for r in recs if r["kind"] == "publish_skipped_corrupt"]
    assert [r["version"] for r in skipped] == [2, 2]   # the manager, the boot
    assert "CRC mismatch" in skipped[0]["reason"]


# ---------------------------------------------------------------------------
# zero-downtime hot-swap
# ---------------------------------------------------------------------------


def test_zero_dropped_requests_across_three_reload_cycles(tmp_path, rng):
    """tests/test_publish.py::
    test_zero_dropped_requests_across_three_reload_cycles: a request
    stream rides three hot-reload cycles with zero shed or dropped
    requests, every reply bit-equal to one version's own bundle (never a
    torn half-loaded model), versions only moving forward, and no
    compile-cache miss on any reload (on the CPU the plain versions run,
    so no library is built either)."""
    tr = _tiny_trainer()
    batch = _batch(rng)
    req = _req(batch)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    tr.train_batch(batch)
    tr.save(save, 0)
    _publish(pub, tr, save)
    srv, mgr = _boot(pub, probation_requests=2)
    try:
        expected = {1: _expected(pub, 1, req)}
        miss0 = srv.metrics.count("compile_cache_misses")
        served, swaps = [], []
        for v in (2, 3, 4):
            for _ in range(3):
                tr.train_batch(batch)
            tr.save(save, v - 1)
            _publish(pub, tr, save)
            expected[v] = _expected(pub, v, req)
            assert not np.allclose(expected[v], expected[v - 1],
                                   rtol=1e-4, atol=1e-5)
            for _ in range(100):
                out = srv.submit(req).result(60)["logits"]
                ks = [k for k, e in expected.items()
                      if np.array_equal(out, e)]
                assert len(ks) == 1, f"reply matches versions {ks}"
                served.append(ks[0])
                act = mgr.poll()
                if act and act["action"] == "swapped":
                    swaps.append(act)
                if mgr.current_version == v and not mgr.in_probation:
                    break
            assert mgr.current_version == v
        assert served == sorted(served)
        assert {2, 3, 4} <= set(served)
        assert [a["version"] for a in swaps] == [2, 3, 4]
        assert all(a["prime"]["compiled"] + a["prime"]["hits"] == 3
                   for a in swaps)               # buckets 1, 2, 4
        hz = srv.healthz()
        c = hz["counters"]
        assert c["shed"] == 0
        assert c["submitted"] == c["accepted"] == c["completed"]
        assert srv.metrics.count("compile_cache_misses") == miss0 == 0
        assert hz["model"]["version"] == 4
        assert c["model_swaps"] == 3
    finally:
        srv.close()


def test_nan_poisoned_version_rolls_back_within_probation(
        tmp_path, journal, rng):
    """tests/test_publish.py::
    test_nan_poisoned_version_rolls_back_within_probation."""
    tr = _tiny_trainer()
    batch = _batch(rng)
    req = _req(batch)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    tr.train_batch(batch)
    tr.save(save, 0)
    _publish(pub, tr, save)
    srv, mgr = _boot(pub, probation_requests=16)
    try:
        want1 = _expected(pub, 1, req)
        tr.params = {k: torch.full_like(v, float("nan"))
                     for k, v in tr.params.items()}
        tr.save(save, 1)
        _publish(pub, tr, save)

        act = mgr.poll()
        assert act is not None and act["action"] == "swapped"
        for _ in range(6):
            err = srv.submit(req).error(60)
            assert isinstance(err, InferenceFailed)  # typed, non-finite
            act = mgr.tick()
            if act is not None:
                break
        assert act is not None and act["action"] == "rolled_back"
        assert act["signal"] == "error_rate_regression"
        assert act["rolled_back_to"] == 1
        out = srv.submit(req).result(60)["logits"]
        assert np.array_equal(out, want1)
        assert srv.healthz()["model"]["version"] == 1
        assert mgr.current_version == 1 and 2 in mgr.rejected
        assert mgr.poll() is None          # never retried
        assert srv.metrics.count("reload_rollbacks") == 1
    finally:
        srv.close()
    rb = [r for r in _records(journal) if r["kind"] == "publish_rollback"]
    assert len(rb) == 1 and rb[0]["version"] == 2
    assert rb[0]["signal"] == "error_rate_regression"
    assert rb[0]["rolled_back_to"] == 1


def test_kill_worker_mid_reload_strands_no_requests(tmp_path, rng):
    """tests/test_publish.py::test_kill_worker_mid_reload_strands_no_requests:
    the supervisor relaunches the worker, the swap completes and every
    request resolves (a reply or a typed error)."""
    tr = _tiny_trainer()
    batch = _batch(rng)
    req = _req(batch)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    tr.train_batch(batch)
    tr.save(save, 0)
    _publish(pub, tr, save)
    srv, mgr = _boot(pub, probation_requests=2)
    try:
        tr.train_batch(batch)
        tr.save(save, 1)
        _publish(pub, tr, save)
        futs = [srv.submit(req) for _ in range(6)]
        chaos.kill_worker(srv)
        act = mgr.poll()                   # swap while the worker is down
        assert act is not None and act["action"] == "swapped"
        futs += [srv.submit(req) for _ in range(6)]
        for i, f in enumerate(futs):
            try:
                f.error(60)
            except TimeoutError:
                pytest.fail(f"request {i} stranded across the reload")
        assert srv.supervisor.restarts >= 1
        for _ in range(100):
            mgr.poll()
            if mgr.current_version == 2:
                break
            srv.submit(req).result(60)
        assert mgr.current_version == 2
        assert np.array_equal(srv.submit(req).result(60)["logits"],
                              _expected(pub, 2, req))
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# freshness SLO
# ---------------------------------------------------------------------------


def test_freshness_slo_reconstructed_from_journal_and_healthz(
        tmp_path, journal, rng):
    """tests/test_publish.py::
    test_freshness_slo_reconstructed_from_journal_and_healthz; the JAX
    package's ``freshness_from_journal`` gives the same rows on the same
    records."""
    from paddle_tpu.publish import freshness_from_journal as jfresh

    tr = _tiny_trainer()
    batch = _batch(rng)
    req = _req(batch)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    tr.train_batch(batch)
    tr.save(save, 0)
    _publish(pub, tr, save)
    srv, mgr = _boot(pub, probation_requests=2)
    try:
        hz = srv.healthz()
        assert hz["model"]["version"] == 1
        assert hz["model"]["freshness_s"] >= 0
        tr.train_batch(batch)
        tr.save(save, 1)
        _publish(pub, tr, save)
        for _ in range(100):
            mgr.poll()
            if mgr.current_version == 2:
                break
            srv.submit(req).result(60)
        assert mgr.current_version == 2
        assert srv.healthz()["model"]["freshness_s"] >= 0
    finally:
        srv.close()
    recs = _records(journal)
    kinds = [r["kind"] for r in recs]
    for k in ("publish_commit", "reload_commit", "probation_passed"):
        assert k in kinds, k
    rows = freshness_from_journal(recs)
    assert rows == jfresh(recs)
    assert [r["version"] for r in rows] == [1, 2]
    r2 = rows[1]
    assert not r2["rolled_back"]
    assert r2["published_at"] >= r2["train_commit_time"]
    assert r2["serving_ready_at"] >= r2["swapped_at"] >= r2["published_at"]
    assert r2["freshness_s"] is not None and r2["freshness_s"] >= 0
    assert rows[0]["swapped_at"] is None


# ---------------------------------------------------------------------------
# a table reader riding the reload
# ---------------------------------------------------------------------------


class _Reader:
    """A table reader's reload surface: ``hot_reload`` and ``last_stop``
    (the reference's is the pserver tier's ``TableReader``)."""

    def __init__(self):
        self.last_stop = None
        self.reloads = 0

    def hot_reload(self):
        self.reloads += 1
        return 1


def test_table_reader_reload_stop_typed_journaled_and_counted(
        tmp_path, journal, rng):
    """tests/test_publish.py::
    test_table_reader_reload_stop_typed_journaled_and_counted, on the
    reload manager's side: a reader whose reload stopped (``last_stop``
    set) refuses the swap as ``table_reload_stalled``, journaled and
    counted, the previous version serving; a stop during probation rolls
    the swapped version back; a clean reader lets a republish through."""
    tr = _tiny_trainer()
    batch = _batch(rng)
    req = _req(batch)
    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    tr.train_batch(batch)
    tr.save(save, 0)
    _publish(pub, tr, save)
    reader = _Reader()
    srv, mgr = _boot(pub, probation_requests=50, table_reader=reader)
    try:
        tr.train_batch(batch)
        tr.save(save, 1)
        _publish(pub, tr, save)
        reader.last_stop = "snap 1: shard-000.npz CRC mismatch"
        act = mgr.poll()
        assert act["action"] == "rolled_back"
        assert act["signal"] == "table_reload_stalled"
        assert mgr.current_version == 1 and reader.reloads == 1
        assert srv.metrics.count("reload_rollbacks") == 1
        assert np.array_equal(srv.submit(req).result(60)["logits"],
                              _expected(pub, 1, req))
        reader.last_stop = None
        _publish(pub, tr, save)            # v3
        act = mgr.poll()
        assert act["action"] == "swapped" and act["version"] == 3
        reader.last_stop = "snap 2: shard-001.npz missing"
        act = mgr.tick()
        assert act["action"] == "rolled_back"
        assert act["signal"] == "table_reload_stalled"
        assert act["rolled_back_to"] == 1
        assert srv.healthz()["model"]["version"] == 1
    finally:
        srv.close()
    rb = [r for r in _records(journal) if r["kind"] == "publish_rollback"]
    assert [(r["version"], r["signal"]) for r in rb] == [
        (2, "table_reload_stalled"), (3, "table_reload_stalled")]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _jax_trainer():
    import paddle_tpu.nn as jnn
    from paddle_tpu.param.optimizers import Adam as JAdam
    from paddle_tpu.trainer import SGDTrainer as JTrainer

    return JTrainer(_net(jnn), JAdam(learning_rate=0.05), seed=0)


def test_version_dirs_cross_packages_both_ways(tmp_path, rng):
    """A version the JAX package publishes boots the port's watcher and a
    version the port publishes into the SAME publish dir hot-swaps in; the
    JAX package loads the port's version; every reply agrees with the JAX
    package's infer of the same bundle (rtol 1e-5 / atol 1e-6).  The
    manifests share their schema, and both packages give the same
    architecture fingerprint for each bundle and the same
    ``validate_version`` verdict before and after damage."""
    from paddle_tpu.config import load_inference_model as jload
    from paddle_tpu.publish import publish_from_checkpoints as jpublish
    from paddle_tpu.publish import validate_version as jvalidate
    from paddle_tpu.serving.reload import load_published as jload_published

    batch = _batch(rng)
    req = _req(batch)
    pub = str(tmp_path / "pub")
    jtr = _jax_trainer()
    jtr.train_batch(batch)
    jtr.save(str(tmp_path / "jck"), 0)
    jpublish(pub, jtr.topology, str(tmp_path / "jck"), warm_cache=False)
    srv, mgr = _boot(pub, probation_requests=2)
    try:
        jm = jload(os.path.join(version_dir(pub, 1), "model.ptz"))
        np.testing.assert_allclose(
            srv.submit(req).result(60)["logits"],
            jm.infer(req, outputs=["logits"])["logits"], rtol=RTOL,
            atol=ATOL)
        # the port trains on from the JAX trainer's checkpoint, publishes v2
        tr = _tiny_trainer()
        tr.load(str(tmp_path / "jck"), 0)
        tr.train_batch(batch)
        tr.save(str(tmp_path / "tck"), 1)
        _publish(pub, tr, str(tmp_path / "tck"))
        for _ in range(50):
            mgr.poll()
            if mgr.current_version == 2:
                break
            srv.submit(req).result(60)
        assert mgr.current_version == 2
        jmodel, jinfo, jv = jload_published(pub)
        assert jv == 2
        np.testing.assert_allclose(
            srv.submit(req).result(60)["logits"],
            jmodel.infer(req, outputs=["logits"])["logits"], rtol=RTOL,
            atol=ATOL)
    finally:
        srv.close()
    from paddle_tpu_torch.config import load_inference_model as tload

    for v in (1, 2):
        vdir = version_dir(pub, v)
        m = read_version_manifest(vdir)
        assert set(m) == {"version", "name", "pass_id", "train_commit_time",
                          "publish_time", "fingerprint", "quantize", "files"}
        bundle = os.path.join(vdir, "model.ptz")
        assert m["fingerprint"] == jload(
            bundle, arch_fingerprint=True).fingerprint == tload(
            bundle, device="cpu", arch_fingerprint=True).fingerprint
        assert validate_version(vdir) is None and jvalidate(vdir) is None
    chaos.corrupt_publish(pub, version=1)
    os.remove(os.path.join(version_dir(pub, 2), "manifest.json"))
    for v in (1, 2):
        assert validate_version(version_dir(pub, v)) == jvalidate(
            version_dir(pub, v)) is not None


def test_publisher_and_trainer_publish_every(tmp_path, journal, rng,
                                             monkeypatch):
    """``SGDTrainer.train`` with ``--save_dir``, ``--scrub_every_s`` and
    ``--publish_every=1`` cuts one version a pass, each from the pass the
    scrubber verified at its end (``scrub.json``'s tip), and stops its
    scrubber; ``Publisher`` cuts the next from the same checkpoints."""
    from paddle_tpu_torch.publish import Publisher, latest_version

    save, pub = str(tmp_path / "ckpt"), str(tmp_path / "pub")
    for name, value in (("save_dir", save), ("publish_dir", pub),
                        ("publish_every", 1), ("scrub_every_s", 3600.0)):
        monkeypatch.setattr(FLAGS, name, value)
    tr = _tiny_trainer()
    batch = _batch(rng)
    tr.train(lambda: iter([batch, batch]), num_passes=2)
    assert latest_version(pub) == 2
    assert [read_version_manifest(version_dir(pub, v))["pass_id"]
            for v in (1, 2)] == [0, 1]
    with open(os.path.join(save, "scrub.json")) as f:
        assert json.load(f)["latest_verified_pass"] == 1
    assert not [t for t in threading.enumerate()
                if t.name == "sdc-scrubber"]
    vdir = Publisher(pub, tr.topology, device="cpu").publish(save)
    assert read_version_manifest(vdir)["version"] == 3
    commits = [r for r in _records(journal) if r["kind"] == "publish_commit"]
    assert [r["version"] for r in commits] == [1, 2, 3]


def test_entry_points_use_the_card_unless_asked(tmp_path, rng):
    """``load_published``, ``ModelFleet.load_published_model``,
    ``publish_from_checkpoints``/``Publisher`` (their warm step) and
    ``serve --serve_watch`` run on the card unless the caller passes the
    CPU: without a card each raises, never falling back, and a refused
    publish leaves no version behind."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from paddle_tpu_torch.__main__ import main
    from paddle_tpu_torch.publish import (Publisher, latest_version,
                                          model_publish_dir)
    from paddle_tpu_torch.serving import ModelFleet

    tr = _tiny_trainer()
    tr.train_batch(_batch(rng))
    save, root = str(tmp_path / "ckpt"), str(tmp_path / "root")
    tr.save(save, 0)
    pub = model_publish_dir(root, "m")
    _publish(pub, tr, save)
    for call in (lambda: load_published(pub),
                 lambda: ModelFleet().load_published_model(root, "m"),
                 lambda: publish_from_checkpoints(pub, tr.topology, save),
                 lambda: Publisher(pub, tr.topology).publish(save)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert latest_version(pub) == 1
    assert sorted(os.listdir(pub)) == ["ccache", "v-00001"]
    keep = FLAGS.as_dict()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", "--serve_watch", "--serve_smoke=1",
                  f"--publish_dir={pub}", "--device=cuda"])
    finally:
        for k, v in keep.items():
            setattr(FLAGS, k, v)
