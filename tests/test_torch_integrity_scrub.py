"""The port's at-rest scrub (``paddle_tpu_torch/resilience/integrity.py``:
``scrub_paths``, ``latest_verified_pass``, ``ScrubDaemon``) and event
journal (``obs/journal.py``) against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_integrity_scrub.py -q

- The scrub tests of ``tests/test_integrity.py`` on the port (quarantine
  and the verified tip, the read path's ``ckpt_quarantined`` journal
  record, a corrupt bundle's member named, the background daemon).
- The same checkpoint chains — written by either package, with the same
  damage — scrubbed by both packages: equal reports (checked count, each
  finding's kind, member, quarantine flags), equal ``scrub.json`` (but its
  time) and equal ``latest_verified_pass``, before and after; each
  package's quarantine marker honoured by the other's ``latest_pass``.
- ``read_journal``, ``merge_journals`` and ``journal_files`` give the JAX
  package's records on the same files, a torn final line included.
- A pserver snapshot chain under a scrub root raises naming ROADMAP.md
  Queue 1 item 8.
"""

import json
import os
import shutil
import time
import zipfile

import numpy as np
import pytest
import torch

from paddle_tpu_torch.obs.journal import (EventJournal, close_journal,
                                          journal_files, journal_path,
                                          merge_journals, read_journal)
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.resilience.checkpoint_io import (latest_pass,
                                                       pass_dir,
                                                       save_checkpoint,
                                                       validate_checkpoint)
from paddle_tpu_torch.resilience.integrity import (ScrubDaemon,
                                                   latest_verified_pass,
                                                   scrub_paths)
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.flags import FLAGS


def _make_ckpts(root, n=2, writer="port"):
    """tests/test_integrity.py::_make_ckpts, written by either package."""
    w = np.arange(8, dtype=np.float32)
    for pid in range(n):
        w = w + 1.0
        if writer == "port":
            save_checkpoint(str(root), pid, params={"w": torch.from_numpy(w)})
        else:
            from paddle_tpu.resilience.checkpoint_io import \
                save_checkpoint as jsave

            jsave(str(root), pid, params={"w": w})


def _summary(report):
    return (report.checked,
            [(f.kind, os.path.basename(f.path), f.member, f.quarantined,
              f.already_quarantined) for f in report.findings],
            {os.path.basename(k): v
             for k, v in report.latest_verified.items()})


def _scrub_state(root):
    with open(os.path.join(str(root), "scrub.json")) as f:
        state = json.load(f)
    state.pop("time")
    return state


def test_scrub_quarantines_and_marks_latest_verified(tmp_path):
    """tests/test_integrity.py::
    test_scrub_quarantines_and_marks_latest_verified."""
    root = tmp_path / "ckpts"
    _make_ckpts(root, n=2)
    assert latest_pass(str(root)) == 1
    chaos.corrupt_checkpoint(pass_dir(str(root), 1))
    report = scrub_paths([str(root)], quarantine=True)
    assert not report.clean and report.checked == 2
    f = report.findings[0]
    assert f.kind == "checkpoint" and f.member == "params.npz"
    assert f.quarantined
    assert os.path.exists(os.path.join(pass_dir(str(root), 1),
                                       "QUARANTINED"))
    reason = validate_checkpoint(pass_dir(str(root), 1))
    assert reason is not None and "quarantined" in reason
    assert latest_pass(str(root)) == 0
    assert _scrub_state(root)["latest_verified_pass"] == 0
    assert latest_verified_pass(str(root)) == 0
    report2 = scrub_paths([str(root)], quarantine=True)
    assert len(report2.findings) == 1
    assert report2.findings[0].already_quarantined


def test_latest_pass_journals_ckpt_quarantined(tmp_path, monkeypatch):
    """tests/test_integrity.py::test_latest_pass_journals_ckpt_quarantined:
    the read path's skip lands in the journal with the member named."""
    root = tmp_path / "ckpts"
    _make_ckpts(root, n=2)
    chaos.corrupt_checkpoint(pass_dir(str(root), 1))
    jdir = tmp_path / "journal"
    monkeypatch.setattr(FLAGS, "obs_journal", str(jdir))
    try:
        assert latest_pass(str(root)) == 0
    finally:
        close_journal()
    recs, torn = read_journal(journal_path(str(jdir), 0))
    assert torn == 0
    quar = [r for r in recs if r["kind"] == "ckpt_quarantined"]
    assert quar and quar[0]["member"] == "params.npz"
    assert "pass-00001" in quar[0]["dir"] and quar[0]["reason"]


def test_scrub_names_corrupt_bundle_member(tmp_path, monkeypatch):
    """tests/test_integrity.py::test_scrub_names_corrupt_bundle_member; the
    finding is journaled as a ``scrub_fail`` anchor and the JAX package
    names the same member."""
    from paddle_tpu.resilience.integrity import scrub_paths as jscrub

    bundle = tmp_path / "model.ptz"
    with zipfile.ZipFile(bundle, "w") as z:
        z.writestr("manifest.json", json.dumps({"magic": "x"}))
        z.writestr("params.npz", os.urandom(4096))
    assert scrub_paths([str(tmp_path)]).clean
    chaos.corrupt_file(str(bundle), offset=200, nbytes=16)
    monkeypatch.setattr(FLAGS, "obs_journal", str(tmp_path / "j"))
    try:
        report = scrub_paths([str(tmp_path)])
    finally:
        close_journal()
    assert [f.kind for f in report.findings] == ["bundle"]
    assert report.findings[0].member
    assert _summary(report) == _summary(jscrub([str(tmp_path)]))
    recs, _ = read_journal(journal_path(str(tmp_path / "j"), 0))
    assert [r["member"] for r in recs if r["kind"] == "scrub_fail"] == [
        report.findings[0].member]


def test_scrub_daemon_quarantines_in_background(tmp_path):
    """tests/test_integrity.py::test_scrub_daemon_quarantines_in_background
    (waits on the marker with a deadline, never a fixed sleep)."""
    root = tmp_path / "ckpts"
    _make_ckpts(root, n=1)
    chaos.corrupt_checkpoint(pass_dir(str(root), 0))
    daemon = ScrubDaemon(str(root), every_s=0.02).start()
    try:
        deadline = time.monotonic() + 10.0
        while (not os.path.exists(os.path.join(pass_dir(str(root), 0),
                                               "QUARANTINED"))
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        daemon.stop()
    assert daemon.scrubs >= 1 and daemon.corrupt_found >= 1
    assert latest_pass(str(root)) == -1
    assert not daemon._thread.is_alive()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("damage", ["corrupt", "truncate", "delete"])
def test_scrub_agrees_with_the_reference(tmp_path, writer, damage):
    """One chain (either package's), copied; the same damage to pass 1 of
    each copy; each package scrubs its copy: the reports, the scrub.json
    files and the verified tips are equal, and each package's
    ``latest_pass`` honours the other's quarantine marker."""
    from paddle_tpu.resilience.checkpoint_io import latest_pass as jlatest
    from paddle_tpu.resilience.integrity import \
        latest_verified_pass as jverified
    from paddle_tpu.resilience.integrity import scrub_paths as jscrub

    a, b = tmp_path / "a" / "ckpts", tmp_path / "b" / "ckpts"
    _make_ckpts(a, n=3, writer=writer)
    shutil.copytree(a, b)
    for root in (a, b):
        assert scrub_paths([str(root)]).clean
        assert latest_verified_pass(str(root)) == jverified(str(root)) == 2
        chaos.corrupt_checkpoint(pass_dir(str(root), 1), mode=damage)
    port = scrub_paths([str(a)], quarantine=True)
    ref = jscrub([str(b)], quarantine=True)
    assert _summary(port) == _summary(ref)
    assert _scrub_state(a) == _scrub_state(b)
    assert latest_verified_pass(str(a)) == jverified(str(b)) == 2
    # the quarantine markers cross: each package refuses the other's
    chaos.corrupt_checkpoint(pass_dir(str(a), 2))
    chaos.corrupt_checkpoint(pass_dir(str(b), 2))
    scrub_paths([str(a)], quarantine=True)
    jscrub([str(b)], quarantine=True)
    assert _scrub_state(a) == _scrub_state(b)
    assert latest_pass(str(b)) == jlatest(str(a)) == 0
    assert latest_verified_pass(str(b)) == jverified(str(a)) == 0
    again = scrub_paths([str(a)], quarantine=True)
    assert _summary(again) == _summary(jscrub([str(b)], quarantine=True))


def test_scrub_of_a_snapshot_chain_names_item_8(tmp_path):
    os.makedirs(tmp_path / "tables" / "snap-00001")
    with pytest.raises(ConfigError, match="Queue 1 item 8\\b"):
        scrub_paths([str(tmp_path)])


def test_journal_reader_and_merge_equal_the_reference(tmp_path):
    """Two ranks' journals (one with a torn final line) read and merge to
    the JAX package's records and torn counts."""
    from paddle_tpu.obs.journal import journal_files as jfiles
    from paddle_tpu.obs.journal import merge_journals as jmerge
    from paddle_tpu.obs.journal import read_journal as jread

    d = str(tmp_path / "j")
    for rank in (1, 0):
        j = EventJournal(journal_path(d, rank), rank=rank, world_size=2)
        j.set_context(pass_id=3, batch_id=rank)
        for i in range(3):
            j.record("step", fsync=i == 2, i=i)
        j.record_batch("span", [{"n": 1}, {"n": 2}])
        j.close()
    with open(journal_path(d, 1), "a") as f:
        f.write('{"kind": "torn')
    assert journal_files(d) == jfiles(d)
    for p in journal_files(d):
        assert read_journal(p) == jread(p)
    merged, torn = merge_journals([d])
    assert (merged, torn) == jmerge([d]) and torn == 1
    assert [r["seq"] for r in merged if r["rank"] == 0] == list(range(5))
    assert all(r["pass"] == 3 and r["world_size"] == 2 for r in merged)
    assert journal_path(d, -1).endswith("events-rsup.jsonl")
