"""At-rest scrubbing of checkpoints and deploy bundles — the scrub half of
``paddle_tpu/resilience/integrity.py``.

Checkpoints and deploy bundles are re-hashed long after their first read
(``scrub_paths``, ``ScrubDaemon`` under ``--scrub_every_s``).  A newly
corrupt checkpoint dir is QUARANTINED (a marker file that
``validate_checkpoint`` honours, demoting it out of ``latest_pass``
eligibility without destroying the evidence), the failure is journaled as
a fsync'd ``scrub_fail`` anchor, and ``scrub.json`` records the newest
fully verified pass, which ``latest_verified_pass`` reads — the publish
gate (``publish/publisher.py``) cuts versions only at or below it.

Not ported here; each waits for its ROADMAP.md Queue 1 item: the pytree
fingerprint (``tree_fingerprint``/``np_tree_fingerprint``), the
cross-replica SDC vote and agreement check (``sdc_vote``,
``make_agreement_check``), ``audit_sdc_step`` (``lint --sdc``) and
``run_fsck`` (the ``fsck`` command), item 9; scrubbing a pserver shard
snapshot chain raises naming item 8.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.utils.error import not_ported
from paddle_tpu_torch.utils.log import logger

__all__ = ["ScrubFinding", "ScrubReport", "scrub_paths",
           "latest_verified_pass", "ScrubDaemon", "SCRUB_STATE"]

SCRUB_STATE = "scrub.json"

#: artifact archives the scrub re-hashes (zip-layer member CRCs): deploy
#: bundles, AOT artifacts and plain zips — ONE list for both the
#: direct-file and tree-walk paths
_BUNDLE_EXTS = (".ptz", ".aotz", ".zip")
#: a pserver shard snapshot dir (the reference's pserver/snapshot.py)
_SNAP_RE = r"snap-(\d{5,})"


@dataclass
class ScrubFinding:
    path: str
    kind: str            # 'checkpoint' | 'bundle'
    reason: str
    member: str = ""
    quarantined: bool = False
    already_quarantined: bool = False

    def describe(self) -> str:
        tag = " [quarantined]" if (self.quarantined
                                   or self.already_quarantined) else ""
        return f"{self.kind} {self.path}: {self.reason}{tag}"


@dataclass
class ScrubReport:
    checked: int = 0
    findings: List[ScrubFinding] = field(default_factory=list)
    #: per checkpoint ROOT (the dir holding pass-%05d children): the
    #: newest pass whose every member re-verified this scrub
    latest_verified: Dict[str, int] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings

    def corrupt_members(self) -> List[str]:
        return [f"{f.path}" + (f":{f.member}" if f.member else "")
                for f in self.findings]


def _verify_bundle(path: str) -> Optional[Tuple[str, str]]:
    """Re-hash a ``.ptz``/zip artifact at rest: the zip layer stores a
    CRC-32 per member which ``testzip`` re-verifies over the full payload.
    Returns ``(member, reason)`` or None when clean."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as z:
            bad = z.testzip()
            if bad is not None:
                return bad, f"member {bad!r} failed its CRC"
    except zipfile.BadZipFile as e:
        return "", f"not a readable zip: {e}"
    except OSError as e:
        return "", f"unreadable: {e}"
    return None


def _journal_scrub_fail(finding: ScrubFinding) -> None:
    from paddle_tpu_torch.obs.journal import journal_event

    # fsync'd: a scrub failure is a durable anchor a postmortem orders
    # resume decisions against
    journal_event("scrub_fail", fsync=True, artifact=finding.kind,
                  dir=finding.path, member=finding.member,
                  reason=finding.reason, quarantined=finding.quarantined)


def scrub_paths(paths: Sequence[str], *, quarantine: bool = False,
                registry=None) -> ScrubReport:
    """Re-verify every checkpoint chain and deploy bundle under ``paths``.

    With ``quarantine``, a newly corrupt checkpoint dir gets the
    ``QUARANTINED`` marker, the failure is journaled as a fsync'd
    ``scrub_fail`` anchor, and each checkpoint root's ``scrub.json``
    records the newest fully verified pass.  Bundles are reported (and
    journaled) but never renamed — serving paths point at them by name.
    A pserver snapshot chain (``snap-%05d`` dirs) raises: the pserver tier
    is not ported."""
    import re

    from paddle_tpu_torch.resilience.checkpoint_io import (
        _PASS_RE, QUARANTINE_MARKER, failing_member, quarantine_checkpoint,
        validate_checkpoint)

    snap_re = re.compile(_SNAP_RE)
    report = ScrubReport()
    ckpt_roots: Dict[str, List[Tuple[int, Optional[ScrubFinding]]]] = {}

    def _checkpoint(d: str) -> Optional[ScrubFinding]:
        report.checked += 1
        already = os.path.exists(os.path.join(d, QUARANTINE_MARKER))
        reason = validate_checkpoint(d)
        if reason is None:
            return None
        f = ScrubFinding(path=d, kind="checkpoint", reason=reason,
                         member=failing_member(reason),
                         already_quarantined=already)
        if quarantine and not already:
            quarantine_checkpoint(d, reason)
            f.quarantined = True
        if not already:  # re-journaling a known-bad dir every pass is spam
            _journal_scrub_fail(f)
        report.findings.append(f)
        return f

    def _bundle(p: str) -> None:
        report.checked += 1
        bad = _verify_bundle(p)
        if bad is not None:
            f = ScrubFinding(path=p, kind="bundle", reason=bad[1],
                             member=bad[0])
            _journal_scrub_fail(f)
            report.findings.append(f)

    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            if root.endswith(_BUNDLE_EXTS):
                _bundle(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            base = os.path.basename(dirpath)
            if _PASS_RE.fullmatch(base):
                dirnames[:] = []
                f = _checkpoint(dirpath)
                parent = os.path.dirname(dirpath)
                ckpt_roots.setdefault(parent, []).append(
                    (int(_PASS_RE.fullmatch(base).group(1)), f))
                continue
            if snap_re.fullmatch(base):
                raise not_ported(f"scrubbing the pserver snapshot {dirpath}",
                                 8)
            dirnames[:] = [n for n in dirnames if not n.startswith(".")]
            for name in filenames:
                if name.endswith(_BUNDLE_EXTS):
                    _bundle(os.path.join(dirpath, name))

    for parent, entries in ckpt_roots.items():
        ok = [pid for pid, f in entries if f is None]
        tip = max(ok) if ok else -1
        report.latest_verified[parent] = tip
        if quarantine:
            _write_scrub_state(parent, tip, entries)
    if registry is not None:
        registry.counter("scrub_runs_total", "scrub passes completed").inc()
        if report.findings:
            registry.counter(
                "scrub_fail_total",
                "artifacts that failed an at-rest scrub").inc(
                len(report.findings))
    return report


def _write_scrub_state(root: str, tip: int, entries) -> None:
    """Atomically record the scrub outcome next to the pass dirs: the
    newest fully verified pass is rollback's trusted target."""
    state = {
        "time": time.time(),
        "latest_verified_pass": tip,
        "passes": {str(pid): (f.reason if f is not None else "ok")
                   for pid, f in sorted(entries, key=lambda e: e[0])},
    }
    path = os.path.join(root, SCRUB_STATE)
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("scrub state not recorded under %s: %s", root, e)


def latest_verified_pass(save_dir: str) -> int:
    """The newest pass the scrubber fully re-verified (``scrub.json``),
    falling back to a validating ``latest_pass`` walk when no scrub has
    run — the publish gate's and rollback's trusted-target resolver."""
    from paddle_tpu_torch.resilience.checkpoint_io import (latest_pass,
                                                           pass_dir,
                                                           validate_checkpoint)

    try:
        with open(os.path.join(save_dir, SCRUB_STATE)) as f:
            tip = int(json.load(f).get("latest_verified_pass", -1))
    except (FileNotFoundError, json.JSONDecodeError, OSError, ValueError):
        return latest_pass(save_dir)
    if tip < 0:
        return latest_pass(save_dir)
    # trust but re-verify: the dir may have rotted (or been pruned) since
    # the scrub pass that blessed it
    if validate_checkpoint(pass_dir(save_dir, tip)) is None:
        return tip
    return latest_pass(save_dir)


class ScrubDaemon:
    """Background checkpoint scrubber (``--scrub_every_s``).

    A daemon thread re-verifies everything under its roots every
    ``every_s`` seconds with quarantine enabled.  Scrubbing only touches
    published, immutable artifacts (temp dirs are dot-prefixed and
    skipped), so it never races an in-flight save.  ``scrub_now()`` runs
    one pass in the caller's thread."""

    def __init__(self, roots, *, every_s: float) -> None:
        self.roots = [roots] if isinstance(roots, str) else list(roots)
        self.every_s = float(every_s)
        self.scrubs = 0
        self.corrupt_found = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, name="sdc-scrubber", daemon=True)

    def start(self) -> "ScrubDaemon":
        self._thread.start()
        return self

    def scrub_now(self) -> Optional[ScrubReport]:
        from paddle_tpu_torch.obs import get_registry

        with self._lock:
            try:
                report = scrub_paths(self.roots, quarantine=True,
                                     registry=get_registry())
            except Exception as e:  # noqa: BLE001 — never kills training
                logger.warning("checkpoint scrub failed: %s", e)
                return None
            self.scrubs += 1
            self.corrupt_found += len(report.findings)
        for f in report.findings:
            if not f.already_quarantined:
                logger.error("scrub: %s", f.describe())
        return report

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.scrub_now()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
