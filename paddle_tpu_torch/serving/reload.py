"""Zero-downtime hot-swap of published model versions — the port's
``paddle_tpu/serving/reload.py``.

``HotSwapManager`` watches a publish directory (``paddle_tpu_torch/publish``)
from the serving side and drives the reload state machine::

    poll() ──> newest valid version > current?
                 │  corrupt version: journaled + skipped, previous
                 │  version keeps serving
                 v
               load (architecture fingerprint)
                 │
                 v
               prime OFF the hot path ──────────> swap_model()
                 │ warm cache ⇒ no compiler run      │
                 v                                   v
                                                 PROBATION window
                                                     │
                                     ┌───────────────┴──────────────┐
                                     v                              v
                               probation_passed              publish_rollback
                               (prev released)               (prev swapped back)

Rollback signals (each journaled as ``publish_rollback`` naming the
signal): ``warmup_failure``, ``breaker_trip``, ``error_rate_regression``
(NaN-poisoned weights fail requests typed — ``nonfinite='error'`` — so a
poisoned version regresses the error rate within its first probation
requests) and, with a ``table_reader`` (anything with ``hot_reload()`` and
``last_stop``), ``table_reload_failed`` / ``table_reload_stalled``.  The
previous model stays resident until probation passes, so a rollback is one
attribute swap — no reload, no build, no downtime.  The load and the warm
step run in the caller's thread; only the final attribute swap touches the
hot path, and a bucket-mode worker reads its runner once per batch, so no
batch is served by two models and none is dropped.

Not ported: ``preflight=True`` (the serving closure's audit, ROADMAP.md
Queue 1 item 9) raises.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

from paddle_tpu_torch.utils.log import logger

__all__ = ["HotSwapManager", "error_baseline", "load_published"]


def error_baseline(server) -> Dict[str, float]:
    """Snapshot one server's error counters as a probation baseline.

    Shared by the single-server :class:`HotSwapManager` probation and
    the per-entry fleet probation (``serving/fleet.py``): each candidate is
    judged against a baseline captured at ITS swap/rollout moment, so a
    fleet of entries can run independent probation windows."""
    m = server.metrics
    baseline = {
        "completed": m.count("completed"),
        "inference_failed": m.count("inference_failed"),
        "worker_crashed": m.count("worker_crashed"),
        "breaker_trips": server.breaker.trips,
    }
    done = baseline["completed"] + baseline["inference_failed"]
    baseline["error_rate"] = (baseline["inference_failed"] / done
                              if done else 0.0)
    return baseline


def _version_info(model, manifest: Dict[str, Any], vdir: str) -> dict:
    return {
        "bundle": os.path.join(vdir, "model.ptz"),
        "version": int(manifest.get("version", 0)),
        "fingerprint": model.fingerprint,
        "quantize": manifest.get("quantize"),
        "train_commit_time": manifest.get("train_commit_time"),
        "pass_id": manifest.get("pass_id"),
    }


def load_published(publish_dir: str, *, max_version: Optional[int] = None,
                   device=None):
    """Load the newest VALID published version (newest-first walk) on
    ``device`` (the card unless the caller asks otherwise): a version that
    fails its CRC manifest is journaled (``publish_skipped_corrupt``) and
    skipped — a torn or bit-rotted publish must never take a booting
    replica down when an older good version exists.  Returns ``(model,
    info, version)``."""
    from paddle_tpu_torch.config.deploy import (BundleCorruptError,
                                                load_inference_model)
    from paddle_tpu_torch.obs.journal import journal_event
    from paddle_tpu_torch.publish import (list_versions,
                                          read_version_manifest,
                                          validate_version, version_dir)

    for v in reversed(list_versions(publish_dir)):
        if max_version is not None and v > max_version:
            continue
        vdir = version_dir(publish_dir, v)
        bad = validate_version(vdir)
        if bad is None:
            try:
                model = load_inference_model(
                    os.path.join(vdir, "model.ptz"), arch_fingerprint=True,
                    device=device)
            except (BundleCorruptError, ValueError) as e:
                bad = str(e)
        if bad is not None:
            journal_event("publish_skipped_corrupt", version=v, reason=bad)
            logger.warning("publish v%d is corrupt (%s) — skipped", v, bad)
            continue
        return model, _version_info(model, read_version_manifest(vdir),
                                    vdir), v
    raise FileNotFoundError(
        f"no valid published version under {publish_dir!r}")


class HotSwapManager:
    """Drive gated hot-reloads of one bucket-mode :class:`InferenceServer`
    from a publish directory.  ``poll()`` discovers/loads/primes/swaps new
    versions; ``tick()`` advances the probation window (both are cheap
    no-ops when there is nothing to do, so a serve loop can call them on
    its heartbeat).  All device-bound work (load, prime) happens in the
    CALLER's thread, on the served model's device — the worker keeps
    serving the current model throughout; only the final attribute swap
    touches the hot path."""

    def __init__(self, server, publish_dir: str, *,
                 probation_requests: int = 32,
                 probation_seconds: float = 0.0,
                 error_rate_margin: float = 0.25,
                 min_probation_samples: int = 4,
                 preflight: bool = False,
                 table_reader=None,
                 clock=time.monotonic) -> None:
        if preflight:
            from paddle_tpu_torch.utils.error import not_ported

            raise not_ported("HotSwapManager(preflight=True) (the serving "
                             "closure's audit)", 9)
        self.server = server
        self.publish_dir = publish_dir
        self.probation_requests = int(probation_requests)
        self.probation_seconds = float(probation_seconds)
        self.error_rate_margin = float(error_rate_margin)
        self.min_probation_samples = int(min_probation_samples)
        self.preflight = preflight
        self.table_reader = table_reader
        self._clock = clock
        #: the committed (serving, past-probation) version
        self.current_version = 0
        #: versions that failed load/audit/warmup/probation — never retried
        #: (a fixed model is REPUBLISHED as a new version)
        self.rejected: Dict[int, str] = {}
        self._probation: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------

    def attach_current(self, version: int, info: Optional[dict]) -> None:
        """Adopt the version the server was booted with (no probation:
        the boot's warmup gate already vouched for it)."""
        self.current_version = int(version)
        if info:
            self.server.set_model_info(info)

    @property
    def in_probation(self) -> bool:
        return self._probation is not None

    @property
    def probation_version(self) -> Optional[int]:
        return self._probation["version"] if self._probation else None

    # ------------------------------------------------------------------
    # discovery + swap
    # ------------------------------------------------------------------

    def _candidate(self) -> Optional[Tuple[int, str]]:
        from paddle_tpu_torch.obs.journal import journal_event
        from paddle_tpu_torch.publish import (list_versions, validate_version,
                                              version_dir)

        floor = max(self.current_version,
                    self._probation["version"] if self._probation else 0)
        for v in reversed(list_versions(self.publish_dir)):
            if v <= floor:
                return None
            if v in self.rejected:
                continue
            vdir = version_dir(self.publish_dir, v)
            bad = validate_version(vdir)
            if bad is not None:
                # corrupt publish: skipped for good, previous version
                # keeps serving (chaos.corrupt_publish)
                self.rejected[v] = f"corrupt: {bad}"
                journal_event("publish_skipped_corrupt", version=v,
                              reason=bad)
                self.server.metrics.inc("reload_skipped_corrupt")
                logger.warning("publish v%d is corrupt (%s) — skipped, "
                               "v%d keeps serving", v, bad, floor)
                continue
            return v, vdir
        return None

    def poll(self) -> Optional[dict]:
        """One reload cycle: advance probation, then — if a newer valid
        version exists — load + audit + prime it off the hot path and
        swap.  Returns an action dict (``swapped`` / ``rolled_back`` /
        ``committed`` / ``rejected``) or None when nothing changed."""
        action = self.tick()
        if self._probation is not None:
            # one version in flight at a time: a newer publish waits for
            # the probation verdict (it will be picked up next poll)
            return action
        cand = self._candidate()
        if cand is None:
            return action
        v, vdir = cand
        return self._load_and_swap(v, vdir)

    def _load_and_swap(self, v: int, vdir: str) -> dict:
        from paddle_tpu_torch.config.deploy import (BundleCorruptError,
                                                    load_inference_model)
        from paddle_tpu_torch.obs.journal import journal_event
        from paddle_tpu_torch.publish import read_version_manifest

        t0 = time.time()
        try:
            manifest = read_version_manifest(vdir)
            # on the served model's device (the worker's), never another
            model = load_inference_model(
                os.path.join(vdir, "model.ptz"), arch_fingerprint=True,
                device=getattr(self.server.model, "device", None))
        except (BundleCorruptError, ValueError, OSError) as e:
            self.rejected[v] = f"load: {e}"
            journal_event("publish_skipped_corrupt", version=v,
                          reason=str(e))
            self.server.metrics.inc("reload_skipped_corrupt")
            logger.warning("publish v%d failed to load (%s) — skipped",
                           v, e)
            return {"action": "rejected", "version": v, "signal": "load"}
        # prime the new model's whole bucket surface OFF the hot path;
        # with the publish dir's warm cache every kernel library it runs is
        # resident or loads from the cache — no compiler run
        try:
            counts = self.server.prime_model(model)
        except Exception as e:  # noqa: BLE001 — a bad model must not swap
            return self._refuse(v, "warmup_failure",
                                f"{type(e).__name__}: {e}")
        # pserver-backed tables ride along: replay the snapshot delta
        # before the swap so the new model never serves stale rows
        if self.table_reader is not None:
            try:
                self.table_reader.hot_reload()
            except Exception as e:  # noqa: BLE001
                return self._refuse(v, "table_reload_failed", str(e))
            stop = getattr(self.table_reader, "last_stop", None)
            if stop is not None:
                return self._refuse(v, "table_reload_stalled", str(stop))
        baseline = error_baseline(self.server)
        prev_info = self.server._model_info
        info = _version_info(model, manifest, vdir)
        prev_model = self.server.swap_model(model, info=info)
        swap_s = time.time() - t0
        journal_event("reload_commit", fsync=True, version=v,
                      pass_id=info.get("pass_id"),
                      fingerprint=model.fingerprint,
                      train_commit_time=info.get("train_commit_time"),
                      prime=counts, swap_s=round(swap_s, 3))
        self._probation = {
            "version": v,
            "started": self._clock(),
            "baseline": baseline,
            "prev_model": prev_model,
            "prev_info": prev_info,
            "prev_version": self.current_version,
        }
        logger.info("hot-swapped to publish v%d (probation: %d requests"
                    "%s)", v, self.probation_requests,
                    f" / {self.probation_seconds:.0f}s"
                    if self.probation_seconds else "")
        return {"action": "swapped", "version": v, "prime": counts,
                "swap_s": swap_s}

    def _refuse(self, v: int, signal: str, detail: str) -> dict:
        """A version that failed BEFORE the swap: the previous bundle
        keeps serving (the 'revert' is a no-op) — journaled under the
        same ``publish_rollback`` kind so the timeline names every
        version that never reached committed, with its failing signal."""
        from paddle_tpu_torch.obs.journal import journal_event

        self.rejected[v] = f"{signal}: {detail}"
        journal_event("publish_rollback", fsync=True, version=v,
                      signal=signal, detail=detail,
                      rolled_back_to=self.current_version)
        self.server.metrics.inc("reload_rollbacks")
        logger.warning("publish v%d refused before swap (%s): %s",
                       v, signal, detail)
        return {"action": "rolled_back", "version": v, "signal": signal}

    # ------------------------------------------------------------------
    # probation
    # ------------------------------------------------------------------

    def tick(self) -> Optional[dict]:
        """Advance the probation window: check the rollback signals
        against the pre-swap baseline, commit when the window closes."""
        p = self._probation
        if p is None:
            return None
        m = self.server.metrics
        base = p["baseline"]
        if self.server.breaker.trips > base["breaker_trips"]:
            return self._rollback("breaker_trip")
        if self.table_reader is not None and \
                getattr(self.table_reader, "last_stop", None) is not None:
            return self._rollback("table_reload_stalled")
        completed = m.count("completed") - base["completed"]
        failed = m.count("inference_failed") - base["inference_failed"]
        resolved = completed + failed
        if resolved >= self.min_probation_samples:
            rate = failed / resolved
            if rate > base["error_rate"] + self.error_rate_margin:
                return self._rollback(
                    "error_rate_regression",
                    detail=f"probation error rate {rate:.3f} vs "
                           f"baseline {base['error_rate']:.3f}")
        elapsed = self._clock() - p["started"]
        if (resolved >= self.probation_requests
                or (self.probation_seconds > 0
                    and elapsed >= self.probation_seconds)):
            return self._commit(resolved)
        return None

    def _commit(self, resolved: int) -> dict:
        from paddle_tpu_torch.obs.journal import journal_event

        p, self._probation = self._probation, None
        self.current_version = p["version"]
        # release the previous bundle: probation passed, rollback can no
        # longer need it resident
        journal_event("probation_passed", fsync=True, version=p["version"],
                      requests=resolved)
        self.server.metrics.inc("reload_probation_passed")
        logger.info("publish v%d committed (probation passed after %d "
                    "requests)", p["version"], resolved)
        return {"action": "committed", "version": p["version"]}

    def _rollback(self, signal: str, detail: str = "") -> dict:
        from paddle_tpu_torch.obs.journal import journal_event

        p, self._probation = self._probation, None
        v = p["version"]
        self.rejected[v] = f"{signal}: {detail}" if detail else signal
        # the previous model stayed resident for exactly this moment:
        # rollback is one attribute swap, no build, zero downtime
        self.server.swap_model(p["prev_model"], info=p["prev_info"])
        self.current_version = p["prev_version"]
        journal_event("publish_rollback", fsync=True, version=v,
                      signal=signal, detail=detail,
                      rolled_back_to=p["prev_version"])
        self.server.metrics.inc("reload_rollbacks")
        logger.warning("publish v%d rolled back to v%d (%s)%s",
                       v, p["prev_version"], signal,
                       f": {detail}" if detail else "")
        return {"action": "rolled_back", "version": v, "signal": signal,
                "rolled_back_to": p["prev_version"]}

    # ------------------------------------------------------------------

    def watch(self, stop_event, *, poll_s: float = 2.0,
              tick_s: float = 0.2) -> None:
        """Blocking watch loop for the serve CLI: poll the publish dir
        every ``poll_s``, advance probation every ``tick_s``, until
        ``stop_event`` is set."""
        next_poll = 0.0
        while not stop_event.is_set():
            now = self._clock()
            try:
                if now >= next_poll:
                    next_poll = now + poll_s
                    self.poll()
                else:
                    self.tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.warning("reload watch: %s: %s", type(e).__name__, e)
            stop_event.wait(tick_s)
