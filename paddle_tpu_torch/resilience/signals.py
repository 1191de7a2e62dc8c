"""Preemption handling — SIGTERM/SIGINT -> checkpoint at a batch boundary;
the port's own copy of ``paddle_tpu/resilience/signals.py``.

Preemptible fleets deliver a grace window before eviction (the PATHWAYS-style
orchestration contract): the runtime sends SIGTERM, the job has seconds to
persist.  ``PreemptionHandler`` converts those signals into a *request*
flag; the trainer polls it at every batch boundary, writes an atomic
mid-pass checkpoint (manifest carries ``next_batch`` so auto-resume
re-enters the pass at the exact batch), and returns cleanly.

Handlers install as a context manager and restore the previous disposition
on exit.  Installation is best-effort: ``signal.signal`` only works in the
main thread — elsewhere the handler degrades to the programmatic
``request()`` path (which is also how the chaos harness delivers simulated
preemptions without killing the test process).

Multi-host: with a gang attached (``handler.gang``), ``poll()`` is a
gang-agreed decision — the local latch is OR-reduced across every process
(``gang.agree_preempt``), so a SIGTERM delivered to one host makes the
whole gang checkpoint at the same point.  The port has no gang yet
(ROADMAP.md Queue 1 item 9), so ``gang`` stays ``None`` and ``poll()`` is
the local latch; ``requested`` is always the local latch.
"""

from __future__ import annotations

import os
import signal as _signal
import threading
from typing import Dict, Optional, Tuple

from paddle_tpu_torch.utils.log import logger

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Latches a preemption request from OS signals or ``request()``."""

    def __init__(self, signals: Tuple[int, ...] = (_signal.SIGTERM,
                                                   _signal.SIGINT),
                 gang=None) -> None:
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._prev: Dict[int, object] = {}
        self._installed = False
        self.signum: Optional[int] = None
        # a resilience.cluster gang context (or None): requested becomes
        # the OR over all ranks' local latches
        self.gang = gang

    # -- context manager -------------------------------------------------

    def __enter__(self) -> "PreemptionHandler":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def install(self) -> None:
        if self._installed:
            return
        for s in self.signals:
            try:
                self._prev[s] = _signal.signal(s, self._on_signal)
            except ValueError:
                # not the main thread: signal-driven preemption unavailable,
                # request() still works
                logger.warning(
                    "PreemptionHandler: cannot install handler for signal "
                    "%s outside the main thread", s)
        self._installed = True

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            try:
                _signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    # -- request plane ---------------------------------------------------

    def _on_signal(self, signum, frame) -> None:
        if self._requested.is_set():
            # second signal: the user/orchestrator is done waiting (e.g. a
            # hung reader never reaches the batch boundary) — restore the
            # previous dispositions and re-deliver so Ctrl-C/kill behave
            # normally again
            logger.warning(
                "second signal %s before the batch boundary: restoring "
                "default handlers", _signal.Signals(signum).name)
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self.signum = signum
        self._requested.set()
        logger.warning(
            "signal %s received: checkpoint requested at next batch "
            "boundary", _signal.Signals(signum).name)

    def request(self, signum: Optional[int] = None) -> None:
        """Programmatic preemption (chaos harness / orchestrator hook)."""
        self.signum = signum
        self._requested.set()

    def poll(self) -> bool:
        """Gang-agreed preemption check — the trainer's batch-boundary
        probe.  Without a gang this is just the local latch; with one,
        the latch is OR-reduced across ranks (flag files on the shared
        dir, or a DCN allgather on live pods — every rank calls poll()
        at every boundary, keeping the collective symmetric), and a
        gang-sourced request latches locally so the decision is sticky
        even if the flag's origin rank exits first."""
        local = self._requested.is_set()
        gang = self.gang
        if gang is None or gang.size <= 1:
            return local
        if gang.agree_preempt(local):
            self._requested.set()
            return True
        return False

    @property
    def requested(self) -> bool:
        """Local latch only — side-effect-free and collective-free, safe
        to read from any rank or thread.  Gang agreement happens in
        ``poll()``."""
        return self._requested.is_set()

    def clear(self) -> None:
        self._requested.clear()
        self.signum = None
