"""Fleet router: spread tenants across servers, health-gated — the port's
copy of ``paddle_tpu/serving/router.py``.

:class:`FleetRouter` fronts N serving backends (typically
:class:`~paddle_tpu_torch.serving.fleet.ModelFleet` instances or
``InferenceServer``s, but anything
with ``submit()`` / ``healthz()`` / ``close()`` routes) and assigns each
tenant a home server by **rendezvous hashing**: every (tenant, server)
pair gets a score ``sha256(tenant|server)`` and the tenant lands on its
highest-scoring HEALTHY server.  Rendezvous beats modulo here because
membership changes move only the tenants whose winner died — no global
reshuffle, so session affinity and per-entry warm state survive a single
server's funeral.

Membership is health-gated with a heartbeat discipline: a server must fail ``probe_budget`` CONSECUTIVE
health probes before it is marked dead (one slow probe is weather, a
streak is a death), and must pass ``probes_to_join`` consecutive probes
to rejoin.  A dead or unready server drains TYPED — requests that would
have routed to it fail with :class:`RouterDrainingError` naming the
server, or re-route when ``failover=True`` — never a black hole.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.serving.errors import ServingError
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.log import logger

__all__ = ["FleetRouter", "RouterDrainingError", "rendezvous_rank"]


class RouterDrainingError(ServingError):
    """The tenant's home server is dead/unready and failover is off —
    the request is refused typed, naming the draining server."""

    def __init__(self, message: str, *, server: str = "") -> None:
        super().__init__(message)
        self.server = server


def rendezvous_rank(tenant: str, servers: List[str]) -> List[str]:
    """Servers ranked by rendezvous (highest-random-weight) score for
    ``tenant`` — deterministic, and removing one server only reassigns
    the tenants it was winning."""
    def score(s: str) -> int:
        h = hashlib.sha256(f"{tenant}|{s}".encode()).digest()
        return int.from_bytes(h[:8], "big")

    return sorted(servers, key=score, reverse=True)


class _Member:
    """One backend's membership record."""

    def __init__(self, name: str, backend) -> None:
        self.name = name
        self.backend = backend
        # alive | dead — flips only on full probe streaks (under
        # FleetRouter._lock: routing must read a settled verdict)
        self.state = "alive"
        self.fail_streak = 0
        self.pass_streak = 0
        self.last_error: Optional[str] = None


class FleetRouter:
    """Tenant-sharded router over named serving backends.

    ``servers`` maps name -> backend.  ``probe_budget`` consecutive
    failed probes mark a member dead; ``probes_to_join`` consecutive
    passes bring it back.  ``failover=True`` re-routes a drained
    tenant to its next rendezvous choice instead of refusing typed.
    """

    def __init__(self, servers: Dict[str, Any], *,
                 probe_budget: int = 3, probes_to_join: int = 2,
                 failover: bool = True,
                 clock=time.monotonic) -> None:
        if not servers:
            raise ConfigError("FleetRouter needs at least one server")
        if probe_budget < 1 or probes_to_join < 1:
            raise ConfigError("probe_budget and probes_to_join must be >= 1")
        self._clock = clock
        self._lock = threading.Lock()
        # membership table, under _lock: probe verdicts and routing reads
        # interleave
        self._members = {n: _Member(n, b) for n, b in servers.items()}
        self.probe_budget = int(probe_budget)
        self.probes_to_join = int(probes_to_join)
        self.failover = failover
        self.routed = {n: 0 for n in servers}
        self.drained = 0

    # ------------------------------------------------------------------
    # health-gated membership
    # ------------------------------------------------------------------

    def probe(self) -> Dict[str, str]:
        """One probe round over every member: a backend probe passes iff
        ``healthz()`` returns with ``ready=True``.  State flips only on
        full streaks (the heartbeat discipline: one miss is weather, a
        streak is a verdict).  Returns the post-probe states."""
        verdicts = {}
        for name, member in list(self._members.items()):
            ok, err = self._probe_one(member.backend)
            with self._lock:
                if ok:
                    member.pass_streak += 1
                    member.fail_streak = 0
                    member.last_error = None
                    if (member.state == "dead"
                            and member.pass_streak >= self.probes_to_join):
                        member.state = "alive"
                        logger.info("router: server %s rejoined after %d "
                                    "clean probes", name, member.pass_streak)
                else:
                    member.fail_streak += 1
                    member.pass_streak = 0
                    member.last_error = err
                    if (member.state == "alive"
                            and member.fail_streak >= self.probe_budget):
                        member.state = "dead"
                        logger.warning(
                            "router: server %s marked dead after %d "
                            "consecutive probe failures (%s) — draining "
                            "typed", name, member.fail_streak, err)
                verdicts[name] = member.state
        return verdicts

    @staticmethod
    def _probe_one(backend) -> tuple:
        try:
            h = backend.healthz()
        except Exception as e:  # noqa: BLE001 — a throwing probe is a miss
            return False, f"{type(e).__name__}: {e}"
        if not h.get("ready", False):
            return False, "not ready"
        return True, None

    def members(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"state": m.state, "fail_streak": m.fail_streak,
                        "pass_streak": m.pass_streak,
                        "last_error": m.last_error,
                        "routed": self.routed[n]}
                    for n, m in self._members.items()}

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def server_for(self, tenant: str) -> str:
        """The tenant's current home: its best-ranked ALIVE server
        (or, with ``failover=False``, its best-ranked server
        unconditionally — the caller sees the drain typed)."""
        with self._lock:
            ranked = rendezvous_rank(tenant, sorted(self._members))
            if not self.failover:
                return ranked[0]
            for name in ranked:
                if self._members[name].state == "alive":
                    return name
            return ranked[0]

    def submit(self, feed, *, tenant: str, **kw):
        """Route one request to the tenant's home server, typed end to
        end: a dead home either fails with :class:`RouterDrainingError`
        (``failover=False``) or re-routes down the tenant's rendezvous
        order — a request is NEVER queued on a server known to be dead."""
        if not tenant:
            raise ConfigError("router routes by tenant: tenant= is required")
        name = self.server_for(tenant)
        with self._lock:
            member = self._members[name]
            if member.state != "alive":
                self.drained += 1
                raise RouterDrainingError(
                    f"tenant {tenant!r}: home server {name!r} is draining "
                    f"({member.last_error or 'dead'}) and no healthy "
                    f"failover exists", server=name)
            self.routed[name] += 1
        return member.backend.submit(feed, tenant=tenant, **kw)

    def healthz(self) -> dict:
        members = self.members()
        return {
            "ready": any(m["state"] == "alive" for m in members.values()),
            "servers": members,
            "drained": self.drained,
        }

    def close(self, join_timeout: float = 2.0) -> None:
        for member in self._members.values():
            try:
                member.backend.close(join_timeout)
            except TypeError:
                member.backend.close()
            except Exception:  # noqa: BLE001 — close the rest anyway
                logger.warning("router: closing %s failed", member.name)
