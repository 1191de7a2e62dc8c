"""Multi-tenant admission: token-bucket quotas + weighted fair share — the
port's copy of ``paddle_tpu/serving/tenancy.py`` (framework-free).

The tenancy tier sits in FRONT of the typed admission queue of every
fleet entry (``serving/fleet.py``): before a request ever reaches a model
entry's ``BatchQueue``, :class:`TenantAdmission` decides whether the
submitting tenant may spend capacity right now.  Two independent layers:

1. **Per-tenant token bucket** — each tenant refills at its own ``rate``
   up to ``burst`` tokens; an empty bucket raises the typed
   :class:`~paddle_tpu_torch.serving.errors.QuotaExceeded` immediately.  One
   tenant's flood burns ONLY its own bucket.

2. **Weighted fair share** — an aggregate bucket models the fleet's
   shared capacity.  While it has tokens, any within-quota tenant
   admits.  When it runs dry (contention), admission falls back to
   start-time fair queuing over the tenants' ``weight``s: every admit
   advances the tenant's virtual time by ``cost / weight``, and a tenant
   whose virtual time has run more than ``credit`` ahead of the global
   virtual clock is shed typed (``QuotaExceeded(fair_share=True)``)
   until the others catch up.  Admitted counts therefore converge to the
   weight ratio under sustained overload — proportional shedding, never
   silent starvation of the light tenants (pinned within ±10% by
   tests/test_torch_fleet.py).

Every clock read goes through the ``clock`` the arbiter was built with, so
tests drive it with an injected clock and no sleeps.

A fair-share shed REFUNDS the tenant's own token: contention is the
fleet's condition, and it must not also eat the tenant's quota.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Union

from paddle_tpu_torch.serving.errors import InvalidRequestError, QuotaExceeded
from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["TenantSpec", "TokenBucket", "TenantAdmission"]


class TenantSpec:
    """One tenant's contract: ``rate`` requests/s refill up to ``burst``
    tokens of personal quota, and ``weight`` shares of the aggregate
    under contention.  A non-positive weight, rate, or burst is a
    configuration bug and is rejected typed at construction — a
    zero-weight tenant would be starved silently forever, which is
    exactly the failure mode this tier exists to make impossible."""

    def __init__(self, name: str, *, weight: float = 1.0,
                 rate: float = 100.0, burst: float = 10.0) -> None:
        if not name or not isinstance(name, str):
            raise ConfigError("tenant name must be a non-empty string")
        if weight <= 0:
            raise ConfigError(
                f"tenant {name!r}: weight must be > 0 (got {weight!r}) — "
                f"a zero-weight tenant would be silently starved under "
                f"any contention")
        if rate <= 0:
            raise ConfigError(
                f"tenant {name!r}: rate must be > 0 requests/s "
                f"(got {rate!r})")
        if burst < 1:
            raise ConfigError(
                f"tenant {name!r}: burst must be >= 1 (got {burst!r}) — "
                f"a zero-burst tenant could never admit anything")
        self.name = name
        self.weight = float(weight)
        self.rate = float(rate)
        self.burst = float(burst)


class TokenBucket:
    """Classic token bucket (float tokens, monotonic-clock refill).
    Not self-locking: :class:`TenantAdmission` serializes access."""

    def __init__(self, rate: float, burst: float, now: float) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = float(now)

    def _refill(self, now: float) -> None:
        if now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
            self._last = now

    def take(self, cost: float, now: float) -> bool:
        self._refill(now)
        if self.tokens + 1e-9 >= cost:
            self.tokens -= cost
            return True
        return False

    def refund(self, cost: float) -> None:
        self.tokens = min(self.burst, self.tokens + cost)

    def occupancy(self) -> float:
        """Fraction of the burst currently SPENT (1.0 = at quota)."""
        return round(1.0 - self.tokens / self.burst, 4) if self.burst else 0.0


class TenantAdmission:
    """Admission arbiter over a fixed tenant set.

    ``capacity_rate`` / ``capacity_burst`` size the aggregate bucket
    (defaults: the sums over tenants — i.e. contention only when the
    whole fleet is collectively over its configured rate).  ``credit``
    is the fair-queuing slack in admitted-request units per unit weight;
    1.0 means a tenant may run one weighted request ahead of the global
    virtual clock before it is shed.
    """

    def __init__(self, tenants: Iterable[Union[TenantSpec, dict]], *,
                 capacity_rate: Optional[float] = None,
                 capacity_burst: Optional[float] = None,
                 credit: float = 1.0,
                 active_window_s: float = 1.0,
                 clock=time.monotonic) -> None:
        specs = [t if isinstance(t, TenantSpec) else TenantSpec(**t)
                 for t in tenants]
        if not specs:
            raise ConfigError("TenantAdmission needs at least one tenant")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ConfigError(f"duplicate tenant names: {sorted(names)}")
        self._clock = clock
        now = clock()
        self.specs: Dict[str, TenantSpec] = {s.name: s for s in specs}
        self._buckets = {s.name: TokenBucket(s.rate, s.burst, now)
                         for s in specs}
        self._aggregate = TokenBucket(
            capacity_rate if capacity_rate is not None
            else sum(s.rate for s in specs),
            capacity_burst if capacity_burst is not None
            else sum(s.burst for s in specs), now)
        self.credit = float(credit)
        self.active_window_s = float(active_window_s)
        self._lock = threading.Lock()
        # start-time fair queuing state — guarded-by=_lock - vtime[t]
        # advances by cost/weight per admit; _vclock is the min over
        # RECENTLY ACTIVE tenants (monotone).  Idle tenants are excluded
        # from the min (they would freeze the clock and starve everyone
        # else) and rejoin at the current clock (no banked credit).
        self._vtime = {s.name: 0.0 for s in specs}
        self._vclock = 0.0
        self._last_seen = {s.name: float("-inf") for s in specs}
        # plain counters for healthz / chaos assertions
        self.admitted = {s.name: 0 for s in specs}
        self.quota_rejected = {s.name: 0 for s in specs}
        self.fair_share_shed = {s.name: 0 for s in specs}

    # ------------------------------------------------------------------

    def admit(self, tenant: Optional[str], cost: float = 1.0) -> None:
        """Admit one request for ``tenant`` or raise typed.  Unknown
        tenants are a client bug (``InvalidRequestError``); a tenant at
        its own quota — or past its weighted fair share under aggregate
        contention — gets :class:`QuotaExceeded` immediately."""
        if tenant is None:
            raise InvalidRequestError(
                "tenancy is configured: submit(..., tenant=NAME) is "
                "required")
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                raise InvalidRequestError(
                    f"unknown tenant {tenant!r} (configured: "
                    f"{sorted(self._buckets)})")
            now = self._clock()
            w = self.specs[tenant].weight
            if now - self._last_seen[tenant] > self.active_window_s:
                # rejoining after idleness: no banked credit, no debt
                self._vtime[tenant] = max(self._vtime[tenant], self._vclock)
            self._last_seen[tenant] = now
            if not bucket.take(cost, now):
                self.quota_rejected[tenant] += 1
                raise QuotaExceeded(
                    f"tenant {tenant!r} is at its quota "
                    f"({self.specs[tenant].rate:g} req/s, burst "
                    f"{self.specs[tenant].burst:g}) — retry after "
                    f"{cost / self.specs[tenant].rate:.3f}s",
                    tenant=tenant)
            if not self._aggregate.take(cost, now):
                # aggregate contention: start-time fair queuing decides.
                # The tenant's own token is REFUNDED on a fair-share shed
                # — fleet contention must not also burn personal quota.
                if self._vtime[tenant] - self._vclock > self.credit / w:
                    bucket.refund(cost)
                    self.fair_share_shed[tenant] += 1
                    raise QuotaExceeded(
                        f"tenant {tenant!r} shed over weighted fair share "
                        f"(weight {w:g}) under aggregate contention",
                        tenant=tenant, fair_share=True)
            self._vtime[tenant] = max(self._vtime[tenant],
                                      self._vclock) + cost / w
            active = [self._vtime[t] for t, seen in self._last_seen.items()
                      if now - seen <= self.active_window_s]
            self._vclock = max(self._vclock, min(active))
            self.admitted[tenant] += 1

    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant occupancy for ``healthz()['tenants']``."""
        with self._lock:
            now = self._clock()
            out = {}
            for name, bucket in self._buckets.items():
                bucket._refill(now)
                out[name] = {
                    "weight": self.specs[name].weight,
                    "rate": self.specs[name].rate,
                    "burst": self.specs[name].burst,
                    "tokens": round(bucket.tokens, 3),
                    "occupancy": bucket.occupancy(),
                    "admitted": self.admitted[name],
                    "quota_rejected": self.quota_rejected[name],
                    "fair_share_shed": self.fair_share_shed[name],
                }
            return out
