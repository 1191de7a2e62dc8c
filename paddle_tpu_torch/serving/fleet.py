"""Model-fleet serving: a model table with tenancy and versioned rollout —
the port's ``paddle_tpu/serving/fleet.py``.

:class:`ModelFleet` promotes the single-model ``InferenceServer`` into a
model TABLE keyed by ``(name, version)``.  Every entry gets the whole
serving stack instantiated PER ENTRY — its own admission queue, circuit
breaker, degradation ladder, warmup gate, supervised worker (whose thread
launches the entry's kernels under the server's worker context), and in
generation mode its slot scheduler — so a NaN-poisoned or breaker-tripped
entry fails only the requests routed to it, and every other entry keeps
serving.

Three planes on top of the table:

- **Tenancy** (``serving/tenancy.py``): per-tenant token-bucket quotas and
  weighted fair-share admission in front of every entry's typed queue.  A
  tenant at quota gets :class:`QuotaExceeded`; fleet contention sheds
  proportionally to weights, never silently.

- **Versioned rollout**: per-model canary percentages over a
  DETERMINISTIC hash-of-request split (same request key -> same arm,
  across retries and processes), shadow traffic (the candidate gets a
  duplicate, the INCUMBENT's reply is the reply, divergence is counted and
  journaled), and automatic rollback with the ``HotSwapManager`` probation
  applied per entry: a canary whose breaker trips or whose error rate
  regresses past the incumbent's baseline is rolled back inside its
  probation window, journaled as ``publish_rollback`` naming the entry.
  Session affinity pins a session to the version that first admitted it.

- **Observability**: registry counters are labeled
  ``fleet_*{tenant=,model=}``, and ``healthz()`` grows a per-entry
  ``models`` table while keeping the single-model ``model`` block of
  ``InferenceServer.healthz()``.

A closed fleet holds no reference cycle: dropping it frees its servers and
their models at once.  Not ported: the requests' trace attributes and
``audit()`` (the serving closures' audit), ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import hashlib
import queue as _queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.serving.errors import (InvalidRequestError,
                                             QuotaExceeded, ServingError)
from paddle_tpu_torch.serving.server import InferenceServer
from paddle_tpu_torch.serving.tenancy import TenantAdmission
from paddle_tpu_torch.utils.error import ConfigError
from paddle_tpu_torch.utils.log import logger

__all__ = ["ModelFleet", "canary_arm"]

#: the hash-split grain: percentages resolve to integer permille buckets
_SPLIT_BUCKETS = 10000


def canary_arm(model: str, key: str, percent: float) -> bool:
    """Deterministic hash-of-request canary split: True routes to the
    candidate.  The split is a pure function of ``(model, key)`` — the
    same request id lands on the same arm across retries, processes,
    and rollout restarts (pinned by tests/test_fleet.py)."""
    if percent <= 0.0:
        return False
    if percent >= 100.0:
        return True
    h = hashlib.sha256(f"{model}|{key}".encode()).digest()
    bucket = int.from_bytes(h[:4], "big") % _SPLIT_BUCKETS
    return bucket < percent * (_SPLIT_BUCKETS / 100.0)


def _content_key(feed: Dict[str, Any]) -> str:
    """Stable digest of a feed's bytes — the split key of last resort
    when the client supplies neither request_key nor session_id (an
    identical retry still lands on the same arm)."""
    h = hashlib.sha256()
    for name in sorted(feed):
        v = feed[name]
        parts = v if isinstance(v, (tuple, list)) else (v,)
        h.update(name.encode())
        for p in parts:
            a = np.asarray(p)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


class _Entry:
    """One model-table row: a full per-entry serving stack."""

    def __init__(self, name: str, version: int, server: InferenceServer,
                 info: Optional[dict], added_at: float) -> None:
        self.name = name
        self.version = int(version)
        self.server = server
        self.info = dict(info) if info else None
        self.added_at = added_at
        # serving | canary | shadow | retired | closed — mutated only
        # under the fleet lock: routing reads a consistent state
        self.state = "serving"

    @property
    def key(self) -> Tuple[str, int]:
        return (self.name, self.version)

    @property
    def label(self) -> str:
        return f"{self.name}@v{self.version}"


class ModelFleet:
    """The model table plus tenancy, rollout, and fleet health surface.

    ``tenants`` (optional) is an iterable of
    :class:`~paddle_tpu_torch.serving.tenancy.TenantSpec` (or kwarg dicts);
    without it the fleet is untenanted and ``submit(tenant=...)`` is
    carried for attribution only; ``capacity_rate``/``capacity_burst``
    size the aggregate bucket and ``credit`` is the fair-queuing slack
    (``--tenant_capacity_rate``, ``--tenant_credit``).  Rollout knobs
    mirror the ``HotSwapManager`` probation contract, applied per entry.
    """

    def __init__(self, *, tenants=None,
                 capacity_rate: Optional[float] = None,
                 capacity_burst: Optional[float] = None,
                 credit: float = 1.0,
                 probation_requests: int = 32,
                 min_probation_samples: int = 8,
                 error_rate_margin: float = 0.10,
                 shadow_rtol: float = 1e-5,
                 shadow_atol: float = 1e-6,
                 session_affinity_max: int = 4096,
                 clock=time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.RLock()
        # the model table, under _lock: entries/routes/sessions mutate
        # together on rollout transitions
        self._entries: Dict[Tuple[str, int], _Entry] = {}
        self._routes: Dict[str, dict] = {}
        self._sessions: "OrderedDict[Tuple[str, str], int]" = OrderedDict()
        self._session_max = int(session_affinity_max)
        self.admission = (TenantAdmission(
            tenants, capacity_rate=capacity_rate,
            capacity_burst=capacity_burst, credit=credit, clock=clock)
            if tenants is not None else None)
        self.probation_requests = int(probation_requests)
        self.min_probation_samples = int(min_probation_samples)
        self.error_rate_margin = float(error_rate_margin)
        self.shadow_rtol = float(shadow_rtol)
        self.shadow_atol = float(shadow_atol)
        self._closed = False
        # fleet-labeled registry counters, created on first use (under
        # _metric_lock: label children memoized once)
        self._metric_lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple[str, ...]], Any] = {}
        # shadow comparison runs OFF the reply path: pairs drain through
        # a bounded queue into one daemon thread; overflow is COUNTED
        # (never blocks a reply), compared pairs feed the divergence
        # counters + journal
        self._shadow_q: "_queue.Queue" = _queue.Queue(maxsize=256)
        self._shadow_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def _count(self, name: str, n: int = 1, **labels) -> None:
        from paddle_tpu_torch.obs import get_registry

        labelnames = tuple(sorted(labels))
        key = (name, labelnames, tuple(labels[k] for k in labelnames))
        with self._metric_lock:
            c = self._counters.get(key)
            if c is None:
                c = get_registry().counter(
                    "fleet_" + name, "fleet counter",
                    labels=labelnames, **labels)
                self._counters[key] = c
        c.inc(n)

    # ------------------------------------------------------------------
    # the model table
    # ------------------------------------------------------------------

    def add_model(self, name: str, model, *, version: int = 1,
                  role: str = "serving", percent: float = 0.0,
                  info: Optional[dict] = None,
                  warmup_feed=None, compile_cache=None,
                  start: bool = True, server_opts: Optional[dict] = None
                  ) -> _Entry:
        """Create one table entry — its own queue/breaker/ladder/worker
        (and slot scheduler in generation mode) — and wire it into the
        model's route.

        ``role``: ``"serving"`` makes the entry the model's incumbent
        (refused typed if one already exists — rollouts go through
        ``"canary"``/``"shadow"``); ``"canary"`` routes ``percent``% of
        the model's traffic to it under probation; ``"shadow"`` mirrors
        traffic to it while every reply still comes from the incumbent.
        """
        if role not in ("serving", "canary", "shadow"):
            raise ConfigError(f"role must be serving|canary|shadow, "
                              f"got {role!r}")
        opts = dict(server_opts or {})
        srv = InferenceServer(model, clock=self._clock, **opts)
        if start:
            srv.start(warmup_feed=warmup_feed,
                      warmup=(warmup_feed is not None
                              or hasattr(model, "topology")),
                      compile_cache=compile_cache)
        if info:
            srv.set_model_info(info)
        entry = _Entry(name, version, srv, info, self._clock())
        with self._lock:
            if self._closed:
                srv.close()
                raise ConfigError("fleet is closed")
            if entry.key in self._entries:
                srv.close()
                raise ConfigError(f"duplicate model entry {entry.label}")
            route = self._routes.get(name)
            if role == "serving":
                if route is not None and route["incumbent"] is not None:
                    srv.close()
                    raise ConfigError(
                        f"model {name!r} already has incumbent "
                        f"v{route['incumbent']} — roll out via "
                        f"role='canary' or role='shadow'")
                self._entries[entry.key] = entry
                self._routes[name] = {
                    "incumbent": version, "candidate": None,
                    "mode": None, "percent": 0.0,
                    "probation": None,
                    "shadow": {"compared": 0, "diverged": 0,
                               "candidate_errors": 0, "dropped": 0},
                }
            else:
                if route is None or route["incumbent"] is None:
                    srv.close()
                    raise ConfigError(
                        f"model {name!r} has no incumbent to roll out "
                        f"against")
                if route["candidate"] is not None:
                    srv.close()
                    raise ConfigError(
                        f"model {name!r} already has candidate "
                        f"v{route['candidate']} in flight — one rollout "
                        f"at a time")
                self._entries[entry.key] = entry
                entry.state = role
                incumbent = self._entries[(name, route["incumbent"])]
                # per-entry probation baselines (the HotSwapManager
                # contract generalized): the incumbent's error rate is
                # the bar, the candidate's own counters are the window
                from paddle_tpu_torch.serving.reload import error_baseline

                route["candidate"] = version
                route["mode"] = role
                route["percent"] = float(percent) if role == "canary" else 0.0
                route["probation"] = {
                    "baseline": error_baseline(incumbent.server),
                    "cand_start": error_baseline(srv),
                    "started": self._clock(),
                }
                from paddle_tpu_torch.obs.journal import journal_event

                journal_event("fleet_rollout", model=name, version=version,
                              mode=role, percent=route["percent"],
                              incumbent=route["incumbent"])
        return entry

    def entry(self, name: str, version: int) -> _Entry:
        with self._lock:
            e = self._entries.get((name, int(version)))
        if e is None:
            raise KeyError(f"no model entry {name}@v{version}")
        return e

    def entries(self) -> List[_Entry]:
        with self._lock:
            return list(self._entries.values())

    def route(self, name: str) -> dict:
        with self._lock:
            r = self._routes.get(name)
            if r is None:
                raise KeyError(f"unknown model {name!r}")
            return dict(r)

    def load_published_model(self, publish_root: str, name: str, *,
                             role: str = "serving", percent: float = 0.0,
                             compile_cache=None,
                             server_opts: Optional[dict] = None,
                             device=None) -> _Entry:
        """Boot one entry from the model's own publish watch dir
        (``publish_root/<name>/v-NNNNN`` — publish.model_publish_dir) on
        ``device`` (the card unless the caller asks otherwise): newest
        valid version wins, corrupt versions are skipped typed, and the
        publish dir's shared compile cache warms the entry."""
        from paddle_tpu_torch.publish import (model_publish_dir,
                                              publish_cache_dir)
        from paddle_tpu_torch.serving.reload import load_published

        mdir = model_publish_dir(publish_root, name)
        model, info, version = load_published(mdir, device=device)
        cache = compile_cache
        if cache is None:
            try:
                cache = publish_cache_dir(mdir)
            except Exception:  # noqa: BLE001 — cache is an optimization
                cache = None
        return self.add_model(name, model, version=version, role=role,
                              percent=percent, info=info,
                              compile_cache=cache, server_opts=server_opts)

    # ------------------------------------------------------------------
    # routing + submit
    # ------------------------------------------------------------------

    def _pick(self, name: str, request_key: Optional[str],
              session_id: Optional[str], feed: Dict[str, Any]
              ) -> Tuple[_Entry, Optional[_Entry], str]:
        """Resolve (serving entry, shadow candidate or None, split key)
        under the fleet lock."""
        route = self._routes.get(name)
        if route is None:
            known = sorted(self._routes)
            raise InvalidRequestError(
                f"unknown model {name!r} (serving: {known})")
        key = request_key or session_id or _content_key(feed)
        version = route["incumbent"]
        shadow_to = None
        if route["candidate"] is not None:
            cand = route["candidate"]
            if route["mode"] == "canary":
                pinned = (self._sessions.get((name, session_id))
                          if session_id else None)
                if pinned is not None and (
                        (name, pinned) in self._entries
                        and self._entries[(name, pinned)].state
                        not in ("retired", "closed")):
                    version = pinned
                elif canary_arm(name, key, route["percent"]):
                    version = cand
            elif route["mode"] == "shadow":
                shadow_entry = self._entries.get((name, cand))
                if shadow_entry is not None and shadow_entry.state == "shadow":
                    shadow_to = shadow_entry
        if session_id is not None:
            # session affinity: in-flight generation slots (and any
            # follow-up turns) pin to the version that admitted the
            # session — a rollout never migrates a live session
            self._sessions[(name, session_id)] = version
            self._sessions.move_to_end((name, session_id))
            while len(self._sessions) > self._session_max:
                self._sessions.popitem(last=False)
        entry = self._entries[(name, version)]
        return entry, shadow_to, key

    def submit(self, feed: Dict[str, Any], *, model: Optional[str] = None,
               tenant: Optional[str] = None,
               request_key: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               max_len: Optional[int] = None,
               session_id: Optional[str] = None):
        """Admit one request into the fleet, or raise typed.

        Order of the admission planes: tenancy first (quota / fair
        share — :class:`QuotaExceeded` never touches any entry's queue
        or breaker), then rollout routing (canary split / session
        affinity / shadow duplication), then the chosen ENTRY's own
        typed admission (shed / deadline / breaker / warmup).  Returns
        the entry's :class:`ServingFuture` — shadow candidates never
        produce the reply."""
        if self._closed:
            from paddle_tpu_torch.serving.errors import ServerClosed

            raise ServerClosed("fleet is closed")
        if model is None:
            with self._lock:
                if len(self._routes) != 1:
                    raise InvalidRequestError(
                        f"fleet serves {sorted(self._routes)} — "
                        f"submit(..., model=NAME) is required")
                model = next(iter(self._routes))
        if self.admission is not None:
            try:
                self.admission.admit(tenant)
            except QuotaExceeded as e:
                self._count("fair_share_shed_total" if e.fair_share
                            else "quota_rejected_total",
                            tenant=tenant or "-")
                raise
        with self._lock:
            entry, shadow_to, key = self._pick(model, request_key,
                                               session_id, feed)
        fut = entry.server.submit(feed, deadline_ms, max_len=max_len,
                                  session_id=session_id)
        self._count("requests_total", tenant=tenant or "-", model=model)
        if entry.state == "canary":
            self._count("canary_requests_total", model=model)
        if shadow_to is not None:
            self._shadow_submit(model, shadow_to, feed, deadline_ms,
                                max_len, session_id, fut, key)
        self._tick_locked_route(model)
        return fut

    def infer(self, feed: Dict[str, Any], *, model: Optional[str] = None,
              tenant: Optional[str] = None, timeout: Optional[float] = None,
              **kw) -> Dict[str, np.ndarray]:
        fut = self.submit(feed, model=model, tenant=tenant, **kw)
        return fut.result(timeout if timeout is not None else 30.0)

    # ------------------------------------------------------------------
    # shadow traffic
    # ------------------------------------------------------------------

    def _shadow_submit(self, name: str, entry: _Entry, feed, deadline_ms,
                       max_len, session_id, incumbent_fut, key) -> None:
        route = self._routes[name]
        try:
            cand_fut = entry.server.submit(
                feed, deadline_ms, max_len=max_len, session_id=session_id)
        except ServingError:
            # the candidate rejecting mirrored traffic is a candidate
            # problem, never the client's: counted, reply unaffected
            with self._lock:
                route["shadow"]["candidate_errors"] += 1
            return
        try:
            self._shadow_q.put_nowait(
                (name, entry.version, incumbent_fut, cand_fut, key))
        except _queue.Full:
            with self._lock:
                route["shadow"]["dropped"] += 1
            return
        if self._shadow_thread is None or not self._shadow_thread.is_alive():
            self._shadow_thread = threading.Thread(
                target=self._shadow_main, name="fleet-shadow", daemon=True)
            self._shadow_thread.start()

    def _shadow_main(self) -> None:
        from paddle_tpu_torch.obs.journal import journal_event

        while True:
            item = self._shadow_q.get()
            if item is None:
                return
            name, version, inc_fut, cand_fut, key = item
            try:
                inc = inc_fut.result(30.0)
                cand = cand_fut.result(30.0)
            except ServingError:
                with self._lock:
                    route = self._routes.get(name)
                    if route is not None:
                        route["shadow"]["compared"] += 1
                        route["shadow"]["candidate_errors"] += 1
                continue
            except Exception:  # noqa: BLE001 — the comparer must survive
                continue
            diverged = self._outputs_diverge(inc, cand)
            with self._lock:
                route = self._routes.get(name)
                if route is not None:
                    route["shadow"]["compared"] += 1
                    if diverged:
                        route["shadow"]["diverged"] += 1
            if diverged:
                self._count("shadow_diverged_total", model=name)
                journal_event("shadow_divergence", model=name,
                              version=version, request_key=key)

    def _outputs_diverge(self, inc: Dict[str, Any],
                         cand: Dict[str, Any]) -> bool:
        if set(inc) != set(cand):
            return True
        for k in inc:
            a, b = np.asarray(inc[k]), np.asarray(cand[k])
            if a.shape != b.shape or a.dtype != b.dtype:
                return True
            if a.dtype.kind == "f":
                if not np.allclose(a, b, rtol=self.shadow_rtol,
                                   atol=self.shadow_atol, equal_nan=True):
                    return True
            elif not np.array_equal(a, b):
                return True
        return False

    # ------------------------------------------------------------------
    # rollout state machine: probation -> promote | rollback
    # ------------------------------------------------------------------

    def tick(self) -> List[dict]:
        """Advance every model's rollout probation; returns the actions
        taken (``promoted`` / ``rolled_back``).  Also called inline on
        every submit, so a poisoned canary rolls back under live traffic
        without any external caller."""
        with self._lock:
            names = list(self._routes)
        actions = []
        for name in names:
            act = self._tick_locked_route(name)
            if act is not None:
                actions.append(act)
        self._reap_retired()
        return actions

    def _tick_locked_route(self, name: str) -> Optional[dict]:
        with self._lock:
            route = self._routes.get(name)
            if route is None or route["candidate"] is None:
                return None
            p = route["probation"]
            cand = self._entries.get((name, route["candidate"]))
            if cand is None or p is None:
                return None
            if cand.server.breaker.trips > p["cand_start"]["breaker_trips"]:
                return self._rollback_locked(name, "breaker_trip")
            m = cand.server.metrics
            completed = (m.count("completed")
                         - p["cand_start"]["completed"])
            failed = (m.count("inference_failed")
                      - p["cand_start"]["inference_failed"])
            resolved = completed + failed
            if resolved >= self.min_probation_samples:
                rate = failed / resolved
                if rate > p["baseline"]["error_rate"] + self.error_rate_margin:
                    return self._rollback_locked(
                        name, "error_rate_regression",
                        detail=f"candidate error rate {rate:.3f} vs "
                               f"incumbent baseline "
                               f"{p['baseline']['error_rate']:.3f}")
            if route["mode"] == "canary" and \
                    resolved >= self.probation_requests:
                return self._promote_locked(name, resolved)
            return None

    def promote(self, name: str) -> dict:
        """Manually conclude a rollout in the candidate's favor (shadow
        mode never auto-promotes — divergence is a human's call)."""
        with self._lock:
            route = self._routes.get(name)
            if route is None or route["candidate"] is None:
                raise ConfigError(f"model {name!r} has no rollout in flight")
            return self._promote_locked(name, 0)

    def rollback(self, name: str, signal: str = "manual",
                 detail: str = "") -> dict:
        with self._lock:
            route = self._routes.get(name)
            if route is None or route["candidate"] is None:
                raise ConfigError(f"model {name!r} has no rollout in flight")
            return self._rollback_locked(name, signal, detail)

    def _promote_locked(self, name: str, resolved: int) -> dict:
        from paddle_tpu_torch.obs.journal import journal_event

        route = self._routes[name]
        v, prev = route["candidate"], route["incumbent"]
        self._entries[(name, prev)].state = "retired"
        self._entries[(name, v)].state = "serving"
        route.update(incumbent=v, candidate=None, mode=None, percent=0.0,
                     probation=None)
        journal_event("probation_passed", fsync=True, model=name,
                      version=v, requests=resolved)
        journal_event("fleet_promote", model=name, version=v, previous=prev)
        self._count("promotions_total", model=name)
        logger.info("fleet: %s@v%d promoted (replacing v%d)", name, v, prev)
        return {"action": "promoted", "model": name, "version": v,
                "previous": prev}

    def _rollback_locked(self, name: str, signal: str,
                         detail: str = "") -> dict:
        from paddle_tpu_torch.obs.journal import journal_event

        route = self._routes[name]
        v = route["candidate"]
        entry = self._entries[(name, v)]
        entry.state = "retired"
        route.update(candidate=None, mode=None, percent=0.0, probation=None)
        # live sessions pinned to the dead candidate re-route to the
        # incumbent on their next request — never to a retired entry
        for skey in [k for k, sv in self._sessions.items()
                     if k[0] == name and sv == v]:
            del self._sessions[skey]
        journal_event("publish_rollback", fsync=True, model=name,
                      version=v, entry=entry.label, signal=signal,
                      detail=detail, rolled_back_to=route["incumbent"])
        self._count("rollbacks_total", model=name)
        logger.warning("fleet: %s rolled back to v%d (%s)%s",
                       entry.label, route["incumbent"], signal,
                       f": {detail}" if detail else "")
        return {"action": "rolled_back", "model": name, "version": v,
                "signal": signal, "rolled_back_to": route["incumbent"]}

    def _reap_retired(self) -> None:
        """Close retired entries once their queues drain — their queued
        requests resolve typed first (reply-or-typed-error even for a
        rolled-back canary's stragglers), so a rollout→rollback cycle
        drops ZERO requests."""
        with self._lock:
            victims = [e for e in self._entries.values()
                       if e.state == "retired"
                       and e.server.queue.depth() == 0]
            for e in victims:
                e.state = "closed"
        for e in victims:
            try:
                e.server.close()
            except Exception:  # noqa: BLE001 — reaping is best-effort
                logger.warning("fleet: closing retired %s failed", e.label)

    # ------------------------------------------------------------------
    # health + audit + lifecycle
    # ------------------------------------------------------------------

    def healthz(self) -> dict:
        """Fleet health: the per-entry ``models`` table
        (name/version/state/breaker/queue occupancy), per-model
        ``routes``, per-tenant ``tenants`` quota occupancy — plus a
        single-model ``model`` block (the default route's incumbent)
        kept schema-compatible with ``InferenceServer.healthz()``."""
        with self._lock:
            entries = list(self._entries.values())
            routes = {n: dict(r) for n, r in self._routes.items()}
        models = {}
        ready = bool(entries)
        for e in entries:
            if e.state == "closed":
                models[e.label] = {"name": e.name, "version": e.version,
                                   "state": "closed"}
                continue
            h = e.server.healthz()
            if e.state == "serving" and not h["ready"]:
                ready = False
            depth = h["queue_depth"]
            cap = e.server.queue.max_queue
            models[e.label] = {
                "name": e.name,
                "version": e.version,
                "state": e.state,
                "ready": h["ready"],
                "mode": h["mode"],
                "breaker": h["breaker"],
                "queue": {"depth": depth, "capacity": cap,
                          "occupancy": round(depth / cap, 4) if cap else 0.0},
                "completed": h["counters"]["completed"],
                "inference_failed": h["counters"]["inference_failed"],
                "shed": h["counters"]["shed"],
            }
        out: Dict[str, Any] = {
            "ready": ready,
            "models": models,
            "routes": {
                n: {"incumbent": r["incumbent"],
                    "candidate": r["candidate"],
                    "mode": r["mode"], "percent": r["percent"],
                    "shadow": dict(r["shadow"])}
                for n, r in routes.items()
            },
        }
        if self.admission is not None:
            out["tenants"] = self.admission.snapshot()
        for n in sorted(routes):
            inc = routes[n]["incumbent"]
            e = next((x for x in entries
                      if x.key == (n, inc) and x.state != "closed"), None)
            if e is not None:
                block = e.server.healthz().get("model")
                if block is not None:
                    out["model"] = block
                    break
        return out

    def audit(self) -> list:
        """The serving closures' audit of every entry (``lint --serve``):
        not ported (ROADMAP.md Queue 1 item 9)."""
        from paddle_tpu_torch.utils.error import not_ported

        raise not_ported("ModelFleet.audit (the serving closures' audit)", 9)

    def close(self, join_timeout: float = 2.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries = list(self._entries.values())
        if self._shadow_thread is not None and self._shadow_thread.is_alive():
            self._shadow_q.put(None)
            self._shadow_thread.join(join_timeout)
        for e in entries:
            if e.state != "closed":
                try:
                    e.server.close(join_timeout)
                except Exception:  # noqa: BLE001 — close the rest anyway
                    logger.warning("fleet: closing %s failed", e.label)
                e.state = "closed"
        from paddle_tpu_torch.obs import get_registry

        reg = get_registry()
        with self._metric_lock:
            for (name, labelnames, labelvalues) in list(self._counters):
                try:
                    reg.remove_series("fleet_" + name,
                                      **dict(zip(labelnames, labelvalues)))
                except Exception:  # noqa: BLE001 — registry hygiene only
                    pass
            self._counters.clear()

    def __enter__(self) -> "ModelFleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
