"""The port's model fleet, tenancy and router
(``paddle_tpu_torch/serving/fleet.py``, ``tenancy.py``, ``router.py``) on
the CPU: the 23 behaviour tests of ``tests/test_fleet.py`` (all but its
bench-table unit) on the port, then the port against the JAX package.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fleet.py -q

The acceptance bar of the reference, proven under chaos faults:

- **Isolation**: ``chaos.tenant_flood`` + ``chaos.poison_tenant`` against
  tenant A leave tenant B 100% served — B's outputs bit-compare EQUAL to a
  solo run, B's p99 stays inside the no-chaos guard, and the poisoned
  entry's breaker trips without tripping any other entry's.
- **Quota/fair share**: a tenant at quota gets a typed ``QuotaExceeded``
  naming it; under sustained aggregate contention admitted counts converge
  to the weight ratio within ±10%; a zero-weight tenant is rejected typed.
  Token buckets and admission run on an injected clock (no sleeps).
- **Rollout**: a 10% canary that NaN-poisons mid-rollout auto-rolls back
  within its probation window, the incumbent arm is never interrupted, and
  zero requests are dropped.  Shadow mode serves 100% incumbent replies
  while counting divergence, and never auto-promotes.
- **Router**: rendezvous placement is deterministic with minimal
  reshuffle; a dead server drains typed or fails over, gated by
  consecutive-probe streaks both ways.

Against the JAX package: ``canary_arm`` and ``rendezvous_rank`` are bit
equal over a seeded set of keys and names, the admission decisions of
both packages' ``TenantAdmission`` are identical step for step on one
injected clock, and ``model_publish_dir``/``list_model_dirs`` agree.  A
fleet over two published models serves each model's bundle bit for bit,
and a closed fleet frees its servers without the cycle collector.

Every test runs under a hard ``signal.alarm`` — a wedged fleet must fail
loudly, never eat the tier-1 budget.
"""

import os
import signal
import time

import numpy as np
import pytest

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (FleetRouter, InferenceFailed, ModelFleet,
                                QuotaExceeded, RouterDrainingError,
                                ServingError, TenantAdmission, TenantSpec,
                                canary_arm, rendezvous_rank)
from paddle_tpu_torch.serving.errors import InvalidRequestError
from paddle_tpu_torch.utils.error import ConfigError

HARD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def hard_timeout():
    def _abort(signum, frame):
        raise RuntimeError(f"fleet test exceeded {HARD_TIMEOUT_S}s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(HARD_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def fresh_names():
    nn.reset_naming()
    yield


def _feed(value, rows=1, dim=4):
    return {"x": np.full((rows, dim), value, np.float32)}


def _add1_model(feed):
    return {"y": np.asarray(feed["x"]) + 1.0}


def _mul2_model(feed):
    return {"y": np.asarray(feed["x"]) * 2.0}


def _opts(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_delay_ms", 1.0)
    kw.setdefault("max_queue", 32)
    kw.setdefault("default_deadline_ms", 30000.0)
    kw.setdefault("restart_backoff_s", 0.01)
    kw.setdefault("max_restart_backoff_s", 0.05)
    return kw


def _wait(cond, timeout=10.0, step=0.005):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------------------
# tenancy: spec validation + quota edges
# ---------------------------------------------------------------------------


def test_tenant_spec_rejects_bad_config_typed():
    with pytest.raises(ConfigError, match="weight"):
        TenantSpec("a", weight=0.0)
    with pytest.raises(ConfigError, match="weight"):
        TenantSpec("a", weight=-1.0)
    with pytest.raises(ConfigError, match="rate"):
        TenantSpec("a", rate=0.0)
    with pytest.raises(ConfigError, match="burst"):
        TenantSpec("a", burst=0.0)
    with pytest.raises(ConfigError, match="name"):
        TenantSpec("")


def test_tenant_admission_rejects_bad_sets_typed():
    with pytest.raises(ConfigError, match="at least one"):
        TenantAdmission([])
    with pytest.raises(ConfigError, match="duplicate"):
        TenantAdmission([TenantSpec("a"), TenantSpec("a")])


def test_unknown_and_missing_tenant_are_client_bugs():
    adm = TenantAdmission([TenantSpec("a")])
    with pytest.raises(InvalidRequestError, match="tenant"):
        adm.admit(None)
    with pytest.raises(InvalidRequestError, match="ghost"):
        adm.admit("ghost")


def test_quota_of_exactly_one():
    """burst=1 with a frozen clock: the first request admits, the second
    is rejected typed NAMING the tenant — never silently queued."""
    t = [0.0]
    adm = TenantAdmission([TenantSpec("solo", rate=1e-9, burst=1.0)],
                          clock=lambda: t[0])
    adm.admit("solo")
    with pytest.raises(QuotaExceeded, match="solo") as ei:
        adm.admit("solo")
    assert ei.value.tenant == "solo"
    assert ei.value.fair_share is False
    assert adm.admitted["solo"] == 1
    assert adm.quota_rejected["solo"] == 1


def test_quota_refills_with_the_clock():
    t = [0.0]
    adm = TenantAdmission([TenantSpec("a", rate=2.0, burst=1.0)],
                          clock=lambda: t[0])
    adm.admit("a")
    with pytest.raises(QuotaExceeded):
        adm.admit("a")
    t[0] = 0.5  # 2 req/s * 0.5s = 1 token back
    adm.admit("a")
    assert adm.admitted["a"] == 2


def test_weighted_fair_share_converges_to_weight_ratio():
    """All tenants at aggregate quota: alternating 3:1-weighted tenants
    under a dry aggregate bucket shed PROPORTIONALLY — admitted counts
    land on the weight ratio within ±10%, and the light tenant's sheds
    are typed fair-share QuotaExceeded, never silence."""
    t = [0.0]
    adm = TenantAdmission(
        [TenantSpec("gold", weight=3.0, rate=1e9, burst=1e9),
         TenantSpec("free", weight=1.0, rate=1e9, burst=1e9)],
        capacity_rate=1e-9, capacity_burst=4.0, clock=lambda: t[0])
    admitted = {"gold": 0, "free": 0}
    shed = {"gold": 0, "free": 0}
    for _ in range(400):
        for name in ("gold", "free"):
            try:
                adm.admit(name)
                admitted[name] += 1
            except QuotaExceeded as e:
                assert e.fair_share is True
                assert e.tenant == name
                shed[name] += 1
    assert admitted["free"] > 0, "light tenant must never be starved"
    ratio = admitted["gold"] / admitted["free"]
    assert 2.7 <= ratio <= 3.3, (admitted, shed)
    assert shed["free"] == adm.fair_share_shed["free"] > 0
    # fair-share sheds refunded the personal token: quota untouched
    assert adm.quota_rejected["free"] == 0


def test_equal_weights_share_equally():
    t = [0.0]
    adm = TenantAdmission(
        [TenantSpec("a", weight=1.0, rate=1e9, burst=1e9),
         TenantSpec("b", weight=1.0, rate=1e9, burst=1e9)],
        capacity_rate=1e-9, capacity_burst=2.0, clock=lambda: t[0])
    admitted = {"a": 0, "b": 0}
    for _ in range(300):
        for name in ("a", "b"):
            try:
                adm.admit(name)
                admitted[name] += 1
            except QuotaExceeded:
                pass
    ratio = admitted["a"] / admitted["b"]
    assert 0.9 <= ratio <= 1.1, admitted


def test_admission_snapshot_shape():
    adm = TenantAdmission([TenantSpec("a", weight=2.0, rate=5.0, burst=3.0)])
    adm.admit("a")
    snap = adm.snapshot()
    assert set(snap) == {"a"}
    assert snap["a"]["weight"] == 2.0
    assert snap["a"]["admitted"] == 1
    assert {"rate", "burst", "tokens", "occupancy", "quota_rejected",
            "fair_share_shed"} <= set(snap["a"])


# ---------------------------------------------------------------------------
# canary split: determinism
# ---------------------------------------------------------------------------


def test_canary_split_deterministic_and_proportional():
    keys = [f"req-{i}" for i in range(4000)]
    arms = [canary_arm("m", k, 10.0) for k in keys]
    # pure function of (model, key, percent): identical across calls
    assert arms == [canary_arm("m", k, 10.0) for k in keys]
    frac = sum(arms) / len(arms)
    assert 0.08 <= frac <= 0.12, frac
    # a different model name reshuffles the split independently
    assert arms != [canary_arm("other", k, 10.0) for k in keys]
    assert not any(canary_arm("m", k, 0.0) for k in keys[:100])
    assert all(canary_arm("m", k, 100.0) for k in keys[:100])


# ---------------------------------------------------------------------------
# the model table
# ---------------------------------------------------------------------------


def test_fleet_routes_by_model_and_requires_name_when_ambiguous():
    with ModelFleet() as fleet:
        fleet.add_model("add1", _add1_model, server_opts=_opts())
        out = fleet.infer(_feed(1.0))  # single route: name inferred
        np.testing.assert_array_equal(out["y"], _feed(1.0)["x"] + 1.0)
        fleet.add_model("mul2", _mul2_model, server_opts=_opts())
        with pytest.raises(InvalidRequestError, match="model=NAME"):
            fleet.submit(_feed(1.0))
        out = fleet.infer(_feed(3.0), model="mul2")
        np.testing.assert_array_equal(out["y"], _feed(3.0)["x"] * 2.0)
        with pytest.raises(InvalidRequestError, match="ghost"):
            fleet.submit(_feed(1.0), model="ghost")


def test_fleet_refuses_rollout_misconfig_typed():
    with ModelFleet() as fleet:
        fleet.add_model("m", _add1_model, server_opts=_opts())
        with pytest.raises(ConfigError, match="already has incumbent"):
            fleet.add_model("m", _mul2_model, version=2,
                            server_opts=_opts())
        with pytest.raises(ConfigError, match="duplicate"):
            fleet.add_model("m", _mul2_model, version=1, role="canary",
                            server_opts=_opts())
        with pytest.raises(ConfigError, match="no incumbent"):
            fleet.add_model("new", _mul2_model, version=2, role="canary",
                            server_opts=_opts())
        with pytest.raises(ConfigError, match="serving\\|canary\\|shadow"):
            fleet.add_model("m", _mul2_model, version=2, role="blue",
                            server_opts=_opts())
        fleet.add_model("m", _mul2_model, version=2, role="canary",
                        percent=50.0, server_opts=_opts())
        with pytest.raises(ConfigError, match="one rollout at a time"):
            fleet.add_model("m", _mul2_model, version=3, role="canary",
                            server_opts=_opts())


def test_fleet_healthz_models_table():
    with ModelFleet(tenants=[TenantSpec("a")]) as fleet:
        fleet.add_model("add1", _add1_model, server_opts=_opts())
        fleet.add_model("mul2", _mul2_model, server_opts=_opts())
        fleet.infer(_feed(1.0), model="add1", tenant="a")
        h = fleet.healthz()
        assert h["ready"] is True
        assert set(h["models"]) == {"add1@v1", "mul2@v1"}
        row = h["models"]["add1@v1"]
        assert row["state"] == "serving" and row["ready"] is True
        assert row["completed"] >= 1
        assert {"depth", "capacity", "occupancy"} == set(row["queue"])
        assert h["routes"]["add1"]["incumbent"] == 1
        assert h["tenants"]["a"]["admitted"] == 1


# ---------------------------------------------------------------------------
# isolation: chaos on tenant A must not touch tenant B
# ---------------------------------------------------------------------------


def test_tenant_flood_and_poison_leave_other_tenant_untouched():
    """The headline isolation proof: flood AND NaN-poison tenant "noisy"
    (routed to entry add1) while tenant "victim" (routed to entry mul2)
    runs the same request sequence as a preceding solo run.  The victim
    must be 100% served with outputs BIT-EQUAL to the solo run, its p99
    inside the no-chaos guard, and only add1's breaker may trip."""
    specs = [TenantSpec("noisy", weight=1.0, rate=2.0, burst=4.0),
             TenantSpec("victim", weight=3.0, rate=1e6, burst=1e6)]
    with ModelFleet(tenants=specs) as fleet:
        fleet.add_model("add1", _add1_model,
                        server_opts=_opts(breaker_threshold=3, max_queue=8))
        fleet.add_model("mul2", _mul2_model, server_opts=_opts())

        def run_victim():
            outs, lats = [], []
            for i in range(24):
                t0 = time.monotonic()
                out = fleet.infer(_feed(float(i)), model="mul2",
                                  tenant="victim", request_key=f"v{i}")
                lats.append(time.monotonic() - t0)
                outs.append(out["y"])
            lats.sort()
            return outs, lats[int(len(lats) * 0.99) - 1]

        solo_outs, solo_p99 = run_victim()

        restore = chaos.poison_tenant(fleet, "noisy")
        try:
            # interleaved poisoned submits (typed failures expected)...
            for i in range(6):
                try:
                    fleet.infer(_feed(1.0), model="add1", tenant="noisy",
                                timeout=10.0)
                except ServingError:
                    pass
            # ...plus a >2.5x flood of the noisy tenant's capacity
            flood = chaos.tenant_flood(fleet, _feed(1.0), tenant="noisy",
                                       model="add1")
            chaos_outs, chaos_p99 = run_victim()
        finally:
            restore()

        # flood overflow rejected TYPED, never silently queued
        assert flood["submitted"] > 2 * (4 + 2)
        assert flood["quota_rejected"] > 0
        assert flood["completed"] == 0  # every admitted feed was NaN
        # victim: bit-equal outputs, zero errors, p99 inside the guard
        assert len(chaos_outs) == len(solo_outs) == 24
        for a, b in zip(solo_outs, chaos_outs):
            assert np.array_equal(a, b)
        assert chaos_p99 < max(solo_p99 * 10.0, 1.0)
        # damage scoped to the poisoned entry: ONLY add1's breaker trips
        assert fleet.entry("add1", 1).server.breaker.trips > 0
        assert fleet.entry("mul2", 1).server.breaker.trips == 0
        h = fleet.healthz()
        assert h["models"]["mul2@v1"]["inference_failed"] == 0
        assert h["tenants"]["noisy"]["quota_rejected"] > 0
        assert h["tenants"]["victim"]["quota_rejected"] == 0


# ---------------------------------------------------------------------------
# rollout: canary auto-rollback, shadow, promote, session affinity
# ---------------------------------------------------------------------------


def _journal_records(tmp_path):
    from paddle_tpu_torch.obs.journal import (close_journal, journal_path,
                                              read_journal)

    close_journal()
    recs, _ = read_journal(journal_path(str(tmp_path / "j"), 0))
    return recs


def test_killed_canary_auto_rolls_back_with_zero_drops(tmp_path,
                                                       monkeypatch):
    """chaos.kill_canary on a 10% canary: the fleet rolls back within
    probation (journaled ``publish_rollback`` naming the entry), the
    incumbent arm never misses a reply, and every submitted request
    resolves — a reply or a typed error, zero drops."""
    from paddle_tpu_torch.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "obs_journal", str(tmp_path / "j"))
    with ModelFleet(probation_requests=500,
                    min_probation_samples=2) as fleet:
        fleet.add_model("m", _add1_model, server_opts=_opts())
        fleet.add_model("m", _add1_model, version=2, role="canary",
                        percent=10.0,
                        server_opts=_opts(breaker_threshold=100))
        chaos.kill_canary(fleet, "m", mode="nan")

        resolved = canary_failures = 0
        for i in range(300):
            arm_canary = canary_arm("m", f"k{i}", 10.0)
            try:
                out = fleet.infer(_feed(float(i)), model="m",
                                  request_key=f"k{i}", timeout=10.0)
                np.testing.assert_array_equal(out["y"],
                                              _feed(float(i))["x"] + 1.0)
                resolved += 1
            except InferenceFailed:
                # only the canary arm may fail, and only pre-rollback
                assert arm_canary, "incumbent arm must never fail"
                resolved += 1
                canary_failures += 1
            if fleet.route("m")["candidate"] is None:
                break
        assert canary_failures >= 2
        assert fleet.route("m")["candidate"] is None, \
            "canary not rolled back within probation"
        assert fleet.route("m")["incumbent"] == 1
        # the incumbent kept serving untripped throughout
        assert fleet.entry("m", 1).server.breaker.trips == 0
        # the retired canary reaps once its queue drains
        def _reaped():
            fleet.tick()
            return fleet.entry("m", 2).state == "closed"

        assert _wait(_reaped, timeout=10.0)
    recs = _journal_records(tmp_path)
    rb = [r for r in recs if r["kind"] == "publish_rollback"]
    assert rb and rb[0]["entry"] == "m@v2"
    assert rb[0]["signal"] in ("breaker_trip", "error_rate_regression")
    assert rb[0]["rolled_back_to"] == 1
    assert any(r["kind"] == "fleet_rollout" for r in recs)


def test_healthy_canary_promotes_after_probation():
    with ModelFleet(probation_requests=8,
                    min_probation_samples=4) as fleet:
        fleet.add_model("m", _add1_model, server_opts=_opts())
        fleet.add_model("m", _mul2_model, version=2, role="canary",
                        percent=100.0, server_opts=_opts())
        for i in range(10):
            fleet.infer(_feed(float(i)), model="m", request_key=f"k{i}",
                        timeout=10.0)
        def _promoted():
            fleet.tick()
            return fleet.route("m")["incumbent"] == 2

        assert _wait(_promoted, timeout=10.0)
        assert fleet.route("m")["candidate"] is None
        # post-promotion traffic serves the new incumbent
        out = fleet.infer(_feed(3.0), model="m", timeout=10.0)
        np.testing.assert_array_equal(out["y"], _feed(3.0)["x"] * 2.0)


def test_session_affinity_pins_and_rollback_unpins():
    """A session sticks to the arm that first admitted it (slots never
    migrate mid-rollout); rolling the candidate back re-routes the
    pinned sessions to the incumbent instead of a dead entry."""
    with ModelFleet(probation_requests=10_000,
                    min_probation_samples=10_000) as fleet:
        fleet.add_model("m", _add1_model, server_opts=_opts())
        fleet.add_model("m", _mul2_model, version=2, role="canary",
                        percent=100.0, server_opts=_opts())
        # 100% canary: the session pins to v2...
        out = fleet.infer(_feed(1.0), model="m", session_id="s1",
                          timeout=10.0)
        np.testing.assert_array_equal(out["y"], _feed(1.0)["x"] * 2.0)
        fleet.rollback("m", "manual")
        # ...and after rollback the SAME session serves from v1
        out = fleet.infer(_feed(1.0), model="m", session_id="s1",
                          timeout=10.0)
        np.testing.assert_array_equal(out["y"], _feed(1.0)["x"] + 1.0)


def test_shadow_serves_incumbent_and_counts_divergence(tmp_path,
                                                       monkeypatch):
    """Shadow rollout: every reply comes from the incumbent while the
    candidate sees duplicate traffic; divergence is counted + journaled;
    shadow NEVER auto-promotes, no matter how many requests resolve."""
    from paddle_tpu_torch.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "obs_journal", str(tmp_path / "j"))
    with ModelFleet(probation_requests=2,
                    min_probation_samples=10_000) as fleet:
        fleet.add_model("m", _add1_model, server_opts=_opts())
        fleet.add_model("m", _mul2_model, version=2, role="shadow",
                        server_opts=_opts())
        n = 12
        for i in range(n):
            # x >= 2 so the arms ALWAYS disagree (x+1 == x*2 at x=1)
            out = fleet.infer(_feed(float(i + 2)), model="m",
                              request_key=f"k{i}", timeout=10.0)
            # 100% of replies are the INCUMBENT's (x+1, never x*2)
            np.testing.assert_array_equal(out["y"],
                                          _feed(float(i + 2))["x"] + 1.0)
        assert _wait(lambda: fleet.route("m")["shadow"]["compared"] >= n,
                     timeout=10.0), fleet.route("m")["shadow"]
        shadow = fleet.route("m")["shadow"]
        assert shadow["diverged"] == shadow["compared"] >= n
        assert shadow["dropped"] == 0
        # divergence is informational: candidate stays, nobody promotes
        fleet.tick()
        assert fleet.route("m")["candidate"] == 2
        assert fleet.route("m")["mode"] == "shadow"
    recs = _journal_records(tmp_path)
    div = [r for r in recs if r["kind"] == "shadow_divergence"]
    assert div and div[0]["model"] == "m" and div[0]["version"] == 2


# ---------------------------------------------------------------------------
# fleet router: rendezvous placement + health-gated membership
# ---------------------------------------------------------------------------


class _FakeServer:
    def __init__(self, ready=True):
        self.ready = ready
        self.submitted = []
        self.closed = False

    def healthz(self):
        if isinstance(self.ready, Exception):
            raise self.ready
        return {"ready": self.ready}

    def submit(self, feed, *, tenant, **kw):
        self.submitted.append(tenant)
        return f"ok:{tenant}"

    def close(self, join_timeout=None):
        self.closed = True


def test_router_rejects_bad_config_typed():
    with pytest.raises(ConfigError, match="at least one"):
        FleetRouter({})
    with pytest.raises(ConfigError, match=">= 1"):
        FleetRouter({"a": _FakeServer()}, probe_budget=0)
    r = FleetRouter({"a": _FakeServer()})
    with pytest.raises(ConfigError, match="tenant"):
        r.submit(_feed(1.0), tenant="")


def test_rendezvous_rank_deterministic_minimal_reshuffle():
    servers = ["s1", "s2", "s3"]
    for tenant in ("alice", "bob", "carol", "dave"):
        ranked = rendezvous_rank(tenant, servers)
        assert ranked == rendezvous_rank(tenant, servers)
        assert sorted(ranked) == sorted(servers)
        # removing a LOSING server never moves the tenant's winner
        survivor = [s for s in servers if s != ranked[-1]]
        assert rendezvous_rank(tenant, survivor)[0] == ranked[0]


def test_router_death_and_rejoin_gated_by_probe_streaks():
    backends = {"s1": _FakeServer(), "s2": _FakeServer()}
    router = FleetRouter(backends, probe_budget=3, probes_to_join=2)
    backends["s1"].ready = False
    assert router.probe()["s1"] == "alive"  # one miss is weather
    backends["s1"].ready = RuntimeError("probe wedged")
    assert router.probe()["s1"] == "alive"  # a throwing probe is a miss
    assert router.probe()["s1"] == "dead"   # three in a row is a verdict
    assert router.members()["s1"]["last_error"].startswith("RuntimeError")
    backends["s1"].ready = True
    assert router.probe()["s1"] == "dead"   # one pass is not a rejoin
    assert router.probe()["s1"] == "alive"
    assert router.healthz()["ready"] is True


def test_router_drains_typed_without_failover():
    backends = {"s1": _FakeServer(), "s2": _FakeServer()}
    router = FleetRouter(backends, probe_budget=1, failover=False)
    tenant = "alice"
    home = router.server_for(tenant)
    backends[home].ready = False
    router.probe()
    with pytest.raises(RouterDrainingError, match=home) as ei:
        router.submit(_feed(1.0), tenant=tenant)
    assert ei.value.server == home
    assert router.healthz()["drained"] == 1


def test_router_failover_reroutes_down_rendezvous_order():
    backends = {"s1": _FakeServer(), "s2": _FakeServer(),
                "s3": _FakeServer()}
    router = FleetRouter(backends, probe_budget=1, failover=True)
    tenant = "alice"
    ranked = rendezvous_rank(tenant, sorted(backends))
    assert router.submit(_feed(1.0), tenant=tenant) == "ok:alice"
    assert backends[ranked[0]].submitted == ["alice"]
    backends[ranked[0]].ready = False
    router.probe()
    assert router.server_for(tenant) == ranked[1]
    router.submit(_feed(1.0), tenant=tenant)
    assert backends[ranked[1]].submitted == ["alice"]
    # an unrelated healthy server saw none of it
    assert backends[ranked[2]].submitted == []
    router.close()
    assert all(b.closed for b in backends.values())


# ---------------------------------------------------------------------------
# publish helpers + bench table unit
# ---------------------------------------------------------------------------


def test_model_publish_dir_and_list_model_dirs(tmp_path):
    from paddle_tpu_torch.publish import list_model_dirs, model_publish_dir

    root = str(tmp_path / "pub")
    assert list_model_dirs(root) == []
    for bad in ("", "v-00001", "_cache", "../evil", "a/b"):
        with pytest.raises(ValueError):
            model_publish_dir(root, bad)
    mdir = model_publish_dir(root, "seq2seq")
    os.makedirs(os.path.join(mdir, "v-00001"))
    os.makedirs(os.path.join(root, "stray"))        # no version dirs
    os.makedirs(os.path.join(root, "_cache"))       # reserved
    assert list_model_dirs(root) == ["seq2seq"]


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def test_canary_arm_and_rendezvous_rank_equal_the_reference():
    """Both pure functions give the JAX package's answers bit for bit over
    a seeded set of models, keys, percentages, tenants and server lists:
    a request lands on the same arm, and a tenant on the same server, in
    either package."""
    from paddle_tpu.serving import canary_arm as jcanary
    from paddle_tpu.serving import rendezvous_rank as jrank

    rs = np.random.RandomState(0)
    for _ in range(400):
        model = f"m{rs.randint(100)}"
        key = f"req-{rs.randint(1 << 30)}"
        pct = float(rs.choice([0.0, 0.5, 10.0, 33.3, 99.99, 100.0]))
        assert canary_arm(model, key, pct) == jcanary(model, key, pct)
    for _ in range(200):
        servers = [f"s{i}" for i in rs.permutation(rs.randint(1, 9))]
        tenant = f"t{rs.randint(1 << 20)}"
        assert rendezvous_rank(tenant, servers) == jrank(tenant, servers)


def test_tenant_admission_decisions_equal_the_reference():
    """The same admit sequence on one injected clock through both
    packages' ``TenantAdmission``: every decision (admit, quota, fair-share
    shed) and the final snapshot are equal."""
    from paddle_tpu.serving.errors import QuotaExceeded as JQuota
    from paddle_tpu.serving.tenancy import TenantAdmission as JAdmission

    def specs():
        return [dict(name="gold", weight=3.0, rate=5.0, burst=3.0),
                dict(name="free", weight=1.0, rate=2.0, burst=2.0)]

    t = [0.0]
    port = TenantAdmission(specs(), capacity_rate=4.0, capacity_burst=3.0,
                           clock=lambda: t[0])
    ref = JAdmission(specs(), capacity_rate=4.0, capacity_burst=3.0,
                     clock=lambda: t[0])
    rs = np.random.RandomState(1)

    def decide(adm, err, name):
        try:
            adm.admit(name)
            return "admit"
        except err as e:
            return "fair" if e.fair_share else "quota"

    decisions = []
    for _ in range(300):
        t[0] += float(rs.exponential(0.08))
        name = "gold" if rs.rand() < 0.6 else "free"
        a = decide(port, QuotaExceeded, name)
        assert a == decide(ref, JQuota, name)
        decisions.append(a)
    assert {"admit", "quota", "fair"} <= set(decisions)
    assert port.snapshot() == ref.snapshot()


def test_model_publish_dir_and_list_model_dirs_equal_the_reference(
        tmp_path):
    from paddle_tpu.publish import list_model_dirs as jlist
    from paddle_tpu.publish import model_publish_dir as jdir
    from paddle_tpu_torch.publish import list_model_dirs, model_publish_dir

    root = str(tmp_path / "pub")
    for name in ("seq2seq", "lm.v2", "x_1"):
        assert model_publish_dir(root, name) == jdir(root, name)
        os.makedirs(os.path.join(root, name, "v-00003"))
    os.makedirs(os.path.join(root, "stray"))
    os.makedirs(os.path.join(root, "ccache"))
    assert list_model_dirs(root) == jlist(root) == ["lm.v2", "seq2seq",
                                                    "x_1"]
    for bad in ("", "v-00001", "ccache", ".tmp-x", "../evil"):
        with pytest.raises(ValueError):
            model_publish_dir(root, bad)
        with pytest.raises(ValueError):
            jdir(root, bad)


def _published_root(tmp_path, rng):
    """Two small models, each published twice under its own watch dir of
    one fleet root (``model_publish_dir``)."""
    from paddle_tpu_torch.ops import compute_dtype_scope
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.publish import (model_publish_dir,
                                          publish_from_checkpoints)
    from paddle_tpu_torch.trainer import SGDTrainer

    root = str(tmp_path / "fleet")
    with compute_dtype_scope("float32"):
        for name, hidden in (("small", 4), ("wide", 8)):
            nn.reset_naming()
            x = nn.data("x", size=4)
            logits = nn.fc(nn.fc(x, hidden, act="tanh", name="h"), 3,
                           act="linear", name="logits")
            label = nn.data("label", size=1, dtype="int32")
            cost = nn.classification_cost(logits, label, name="cost")
            tr = SGDTrainer(cost, Adam(learning_rate=0.1), seed=0,
                            device="cpu")
            save = str(tmp_path / f"ck-{name}")
            for p in range(2):
                tr.train_batch({"x": rng.randn(6, 4).astype(np.float32),
                                "label": rng.randint(0, 3, (6, 1)).astype(
                                    np.int32)})
                tr.save(save, p)
                publish_from_checkpoints(model_publish_dir(root, name),
                                         tr.topology, save, pass_id=p,
                                         device="cpu")
    return root


def test_fleet_serves_published_models_with_canary_rollback(tmp_path, rng):
    """``load_published_model`` boots each model of a fleet root from its
    newest version; replies equal that bundle's own ``infer`` bit for bit;
    an older version rolled out as a 100% canary and killed with
    ``chaos.kill_canary`` rolls back with zero dropped requests."""
    from paddle_tpu_torch.config import load_inference_model
    from paddle_tpu_torch.ops import compute_dtype_scope
    from paddle_tpu_torch.publish import model_publish_dir, version_dir

    root = _published_root(tmp_path, rng)
    feed = {"x": rng.randn(2, 4).astype(np.float32)}
    with compute_dtype_scope("float32"), ModelFleet(
            probation_requests=500, min_probation_samples=2) as fleet:
        for name in ("small", "wide"):
            e = fleet.load_published_model(
                root, name, device="cpu",
                server_opts=_opts(outputs=["logits"]))
            assert e.version == 2 and e.info["version"] == 2
            want = load_inference_model(
                os.path.join(version_dir(model_publish_dir(root, name), 2),
                             "model.ptz"), device="cpu").infer(
                feed, outputs=["logits"])["logits"]
            got = fleet.infer(feed, model=name, timeout=10.0)["logits"]
            assert np.array_equal(got, want)
        old = load_inference_model(
            os.path.join(version_dir(model_publish_dir(root, "small"), 1),
                         "model.ptz"), device="cpu")
        fleet.add_model("small", old, version=1, role="canary",
                        percent=100.0,
                        server_opts=_opts(outputs=["logits"]))
        chaos.kill_canary(fleet, "small", mode="nan")
        futs = [fleet.submit(feed, model="small", request_key=f"k{i}")
                for i in range(6)]
        for f in futs:
            f.error(10.0)                  # resolves: reply or typed error
        fleet.tick()
        assert fleet.route("small")["candidate"] is None
        assert fleet.route("small")["incumbent"] == 2
        assert np.isfinite(fleet.infer(feed, model="small",
                                       timeout=10.0)["logits"]).all()


def test_closed_fleet_frees_its_servers_without_the_cycle_collector():
    """Dropping a closed fleet (tenanted, with a shadow rollout and a
    poison restored) frees its servers and their models at once: no
    reference cycle holds them for the collector."""
    import gc
    import weakref

    class _Model:
        def __call__(self, feed):
            return {"y": np.asarray(feed["x"]) + 1.0}

    gc.collect()
    gc.disable()
    try:
        model, cand = _Model(), _Model()
        fleet = ModelFleet(tenants=[TenantSpec("a")])
        fleet.add_model("m", model, server_opts=_opts())
        fleet.add_model("m", cand, version=2, role="shadow",
                        server_opts=_opts())
        restore = chaos.poison_tenant(fleet, "b")
        fleet.infer(_feed(2.0), model="m", tenant="a", timeout=10.0)
        restore()
        assert _wait(lambda: fleet.route("m")["shadow"]["compared"] >= 1)
        servers = [weakref.ref(e.server) for e in fleet.entries()]
        refs = [weakref.ref(model), weakref.ref(cand)]
        fleet.close()
        del fleet, model, cand, restore
        assert all(r() is None for r in servers + refs)
    finally:
        gc.enable()
