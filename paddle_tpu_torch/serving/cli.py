"""``python -m paddle_tpu_torch serve`` — the serving command line,
counterpart of ``paddle_tpu/serving/cli.py``.

Usage:

    python -m paddle_tpu_torch serve --serve_bundle=model.ptz [--serve_* ...]
    python -m paddle_tpu_torch serve --serve_bundle=model.ptz --serve_smoke=16
    python -m paddle_tpu_torch serve --serve_continuous --serve_smoke=16
    python -m paddle_tpu_torch serve --serve_watch --publish_dir=DIR
    python -m paddle_tpu_torch serve --serve_watch --serve_smoke=16
    python -m paddle_tpu_torch serve --serve_fleet --serve_smoke=16

Loads a deploy bundle (``config/deploy.py``; quantized bundles dequantize
on load) on ``--device`` (``cuda`` by default), builds a bucket-mode
:class:`InferenceServer` from the ``--serve_*`` flags, passes its warmup
gate (one warm call per batch bucket) and prints a ``ready`` line, then
either serves until SIGTERM/SIGINT (printing a ``healthz()`` line every 10
seconds) or, with ``--serve_smoke=N``, pushes N synthetic requests through
the queue, batcher and worker and exits 0 only if every one got a reply.
A smoke's last line is the server's ``healthz()`` with ``launches``: the
hand-written kernels launched after the ready line, by kernel and by path
(``ops.kernels.launch_counts``; empty on the CPU, where the plain versions
run), and ``compile_cache``: per kernel library its ``nvcc``/``g++`` runs,
its cache loads, where it came from and its smoke call's errors
(``config.compile_cache.library_stats``).

``--compile_cache_dir`` defaults to ``auto``: a per-bundle cache next to
the artifact (``<bundle>.ccache``), so a replica's second boot loads its
kernel libraries instead of building them (an explicit
``--compile_cache_dir=`` opts out; a bundle's embedded ``aot/`` members
layer underneath either way).  A library loaded from a cache passes its
smoke call first.

``--serve_watch`` serves the newest valid version under ``--publish_dir``
(corrupt versions journaled and skipped) and hot-reloads newer publishes
as they land (``serving/reload.py``), warmed from the publish dir's
``ccache/`` (or an explicit ``--compile_cache_dir``).  With
``--serve_smoke=N`` it is the self-test of the train->publish->reload loop:
a tiny model is trained, published as v1, served, published as v2 and N
requests stream across the swap; exit 0 needs zero failures, v2 committed
and no cache miss on the reload.  When ``--publish_dir`` already holds
versions the smoke trains nothing: it serves the newest one to N requests
and prints the first reply's outputs (``smoke_outputs``) on its last line.

``--serve_fleet --serve_smoke=N`` is the two-model, two-tenant isolation
self-test of ``ModelFleet`` (``--tenant_spec`` overrides the tenants).

``--serve_continuous`` is a smoke-only surface: a compact in-process
seq2seq backend (``serving.slots.example_slot_backend``) is admitted N
mixed-length requests (short decode budgets interleaved with
full-``max_len`` stragglers) through the slot scheduler, and the run exits
0 only on zero silent drops.

Not ported yet; each raises a ``ConfigError`` naming its ROADMAP.md Queue 1
item: ``--serve_preflight`` (the serving closure's audit) and
``--metrics_port``, item 9.
"""

from __future__ import annotations

import json
import signal
import threading
from typing import List, Optional

__all__ = ["run"]


def _smoke_launches() -> dict:
    """The kernels launched since the last ``reset_launch_counts``, by
    kernel and by path (the nonzero ones)."""
    from paddle_tpu_torch.ops.kernels import launch_counts

    counts = launch_counts()
    return {"by_kernel": {n: c for n, c in counts.items() if c},
            "by_path": {n: p for n, p in counts.by_path.items() if p}}


def _cache_stats(cache) -> dict:
    """The smoke lines' ``compile_cache`` block."""
    from paddle_tpu_torch.config.compile_cache import library_stats

    return {"hits": getattr(cache, "hits", 0),
            "misses": getattr(cache, "misses", 0),
            "libraries": {n: v for n, v in library_stats().items()
                          if v["origin"] is not None}}


def _resolve_cache_dir(bundle: Optional[str]) -> str:
    """The ``--compile_cache_dir`` resolution: the default ``auto`` derives
    a per-bundle cache NEXT TO the artifact (``<bundle>.ccache``), so a
    replica's second boot is warm by default; an explicit empty value
    opts out, and any other value is the shared fleet cache.  The
    bundle-less continuous smoke has no artifact to key a default cache
    on, so ``auto`` resolves to off there.  The derived default DEGRADES
    to off when the bundle's directory is not writable (a read-only
    artifact mount); an EXPLICIT cache dir keeps failing loudly."""
    import os

    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    d = FLAGS.compile_cache_dir
    if d != "auto":
        return d
    if not bundle:
        return ""
    derived = bundle + ".ccache"
    try:
        os.makedirs(derived, exist_ok=True)
    except OSError as e:
        logger.warning(
            "serve: per-bundle compile cache %r unavailable (%s) — "
            "booting without a cache (pass --compile_cache_dir=DIR for "
            "a writable location)", derived, e)
        return ""
    return derived


def _watch_cache_dir(publish_dir: str) -> str:
    """The watch paths' cache: the publish dir's shared ``ccache/`` unless
    ``--compile_cache_dir`` names another (or, empty, none)."""
    import os

    from paddle_tpu_torch.utils.flags import FLAGS

    d = FLAGS.compile_cache_dir
    return os.path.join(publish_dir, "ccache") if d == "auto" else d


def _continuous_smoke() -> int:
    """The ``--serve_continuous --serve_smoke=N`` self-test: N mixed-length
    requests through the full admit/step/harvest loop — every one must
    resolve (reply or typed error) and none may be silently dropped."""
    import numpy as np

    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving.server import InferenceServer
    from paddle_tpu_torch.serving.slots import example_slot_backend
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    # --spec_decode rides the greedy verify: the smoke backend drops to
    # beam_size=1 so the wide-verify path actually engages
    backend = example_slot_backend(
        beam_size=1 if FLAGS.spec_decode else 2, src_len=8, max_len=16,
        vocab=256, dim=32, device=FLAGS.device)
    server = InferenceServer(
        backend,
        mode="generation",
        slots=FLAGS.serve_slots,
        batch_delay_ms=FLAGS.serve_batch_delay_ms,
        max_queue=FLAGS.serve_queue_depth,
        default_deadline_ms=FLAGS.serve_deadline_ms,
        breaker_threshold=FLAGS.serve_breaker_threshold,
        breaker_cooldown_s=FLAGS.serve_breaker_cooldown_s,
        max_restarts=FLAGS.serve_max_restarts,
        restart_backoff_s=FLAGS.serve_backoff_s,
        hang_timeout_s=FLAGS.serve_hang_timeout_s,
        nonfinite=FLAGS.serve_nonfinite,
        spec_k=FLAGS.spec_k if FLAGS.spec_decode else 0,
        prefix_cache_mb=FLAGS.prefix_cache_mb,
        slot_page_pool_mb=FLAGS.slot_page_pool,
    )
    try:
        from paddle_tpu_torch.config.compile_cache import open_cache

        server.start(compile_cache=open_cache(
            cache_dir=_resolve_cache_dir(None)))
        reset_launch_counts()
        print(json.dumps({"ready": server.ready, **server.healthz()},
                         default=str), flush=True)
        rng = np.random.RandomState(0)
        failures = dropped = 0
        futs = []
        for i in range(FLAGS.serve_smoke):
            ids = rng.randint(3, 256, (1, 8)).astype(np.int32)
            lens = np.asarray([4 + (i % 5)], np.int32)
            # 90% short budgets, every 10th a full-max_len straggler
            max_len = backend.max_len if i % 10 == 9 else 3
            futs.append(server.submit(
                {"src": (ids, lens)},
                deadline_ms=FLAGS.serve_deadline_ms, max_len=max_len))
        for i, f in enumerate(futs):
            try:
                err = f.error(FLAGS.serve_deadline_ms / 1e3 + 60.0)
            except TimeoutError:
                dropped += 1   # a future that never resolves IS a drop
                logger.error("continuous smoke request %d never resolved", i)
                continue
            if err is not None:
                failures += 1
                logger.warning("continuous smoke request %d failed: %s",
                               i, err)
        print(json.dumps({**server.healthz(), "launches": _smoke_launches()},
                         default=str), flush=True)
        return 1 if (failures or dropped) else 0
    finally:
        server.close()


def _build_server(model):
    """One bucket-mode InferenceServer from the ``--serve_*`` flags."""
    from paddle_tpu_torch.serving.server import InferenceServer
    from paddle_tpu_torch.utils.flags import FLAGS

    return InferenceServer(
        model,
        max_batch=FLAGS.serve_max_batch,
        batch_delay_ms=FLAGS.serve_batch_delay_ms,
        max_queue=FLAGS.serve_queue_depth,
        default_deadline_ms=FLAGS.serve_deadline_ms,
        breaker_threshold=FLAGS.serve_breaker_threshold,
        breaker_cooldown_s=FLAGS.serve_breaker_cooldown_s,
        max_restarts=FLAGS.serve_max_restarts,
        restart_backoff_s=FLAGS.serve_backoff_s,
        hang_timeout_s=FLAGS.serve_hang_timeout_s,
        nonfinite=FLAGS.serve_nonfinite,
    )


def _parse_tenant_spec(s: str):
    """``--tenant_spec`` grammar: ``name:weight:rate:burst`` entries,
    comma-separated; trailing fields optional (defaults from TenantSpec).
    Bad entries are ConfigError — a misconfigured tenant table must never
    boot into silent starvation."""
    from paddle_tpu_torch.serving.tenancy import TenantSpec
    from paddle_tpu_torch.utils.error import ConfigError

    specs = []
    for item in filter(None, (p.strip() for p in s.split(","))):
        parts = item.split(":")
        try:
            kw = {}
            if len(parts) > 1:
                kw["weight"] = float(parts[1])
            if len(parts) > 2:
                kw["rate"] = float(parts[2])
            if len(parts) > 3:
                kw["burst"] = float(parts[3])
            specs.append(TenantSpec(parts[0], **kw))
        except ValueError as e:
            raise ConfigError(
                f"--tenant_spec entry {item!r} is not "
                f"name:weight:rate:burst ({e})") from None
    return specs


def _fleet_smoke() -> int:
    """The ``--serve_fleet --serve_smoke=N`` self-test: two models, two
    tenants, one deliberate flood.  A 'gold' tenant streams N requests
    against model A while a 'free' tenant (tiny quota) floods model B past
    its bucket.  Exits 0 only if BOTH models served, the flood was
    rejected TYPED (QuotaExceeded observed — quotas are real), and the
    gold tenant took zero errors."""
    import time

    import numpy as np

    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving.errors import QuotaExceeded
    from paddle_tpu_torch.serving.fleet import ModelFleet
    from paddle_tpu_torch.serving.tenancy import TenantSpec
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    n = FLAGS.serve_smoke
    tenants = (_parse_tenant_spec(FLAGS.tenant_spec)
               if FLAGS.tenant_spec else
               [TenantSpec("gold", weight=3.0, rate=1000.0, burst=4 * n),
                TenantSpec("free", weight=1.0, rate=0.5, burst=2.0)])
    fleet = ModelFleet(
        tenants=tenants,
        capacity_rate=FLAGS.tenant_capacity_rate or None,
        credit=FLAGS.tenant_credit,
        probation_requests=FLAGS.serve_probation_requests,
        clock=time.monotonic)
    server_opts = dict(max_batch=FLAGS.serve_max_batch,
                       batch_delay_ms=FLAGS.serve_batch_delay_ms,
                       max_queue=FLAGS.serve_queue_depth,
                       default_deadline_ms=FLAGS.serve_deadline_ms,
                       restart_backoff_s=FLAGS.serve_backoff_s,
                       nonfinite=FLAGS.serve_nonfinite)
    feed = {"x": np.ones((1, 4), np.float32)}
    reset_launch_counts()
    try:
        fleet.add_model("add1", lambda f, *r: {"y": f["x"] + 1},
                        server_opts=server_opts, warmup_feed=feed)
        fleet.add_model("mul2", lambda f, *r: {"y": f["x"] * 2},
                        server_opts=server_opts, warmup_feed=feed)
        gold_name, free_name = tenants[0].name, tenants[-1].name
        gold_errors = quota_rejections = served_a = served_b = 0
        for i in range(n):
            try:
                out = fleet.infer(feed, model="add1", tenant=gold_name,
                                  timeout=30.0)
                if np.allclose(out["y"], 2.0):
                    served_a += 1
            except Exception as e:  # noqa: BLE001 — every error indicts
                gold_errors += 1
                logger.warning("fleet smoke gold request %d failed: %s",
                               i, e)
            # the free tenant floods: 3 submits per gold request blows its
            # 2-token bucket — overflow must come back typed
            for _ in range(3):
                try:
                    out = fleet.infer(feed, model="mul2", tenant=free_name,
                                      timeout=30.0)
                    if np.allclose(out["y"], 2.0):
                        served_b += 1
                except QuotaExceeded:
                    quota_rejections += 1
                except Exception as e:  # noqa: BLE001
                    logger.warning("fleet smoke free request failed: %s", e)
        hz = fleet.healthz()
        print(json.dumps({**hz, "launches": _smoke_launches()},
                         default=str), flush=True)
        problems = []
        if not served_a:
            problems.append("model add1 never served its tenant")
        if not served_b:
            problems.append("model mul2 never served its tenant")
        if not quota_rejections:
            problems.append("the flood was never quota-rejected — "
                            "tenancy is not enforcing")
        if gold_errors:
            problems.append(f"gold tenant took {gold_errors} error(s) "
                            f"from the free tenant's flood")
        for p in problems:
            logger.error("fleet smoke: %s", p)
        return 1 if problems else 0
    finally:
        fleet.close()


def _watch_serve() -> int:
    """``--serve_watch``: boot from the newest valid version under
    ``--publish_dir`` (corrupt versions journaled and skipped) warmed from
    the publish dir's shared compile cache, then hot-reload newer
    publishes as they land — zero-downtime swap, probation window,
    automatic rollback."""
    import time

    from paddle_tpu_torch.config.compile_cache import open_cache
    from paddle_tpu_torch.serving.reload import (HotSwapManager,
                                                 load_published)
    from paddle_tpu_torch.utils.error import ConfigError
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    if not FLAGS.publish_dir:
        raise ConfigError("serve: --serve_watch needs --publish_dir=DIR")
    model, info, version = load_published(FLAGS.publish_dir,
                                          device=FLAGS.device)
    server = _build_server(model)
    logger.info("serve: watching %r from v%d (probation %d requests)",
                FLAGS.publish_dir, version, FLAGS.reload_probation)
    try:
        server.start(compile_cache=open_cache(
            bundle=info["bundle"],
            cache_dir=_watch_cache_dir(FLAGS.publish_dir)))
        mgr = HotSwapManager(server, FLAGS.publish_dir,
                             probation_requests=FLAGS.reload_probation)
        mgr.attach_current(version, info)
        stop = threading.Event()

        def _stop(signum, frame):
            stop.set()

        prev = {s: signal.signal(s, _stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            print(json.dumps({"ready": server.ready, **server.healthz()},
                             default=str), flush=True)
            last_hz = 0.0
            while not stop.is_set():
                stop.wait(1.0)
                try:
                    mgr.poll()
                except Exception as e:  # noqa: BLE001 — serving survives
                    logger.warning("serve watch: %s: %s",
                                   type(e).__name__, e)
                now = time.monotonic()
                if now - last_hz >= 10.0:
                    last_hz = now
                    print(json.dumps(server.healthz(), default=str),
                          flush=True)
                if not server.ready:
                    logger.error("serve: server left RUNNING state; "
                                 "exiting")
                    return 1
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
        return 0
    finally:
        server.close()


def _watch_smoke() -> int:
    """The ``--serve_watch --serve_smoke=N`` self-test.  With versions
    already under ``--publish_dir``: serve the newest to N requests
    (``_serve_published_smoke``).  Otherwise the whole train->publish->
    reload loop in one process: train a tiny model, publish v1, boot the
    watcher from it, publish v2 from a later checkpoint and stream N
    requests ACROSS the reload.  Exits 0 only if every request resolved
    (zero shed, zero drops), the server ended up serving v2, and the
    reload missed the compile cache nowhere."""
    import os
    import tempfile

    import numpy as np

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.config.compile_cache import open_cache
    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.publish import latest_version, publish_from_checkpoints
    from paddle_tpu_torch.serving.feeds import example_feed
    from paddle_tpu_torch.serving.reload import (HotSwapManager,
                                                 load_published)
    from paddle_tpu_torch.trainer import SGDTrainer
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    if FLAGS.publish_dir and latest_version(FLAGS.publish_dir) > 0:
        return _serve_published_smoke()
    root = tempfile.mkdtemp(prefix="serve-watch-smoke-")
    save_dir = os.path.join(root, "ckpt")
    pub = FLAGS.publish_dir or os.path.join(root, "publish")

    nn.reset_naming()
    x = nn.data("x", size=6, is_seq=True)
    pool = nn.pooling(nn.fc(x, 8, act="relu", name="h"),
                      pooling_type="max", name="pool")
    logits = nn.fc(pool, 3, act="linear", name="logits")
    label = nn.data("label", size=1, dtype="int32")
    cost = nn.classification_cost(logits, label, name="cost")
    tr = SGDTrainer(cost, Adam(learning_rate=0.05), seed=0,
                    device=FLAGS.device)
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 5, 6).astype(np.float32)
    lens = np.array([5, 3, 4, 5], np.int32)
    batch = {"x": (xs, lens), "label": np.zeros((4, 1), np.int32)}
    feed = example_feed(tr.topology)  # covers every data layer

    tr.train_batch(batch)
    tr.save(save_dir, 0)
    publish_from_checkpoints(pub, tr.topology, save_dir,
                             warm_max_batch=FLAGS.serve_max_batch,
                             device=FLAGS.device)
    model, info, v1 = load_published(pub, device=FLAGS.device)
    server = _build_server(model)
    cache = open_cache(bundle=info["bundle"], cache_dir=_watch_cache_dir(pub))
    try:
        server.start(compile_cache=cache)
        n = FLAGS.serve_smoke
        mgr = HotSwapManager(server, pub,
                             probation_requests=min(FLAGS.reload_probation,
                                                    max(1, n // 4)))
        mgr.attach_current(v1, info)
        print(json.dumps({"ready": server.ready, **server.healthz()},
                         default=str), flush=True)
        reset_launch_counts()
        # train on -> publish v2 while v1 serves
        tr.train_batch(batch)
        tr.save(save_dir, 1)
        publish_from_checkpoints(pub, tr.topology, save_dir,
                                 warm_max_batch=FLAGS.serve_max_batch,
                                 device=FLAGS.device)
        miss0 = server.metrics.count("compile_cache_misses")
        failures = 0
        for i in range(n):
            try:
                server.infer(feed, deadline_ms=FLAGS.serve_deadline_ms)
            except Exception as e:  # noqa: BLE001 — typed reply counts
                failures += 1
                logger.warning("watch smoke request %d failed: %s", i, e)
            mgr.poll()  # reload + probation ride the request stream
        for _ in range(64):  # drain probation if the stream was short
            if mgr.poll() is None and not mgr.in_probation:
                break
            server.infer(feed, deadline_ms=FLAGS.serve_deadline_ms)
        hz = server.healthz()
        print(json.dumps({**hz, "launches": _smoke_launches(),
                          "compile_cache": _cache_stats(cache)},
                         default=str), flush=True)
        miss_delta = server.metrics.count("compile_cache_misses") - miss0
        problems = []
        if failures:
            problems.append(f"{failures} request(s) failed")
        if hz["counters"]["shed"]:
            problems.append(f"shed={hz['counters']['shed']}")
        if (hz.get("model") or {}).get("version") != 2:
            problems.append(f"still serving {hz.get('model')}")
        if mgr.current_version != 2:
            problems.append(f"v2 not committed (at v{mgr.current_version})")
        if miss_delta:
            problems.append(f"reload missed the compile cache {miss_delta} "
                            f"time(s)")
        for p in problems:
            logger.error("watch smoke: %s", p)
        return 1 if problems else 0
    finally:
        server.close()


def _serve_published_smoke() -> int:
    """``--serve_watch --serve_smoke=N`` over a publish dir that already
    holds versions: boot from the newest valid one (warmed from the
    compile cache), serve N requests of the model's example feed with the
    watcher polling, and print the first reply's outputs
    (``smoke_outputs``), the launches after the ready line and the
    ``compile_cache`` block on the last line.  Exits 0 only if every
    request replied and the newest valid version served them."""
    import numpy as np

    from paddle_tpu_torch.config.compile_cache import open_cache
    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving.feeds import example_feed
    from paddle_tpu_torch.serving.reload import (HotSwapManager,
                                                 load_published)
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    pub = FLAGS.publish_dir
    model, info, version = load_published(pub, device=FLAGS.device)
    server = _build_server(model)
    cache = open_cache(bundle=info["bundle"], cache_dir=_watch_cache_dir(pub))
    try:
        server.start(compile_cache=cache)
        mgr = HotSwapManager(server, pub,
                             probation_requests=FLAGS.reload_probation)
        mgr.attach_current(version, info)
        reset_launch_counts()
        print(json.dumps({"ready": server.ready, **server.healthz(),
                          "compile_cache": _cache_stats(cache)},
                         default=str), flush=True)
        feed = example_feed(model.topology)
        failures, first = 0, None
        for i in range(FLAGS.serve_smoke):
            try:
                out = server.infer(feed, deadline_ms=FLAGS.serve_deadline_ms)
                if first is None:
                    first = {k: np.asarray(v).tolist()
                             for k, v in out.items()}
            except Exception as e:  # noqa: BLE001 — typed reply counts
                failures += 1
                logger.warning("watch smoke request %d failed: %s", i, e)
            mgr.poll()
        hz = server.healthz()
        print(json.dumps({**hz, "launches": _smoke_launches(),
                          "compile_cache": _cache_stats(cache),
                          "smoke_outputs": first}, default=str), flush=True)
        served = (hz.get("model") or {}).get("version")
        if served != version:
            logger.error("watch smoke: serving %s, want v%d", served,
                         version)
        return 1 if failures or served != version else 0
    finally:
        server.close()


def run(argv: Optional[List[str]] = None) -> int:
    from paddle_tpu_torch.config.deploy import load_inference_model
    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving.feeds import example_feed
    from paddle_tpu_torch.utils.error import ConfigError
    from paddle_tpu_torch.utils.flags import (FLAGS, parse_flags,
                                              refuse_unparsed)
    from paddle_tpu_torch.utils.log import logger

    refuse_unparsed(parse_flags(list(argv or [])), "serve: ")
    if FLAGS.serve_fleet:
        if FLAGS.serve_smoke <= 0:
            raise ConfigError(
                "serve: --serve_fleet is a smoke-only CLI surface (pass "
                "--serve_smoke=N); production fleets build ModelFleet/"
                "FleetRouter in-process")
        return _fleet_smoke()
    if FLAGS.serve_watch:
        # the continuous publishing consumer; its smoke is the self-test
        # of the whole train->publish->reload loop
        return _watch_smoke() if FLAGS.serve_smoke > 0 else _watch_serve()
    if FLAGS.serve_continuous:
        if FLAGS.serve_smoke <= 0:
            raise ConfigError(
                "serve: --serve_continuous is a smoke-only CLI surface "
                "(pass --serve_smoke=N); production continuous serving "
                "builds InferenceServer(mode='generation') over a "
                "SlotBackend in-process")
        return _continuous_smoke()
    if not FLAGS.serve_bundle:
        raise ConfigError("serve: --serve_bundle=<model.ptz> is required")

    # BundleCorruptError is typed and names the failing member
    model = load_inference_model(FLAGS.serve_bundle, device=FLAGS.device)
    server = _build_server(model)
    logger.info("serve: warming up %r (batch buckets up to %d)",
                FLAGS.serve_bundle, FLAGS.serve_max_batch)
    # the kernel libraries from the bundle's aot/ members (read-only: a
    # fleet shares the artifact) layered over --compile_cache_dir
    from paddle_tpu_torch.config.compile_cache import open_cache

    cache = open_cache(bundle=FLAGS.serve_bundle,
                       cache_dir=_resolve_cache_dir(FLAGS.serve_bundle))
    try:
        server.start(compile_cache=cache)
        if FLAGS.serve_smoke > 0:
            reset_launch_counts()
            print(json.dumps({"ready": server.ready, **server.healthz(),
                              "compile_cache": _cache_stats(cache)},
                             default=str), flush=True)
            feed = example_feed(model.topology)
            failures = 0
            for i in range(FLAGS.serve_smoke):
                try:
                    server.infer(feed, deadline_ms=FLAGS.serve_deadline_ms)
                except Exception as e:  # noqa: BLE001 — typed reply counts
                    failures += 1
                    logger.warning("serve smoke request %d failed: %s", i, e)
            print(json.dumps({**server.healthz(),
                              "launches": _smoke_launches(),
                              "compile_cache": _cache_stats(cache)},
                             default=str), flush=True)
            return 1 if failures else 0

        # serve until SIGTERM/SIGINT: a signal ends the loop cleanly (the
        # handlers go in before the ready line, which a supervisor may
        # answer with a signal at once)
        stop = threading.Event()

        def _stop(signum, frame):
            stop.set()

        prev = {s: signal.signal(s, _stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            print(json.dumps({"ready": server.ready, **server.healthz()},
                             default=str), flush=True)
            while not stop.is_set():
                stop.wait(10.0)
                print(json.dumps(server.healthz(), default=str), flush=True)
                if not server.ready:
                    logger.error("serve: server left RUNNING state; exiting")
                    return 1
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
        return 0
    finally:
        server.close()
