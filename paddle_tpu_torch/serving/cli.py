"""``python -m paddle_tpu_torch serve`` — the serving command line,
counterpart of ``paddle_tpu/serving/cli.py``.

Usage:

    python -m paddle_tpu_torch serve --serve_bundle=model.ptz [--serve_* ...]
    python -m paddle_tpu_torch serve --serve_bundle=model.ptz --serve_smoke=16
    python -m paddle_tpu_torch serve --serve_continuous --serve_smoke=16

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
run).

``--serve_continuous`` is a smoke-only surface: a compact in-process
seq2seq backend (``serving.slots.example_slot_backend``) is admitted N
mixed-length requests (short decode budgets interleaved with
full-``max_len`` stragglers) through the slot scheduler, and the run exits
0 only on zero silent drops.

Not ported yet; each raises a ``ConfigError`` naming its ROADMAP.md Queue 1
item: ``--serve_watch`` (reload from a publish dir), ``--serve_fleet`` and
the tenancy flags, ``--compile_cache_dir``, item 7; ``--serve_preflight``
(the serving closure's audit) and ``--metrics_port``, item 9.
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
        server.start()
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


def run(argv: Optional[List[str]] = None) -> int:
    from paddle_tpu_torch.config.deploy import load_inference_model
    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving.feeds import example_feed
    from paddle_tpu_torch.utils.error import ConfigError
    from paddle_tpu_torch.utils.flags import (FLAGS, parse_flags,
                                              refuse_unparsed)
    from paddle_tpu_torch.utils.log import logger

    refuse_unparsed(parse_flags(list(argv or [])), "serve: ")
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
    try:
        server.start()
        if FLAGS.serve_smoke > 0:
            reset_launch_counts()
            print(json.dumps({"ready": server.ready, **server.healthz()},
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
                              "launches": _smoke_launches()},
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
