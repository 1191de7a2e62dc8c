"""The ``paddle_trainer`` command line of the port:
``python -m paddle_tpu_torch --job=... --config=...`` — counterpart of
``paddle_tpu/__main__.py``.

Reference: the paddle_trainer binary drives train / test / checkgrad / time
from gflags and a Python config (paddle/trainer/TrainerMain.cpp:32-65;
Trainer.h:43-202; TrainerBenchmark.cpp for --job=time).

The ``--config`` file is a Python module defining ``get_config()``, which
returns a dict built with the port's modules:

    cost         LayerOutput (or list) — required
    optimizer    Optimizer (default SGD lr=0.01)
    reader       () -> iterable of batches — required for train/time
    feeder       batch -> feed dict (optional)
    test_reader  () -> iterable (optional; falls back to reader for --job=test)
    trainer_kwargs  extra SGDTrainer kwargs (optional)

The trainer runs on ``--device`` (``cuda`` by default: without a card the
command raises; ``--device=cpu`` runs the kernels' plain versions).  In a
world the port's launcher started (``parallel.launch_local(n, "-m",
["paddle_tpu_torch", "--job=train", ...])``), or with ``--mesh_shape``,
the trainer takes ``MeshConfig.from_flags()`` bound to this rank
(``--mesh_shape`` must equal the world size); ``--job=train`` then prints,
on each rank, a last JSON line with the rank, its losses and synchronised
step milliseconds, a SHA-256 of its final parameters, its kernel launches
at the last training step (by library and by kernel variant) and its
collectives (``parallel.comm_stats``).
``--data_pack`` packs the config's reader and ``DataFeeder`` into packed
rows (``datapipe.auto_pack``).  ``--amp`` (with ``--loss_scale``,
``--loss_scale_growth``, ``--loss_scale_max``), ``--remat`` and
``--prefetch_depth`` reach the trainer through ``FLAGS``.

``python -m paddle_tpu_torch data {pack|verify} ...`` is the shard-set
tooling (``datapipe/cli.py``).  ``python -m paddle_tpu_torch serve
--serve_bundle=model.ptz`` serves a deploy bundle (``serving/cli.py``;
``--serve_smoke=N`` is its self-test, ``--serve_continuous
--serve_smoke=N`` the continuous-batching one; ``--serve_watch`` serves and
hot-reloads a publish dir, ``--serve_fleet --serve_smoke=N`` is the fleet's
self-test).

Not ported here, and refused with a ``ConfigError`` naming the ROADMAP.md
Queue 1 item that ports them: the ``lint`` (item 9), ``obs`` (item 9) and
``fsck`` (item 9) subcommands, and the reference's flags of parts not
ported yet (``utils/flags.py::NOT_PORTED_FLAGS``).
"""

from __future__ import annotations

import runpy
import sys
import time
from typing import List, Optional

#: the reference's subcommands and the ROADMAP.md Queue 1 item porting each
NOT_PORTED_COMMANDS = {"lint": 9, "obs": 9, "fsck": 9}


def _load_config(path: str):
    from paddle_tpu_torch.utils.error import ConfigError

    ns = runpy.run_path(path)
    if "get_config" not in ns:
        raise ConfigError(f"config {path!r} does not define get_config()")
    conf = ns["get_config"]()
    if "cost" not in conf:
        raise ConfigError(f"get_config() in {path!r} returned no 'cost'")
    return conf


def _mesh():
    """The mesh of a launched world (the launcher's environment) or of
    ``--mesh_shape``, bound to this rank; ``None`` for one process."""
    import os

    from paddle_tpu_torch.parallel import distributed as D
    from paddle_tpu_torch.parallel.mesh import MeshConfig
    from paddle_tpu_torch.utils.flags import FLAGS

    if not (FLAGS.mesh_shape or os.environ.get(D.ENV_COORDINATOR)):
        return None
    D.initialize_distributed()
    return MeshConfig.from_flags().build()


def _build_trainer(conf):
    from paddle_tpu_torch.param.optimizers import SGD
    from paddle_tpu_torch.trainer import SGDTrainer
    from paddle_tpu_torch.utils.flags import FLAGS

    kwargs = dict(conf.get("trainer_kwargs", {}))
    mesh = _mesh()
    if mesh is not None:
        kwargs.setdefault("mesh", mesh)
    return SGDTrainer(conf["cost"],
                      conf.get("optimizer") or SGD(learning_rate=0.01),
                      device=FLAGS.device if mesh is None else None,
                      **kwargs)


def _train_launches() -> dict:
    """The kernel launches of this process so far, by library and by
    kernel variant."""
    from paddle_tpu_torch.ops.kernels import launch_counts

    counts = launch_counts()
    return {"by_library": {k: v for k, v in counts.items() if v},
            "by_path": {k: v for k, v in counts.by_path.items() if v}}


def params_digest(params) -> str:
    """SHA-256 over the parameters' bytes, in sorted-name order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for k in sorted(params):
        t = params[k].detach().contiguous().cpu()
        h.update(k.encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _first_feed(conf):
    feeder = conf.get("feeder")
    batch = next(iter(conf["reader"]()))
    return feeder(batch) if feeder else batch


def job_train(conf) -> int:
    from paddle_tpu_torch.resilience import resilient_reader
    from paddle_tpu_torch.trainer import events as ev
    from paddle_tpu_torch.trainer.checkpoint import latest_pass
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    trainer = _build_trainer(conf)
    # --resume=auto self-locates inside train(); --start_pass remains the
    # explicit-pass resume
    if FLAGS.resume != "auto" and FLAGS.save_dir and FLAGS.start_pass > 0:
        resume = min(FLAGS.start_pass - 1, latest_pass(FLAGS.save_dir))
        if resume >= 0:
            logger.info("resuming from pass %d", resume)
            trainer.load(FLAGS.save_dir, resume)

    losses, step_ms, launches = [], [], {}
    t_begin = [0.0]

    def handler(e):
        if isinstance(e, ev.BeginIteration):
            t_begin[0] = time.perf_counter()
        if isinstance(e, ev.EndIteration):
            # the cost's host read waits for the step: a synchronised time
            step_ms.append((time.perf_counter() - t_begin[0]) * 1e3)
            losses.append(e.cost)
            if trainer.mesh is not None:
                launches.update(_train_launches())
        if isinstance(e, ev.EndPass):
            logger.info("pass %d done: %s", e.pass_id, e.evaluator)

    reader = conf["reader"]
    feeder = conf.get("feeder")
    test_reader = conf.get("test_reader")
    if FLAGS.data_pack:
        # the batch reader and DataFeeder re-plumbed into packed rows; the
        # test reader packs the same way, since train() feeds its batches
        # through the same (now packed) feeder
        from paddle_tpu_torch.data.feeder import DataFeeder
        from paddle_tpu_torch.datapipe import auto_pack
        from paddle_tpu_torch.utils.error import ConfigError

        if not isinstance(feeder, DataFeeder):
            raise ConfigError(
                "--data_pack needs the config's feeder to be a DataFeeder "
                "(the packer re-plumbs its slots)")
        if test_reader is not None:
            test_reader, _ = auto_pack(test_reader, feeder)
        reader, feeder = auto_pack(reader, feeder)
        logger.info("--data_pack: sequence packing enabled (note: packed "
                    "readers resume via fast-forward)")
    if FLAGS.reader_retries > 0:
        from paddle_tpu_torch.datapipe import is_checkpointable_source

        if is_checkpointable_source(reader):
            # a datapipe source has its own skip policy (skip_corrupt);
            # wrapping it would hide its cursor from the trainer
            logger.warning("--reader_retries ignored for a checkpointable "
                           "datapipe source (use skip_corrupt=True)")
        else:
            reader = resilient_reader(reader,
                                      max_retries=FLAGS.reader_retries)
    if trainer.mesh is not None:
        # the printed launches and collectives are the training run's
        from paddle_tpu_torch.ops.kernels import reset_launch_counts
        from paddle_tpu_torch.parallel import reset_comm_stats

        reset_launch_counts()
        reset_comm_stats()
    trainer.train(reader, num_passes=FLAGS.num_passes,
                  feeder=feeder, test_reader=test_reader,
                  event_handler=handler,
                  resume="auto" if FLAGS.resume == "auto" else None)
    if trainer.preempted:
        logger.warning("training preempted; relaunch with --resume=auto")
    if trainer.mesh is not None:
        import json

        from paddle_tpu_torch.parallel import distributed as D

        print(json.dumps({"rank": trainer.mesh.rank,
                          "world": trainer.mesh.size, "losses": losses,
                          "step_ms": step_ms,
                          "params_sha256": params_digest(trainer.params),
                          "launches": launches,
                          "comm": D.comm_stats()}), flush=True)
        D.shutdown_distributed()
    return 0


def job_test(conf) -> int:
    from paddle_tpu_torch.trainer.checkpoint import latest_pass
    from paddle_tpu_torch.utils.error import ConfigError
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    trainer = _build_trainer(conf)
    if FLAGS.save_dir:
        p = (FLAGS.test_pass if FLAGS.test_pass >= 0
             else latest_pass(FLAGS.save_dir))
        if p < 0:
            raise ConfigError(f"no checkpoint under {FLAGS.save_dir!r}")
        trainer.load(FLAGS.save_dir, p)
        logger.info("testing checkpoint pass %d", p)
    reader = conf.get("test_reader") or conf["reader"]
    result = trainer.test(reader, feeder=conf.get("feeder"))
    logger.info("test result: %s", result)
    print({k: round(v, 6) for k, v in result.items()})
    return 0


def job_checkgrad(conf) -> int:
    """Finite-difference check of the whole-model gradient on one batch
    (Trainer::checkGradient analog)."""
    from paddle_tpu_torch.trainer.checkgrad import check_gradients
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    trainer = _build_trainer(conf)
    feed = trainer._device_feed(_first_feed(conf))

    def loss_fn(params):
        outs, _ = trainer.topology.apply(params, trainer.state, feed,
                                         train=False)
        return trainer._total_cost([outs[n].value
                                    for n in trainer.cost_names])

    # whole-model FD through kinks (max-pool) is rougher than per-op
    # checks: the reference's tolerances
    report = check_gradients(loss_fn, trainer.params,
                             eps=FLAGS.checkgrad_eps, rtol=1e-1, atol=5e-3)
    worst = max(report.values()) if report else 0.0
    logger.info("checkgrad OK: %d params, worst abs err %.3g", len(report),
                worst)
    print(f"checkgrad OK ({len(report)} parameters, worst abs err "
          f"{worst:.3g})")
    return 0


def job_time(conf) -> int:
    """--job=time: ms/batch over N timed batches after a warm-up batch
    (TrainerBenchmark.cpp analog)."""
    from paddle_tpu_torch.utils.flags import FLAGS
    from paddle_tpu_torch.utils.log import logger

    trainer = _build_trainer(conf)
    feeder = conf.get("feeder")
    n = max(1, FLAGS.time_batches)
    feeds = []
    for i, batch in enumerate(conf["reader"]()):
        if i >= n:
            break
        feeds.append(feeder(batch) if feeder else batch)
    float(trainer.train_batch(feeds[0]))  # warm-up: builds, first launch
    t0 = time.perf_counter()
    for feed in feeds:
        loss = trainer.train_batch(feed)
    float(loss)  # waits for the last step
    ms = (time.perf_counter() - t0) / len(feeds) * 1e3
    logger.info("%d batches, %.3f ms/batch", len(feeds), ms)
    print(f"{ms:.3f} ms/batch over {len(feeds)} batches")
    return 0


JOBS = {
    "train": job_train,
    "test": job_test,
    "checkgrad": job_checkgrad,
    "time": job_time,
}


_USAGE = """\
usage: python -m paddle_tpu_torch --job={train|test|checkgrad|time} --config=CONF.py [--device=cuda|cpu] [--flag=value ...]
       python -m paddle_tpu_torch data {pack|verify} ...   (shard-set tooling; data --help)
       python -m paddle_tpu_torch serve --serve_bundle=MODEL.ptz [--serve_smoke=N] [--serve_* ...]
       python -m paddle_tpu_torch serve --serve_continuous --serve_smoke=N

The paddle_trainer command line of the PyTorch port.  CONF.py defines
get_config() (see the module docstring of paddle_tpu_torch/__main__.py).
The trainer and the server run on --device (cuda by default).  A bundle is
written by paddle_tpu_torch.config.merge_model.  Flags (also settable via
PADDLE_TPU_TORCH_<NAME> environment variables):
"""


def main(argv: Optional[List[str]] = None) -> int:
    from paddle_tpu_torch.utils.error import ConfigError, not_ported
    from paddle_tpu_torch.utils.flags import (FLAGS, flags_help, parse_flags,
                                              refuse_unparsed)

    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] == "data":
        # shard-set tooling: its own argparse surface
        from paddle_tpu_torch.datapipe.cli import run as data_run

        return data_run(argv[1:])
    if argv and argv[0] in NOT_PORTED_COMMANDS:
        raise not_ported(f"the {argv[0]!r} subcommand",
                         NOT_PORTED_COMMANDS[argv[0]])
    if "-h" in argv or "--help" in argv:
        print(_USAGE)
        print(flags_help())
        return 0
    if argv and argv[0] == "serve":
        from paddle_tpu_torch.serving.cli import run as serve_run

        return serve_run(argv[1:])
    refuse_unparsed(parse_flags(argv))
    if FLAGS.job not in JOBS:
        raise ConfigError(
            f"--job must be one of {sorted(JOBS)}, got {FLAGS.job!r}")
    if not FLAGS.config:
        raise ConfigError("--config=<file.py> is required")
    conf = _load_config(FLAGS.config)
    return JOBS[FLAGS.job](conf)


if __name__ == "__main__":
    sys.exit(main())
