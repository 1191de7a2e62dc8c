"""The training loop — counterpart of ``paddle_tpu/trainer/trainer.py``.

Reference: the v2 SGD trainer drives GradientMachine.forwardBackward +
ParameterUpdater per batch from a Python loop
(python/paddle/v2/trainer.py:30-175), over the C++ Trainer/TrainerInternal
machinery (paddle/trainer/Trainer.cpp:261-576).

One device.  A batch step is eager PyTorch: ``Topology.apply`` ->
``torch.autograd.grad`` -> the optimizer's functional ``new_values`` -> the
pruning masks -> one in-place ``commit`` of every parameter, slot and the
step counter.  With the bad-step guard on (the default) the commit is
selected on the device by the finite check of the loss and the gradient
norm (``resilience/guard.py``); the trainer reads the skip flag once,
after the whole step is queued.  On the card the LSTM layers of
``lstm_benchmark_net`` run K9r forward and K10 backward, and ``test`` /
``infer`` run K9.

A ``sparse_grad`` table (``ParamAttr(sparse_grad=True)``) takes the
optimizer's masked row update (``sparse_rows``): rows the batch did not
touch keep their value and slots, as the reference's single-device trainer
does.

Not ported here, and refused with a ``ConfigError`` naming the ROADMAP.md
Queue 1 item that ports it: ``mesh`` (with it the pserver tier's sharded
tables), ``data_axis``, ``sharding_rules``, ``pipeline`` and
``device_specs`` (item 8); ``amp``
and ``remat`` (the rest of item 4; so is the batch prefetcher); the gang,
the SDC firewall and ``audit`` (item 9); ``publish`` (item 7).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import PreparedFeed, PrepareError
from paddle_tpu_torch.nn.graph import LayerOutput, Topology
from paddle_tpu_torch.param.hooks import apply_masks, build_masks
from paddle_tpu_torch.param.optimizers import (SGD, Optimizer,
                                               ParameterAverager, commit)
from paddle_tpu_torch.resilience.checkpoint_io import (latest_pass,
                                                       load_checkpoint,
                                                       pass_dir,
                                                       read_manifest,
                                                       save_checkpoint)
from paddle_tpu_torch.resilience.errors import ReaderError, TooManyBadSteps
from paddle_tpu_torch.resilience.guard import guarded_update
from paddle_tpu_torch.resilience.signals import PreemptionHandler
from paddle_tpu_torch.trainer import events as ev
from paddle_tpu_torch.utils.error import not_ported
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import logger

__all__ = ["SGDTrainer"]

#: the manifest meta key of the port's random stream (the reference's is
#: ``rng_key``, a JAX key, which the port does not use)
RNG_META_KEY = "torch_rng_state"


class SGDTrainer:
    """v2-style trainer: ``SGDTrainer(cost=..., optimizer=...)``, then
    ``.train(reader, num_passes, event_handler, feeder)``.  ``device``
    (default ``cuda``) is where the parameters live and the steps run;
    without a card, leaving it unset raises."""

    def __init__(
        self,
        cost: Union[LayerOutput, Sequence[LayerOutput]],
        optimizer: Optional[Optimizer] = None,
        *,
        extra_outputs: Sequence[LayerOutput] = (),
        cost_weights: Optional[Sequence[float]] = None,
        mesh=None,
        data_axis: str = "data",
        seed: Optional[int] = None,
        averager: Optional[ParameterAverager] = None,
        device_specs: Optional[Dict[str, Any]] = None,
        sharding_rules=None,
        pipeline: Optional[Dict[str, Any]] = None,
        guard_nonfinite: Optional[bool] = None,
        max_bad_steps: Optional[int] = None,
        amp: Optional[bool] = None,
        remat: Optional[bool] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        for what, given in (("mesh", mesh is not None),
                            ("data_axis", data_axis != "data"),
                            ("sharding_rules", sharding_rules is not None),
                            ("pipeline", pipeline is not None),
                            ("device_specs", device_specs is not None)):
            if given:
                raise not_ported(f"SGDTrainer({what}=)", 8)
        if amp:
            raise not_ported("SGDTrainer(amp=True) (--amp, mixed "
                              "precision with loss scaling)", 4)
        if remat:
            raise not_ported("SGDTrainer(remat=True) (--remat)", 4)
        # several costs train jointly (MultiNetwork analog): the total
        # loss is their weighted sum, parameters shared by name
        costs = [cost] if isinstance(cost, LayerOutput) else list(cost)
        self.cost_names = [c.name for c in costs]
        self.cost_weights = (list(cost_weights) if cost_weights
                             else [1.0] * len(costs))
        if len(self.cost_weights) != len(costs):
            raise ValueError("cost_weights must match the number of costs")
        self.cost_name = costs[0].name
        self.extra_names = [e.name for e in extra_outputs]
        self.topology = Topology([*costs, *extra_outputs], device=device)
        self.device = self.topology.device
        self.optimizer = optimizer or SGD(learning_rate=0.01)
        self.averager = averager

        # per-parameter attributes from the specs (ParameterConfig analog)
        self.lr_scales: Dict[str, float] = {}
        self.decays: Dict[str, float] = {}
        self.statics: Dict[str, bool] = {}
        self.sparse_rows: Dict[str, bool] = {}
        self.pruning_ratios: Dict[str, float] = {}
        for name, spec in self.topology.param_specs.items():
            if spec.is_state:
                continue
            attr = spec.attr
            if attr.sparse_grad:
                self.sparse_rows[name] = True
            if attr.learning_rate != 1.0:
                self.lr_scales[name] = attr.learning_rate
            if attr.l2_decay:
                self.decays[name] = attr.l2_decay
            if attr.is_static:
                self.statics[name] = True
            if attr.pruning_ratio:
                self.pruning_ratios[name] = attr.pruning_ratio

        seed = FLAGS.seed if seed is None else seed
        params, self.state = self.topology.init(seed)
        # the stream each batch's apply seed is drawn from (checkpointed)
        self._gen = torch.Generator().manual_seed(seed)
        # StaticPruningHook analog: masks fixed from the initial magnitudes,
        # multiplied in after every update
        self.masks = build_masks(params, self.pruning_ratios)
        self._adopt_params(apply_masks(params, self.masks))
        self.fused_apply = bool(FLAGS.fused_apply)
        self.opt_state = self.optimizer.init_state(self.params)
        self.avg_params = (averager.init_state(self.params)
                           if averager is not None else None)
        self.guard_nonfinite = (FLAGS.guard_nonfinite
                                if guard_nonfinite is None
                                else bool(guard_nonfinite))
        self.max_bad_steps = (FLAGS.max_bad_steps if max_bad_steps is None
                              else int(max_bad_steps))
        self.bad_steps_total = 0
        self._bad_streak = 0
        self._last_extras: Dict[str, Any] = {}
        self.preempted = False
        #: batches re-read and discarded to resume mid-pass
        self.resume_replayed_batches = 0
        from paddle_tpu_torch.obs import get_registry

        reg = get_registry()
        self._obs_cost = reg.gauge("train_last_cost", "cost of the last step")
        self._obs_counters = {
            "batches": reg.counter("train_batches_total",
                                   "optimizer steps taken"),
            "bad_steps": reg.counter("train_bad_steps_total",
                                     "guard-skipped non-finite steps"),
            "checkpoints": reg.counter("train_checkpoints_total",
                                       "checkpoint commits published"),
        }

    # ------------------------------------------------------------------

    def _adopt_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Make ``params`` the trainer's: leaves that require grad, so
        every step's ``torch.autograd.grad`` runs on the same tensors."""
        self.params = {k: v.detach().requires_grad_()
                       for k, v in params.items()}

    def _device_feed(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """The prepared (numpy) feed on the trainer's device, moved once;
        values are converted as ``Topology.apply`` would convert them."""
        dev = self.device

        def put(v):
            if isinstance(v, tuple):
                return tuple(put(x) for x in v)
            if torch.is_tensor(v):
                return v.to(dev)
            if isinstance(v, (np.ndarray, list, int, float, np.generic)):
                return torch.as_tensor(np.asarray(v), device=dev)
            return v

        return {k: put(v) for k, v in feed.items()}

    def _total_cost(self, outs) -> torch.Tensor:
        if len(self.cost_names) == 1 and self.cost_weights[0] == 1.0:
            return outs[self.cost_name].value
        return sum(w * outs[n].value
                   for n, w in zip(self.cost_names, self.cost_weights))

    def rebuild_masks(self) -> None:
        """Rebuild the pruning masks from the current parameter values
        (the reference builds them from the values in effect, initial or
        loaded: paddle/parameter/ParameterUpdaterHook.cpp:36-78)."""
        if not self.pruning_ratios:
            return
        self.masks = build_masks(self.params, self.pruning_ratios)
        self._adopt_params(apply_masks(self.params, self.masks))

    @torch.no_grad()
    def _log_parameter_stats(self) -> None:
        """Per-parameter mean/|max|/min (the --show_parameter_stats_period
        plane, TrainerInternal.cpp:162 showParameterStats); one host read
        for all of them."""
        names = sorted(self.params)
        stats = torch.stack([torch.stack([v.float().mean(),
                                          v.float().abs().max(),
                                          v.float().min()])
                             for v in (self.params[k] for k in names)])
        for k, (mean, amax, mn) in zip(names, stats.cpu().tolist()):
            logger.info("param %-28s mean=% .5e absmax=% .5e min=% .5e",
                        k, mean, amax, mn)

    def audit(self, feed: Dict[str, Any], *, label: str = "train_step"):
        raise not_ported("SGDTrainer.audit (the step auditor, `lint`)", 9)

    def publish(self, publish_dir: str, save_dir: str, *,
                pass_id: Optional[int] = None):
        raise not_ported("SGDTrainer.publish (continuous publication)", 7)

    # ------------------------------------------------------------------

    def train_batch(self, feed: Dict[str, Any]) -> torch.Tensor:
        """Run one optimizer step on a prepared feed dict; returns the cost
        (a detached scalar tensor on the device).

        With the bad-step guard on, a non-finite loss/grad step leaves the
        parameters, the optimizer slots, the step counter and the layer
        state bit for bit unchanged (selected on the device); the skip
        flag lands in ``_last_extras['bad_step']`` and the host counters
        ``bad_steps_total``/``bad_steps_streak`` advance.  After
        ``max_bad_steps`` consecutive skips the step raises
        ``TooManyBadSteps``."""
        feed = self._device_feed(feed)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))
        params = self.params
        with torch.enable_grad():
            outs, new_state = self.topology.apply(params, self.state, feed,
                                                  train=True, rng=seed)
            loss = self._total_cost(outs)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(params.items(), grads)}
        extras = {k: outs[k].value.detach() for k in self.extra_names}

        @torch.no_grad()
        def do_update(where: Optional[torch.Tensor]) -> None:
            new_p, new_o = self.optimizer.new_values(
                params, grads, self.opt_state, lr_scales=self.lr_scales,
                decays=self.decays, statics=self.statics,
                sparse_rows=self.sparse_rows, fused=self.fused_apply)
            commit(params, self.opt_state, apply_masks(new_p, self.masks),
                   new_o, where)

        if self.guard_nonfinite:
            new_state, gextras = guarded_update(
                do_update, loss=loss, grads=grads, new_state=new_state,
                old_state=self.state)
            extras.update(gextras)
        else:
            do_update(None)
        self.state = new_state
        if self.averager is not None:
            self.avg_params = self.averager.update(self.avg_params, params)
        self._obs_counters["batches"].inc()
        self._last_extras = extras
        if self.guard_nonfinite:
            # the one host read of the step, after all of it is queued
            if bool(extras["bad_step"]):
                self.bad_steps_total += 1
                self._bad_streak += 1
                self._obs_counters["bad_steps"].inc()
                logger.warning(
                    "non-finite loss/grad: optimizer update skipped "
                    "(streak %d, total %d)", self._bad_streak,
                    self.bad_steps_total)
                if (self.max_bad_steps
                        and self._bad_streak >= self.max_bad_steps):
                    raise TooManyBadSteps(
                        f"{self._bad_streak} consecutive non-finite steps "
                        f"(max_bad_steps={self.max_bad_steps})")
            else:
                self._bad_streak = 0
        return loss.detach()

    @property
    def bad_steps_streak(self) -> int:
        return self._bad_streak

    def train(self, reader: Callable, *, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeder: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              resume: Optional[str] = None,
              preemption: Optional[PreemptionHandler] = None) -> None:
        """Pass/batch loop with events — trainer.py:108-173 analog.

        - ``resume="auto"`` (or ``--resume=auto``): restore params, state,
          optimizer state, the random stream and the pass id from the
          newest valid checkpoint under ``FLAGS.save_dir`` and continue
          from there, mid-pass at the batch a preemption checkpoint
          recorded (the reader is re-read and fast-forwarded);
        - SIGTERM/SIGINT (or a ``preemption`` handler's ``request()``)
          writes an atomic checkpoint at the next batch boundary and
          returns (``self.preempted`` is set);
        - a reader exception mid-pass emits ``EndPass`` and re-raises as
          ``ReaderError``, attributed to the data tier.

        ``log_period``, ``test_period`` (mid-pass evaluation),
        ``saving_period``, ``keep_last_n`` and
        ``show_parameter_stats_period`` come from ``FLAGS``."""
        handler = event_handler or (lambda e: None)
        log_period = FLAGS.log_period
        resume = resume or FLAGS.resume or None
        if resume is not None and resume != "auto":
            raise ValueError(f"resume must be None or 'auto', got {resume!r}")
        start_pass, start_batch = FLAGS.start_pass, 0
        if resume == "auto":
            start_pass, start_batch = self._auto_resume()
        if (preemption is None and FLAGS.save_dir
                and FLAGS.checkpoint_on_preemption):
            preemption = PreemptionHandler()
        self.preempted = False
        if preemption is not None:
            preemption.install()
        try:
            for pass_id in range(start_pass, num_passes):
                handler(ev.BeginPass(pass_id))
                costs: List[float] = []
                t0 = time.time()

                def _reader_failed(e: Exception, pass_id=pass_id):
                    # pass teardown reaches the handlers even on failure,
                    # and the crash is attributed to the reader tier
                    handler(ev.EndPass(pass_id))
                    if isinstance(e, ReaderError):
                        return e
                    return ReaderError(
                        f"reader raised in pass {pass_id}: "
                        f"{type(e).__name__}: {e}")

                try:
                    it = iter(reader())
                except Exception as e:
                    raise _reader_failed(e) from e
                skip = start_batch if pass_id == start_pass else 0
                if skip:
                    logger.info("resuming pass %d at batch %d "
                                "(fast-forward)", pass_id, skip)
                batch_id = 0
                while True:
                    if preemption is not None and preemption.poll():
                        self._preempt_exit(pass_id, batch_id + skip)
                        return
                    try:
                        data_batch = next(it, None)
                    except PrepareError as e:
                        raise (e.__cause__ if e.__cause__ is not None
                               else e)
                    except Exception as e:
                        raise _reader_failed(e) from e
                    if data_batch is None:
                        break
                    if skip:
                        # fast-forward a deterministic reader to the batch
                        # the preemption checkpoint recorded
                        skip -= 1
                        batch_id += 1
                        self.resume_replayed_batches += 1
                        continue
                    handler(ev.BeginIteration(pass_id, batch_id))
                    feed = (data_batch.feed
                            if isinstance(data_batch, PreparedFeed)
                            else feeder(data_batch) if feeder
                            else data_batch)
                    try:
                        loss = self.train_batch(feed)
                    except TooManyBadSteps:
                        handler(ev.EndPass(pass_id))
                        raise
                    drops = getattr(feeder, "dropped_features", None)
                    if drops is not None:
                        self._last_extras = {**self._last_extras,
                                             "dropped_features": int(drops)}
                    cost = float(loss)
                    costs.append(cost)
                    self._obs_cost.set(cost)
                    handler(ev.EndIteration(pass_id, batch_id, cost))
                    if log_period and (batch_id + 1) % log_period == 0:
                        logger.info(
                            "Pass %d, Batch %d, Cost %.5f (%.1f batch/s)",
                            pass_id, batch_id + 1,
                            float(np.mean(costs[-log_period:])),
                            log_period / max(time.time() - t0, 1e-9))
                        t0 = time.time()
                    psp = FLAGS.show_parameter_stats_period
                    if psp and (batch_id + 1) % psp == 0:
                        self._log_parameter_stats()
                    tp = FLAGS.test_period
                    if (tp and test_reader is not None
                            and (batch_id + 1) % tp == 0):
                        # mid-pass evaluation (Trainer.cpp trainOneBatch
                        # "testing" branch; 0 = per pass only)
                        mid = self.test(test_reader, feeder=feeder)
                        logger.info("Pass %d, Batch %d, Test cost %.5f",
                                    pass_id, batch_id + 1, mid["cost"])
                    batch_id += 1
                result = {}
                if test_reader is not None:
                    result = self.test(test_reader, feeder=feeder)
                handler(ev.EndPass(pass_id, evaluator=result))
                if FLAGS.save_dir and FLAGS.saving_period and (
                        (pass_id + 1) % FLAGS.saving_period == 0):
                    self.save(FLAGS.save_dir, pass_id)
        finally:
            if preemption is not None:
                preemption.uninstall()

    def _preempt_exit(self, pass_id: int, batch_id: int) -> None:
        """Preemption landed: persist an atomic mid-pass checkpoint (its
        manifest records ``next_batch`` so ``resume="auto"`` re-enters this
        pass at this batch) and return."""
        self.preempted = True
        if FLAGS.save_dir:
            d = self.save(FLAGS.save_dir, pass_id,
                          meta={"preempted": True, "next_batch": batch_id})
            logger.warning(
                "preemption: checkpoint saved to %s (pass %d, next batch "
                "%d); exiting", d, pass_id, batch_id)
        else:
            logger.warning(
                "preemption requested but --save_dir is unset: exiting "
                "WITHOUT a checkpoint")

    def _auto_resume(self) -> tuple:
        """Restore the newest valid checkpoint under FLAGS.save_dir;
        returns ``(start_pass, start_batch)``."""
        save_dir = FLAGS.save_dir
        if not save_dir:
            return FLAGS.start_pass, 0
        p = latest_pass(save_dir)
        if p < 0:
            logger.info("resume=auto: no valid checkpoint under %r, "
                        "starting fresh", save_dir)
            return FLAGS.start_pass, 0
        # latest_pass just validated pass p: load without a second CRC pass
        manifest = self.load(save_dir, p, validate=False)
        meta = (manifest or {}).get("meta", {})
        if meta.get("preempted"):
            nb = int(meta.get("next_batch", 0))
            logger.info("resume=auto: preemption checkpoint pass %d, "
                        "resuming at batch %d", p, nb)
            return p, nb
        logger.info("resume=auto: resuming after completed pass %d", p)
        return p + 1, 0

    # ------------------------------------------------------------------

    @torch.no_grad()
    def test(self, reader: Callable, *, feeder: Optional[Callable] = None,
             evaluators: Optional[Dict] = None) -> Dict[str, float]:
        """Eval loop — Tester analog (paddle/trainer/Tester.h:40).

        Reports the weighted joint cost the train step optimizes, plus
        per-cost values when training is multi-cost.  Cost sums accumulate
        on the device and reach the host once, at the end.
        ``evaluators`` maps ``{evaluator: wire_fn}`` where ``wire_fn(outs,
        feed) -> kwargs`` for the evaluator's ``batch_stats`` (``outs``:
        {layer name: value tensor}; ``feed``: the batch on the device);
        additive evaluators accumulate on the device
        (``DeviceAccumulator``), the others per batch on the host."""
        from paddle_tpu_torch.evaluators import DeviceAccumulator

        evaluators = evaluators or {}
        params = (self.avg_params if self.avg_params is not None
                  else self.params)
        accs = {e: (DeviceAccumulator(e) if e.additive else None)
                for e in evaluators}
        for e, acc in accs.items():
            if acc is None:
                e.start()
        want = None if evaluators else self.cost_names
        totals = None
        nb = 0
        for data_batch in reader():
            feed = self._device_feed(feeder(data_batch) if feeder
                                     else data_batch)
            outs, _ = self.topology.apply(params, self.state, feed,
                                          train=False, outputs=want)
            costs = {n: outs[n].value for n in self.cost_names}
            totals = (costs if totals is None
                      else {n: totals[n] + costs[n] for n in totals})
            nb += 1
            if evaluators:
                values = {k: a.value for k, a in outs.items()}
                for e, wire in evaluators.items():
                    kw = wire(values, feed)
                    if accs[e] is not None:
                        accs[e].add(**kw)
                    else:
                        e.eval_batch(**kw)

        def ev_key(e, seen):
            # instances of one evaluator class get numbered keys
            k, i = e.name, 2
            while k in seen:
                k, i = f"{e.name}:{i}", i + 1
            return k

        if totals is None:  # empty reader: every key present, nan-filled
            result = {"cost": float("nan")}
            if len(self.cost_names) > 1:
                for n in self.cost_names:
                    result[f"cost:{n}"] = float("nan")
            for e in accs:
                result[ev_key(e, result)] = float("nan")
            return result
        vals = {n: float(totals[n]) / nb for n in self.cost_names}
        result = {"cost": sum(w * vals[n] for n, w in
                              zip(self.cost_names, self.cost_weights))}
        if len(self.cost_names) > 1:
            for n, v in vals.items():
                result[f"cost:{n}"] = v
        for e, acc in accs.items():
            result[ev_key(e, result)] = (acc.result() if acc is not None
                                         else e.result())
        return result

    @torch.no_grad()
    def infer(self, output_layers, feed: Dict[str, Any]
              ) -> Dict[str, np.ndarray]:
        """paddle.infer analog: run forward to the given layers."""
        if isinstance(output_layers, LayerOutput):
            output_layers = [output_layers]
        names = [l.name for l in output_layers]
        outs, _ = self.topology.apply(self.params, self.state,
                                      self._device_feed(feed), train=False,
                                      outputs=names)
        return {k: outs[k].value.float().cpu().numpy() for k in names}

    # ------------------------------------------------------------------

    def save(self, save_dir: str, pass_id: int,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Atomic, CRC-manifested checkpoint in the reference's format:
        params + state + optimizer state (+ averaged params), with the
        random stream in the manifest so a resumed run continues it.
        Retention (``FLAGS.keep_last_n``) prunes old passes."""
        meta = dict(meta or {})
        meta.setdefault(RNG_META_KEY,
                        bytes(self._gen.get_state().tolist()).hex())
        extra = ({"avg_params": self.avg_params}
                 if self.avg_params is not None else None)
        d = save_checkpoint(save_dir, pass_id, params=self.params,
                            state=self.state, opt_state=self.opt_state,
                            extra=extra, meta=meta)
        self._obs_counters["checkpoints"].inc()
        return d

    def load(self, save_dir: str, pass_id: int, *,
             validate: bool = True) -> Dict[str, Any]:
        """Validate and restore a checkpoint (either package's); raises
        ``CheckpointError`` on corruption.  Restores the random stream
        when the manifest carries the port's; returns the manifest."""
        extra_like = ({"avg_params": self.avg_params}
                      if self.avg_params is not None else None)
        out = load_checkpoint(save_dir, pass_id, params=self.params,
                              state=self.state, opt_state=self.opt_state,
                              extra_like=extra_like, validate=validate)
        params, self.state, self.opt_state = out[:3]
        if extra_like is not None and "avg_params" in out[3]:
            self.avg_params = out[3]["avg_params"]
        self._adopt_params(params)
        try:
            manifest = read_manifest(pass_dir(save_dir, pass_id))
        except (FileNotFoundError, ValueError):
            manifest = {}
        meta = manifest.get("meta") or {}
        if RNG_META_KEY in meta:
            self._gen.set_state(torch.tensor(
                list(bytes.fromhex(meta[RNG_META_KEY])), dtype=torch.uint8))
        elif "rng_key" in meta:
            logger.info("checkpoint pass %d carries a JAX rng_key; the "
                        "port keeps its own random stream (rng_key is not "
                        "used)", pass_id)
        self.rebuild_masks()
        return manifest
