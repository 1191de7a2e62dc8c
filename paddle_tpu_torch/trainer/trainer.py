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

A reader with the cursor protocol (``datapipe.ShardSource``) is bound per
``train()``: every checkpoint manifest records its cursor
(``meta["data_cursor"]``), computed from the count of batches stepped, and
``resume="auto"`` restores the cursor instead of re-reading the pass up to
the checkpoint (``resume_replayed_batches`` stays 0).  A plain reader keeps
that re-read-and-discard fast-forward.

``amp`` (``--amp``): the forward and backward run under the bfloat16
activation policy (``ops/numerics.py``) while the parameters, the masters,
stay float32.  The step differentiates ``scale * loss``, and the loss-scale
state lives in ``opt_state["amp"]`` (checkpointed with the slots, in the
reference's format); ``scaled_guarded_update`` unscales, skips an
overflowing step and rescales, all on the device, and the trainer reads
the step's flags once (``amp_overflows_total``, the overflow log line).
The guard is always on under ``--amp``.

``remat`` (``--remat``): the loss is computed inside
``torch.utils.checkpoint(use_reentrant=False)``, so the backward recomputes
the forward instead of holding its activations.  Every random draw of the
forward comes from generators derived from the step's seed inside the
recomputed function, so the recompute replays them; the layer state comes
from the first forward.  The recompute launches the forward kernels a
second time (K9r twice a step for an LSTM layer).

``--prefetch_depth`` > 0 wraps each pass's reader in a ``BatchPrefetcher``
after any resume fast-forward; it is closed at pass end, at a preemption
(the checkpoint counts the batches the step consumed, not the read-ahead)
and on any exception.

``mesh`` (a ``parallel.MeshConfig`` or a built ``parallel.Mesh``) runs the
step on this rank of a launched world (``parallel/distributed.py``).  Every
rank holds the full dense parameters; ``train_batch`` takes the global
batch and steps on this rank's slice of it along ``data_axis`` (its rows
must divide over the axis).  Each cost is scaled by this rank's share of
the global batch (what it averages over, its ``COST_NORM``: rows, or a
sequence cost's real tokens, over the axis's total), so one sum of the
losses and gradients over the axis is the global batch's; every rank runs
the same update (the reference's GSPMD step,
``paddle_tpu/parallel/api.py:105-116``).  A layer of batch statistics
(``batch_norm``, ``data_norm``) under a data axis of more than one rank is
refused (item 8): each rank would normalise by its slice's statistics,
where the reference uses the global batch's.  With the pserver axis in the mesh
(``--pserver_axis``, default ``model``) every ``sparse_grad`` table is
routed through the pserver tier (``pserver/tier.py``): sharded over that
axis, looked up all-to-all, pushed row-sparse; it leaves ``params`` and the
dense optimizer's state.  ``test`` and ``infer`` run the whole batch on
every rank.  Only rank 0 writes checkpoints and publishes; a checkpoint
gathers the tier's tables (every rank calls ``save``).

Not ported here, and refused with a ``ConfigError`` naming the ROADMAP.md
Queue 1 item that ports it: ``sharding_rules`` (tensor parallelism),
``pipeline`` and ``device_specs`` (item 8); a mesh with a dcn axis (the
hierarchy, item 8); batch statistics under a data axis (item 8); the
gang, the SDC firewall and ``audit`` (item 9).

``publish`` cuts a gated, versioned deploy bundle from the newest verified
checkpoint (``paddle_tpu_torch.publish``); ``train`` does so every
``--publish_every`` passes into ``--publish_dir`` and runs the checkpoint
scrubber under ``--scrub_every_s``.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.data.feeder import (BatchPrefetcher, PreparedFeed,
                                          PrepareError)
from paddle_tpu_torch.nn.graph import COST_NORM, Act, LayerOutput, Topology
from paddle_tpu_torch.param.hooks import apply_masks, build_masks
from paddle_tpu_torch.param.optimizers import (SGD, Optimizer,
                                               ParameterAverager,
                                               clip_by_global_norm, commit)
from paddle_tpu_torch.resilience.checkpoint_io import (latest_pass,
                                                       load_checkpoint,
                                                       pass_dir,
                                                       read_manifest,
                                                       save_checkpoint)
from paddle_tpu_torch.resilience.errors import ReaderError, TooManyBadSteps
from paddle_tpu_torch.resilience.guard import (guarded_update,
                                               init_loss_scale,
                                               scaled_guarded_update)
from paddle_tpu_torch.resilience.signals import PreemptionHandler
from paddle_tpu_torch.trainer import events as ev
from paddle_tpu_torch.utils.error import ConfigError, not_ported
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import logger

__all__ = ["SGDTrainer"]

#: the key prefix of the pserver tier's row gradients among the gradients
#: the bad-step guard checks
_SEG = "pserver:"

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
        for what, given in (("sharding_rules", sharding_rules is not None),
                            ("pipeline", pipeline is not None),
                            ("device_specs", device_specs is not None)):
            if given:
                raise not_ported(f"SGDTrainer({what}=)", 8)
        self.mesh = None
        if mesh is not None:
            from paddle_tpu_torch.parallel.mesh import MeshConfig, as_mesh

            cfg = getattr(mesh, "config", mesh)
            if (isinstance(cfg, MeshConfig) and cfg.dcn_axis
                    and cfg.dcn_axis in cfg.shape):
                raise not_ported("SGDTrainer(mesh=) with a dcn_axis (the "
                                 "hierarchical all-reduce)", 8)
            self.mesh = as_mesh(mesh, device)
            cfg = self.mesh.config
            if device is None:
                device = self.mesh.device
            if data_axis == "data":
                data_axis = cfg.data_axis
        self.data_axis = data_axis
        #: the ranks of the data axis, each stepping its rows of the batch
        self.n_data = (self.mesh.axis_size(data_axis)
                       if self.mesh is not None else 1)
        if amp is not None and bool(amp) != bool(FLAGS.amp):
            # the bfloat16 dtype policy (ops/numerics) reads FLAGS.amp at
            # call time; a constructor override that disagrees would run
            # loss scaling without bfloat16 or bfloat16 without the
            # overflow machinery, so it is refused
            raise ValueError(
                f"SGDTrainer(amp={amp!r}) disagrees with FLAGS.amp="
                f"{FLAGS.amp!r}: the compute dtype policy is flag-driven, "
                f"set FLAGS.amp (or --amp) to toggle mixed precision")
        self.amp = bool(FLAGS.amp if amp is None else amp)
        self.remat = bool(FLAGS.remat if remat is None else remat)
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
        stats = [l.name for l in self.topology.layers
                 if l.layer_type in ("batch_norm", "data_norm")]
        if self.n_data > 1 and stats:
            # each rank would normalise by its slice's statistics, where
            # the reference's global-batch step uses the whole batch's
            raise not_ported(
                f"SGDTrainer(mesh=) with a data axis of {self.n_data} ranks "
                f"over the batch statistics of {stats} (synchronised batch "
                f"statistics)", 8)
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
        # the pserver tier: with the pserver axis in the mesh, every
        # sparse_grad table leaves the dense params and lives sharded
        self.pserver = None
        routed: set = set()
        if self.mesh is not None and self.sparse_rows:
            ps_axis = self.mesh.config.role_axis("pserver")
            if ps_axis in self.mesh.axis_names:
                from paddle_tpu_torch.pserver import PServerTier

                tier = PServerTier(self.mesh, self.topology, self.optimizer,
                                   axis=ps_axis, lr_scales=self.lr_scales,
                                   decays=self.decays, seed=seed,
                                   data_axis=self.data_axis)
                if tier.active:
                    self.pserver = tier
                    routed = tier.param_names()
                    for name in routed:
                        self.sparse_rows.pop(name, None)
                        self.lr_scales.pop(name, None)
                        self.decays.pop(name, None)
        params, self.state = self.topology.init(seed, skip=routed)
        # the stream each batch's apply seed is drawn from (checkpointed)
        self._gen = torch.Generator().manual_seed(seed)
        # StaticPruningHook analog: masks fixed from the initial magnitudes,
        # multiplied in after every update
        self.masks = build_masks(params, self.pruning_ratios)
        self._adopt_params(apply_masks(params, self.masks))
        self.fused_apply = bool(FLAGS.fused_apply)
        self.opt_state = self.optimizer.init_state(self.params)
        self.amp_overflows_total = 0
        if self.amp:
            self.opt_state["amp"] = init_loss_scale(FLAGS.loss_scale,
                                                    device=self.device)
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
        # the checkpointable data source of the running train() (its
        # cursor rides each manifest) and a loaded manifest's cursor
        # waiting for it
        self._data_source = None
        self._pending_cursor = None
        #: the running pass's BatchPrefetcher (``--prefetch_depth``)
        self._prefetcher: Optional[BatchPrefetcher] = None
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
            "publishes": reg.counter("train_publishes_total",
                                     "gated deploy bundles published"),
        }

    # ------------------------------------------------------------------

    def _adopt_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Make ``params`` the trainer's: leaves that require grad, so
        every step's ``torch.autograd.grad`` runs on the same tensors."""
        self.params = {k: v.detach().requires_grad_()
                       for k, v in params.items()}

    def _device_feed(self, feed: Dict[str, Any], *,
                     pinned: bool = False) -> Dict[str, Any]:
        """The prepared (numpy) feed on the trainer's device, moved once;
        values are converted as ``Topology.apply`` would convert them.
        ``pinned`` (the prefetcher's copy on the card): each host array is
        pinned and copied asynchronously on the current stream (the
        prefetcher's side stream)."""
        dev = self.device

        def put(v):
            if isinstance(v, tuple):
                return tuple(put(x) for x in v)
            if isinstance(v, (np.ndarray, list, int, float, np.generic)):
                v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
            elif not torch.is_tensor(v):
                return v
            if pinned and v.device.type == "cpu":
                return v.pin_memory().to(dev, non_blocking=True)
            return v.to(dev)

        return {k: put(v) for k, v in feed.items()}

    def _overrides(self):
        """The routed tables' stand-ins for a forward without gradients."""
        return (self.pserver.make_overrides({}) if self.pserver is not None
                else None)

    @property
    def _writer(self) -> bool:
        """Whether this rank writes checkpoints and publishes (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _total_cost(self, values: Sequence[torch.Tensor]) -> torch.Tensor:
        """The costs' weighted sum: the loss."""
        if len(values) == 1 and self.cost_weights[0] == 1.0:
            return values[0]
        return sum(w * v for v, w in zip(values, self.cost_weights))

    def _shares(self, costs: Sequence[Act]) -> List[torch.Tensor]:
        """This rank's share of the global batch for each cost
        (``loss_shares`` of its ``COST_NORM``).  Each cost scaled by its
        share, the ranks' losses and gradients sum to the global
        batch's."""
        from paddle_tpu_torch.parallel.api import loss_shares

        for name, c in zip(self.cost_names, costs):
            if COST_NORM not in c.state:
                raise ConfigError(
                    f"cost layer {name!r} does not report what its value "
                    f"averages over (Act.state[{COST_NORM!r}]), so the "
                    f"{self.n_data} ranks of the data axis cannot weight "
                    f"it to the global batch's cost")
        return loss_shares(self.mesh, [c.state[COST_NORM] for c in costs],
                           self.data_axis)

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
                pass_id: Optional[int] = None) -> Optional[str]:
        """Export a gated deploy bundle into the versioned publish dir
        (``paddle_tpu_torch.publish``) from the newest VERIFIED checkpoint
        under ``save_dir`` — the train side of the continuous
        train->publish->reload loop; its warm step runs on the trainer's
        device.  A gate refusal (no verified pass, quarantined pass,
        corrupt checkpoint, quantize error budget) is journaled as
        ``publish_refused`` and returns None; it never fails training."""
        from paddle_tpu_torch.publish import (PublishRefused,
                                              publish_from_checkpoints)

        try:
            vdir = publish_from_checkpoints(
                publish_dir, self.topology, save_dir, pass_id=pass_id,
                quantize=FLAGS.deploy_quantize or None, device=self.device)
        except PublishRefused as e:
            logger.warning("publish refused (%s): %s", e.reason, e)
            return None
        self._obs_counters["publishes"].inc()
        return vdir

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
        ``TooManyBadSteps``.  Under ``--amp`` an overflow of the scaled
        gradients also skips the step and halves the loss scale
        (``_last_extras['amp_overflow']``, ``amp_overflows_total``); only a
        non-finite loss counts as a bad step."""
        feed = self._device_feed(feed)
        if self.mesh is not None:
            from paddle_tpu_torch.parallel.api import shard_batch

            feed = shard_batch(self.mesh, feed, self.data_axis)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))
        if self.n_data > 1:
            # each slice of the batch draws its own dropout masks and
            # noise, as rows of one global draw would
            seed = (seed + 0x9E3779B97F4A7C15
                    * self.mesh.axis_index(self.data_axis)) % 2 ** 62
        params = self.params
        amp_state = self.opt_state["amp"] if self.amp else None
        tier = self.pserver
        proxies = tier.make_proxies(feed) if tier is not None else {}
        overrides = (tier.make_overrides(proxies) if tier is not None
                     else None)

        def forward():
            outs, new_state = self.topology.apply(
                params, self.state, feed, train=True, rng=seed,
                param_overrides=overrides)
            extras = {k: outs[k].value for k in self.extra_names}
            return [outs[n] for n in self.cost_names], new_state, extras

        with torch.enable_grad():
            if self.remat:
                from torch.utils.checkpoint import (checkpoint,
                                                    set_checkpoint_early_stop)

                # the forward's draws come from generators seeded inside
                # it, so the recompute replays them without the default
                # generators' state.  The recompute runs to its end: its
                # early stop is an exception, which the layers' error
                # scopes would wrap
                with set_checkpoint_early_stop(False):
                    costs, new_state, extras = checkpoint(
                        forward, use_reentrant=False,
                        preserve_rng_state=False)
            else:
                costs, new_state, extras = forward()
            values = [c.value for c in costs]
            if self.n_data > 1:
                values = [v * sh.to(v.dtype)
                          for v, sh in zip(values, self._shares(costs))]
            loss = self._total_cost(values)
            # dynamic loss scaling: the differentiated value is scale * loss
            # so bfloat16 gradients use the representable range; the
            # reported loss stays unscaled
            target = loss * amp_state["scale"] if self.amp else loss
            wrt = list(params.values()) + list(proxies.values())
            all_grads = torch.autograd.grad(target, wrt, allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(params.items(), all_grads)}
        px_grads = {k: (torch.zeros_like(p) if g is None else g)
                    for (k, p), g in zip(proxies.items(),
                                         all_grads[len(params):])}
        extras = {k: v.detach() for k, v in extras.items()}
        loss = loss.detach()
        if self.n_data > 1:
            from paddle_tpu_torch.parallel.api import reduce_loss_and_grads

            loss = reduce_loss_and_grads(self.mesh, loss, grads,
                                         self.data_axis)
        segments = (tier.segments(feed, px_grads) if tier is not None
                    else {})
        opt_core = {k: v for k, v in self.opt_state.items() if k != "amp"}
        if segments:
            # the guard's finite check and the amp unscale see the row
            # gradients too
            grads = {**grads, **{_SEG + k: g
                                 for k, (_, g) in segments.items()}}

        @torch.no_grad()
        def do_update(g: Dict[str, torch.Tensor],
                      where: Optional[torch.Tensor]) -> None:
            dense = {k: g[k] for k in params}
            segs = {k: (ids, g[_SEG + k]) for k, (ids, _) in
                    segments.items()}
            clip = True
            thr = self.optimizer.gradient_clipping_threshold
            if segs and thr > 0:
                # clipping parity with one process: the norm includes the
                # tables' deduped row gradients, and one scale hits both
                dense, gnorm = clip_by_global_norm(
                    dense, thr, extra_sq=tier.grad_norm_sq(segs))
                scale = torch.clamp(thr / torch.clamp(gnorm, min=1e-12),
                                    max=1.0)
                segs = {k: (ids, sg * scale)
                        for k, (ids, sg) in segs.items()}
                clip = False
            new_p, new_o = self.optimizer.new_values(
                params, dense, opt_core, lr_scales=self.lr_scales,
                decays=self.decays, statics=self.statics,
                sparse_rows=self.sparse_rows, clip=clip,
                fused=self.fused_apply)
            commit(params, opt_core, apply_masks(new_p, self.masks), new_o,
                   where)
            if segs:
                tier.apply_grads(segs, where)

        if self.amp:
            # loss scaling needs the skip machinery, so the guard is always
            # on under --amp; the scale advances on a skip too
            new_state, new_amp, gextras = scaled_guarded_update(
                do_update, loss=loss, scaled_grads=grads,
                amp_state=amp_state, new_state=new_state,
                old_state=self.state,
                growth_interval=int(FLAGS.loss_scale_growth),
                max_scale=float(FLAGS.loss_scale_max))
            with torch.no_grad():
                for k, v in new_amp.items():
                    amp_state[k].copy_(v)
            extras.update(gextras)
        elif self.guard_nonfinite:
            new_state, gextras = guarded_update(
                lambda where: do_update(grads, where), loss=loss,
                grads=grads, new_state=new_state, old_state=self.state)
            extras.update(gextras)
        else:
            do_update(grads, None)
        self.state = new_state
        if self.averager is not None:
            self.avg_params = self.averager.update(self.avg_params, params)
        self._obs_counters["batches"].inc()
        self._last_extras = extras
        if self.amp or self.guard_nonfinite:
            # the one host read of the step, after all of it is queued
            flags = [extras["bad_step"].float()]
            if self.amp:
                flags += [extras["amp_overflow"].float(),
                          extras["loss_scale"].float()]
            flags = torch.stack(flags).tolist()
            if self.amp and flags[1]:
                self.amp_overflows_total += 1
                logger.warning(
                    "amp: non-finite scaled gradients — step skipped, "
                    "loss scale halved to %g (overflow %d)", flags[2],
                    self.amp_overflows_total)
            if flags[0]:
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
          recorded: a checkpointable source restores its cursor, a plain
          reader is re-read and fast-forwarded;
        - SIGTERM/SIGINT (or a ``preemption`` handler's ``request()``)
          writes an atomic checkpoint at the next batch boundary and
          returns (``self.preempted`` is set);
        - a reader exception mid-pass emits ``EndPass`` and re-raises as
          ``ReaderError``, attributed to the data tier.

        ``log_period``, ``test_period`` (mid-pass evaluation),
        ``saving_period``, ``keep_last_n`` and
        ``show_parameter_stats_period`` come from ``FLAGS``.

        Continuous delivery, from ``FLAGS`` too: ``--scrub_every_s`` runs a
        background ``ScrubDaemon`` over ``--save_dir`` (it also scrubs each
        end-of-pass checkpoint at once, so the pass is verified before a
        publish reads it), and ``--publish_dir`` with ``--publish_every=N``
        publishes a gated bundle every N passes (``publish``)."""
        handler = event_handler or (lambda e: None)
        log_period = FLAGS.log_period
        resume = resume or FLAGS.resume or None
        if resume is not None and resume != "auto":
            raise ValueError(f"resume must be None or 'auto', got {resume!r}")
        from paddle_tpu_torch.datapipe import is_checkpointable_source

        src = reader if is_checkpointable_source(reader) else None
        self._data_source = src
        self._pending_cursor = None
        start_pass, start_batch = FLAGS.start_pass, 0
        if resume == "auto":
            start_pass, start_batch = self._auto_resume()
        cursor_restored = False
        if src is not None and self._pending_cursor is not None:
            # point the source at the saved cursor: nothing is re-read
            src.restore(self._pending_cursor)
            cursor_restored = True
            self._pending_cursor = None
        if (preemption is None and FLAGS.save_dir
                and FLAGS.checkpoint_on_preemption):
            preemption = PreemptionHandler()
        self.preempted = False
        if preemption is not None:
            preemption.install()
        scrubber = None
        if FLAGS.scrub_every_s > 0 and FLAGS.save_dir and self._writer:
            from paddle_tpu_torch.resilience.integrity import ScrubDaemon

            scrubber = ScrubDaemon(FLAGS.save_dir,
                                   every_s=FLAGS.scrub_every_s).start()
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
                    if src is not None:
                        src.seek(pass_id)
                    it = iter(reader())
                except Exception as e:
                    raise _reader_failed(e) from e
                self._prefetcher = None
                skip = start_batch if pass_id == start_pass else 0
                batch_id = 0
                if skip and cursor_restored:
                    # the restored cursor already points at this batch:
                    # the numbering continues, nothing is re-read
                    batch_id, skip = skip, 0
                    logger.info("resuming pass %d at batch %d from the "
                                "data cursor (no replay)", pass_id,
                                batch_id)
                elif skip:
                    logger.info("resuming pass %d at batch %d "
                                "(fast-forward)", pass_id, skip)

                def _wrap_prefetch():
                    # --prefetch_depth: prepare + host-to-device copy of the
                    # next batches overlap the step of this one.  Built
                    # after the resume fast-forward (the skipped batches
                    # are consumed raw) and closed at every loop exit
                    nonlocal it
                    if FLAGS.prefetch_depth > 0:
                        copy = (functools.partial(self._device_feed,
                                                  pinned=True)
                                if self.device.type == "cuda" else None)
                        it = self._prefetcher = BatchPrefetcher(
                            it, prepare=feeder, transfer=copy,
                            depth=FLAGS.prefetch_depth, device=self.device)

                if not skip:
                    _wrap_prefetch()
                while True:
                    if preemption is not None and preemption.poll():
                        # the read-ahead is abandoned here: the checkpoint
                        # records the batches the step consumed
                        self._close_prefetcher()
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
                        if not skip:
                            _wrap_prefetch()
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
                    if src is not None:
                        # corrupt records the source skipped and counted
                        self._last_extras = {
                            **self._last_extras,
                            "dropped_records":
                                int(getattr(src, "dropped_records", 0))}
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
                self._close_prefetcher()
                result = {}
                if test_reader is not None:
                    result = self.test(test_reader, feeder=feeder)
                handler(ev.EndPass(pass_id, evaluator=result))
                if FLAGS.save_dir and FLAGS.saving_period and (
                        (pass_id + 1) % FLAGS.saving_period == 0):
                    self.save(FLAGS.save_dir, pass_id)
                    if scrubber is not None:
                        scrubber.scrub_now()
                if (FLAGS.publish_dir and FLAGS.publish_every
                        and FLAGS.save_dir and self._writer
                        and (pass_id + 1) % FLAGS.publish_every == 0):
                    # from the newest VERIFIED checkpoint bytes, never from
                    # live memory; a refusal is journaled, never fatal
                    self.publish(FLAGS.publish_dir, FLAGS.save_dir)
        finally:
            self._close_prefetcher()  # exception paths: join the producer
            if scrubber is not None:
                scrubber.stop()
            if preemption is not None:
                preemption.uninstall()

    def _close_prefetcher(self) -> None:
        """Stop and join the running pass's prefetcher (no-op when
        ``--prefetch_depth`` is off or it is already closed)."""
        pf, self._prefetcher = self._prefetcher, None
        if pf is not None:
            pf.close()

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
                                          train=False, outputs=want,
                                          param_overrides=self._overrides())
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
                                      outputs=names,
                                      param_overrides=self._overrides())
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
        src = self._data_source
        if src is not None and "data_cursor" not in meta:
            # the source's cursor from the count of batches stepped (never
            # from what was read ahead): a mid-pass checkpoint records
            # (pass, next_batch), an end-of-pass one the next pass's start
            try:
                if meta.get("preempted"):
                    cur = src.cursor_for(pass_id,
                                         int(meta.get("next_batch", 0)))
                else:
                    cur = src.cursor_for(pass_id + 1, 0)
                meta["data_cursor"] = cur
            except Exception as e:  # noqa: BLE001 — never fail a save
                logger.warning("data cursor not recorded: %s", e)
        extra = ({"avg_params": self.avg_params}
                 if self.avg_params is not None else {})
        if self.pserver is not None:
            # a collective: every rank gathers, rank 0 writes
            extra["pserver"] = self.pserver.full_state()
        if self.mesh is not None:
            meta.setdefault("mesh", self.mesh.config.to_json())
        if not self._writer:
            return pass_dir(save_dir, pass_id)
        d = save_checkpoint(save_dir, pass_id, params=self.params,
                            state=self.state, opt_state=self.opt_state,
                            extra=extra or None, meta=meta)
        self._obs_counters["checkpoints"].inc()
        return d

    def load(self, save_dir: str, pass_id: int, *,
             validate: bool = True) -> Dict[str, Any]:
        """Validate and restore a checkpoint (either package's); raises
        ``CheckpointError`` on corruption.  Restores the random stream
        when the manifest carries the port's; returns the manifest."""
        extra_like = ({"avg_params": self.avg_params}
                      if self.avg_params is not None else {})
        if self.pserver is not None:
            extra_like["pserver"] = self.pserver.state()
        out = load_checkpoint(save_dir, pass_id, params=self.params,
                              state=self.state, opt_state=self.opt_state,
                              extra_like=extra_like or None,
                              validate=validate)
        params, self.state, self.opt_state = out[:3]
        if extra_like and "avg_params" in out[3]:
            self.avg_params = out[3]["avg_params"]
        if self.pserver is not None:
            self.pserver.adopt(out[3]["pserver"])
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
        # the data source's cursor, for train() to restore in place of a
        # fast-forward
        self._pending_cursor = meta.get("data_cursor")
        self.rebuild_masks()
        return manifest
