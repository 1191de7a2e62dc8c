"""Optimizers — counterpart of ``paddle_tpu/param/optimizers.py``.

The reference's optimizer tier: SGD, Momentum, AdaGrad, AdaDelta, RMSProp,
DecayedAdaGrad, Adam and AdaMax (paddle/parameter/FirstOrderOptimizer.h),
global-norm and value clipping, L2/L1 decay applied to the gradient
(Regularizer.h), the learning-rate schedules (LearningRateScheduler.cpp)
and parameter averaging (AverageOptimizer.cpp).  Per-parameter learning
rate scales, decays and static flags come from the ``Topology``'s
ParamSpecs (``SGDTrainer`` reads them), as the reference's
ParameterConfig fields.

State has the reference's shape, ``{"step": int32 scalar tensor, "slots":
{name: per-parameter slots}}``, each rule's slots as the reference's
(``()`` for SGD, one tensor for Momentum, a tuple for Adam), so a
checkpoint of either package loads in the other.

Two halves:

- ``new_values(params, grads, opt_state, ...)`` is functional, the
  reference's ``update``: it returns new parameter and state dicts and
  leaves its inputs alone.  The schedule is evaluated with tensor ops on
  the device step counter, so no schedule forces a host sync.
- ``update(...)`` runs ``new_values`` and writes the results back IN
  PLACE into the caller's tensors (``commit``), under ``torch.no_grad()``;
  the returned dicts are the caller's.  Parameters that require grad stay
  leaves that require grad.  ``where=`` (a bool scalar tensor on the
  device) keeps every value, the step counter included, bit for bit where
  it is False: the bad-step guard's selection, decided on the device.

``fused=True`` (the reference's fused multi-tensor apply) runs the same
per-leaf loop: the reference's fused apply gives the per-leaf values
elementwise.  A fused kernel is a redesign for a later PR.

``sparse_rows`` marks row-sparse parameters (``sparse_grad`` tables): a
row whose gradient is all zero keeps its value and every slot of the
parameter's shape, while the step counter still advances for all.  ``True``
takes the masked path over the whole table; an int ``K`` gathers up to K
touched rows, updates them (``row_apply``) and scatters them back, and a
batch that touches more than K rows takes the masked path instead.

The pserver's push (``pserver/apply.py``) applies (ids, row-gradient)
segments with ``sparse_apply_rows``: ``dedup_rows`` sums duplicate ids in
stable id order, and ``row_apply(oob_drop=True)`` updates the unique live
rows and drops the out-of-range ones (all-to-all padding sentinels).
``inplace=True`` writes only the touched rows of the table and its slots,
so the push never allocates a table-sized temporary.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from paddle_tpu_torch.utils.registry import Registry

__all__ = ["Optimizer", "SGD", "Momentum", "AdaGrad", "AdaDelta", "RMSProp",
           "DecayedAdaGrad", "Adam", "AdaMax", "OPTIMIZERS", "LR_SCHEDULES",
           "lr_schedule", "clip_by_global_norm", "clip_by_value",
           "ParameterAverager", "commit", "slot_leaves", "dedup_rows"]

Params = Dict[str, torch.Tensor]

OPTIMIZERS: Registry = Registry("optimizer")
LR_SCHEDULES: Registry = Registry("lr_schedule")


# ---------------------------------------------------------------------------
# learning-rate schedules: Python floats in, tensor ops on the step counter
# ---------------------------------------------------------------------------


@LR_SCHEDULES.register("constant")
def _const(base, step, **kw):
    return base


@LR_SCHEDULES.register("poly")
def _poly(base, step, *, decay_a=1e-4, decay_b=0.75, **kw):
    # base * (1 + a*step)^(-b) — the reference's default 'poly' schedule
    return base * torch.pow(1.0 + decay_a * step, -decay_b)


@LR_SCHEDULES.register("exp")
def _exp(base, step, *, decay_a=0.99, decay_b=1000.0, **kw):
    return base * torch.pow(decay_a, step / decay_b)


@LR_SCHEDULES.register("discexp")
def _discexp(base, step, *, decay_a=0.99, decay_b=1000.0, **kw):
    return base * torch.pow(decay_a, torch.floor(step / decay_b))


@LR_SCHEDULES.register("linear")
def _linear(base, step, *, decay_a=1e-6, decay_b=1e-4, **kw):
    return torch.clamp(base - decay_a * step, min=decay_b)


@LR_SCHEDULES.register("warmup_cosine")
def _warmup_cosine(base, step, *, warmup_steps=1000, total_steps=100000,
                   **kw):
    # not in the reference's C++ (the JAX package's addition): linear
    # warmup, then cosine decay
    warm = base * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0, 1)
    cos = base * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def lr_schedule(name: str, base: float, **kwargs) -> Callable:
    fn = LR_SCHEDULES.get(name)
    return lambda step: fn(base, step, **kwargs)


# ---------------------------------------------------------------------------
# clipping and decay
# ---------------------------------------------------------------------------


def clip_by_value(grads: Mapping[str, torch.Tensor], threshold: float
                  ) -> Dict[str, torch.Tensor]:
    return {k: torch.clamp(g, -threshold, threshold)
            for k, g in grads.items()}


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float,
                        extra_sq=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global L2 norm) -> (new
    grads, the norm).  Squares are summed leaf by leaf in sorted-name order
    (the reference's leaf order).  ``extra_sq`` joins more sum-of-squares
    mass into the norm without being scaled here: the pserver tier's
    deduped row gradients, which the trainer scales by the same factor."""
    names = sorted(grads)
    sq = [grads[k].float().square().sum() for k in names]
    if extra_sq is not None:
        sq.append(extra_sq)
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    gnorm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: grads[k] * scale for k in grads}, gnorm


def _regularize(p: torch.Tensor, g: torch.Tensor, decay: float,
                l1: float) -> torch.Tensor:
    """L2 ``decay`` and L1 ``l1`` added to the gradient (the reference's
    Regularizer analog)."""
    if decay:
        g = g + decay * p
    if l1:
        g = g + l1 * torch.sign(p)
    return g


def dedup_rows(ids: torch.Tensor, row_grads: torch.Tensor, *,
               sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable-sorted segment sum of duplicate row ids -> ``(uids [N] int64,
    ug [N, ...])``: the unique ids packed to the front (``sentinel`` in the
    unused places) with their summed gradients beside them (zeros
    elsewhere).  The sum runs in stable id order, the dense path's sorted
    scatter-add order; the sparse apply and the clip norm's row mass share
    it."""
    n = ids.shape[0]
    ids = ids.to(torch.long)
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    sg = row_grads[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    if n > 1:
        first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first.to(torch.long), 0) - 1
    uids = torch.full((n,), sentinel, dtype=torch.long, device=ids.device)
    uids[seg] = sids
    ug = torch.zeros((n,) + tuple(row_grads.shape[1:]),
                     dtype=row_grads.dtype, device=row_grads.device)
    ug.index_add_(0, seg, sg)
    return uids, ug


def slot_leaves(slots) -> List[torch.Tensor]:
    """A parameter's slots as a flat list: ``()``, one tensor or a
    tuple."""
    if torch.is_tensor(slots):
        return [slots]
    return list(slots)


def _map_slots(fn, slots, *rest):
    """``fn`` over a parameter's slots (and the same leaves of ``rest``),
    keeping their structure: ``()``, one tensor or a tuple."""
    if torch.is_tensor(slots):
        return fn(slots, *rest)
    return tuple(fn(*leaves) for leaves in zip(slots, *rest))


@torch.no_grad()
def commit(params: Params, opt_state: Dict[str, Any], new_params: Params,
           new_opt: Dict[str, Any],
           where: Optional[torch.Tensor] = None) -> None:
    """Write ``new_values``' results into the caller's tensors in place.
    With ``where`` (a bool scalar tensor), each tensor takes its new value
    only where it is True and keeps its bits otherwise, the step counter
    included; the choice stays on the device."""

    def put(old: torch.Tensor, new: torch.Tensor) -> None:
        if new is old:
            return
        old.copy_(new if where is None else torch.where(where, new, old))

    for k, p in params.items():
        put(p, new_params[k])
        for old, new in zip(slot_leaves(opt_state["slots"][k]),
                            slot_leaves(new_opt["slots"][k])):
            put(old, new)
    put(opt_state["step"], new_opt["step"])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@dataclass
class Optimizer:
    """Base: learning-rate schedule, clipping and weight decay.
    Subclasses give the per-parameter rule (``init_leaf``,
    ``update_leaf``)."""

    learning_rate: float = 0.01
    learning_rate_schedule: str = "constant"
    schedule_args: Dict[str, Any] = field(default_factory=dict)
    gradient_clipping_threshold: float = 0.0   # 0 = off; global-norm clip
    l2_rate: float = 0.0
    l1_rate: float = 0.0

    def lr_at(self, step: torch.Tensor):
        """The learning rate at ``step`` (the device counter): the base
        rate as a Python float for the constant schedule, else a float32
        scalar tensor on the counter's device."""
        fn = LR_SCHEDULES.get(self.learning_rate_schedule)
        return fn(self.learning_rate, step, **self.schedule_args)

    def init_leaf(self, p: torch.Tensor):
        return ()

    def update_leaf(self, p: torch.Tensor, g: torch.Tensor, slots, lr,
                    step: torch.Tensor):
        """-> (new parameter, new slots) for one parameter."""
        raise NotImplementedError

    def init_state(self, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Any]:
        step_dev = next(iter(params.values())).device if params else None
        return {"step": torch.zeros((), dtype=torch.int32, device=step_dev),
                "slots": {k: self.init_leaf(p) for k, p in params.items()}}

    @torch.no_grad()
    def new_values(self, params: Params, grads: Mapping[str, torch.Tensor],
                   opt_state: Dict[str, Any], *,
                   lr_scales: Optional[Dict[str, float]] = None,
                   decays: Optional[Dict[str, float]] = None,
                   statics: Optional[Dict[str, bool]] = None,
                   sparse_rows: Optional[Dict[str, Any]] = None,
                   clip: bool = True, fused: Optional[bool] = None
                   ) -> Tuple[Params, Dict[str, Any]]:
        """One step, functional (the reference's ``update``): global-norm
        clipping when set and ``clip`` (False: the caller clipped), L2/L1
        decay, then the rule for every parameter that is not static.
        ``fused`` is accepted and runs the per-leaf loop.

        ``sparse_rows`` maps a parameter of two or more dims to ``True``
        (the masked row update) or an int ``K`` (the gather-update-scatter
        of up to K touched rows, the masked update when more are touched;
        deciding which reads the touched count back to the host).  A row is
        touched where any entry of its gradient is non-zero."""
        step = opt_state["step"] + 1
        lr = self.lr_at(step)
        if self.gradient_clipping_threshold > 0 and clip:
            grads, _ = clip_by_global_norm(grads,
                                           self.gradient_clipping_threshold)
        new_params, new_slots = {}, {}
        for k, p in params.items():
            old_slots = opt_state["slots"][k]
            if statics and statics.get(k):
                new_params[k], new_slots[k] = p, old_slots
                continue
            decay = (decays.get(k, 0.0) if decays else 0.0) + self.l2_rate
            scale = lr_scales.get(k, 1.0) if lr_scales else 1.0
            g = grads[k]
            kind = sparse_rows.get(k) if sparse_rows else None
            if kind and p.dim() >= 2:
                touched = (g != 0).flatten(1).any(dim=1)
                if (kind is not True and 0 < kind < p.shape[0]
                        and int(touched.sum()) <= kind):
                    # top-k of the touched flags: distinct rows, the
                    # touched ones first; the rest stay as they are
                    live, rows = torch.topk(touched.to(torch.float32), kind)
                    new_params[k], new_slots[k] = self.row_apply(
                        p, rows, g[rows], old_slots, live > 0, lr * scale,
                        step, decay=decay)
                else:
                    new_params[k], new_slots[k] = self._masked_update(
                        p, g, old_slots, touched, lr * scale, step, decay)
                continue
            p2, s2 = self.update_leaf(
                p, _regularize(p, g, decay, self.l1_rate), old_slots,
                lr * scale, step)
            new_params[k] = p2.to(p.dtype)
            new_slots[k] = s2
        return new_params, {"step": step, "slots": new_slots}

    def _masked_update(self, p, g, old_slots, touched, lr_eff, step, decay):
        """The whole parameter updated, then every untouched row of it and
        of each slot of its shape put back: ``sparse_rows=True``, and the
        ``K`` path's overflow."""
        p2, s2 = self.update_leaf(p, _regularize(p, g, decay, self.l1_rate),
                                  old_slots, lr_eff, step)

        def sel(new, old):
            if new.shape != p.shape:
                return new
            row = touched.reshape((-1,) + (1,) * (p.dim() - 1))
            return torch.where(row, new, old)

        return sel(p2, p).to(p.dtype), _map_slots(sel, s2, old_slots)

    @torch.no_grad()
    def update(self, params: Params, grads: Mapping[str, torch.Tensor],
               opt_state: Dict[str, Any], *,
               where: Optional[torch.Tensor] = None, **kw
               ) -> Tuple[Params, Dict[str, Any]]:
        """One step, in place: ``new_values`` (``**kw`` are its options),
        then ``commit``.  The step counter, the parameters and the slots
        all advance in place (where ``where`` allows), so a caller may drop
        the returned pair (it holds the same ``params`` and
        ``opt_state``)."""
        new_p, new_o = self.new_values(params, grads, opt_state, **kw)
        commit(params, opt_state, new_p, new_o, where)
        return params, opt_state

    def row_apply(self, p, rows, g_rows, old_slots, live, lr_eff, step, *,
                  decay: float = 0.0, oob_drop: bool = False):
        """The gather-update-scatter row update: ``rows`` (distinct among
        the ``live`` entries) of ``p`` and of each slot of its shape are
        gathered, updated with the gathered gradients ``g_rows`` and
        scattered back; an entry with ``live`` False keeps its value and
        slots.  ``oob_drop=True`` also drops entries whose row is out of
        range (the sparse apply parks its dead entries past the end); they
        gather zeros and write nothing.  -> (new parameter, new slots),
        functional."""
        if oob_drop:
            keep = (rows >= 0) & (rows < p.shape[0])
            rows = torch.where(keep, rows, torch.zeros_like(rows))
            live = live & keep
            # only live rows are written: a dead entry parked on row 0
            # must not overwrite a live update of that row
            idx = torch.nonzero(live).reshape(-1)
            return self.row_apply(p, rows[idx], g_rows[idx], old_slots,
                                  live[idx], lr_eff, step, decay=decay)
        live_col = live.reshape((-1,) + (1,) * (p.dim() - 1))
        p_r = p[rows]
        g_r = _regularize(p_r, g_rows, decay, self.l1_rate)
        s_r = _map_slots(lambda s: s[rows] if s.shape == p.shape else s,
                         old_slots)
        p2_r, s2_r = self.update_leaf(p_r, g_r, s_r, lr_eff, step)
        p2_r = torch.where(live_col, p2_r, p_r)

        def put(old, new):
            if old.shape != p.shape:
                return new
            return old.index_copy(0, rows,
                                  torch.where(live_col, new, old[rows]))

        return (p.index_copy(0, rows, p2_r.to(p.dtype)),
                _map_slots(put, old_slots, s2_r))

    @torch.no_grad()
    def sparse_apply_rows(self, p, ids, row_grads, old_slots, *, lr_eff,
                          step, decay: float = 0.0, inplace: bool = False,
                          where: Optional[torch.Tensor] = None):
        """Row-sparse apply from (ids, row-gradient) segments, the
        pserver's push.  Duplicates are summed in stable id order
        (``dedup_rows``), the dense masked path's (``sparse_rows=True``)
        accumulation order; ids ``>= p.shape[0]`` (padding sentinels) and
        all-zero segments are dropped: those rows and their slots do not
        advance.  -> (new parameter, new slots).

        ``inplace=True`` writes the touched rows of ``p`` and of its slots
        in place and nothing else (no table-sized temporary); ``where``
        (a bool scalar tensor) then keeps every bit where it is False, the
        bad-step guard's selection on the device."""
        v = p.shape[0]
        uids, ug = dedup_rows(ids, row_grads, sentinel=v)
        live = (uids < v) & (ug != 0).flatten(1).any(dim=1)
        if not inplace:
            return self.row_apply(p, uids, ug, old_slots, live, lr_eff, step,
                                  decay=decay, oob_drop=True)
        idx = torch.nonzero(live).reshape(-1)
        rows, g = uids[idx], ug[idx]
        p_r = p[rows]
        s_r = _map_slots(lambda s: s[rows] if s.shape == p.shape else s,
                         old_slots)
        p2_r, s2_r = self.update_leaf(
            p_r, _regularize(p_r, g, decay, self.l1_rate), s_r, lr_eff,
            step)

        def put(old, new_r, old_r):
            if old.shape != p.shape:
                return
            if where is not None:
                new_r = torch.where(where, new_r.to(old.dtype), old_r)
            old.index_copy_(0, rows, new_r.to(old.dtype))

        put(p, p2_r, p_r)
        for old, new_r, old_r in zip(slot_leaves(old_slots),
                                     slot_leaves(s2_r), slot_leaves(s_r)):
            put(old, new_r, old_r)
        return p, old_slots


@OPTIMIZERS.register("sgd")
@dataclass
class SGD(Optimizer):
    """Plain SGD (SgdOptimizer, FirstOrderOptimizer.h:23)."""

    def update_leaf(self, p, g, s, lr, step):
        return p - lr * g, s


@OPTIMIZERS.register("momentum")
@dataclass
class Momentum(Optimizer):
    """Heavy-ball momentum (the reference folds momentum into SGD via
    ParameterConfig::momentum)."""

    momentum: float = 0.9
    use_nesterov: bool = False

    def init_leaf(self, p):
        return torch.zeros_like(p)

    def update_leaf(self, p, g, v, lr, step):
        v2 = self.momentum * v - lr * g
        if self.use_nesterov:
            return p + self.momentum * v2 - lr * g, v2
        return p + v2, v2


@OPTIMIZERS.register("adagrad")
@dataclass
class AdaGrad(Optimizer):
    """AdaGrad (AdagradParameterOptimizer, FirstOrderOptimizer.h:100)."""

    epsilon: float = 1e-6

    def init_leaf(self, p):
        return torch.zeros_like(p)

    def update_leaf(self, p, g, acc, lr, step):
        acc2 = acc + g.square()
        return p - lr * g / (torch.sqrt(acc2) + self.epsilon), acc2


@OPTIMIZERS.register("adadelta")
@dataclass
class AdaDelta(Optimizer):
    """AdaDelta (AdaDeltaParameterOptimizer, FirstOrderOptimizer.h:130)."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_leaf(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))  # E[g^2], E[dx^2]

    def update_leaf(self, p, g, s, lr, step):
        eg, ed = s
        eg2 = self.rho * eg + (1 - self.rho) * g.square()
        dx = -torch.sqrt((ed + self.epsilon) / (eg2 + self.epsilon)) * g
        ed2 = self.rho * ed + (1 - self.rho) * dx.square()
        return p + lr * dx, (eg2, ed2)


@OPTIMIZERS.register("rmsprop")
@dataclass
class RMSProp(Optimizer):
    """RMSProp with mean-centering (RMSPropParameterOptimizer,
    FirstOrderOptimizer.h:156 — tracks E[g^2] and E[g])."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_leaf(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))  # E[g^2], E[g]

    def update_leaf(self, p, g, s, lr, step):
        eg2, eg = s
        eg2n = self.rho * eg2 + (1 - self.rho) * g.square()
        egn = self.rho * eg + (1 - self.rho) * g
        denom = torch.sqrt(eg2n - egn.square() + self.epsilon)
        return p - lr * g / denom, (eg2n, egn)


@OPTIMIZERS.register("decayed_adagrad")
@dataclass
class DecayedAdaGrad(Optimizer):
    """Decayed AdaGrad (DecayedAdagradParameterOptimizer,
    FirstOrderOptimizer.h:199)."""

    rho: float = 0.95
    epsilon: float = 1e-6

    def init_leaf(self, p):
        return torch.zeros_like(p)

    def update_leaf(self, p, g, acc, lr, step):
        acc2 = self.rho * acc + (1 - self.rho) * g.square()
        return p - lr * g / (torch.sqrt(acc2) + self.epsilon), acc2


@OPTIMIZERS.register("adam")
@dataclass
class Adam(Optimizer):
    """Adam with bias correction (AdamParameterOptimizer,
    FirstOrderOptimizer.h:244: float32 moment arithmetic; ``slot_dtype``,
    e.g. "bfloat16", stores the moments at reduced width and widens them
    for each step's arithmetic)."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    slot_dtype: Optional[str] = None

    def init_leaf(self, p: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dt = getattr(torch, self.slot_dtype) if self.slot_dtype else p.dtype
        return (torch.zeros(p.shape, dtype=dt, device=p.device),
                torch.zeros(p.shape, dtype=dt, device=p.device))

    def update_leaf(self, p, g, slots, lr, step):
        m, v = slots
        g = g.float()
        m2 = self.beta1 * m.float() + (1 - self.beta1) * g
        v2 = self.beta2 * v.float() + (1 - self.beta2) * g.square()
        # bias corrections as float32 scalars, as the reference computes
        # them (a CPU scalar tensor combines with tensors on any device)
        t = step.to(torch.float32)
        bc1 = 1 - torch.tensor(self.beta1, dtype=torch.float32).pow(t)
        bc2 = 1 - torch.tensor(self.beta2, dtype=torch.float32).pow(t)
        mhat = m2 / bc1
        vhat = v2 / bc2
        p2 = p - lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return p2.to(p.dtype), (m2.to(m.dtype), v2.to(v.dtype))


@OPTIMIZERS.register("adamax")
@dataclass
class AdaMax(Optimizer):
    """AdaMax (AdamaxParameterOptimizer, FirstOrderOptimizer.h:275)."""

    beta1: float = 0.9
    beta2: float = 0.999

    def init_leaf(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def update_leaf(self, p, g, s, lr, step):
        m, u = s
        m2 = self.beta1 * m + (1 - self.beta1) * g
        u2 = torch.maximum(self.beta2 * u, g.abs())
        t = step.to(torch.float32)
        bc1 = 1 - torch.tensor(self.beta1, dtype=torch.float32).pow(t)
        return p - lr / bc1 * m2 / (u2 + 1e-12), (m2, u2)


# ---------------------------------------------------------------------------
# parameter averaging (AverageOptimizer analog)
# ---------------------------------------------------------------------------


@dataclass
class ParameterAverager:
    """An exponential moving average of the parameters for evaluation —
    analog of the reference's AverageOptimizer
    (paddle/parameter/AverageOptimizer.cpp)."""

    average_window: float = 0.999

    def init_state(self, params: Mapping[str, torch.Tensor]) -> Params:
        return {k: p.detach().clone() for k, p in params.items()}

    @torch.no_grad()
    def update(self, avg: Params, params: Mapping[str, torch.Tensor]
               ) -> Params:
        w = self.average_window
        return {k: w * a + (1 - w) * params[k] for k, a in avg.items()}
