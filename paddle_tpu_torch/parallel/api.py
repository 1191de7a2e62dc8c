"""The data-parallel training step — counterpart of
``paddle_tpu/parallel/api.py``.

The reference compiles ``jax.value_and_grad(loss) + optimizer.update`` once
over a mesh and lets GSPMD insert the gradient all-reduce
(``paddle_tpu/parallel/api.py:105-116``).  The port runs the same step on
every rank of the data axis, each on its slice of the global batch
(``shard_batch``): forward and backward locally, one all-reduce of every
gradient (and of the loss) over the data group, then the same
``optimizer.update`` on every rank, whose replicas therefore stay equal.

Each rank scales its loss by its share of the global batch before the
backward: what its loss averages over (its rows, or a sequence loss's
real tokens) over the data axis's total (``loss_shares``).  So one sum
over the axis gives the global batch's loss and gradients
(``reduce_loss_and_grads``), as GSPMD's step over the whole batch
computes them.  The loss reports
what it averages over through its model's ``loss_weight(batch)`` (as
``Seq2SeqAttention`` does); a loss without one weighs every rank the same,
which is the global mean for a mean over rows.  ``SGDTrainer(mesh=)``
uses the same two helpers with each cost layer's ``COST_NORM``.

Not ported here: a ``MeshConfig`` that binds a ``dcn_axis`` (the
hierarchical all-reduce, ``parallel/hierarchical.py``) and sharding rules
that shard a dense parameter (tensor parallelism) raise, naming the parts
of ROADMAP.md Queue 1 item 8 that port them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.parallel.mesh import Mesh, MeshConfig, as_mesh
from paddle_tpu_torch.parallel.sharding import (ShardingRules,
                                                _refuse_sharded)
from paddle_tpu_torch.utils.error import ConfigError, not_ported

__all__ = ["make_parallel_train_step", "data_parallel_grads", "shard_batch",
           "agreement_spec", "loss_shares", "reduce_loss_and_grads"]


def agreement_spec(mesh, axis: Optional[str] = None):
    """``(mesh, axis name, replica count)`` of the cross-replica agreement
    check: the data axis by default; a missing or size-1 axis is a
    ``ConfigError`` (one replica compares nothing)."""
    built = as_mesh(mesh)
    name = axis or built.config.role_axis("data")
    if name not in built.axis_names:
        raise ConfigError(f"agreement axis {name!r} not in mesh axes "
                          f"{tuple(built.axis_names)}")
    n = built.axis_size(name)
    if n < 2:
        raise ConfigError(f"agreement over axis {name!r} needs >=2 "
                          f"replicas, mesh has {n} — nothing to compare")
    return built, name, n


def shard_batch(mesh, feed: Dict[str, Any], axis: str = "data"
                ) -> Dict[str, Any]:
    """This rank's rows of the global ``feed`` along ``axis`` (each array's
    leading dimension, or each of a tuple's), as tensors on the rank's
    device; values that are neither arrays nor tensors pass through.  The
    rows must divide over the axis."""
    mesh = as_mesh(mesh)
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)

    def put(v):
        if isinstance(v, tuple):
            return tuple(put(x) for x in v)
        if not torch.is_tensor(v):
            if not isinstance(v, (np.ndarray, np.generic, list, int, float)):
                return v
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        if v.dim() and n > 1:
            if v.shape[0] % n:
                raise ConfigError(
                    f"a batch of {v.shape[0]} rows does not divide over the "
                    f"{n} ranks of axis {axis!r}")
            b = v.shape[0] // n
            v = v[i * b:(i + 1) * b]
        return v.to(mesh.device)

    return {k: put(v) for k, v in feed.items()}


def loss_shares(mesh, norms: Sequence[Any], axis: str
                ) -> List[torch.Tensor]:
    """This rank's share of the global batch for each loss, from what each
    averages over on this rank (``norms``): the count over the axis's
    total (at least 1); a sum's (``None``) share is 1.  A rank's loss
    times its share, summed over the axis, is the loss of the global
    batch.  A count taken from the data is a tensor, and the counts are
    summed over the axis in one all-reduce; a count known from the shapes
    alone is a Python number, the same on every rank (the batch divides
    evenly over the axis), so norms that are all numbers need no
    exchange: each share is ``1 / n``."""
    mesh = as_mesh(mesh)
    counts = torch.stack([torch.as_tensor(
        0.0 if d is None else d, dtype=torch.float32,
        device=mesh.device).reshape(()) for d in norms])
    if any(torch.is_tensor(d) for d in norms):
        total = counts.clone()
        mesh.all_reduce([total], axis, tag="loss_norm_allreduce")
    else:
        total = counts * mesh.axis_size(axis)
    shares = counts / torch.clamp(total, min=1.0)
    return [torch.ones_like(shares[i]) if d is None else shares[i]
            for i, d in enumerate(norms)]


def reduce_loss_and_grads(mesh, loss: torch.Tensor,
                          grads: Dict[str, torch.Tensor], axis: str
                          ) -> torch.Tensor:
    """One all-reduce (sum) over ``axis`` of this rank's loss and every
    gradient (in place).  Each rank's are its share of the global batch's
    (``loss_shares``), so the sums are the global batch's -> the global
    loss (float32 scalar)."""
    loss = loss.detach().float().reshape(1).clone()
    as_mesh(mesh).all_reduce([loss, *grads.values()], axis,
                             tag="grad_allreduce")
    return loss.reshape(())


def _loss_norm(loss_fn, batch):
    """What ``loss_fn`` averages over on this batch (``loss_shares``): the
    ``loss_weight(batch)`` of the model whose bound method ``loss_fn`` is,
    a count from the data; else 1 (every rank's slice weighs the same: a
    mean over rows)."""
    own = getattr(getattr(loss_fn, "__self__", None), "loss_weight", None)
    return torch.as_tensor(own(batch)) if own is not None else 1


def data_parallel_grads(loss_fn, params: Dict[str, torch.Tensor],
                        batch: Dict[str, Any], mesh, *,
                        axis: Optional[str] = None):
    """The global batch's ``(loss, gradients)`` from this rank's slice:
    local forward, the loss scaled by this rank's share of the global
    batch (``loss_shares`` of what it averages over: ``_loss_norm``),
    local backward, then one sum over the data axis -> (float32 scalar
    loss, ``{name: gradient}``)."""
    mesh = as_mesh(mesh)
    axis = axis or mesh.config.role_axis("data")
    n = mesh.axis_size(axis)
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_() for k in names}
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        if n > 1:
            (share,) = loss_shares(mesh, [_loss_norm(loss_fn, batch)],
                                   axis)
            loss = loss * share.to(loss.dtype)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
    grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
             for k, g in zip(names, grads)}
    if n > 1:
        return reduce_loss_and_grads(mesh, loss, grads, axis), grads
    return loss.detach().float().reshape(()), grads


def make_parallel_train_step(
        loss_fn: Callable[[Dict[str, torch.Tensor], Dict[str, Any]],
                          torch.Tensor],
        optimizer, mesh, *, rules: Optional[ShardingRules] = None,
        donate: bool = True) -> Callable:
    """``step(params, opt_state, batch) -> (loss, params, opt_state)`` on
    this rank: ``batch`` is the rank's slice (``shard_batch``), the loss
    returned is the global batch's (``data_parallel_grads``, weighted by
    the model's ``loss_weight`` where it has one).
    ``donate=True`` updates ``params`` and ``opt_state`` in place (the
    reference donates them); ``False`` leaves them and returns new ones."""
    if (isinstance(mesh, MeshConfig) and mesh.dcn_axis
            and mesh.dcn_axis in mesh.shape):
        raise not_ported("make_parallel_train_step over a MeshConfig with a "
                         "dcn_axis (the hierarchical all-reduce, parallel/"
                         "hierarchical.py)", 8)
    mesh: Mesh = as_mesh(mesh)

    def step(params, opt_state, batch):
        if rules is not None:
            _refuse_sharded(rules.shardings(mesh, params))
        loss, grads = data_parallel_grads(loss_fn, params, batch, mesh)
        if donate:
            optimizer.update(params, grads, opt_state)
            return loss, params, opt_state
        new_p, new_o = optimizer.new_values(params, grads, opt_state)
        return loss, new_p, new_o

    return step
