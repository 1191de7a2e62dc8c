"""PServerTier — counterpart of ``paddle_tpu/pserver/tier.py``: sharded
tables wired into ``SGDTrainer``'s step.

``nn.embedding(..., sparse_grad=True)`` marks a table; a trainer whose
mesh carries the pserver axis routes every such table through this tier:

- the table is born sharded (``ShardedTable``: each rank draws only its
  own rows) and is not in the trainer's dense ``params``: the dense
  optimizer neither stores nor updates it;
- in the step the topology sees a ``TableProxy`` for it
  (``Topology.apply(param_overrides=)``): lookups run the all-to-all
  exchange against the live shard, and each adds a zeros proxy of its
  request shape;
- the proxies' gradients are the (ids, row-gradient) segments.  Under a
  data axis they are all-gathered over it (the global batch's segments,
  in global row order; each rank's are its share of the global batch's,
  as the trainer scales its cost); ``apply_grads`` pushes them through
  ``sharded_row_update``.  No table-sized gradient exists;
- each table's optimizer slots live sharded like it and advance only for
  touched rows; the tier keeps its own step counter (the dense
  optimizer's schedule evaluated at it);
- ``state()``/``adopt()`` hand the shard-local state over; ``full_state()``
  gathers whole tables (a collective) for a checkpoint in the reference's
  layout, which ``adopt`` also takes (each rank keeps its own rows,
  re-padded when the checkpoint's shard count differs).

Not ported here: ``resize`` (elastic resize, the gang supervisor, ROADMAP.md
Queue 1 item 9) and ``snapshot`` (``pserver/snapshot.py``, item 8).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from paddle_tpu_torch.param.optimizers import _map_slots, dedup_rows
from paddle_tpu_torch.pserver.apply import sharded_row_update
from paddle_tpu_torch.pserver.lookup import TableProxy
from paddle_tpu_torch.pserver.table import ShardedTable, TableSpec
from paddle_tpu_torch.utils.error import not_ported
from paddle_tpu_torch.utils.flags import FLAGS
from paddle_tpu_torch.utils.log import logger

__all__ = ["PServerTier", "Route", "discover_routes"]


def _repad_rows(arr: torch.Tensor, vocab: int, v_pad_new: int
                ) -> torch.Tensor:
    """Keep the true vocab rows, re-pad the tail with zeros to a new shard
    multiple (pad rows are zero in every world)."""
    arr = arr[:vocab]
    if v_pad_new > vocab:
        pad = arr.new_zeros((v_pad_new - vocab,) + tuple(arr.shape[1:]))
        arr = torch.cat([arr, pad])
    return arr


class Route(NamedTuple):
    """One embedding layer routed through the tier."""

    layer: str       # embedding layer name
    param: str       # table parameter name
    data: str        # feeding data layer name
    is_seq: bool     # sequence slot (ids [B, T]) or scalar slot ([B, 1])
    dim: int


def discover_routes(topology) -> List[Route]:
    """Embedding layers whose table parameter is marked ``sparse_grad``."""
    routes = []
    for layer in topology.layers:
        if layer.layer_type != "embedding" or not layer.param_specs:
            continue
        spec = layer.param_specs[0]
        if not spec.attr.sparse_grad:
            continue
        parent = layer.parents[0]
        routes.append(Route(
            layer=layer.name, param=spec.name, data=parent.name,
            is_seq=bool((parent.data_spec or {}).get("is_seq")),
            dim=layer.size))
    return routes


def _feed_ids(feed, route: Route) -> torch.Tensor:
    """The ids the embedding forward looks up for this route (its [B, 1]
    squeeze included), so proxies and segments line up with the lookup."""
    v = feed[route.data]
    value = v[0] if isinstance(v, tuple) else v
    ids = torch.as_tensor(value).to(torch.long)
    if not route.is_seq and ids.dim() == 2 and ids.shape[1] == 1:
        ids = ids[:, 0]
    return ids


class PServerTier:
    """Sharded-table store and step hooks of one trainer on one rank."""

    def __init__(self, mesh, topology, optimizer, *,
                 axis: Optional[str] = None, pad: Optional[bool] = None,
                 lr_scales: Optional[Dict[str, float]] = None,
                 decays: Optional[Dict[str, float]] = None,
                 seed: Optional[int] = None,
                 data_axis: Optional[str] = None) -> None:
        self.mesh = mesh
        self.axis = axis or mesh.config.role_axis("pserver")
        self.data_axis = data_axis or mesh.config.data_axis
        self.optimizer = optimizer
        self.lr_scales = dict(lr_scales or {})
        self.decays = dict(decays or {})
        seed = int(FLAGS.seed) if seed is None else int(seed)
        pad = FLAGS.pserver_pad_vocab if pad is None else pad
        self.routes = discover_routes(topology)
        self.tables: Dict[str, ShardedTable] = {}
        self._slots: Dict[str, Any] = {}
        self._step = torch.zeros((), dtype=torch.int32, device=mesh.device)
        by_param: Dict[str, List[Route]] = {}
        for r in self.routes:
            by_param.setdefault(r.param, []).append(r)
        self.routes_by_param = by_param
        for pname, rs in by_param.items():
            spec = topology.param_specs[pname]
            attr = spec.attr
            init = attr.init or "normal"
            if init not in ("normal", "uniform", "zeros"):
                init = "normal"   # xavier etc. have no row-local analog
            tspec = TableSpec(
                name=pname, vocab=spec.shape[0], dim=spec.shape[1],
                init=init,
                initial_std=(attr.initial_std
                             if attr.initial_std is not None else 0.01),
                initial_mean=attr.initial_mean, seed=seed,
                # --amp: rows leave the lookup in bf16 after the proxy
                # add, so masters, row gradients and the push stay f32
                compute_dtype="bfloat16" if FLAGS.amp else None)
            table = ShardedTable(tspec, mesh, axis=self.axis, pad=pad)
            self.tables[pname] = table
            self._slots[pname] = optimizer.init_leaf(table.data)
            logger.info("pserver: routed %s (%s) -> %r", pname,
                        ", ".join(r.layer for r in rs), table)

    # -- state ---------------------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self.tables)

    def param_names(self):
        return set(self.tables)

    def state(self) -> Dict[str, Any]:
        """The shard-local state (this rank's rows, slots, dirty marks)."""
        return {"step": self._step,
                "tables": {k: t.data for k, t in self.tables.items()},
                "slots": dict(self._slots),
                "dirty": {k: t.dirty for k, t in self.tables.items()}}

    def full_state(self) -> Dict[str, Any]:
        """The whole tables, slots and dirty marks gathered over the
        pserver axis (a collective every member calls), in the
        reference's checkpoint layout ``[V_pad, ...]``."""
        out = {"step": self._step, "tables": {}, "slots": {}, "dirty": {}}
        for k, t in self.tables.items():
            out["tables"][k] = t.gather_full()
            out["dirty"][k] = t.gather_full(t.dirty)
            out["slots"][k] = _map_slots(
                lambda s: t.gather_full(s) if s.shape == t.data.shape
                else s, self._slots[k])
        return out

    def adopt(self, state: Dict[str, Any]) -> None:
        """Take a state: shard-local (``state()``) or whole-table
        (``full_state()``, a checkpoint, possibly saved under another
        shard count: the true rows carry over and re-pad)."""
        with torch.no_grad():
            self._step.copy_(torch.as_tensor(state["step"]))
        for k, t in self.tables.items():

            def mine(a, t=t):
                a = torch.as_tensor(a)
                if a.dim() == 0:
                    return a.to(t.data.device)
                if a.shape[0] != t.vocab_padded and a.shape[0] == t.shard_rows:
                    return a.to(t.data.device)      # shard-local already
                if a.shape[0] != t.vocab_padded:
                    logger.info("pserver: re-padding table %r from %d to %d "
                                "rows (%d shards)", k, a.shape[0],
                                t.vocab_padded, t.shards)
                    a = _repad_rows(a, t.spec.vocab, t.vocab_padded)
                return t.own_rows(a).to(t.data.device).clone()

            t.data = mine(state["tables"][k]).to(t.data.dtype)
            t.dirty = mine(state["dirty"][k]).to(torch.bool)
            self._slots[k] = _map_slots(mine, state["slots"][k])

    def resize(self, mesh) -> None:
        raise not_ported("PServerTier.resize (elastic resize under the gang "
                         "supervisor)", 9)

    def snapshot(self, save_dir: str, *, reset_dirty: bool = True):
        raise not_ported("PServerTier.snapshot (pserver/snapshot.py)", 8)

    # -- step hooks ------------------------------------------------------------

    def make_proxies(self, feed) -> Dict[Tuple[str, str], torch.Tensor]:
        """Zeros of each routed lookup's request shape, requiring grad."""
        out = {}
        for r in self.routes:
            ids = _feed_ids(feed, r)
            out[(r.param, r.layer)] = torch.zeros(
                ids.shape + (r.dim,), dtype=torch.float32,
                device=self.mesh.device, requires_grad=True)
        return out

    def make_overrides(self, proxies) -> Dict[str, TableProxy]:
        cdt = {k: (getattr(torch, t.spec.compute_dtype)
                   if t.spec.compute_dtype else None)
               for k, t in self.tables.items()}
        return {name: TableProxy(name, self.mesh, self.axis, t.data,
                                 proxies, compute_dtype=cdt[name],
                                 shape=t.shape)
                for name, t in self.tables.items()}

    def segments(self, feed, proxy_grads) -> Dict[str, Tuple[torch.Tensor,
                                                              torch.Tensor]]:
        """``{table: (ids [N], row grads [N, D])}`` of the global batch:
        this rank's segments all-gathered over the data axis (in global row
        order).  Each rank's row gradients are already its share of the
        global batch's (the trainer scales its cost: ``loss_shares``)."""
        nd = self.mesh.axis_size(self.data_axis)
        out = {}
        for pname, routes in self.routes_by_param.items():
            ids = torch.cat([_feed_ids(feed, r).reshape(-1).to(
                self.mesh.device) for r in routes])
            g = torch.cat([proxy_grads[(pname, r.layer)].reshape(-1, r.dim)
                           for r in routes])
            if nd > 1:
                ids = self.mesh.all_gather(ids, self.data_axis,
                                           tag="pserver_segments")
                g = self.mesh.all_gather(g, self.data_axis,
                                         tag="pserver_segments")
            out[pname] = (ids, g)
        return out

    def grad_norm_sq(self, segments) -> torch.Tensor:
        """Sum of squares of the per-row (duplicate-summed) gradients: the
        mass the dense gradient would add to a global-norm clip."""
        total = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        for ids, g in segments.values():
            _, sums = dedup_rows(ids, g, sentinel=2 ** 62)
            total = total + sums.float().square().sum()
        return total

    def apply_grads(self, segments, where: Optional[torch.Tensor] = None
                    ) -> None:
        """Push the segments into the shards, slots and dirty marks in
        place; the tier's step counter advances (all held where ``where``
        is False)."""
        step = self._step + 1
        lr = self.optimizer.lr_at(step)
        for pname, (ids, g) in segments.items():
            t = self.tables[pname]
            scale = self.lr_scales.get(pname, 1.0)
            decay = self.decays.get(pname, 0.0) + self.optimizer.l2_rate
            sharded_row_update(self.mesh, self.optimizer, t.data,
                               self._slots[pname], t.dirty, ids, g,
                               axis=self.axis, lr_eff=lr * scale, step=step,
                               decay=decay, where=where)
        with torch.no_grad():
            self._step.copy_(step if where is None
                             else torch.where(where, step, self._step))
