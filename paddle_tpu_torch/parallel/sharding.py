"""Sharding rules — counterpart of ``paddle_tpu/parallel/sharding.py``.

The reference annotates parameters and batches with ``PartitionSpec``s and
lets GSPMD place them.  The port runs one process per rank, so a placement
is a statement about what each rank holds:

- ``replicated(mesh)`` (``P()``): every rank holds the whole tensor, the
  data axis's replicas (``MultiGradientMachine``'s analog);
- ``batch_sharding(mesh, ndim, axis)`` (``P(axis, None, ...)``): each rank
  holds its rows of the leading dimension (``api.shard_batch`` cuts them);
- ``ShardingRules`` maps parameter-name globs to specs, first match wins,
  as the reference's.  The port places a dense parameter replicated only:
  a spec that names a mesh axis for one (tensor parallelism) raises,
  naming the part of ROADMAP.md Queue 1 item 8 that ports it.  Embedding
  tables shard over the pserver axis through ``pserver/``.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.parallel.mesh import as_mesh

__all__ = ["ShardingRules", "replicated", "batch_sharding", "shard_params",
           "P"]


class P(tuple):
    """A partition spec: one mesh-axis name (or ``None``) per dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P({', '.join(repr(p) for p in self)})"

    @property
    def is_replicated(self) -> bool:
        return all(p is None for p in self)


def replicated(mesh) -> P:
    return P()


def batch_sharding(mesh, ndim: int, axis: str = "data") -> P:
    """The leading (batch) dimension over ``axis``; the rest whole."""
    return P(axis, *([None] * (ndim - 1)))


class ShardingRules:
    """Ordered ``(pattern, P)`` rules over parameter names; first match
    wins; no match is ``P()``."""

    def __init__(self, rules: Sequence[Tuple[str, P]]):
        self.rules = [(pat, spec if isinstance(spec, P) else P(*spec))
                      for pat, spec in rules]

    def spec_for(self, name: str, ndim: int) -> P:
        for pat, spec in self.rules:
            if fnmatch.fnmatch(name, pat):
                return P(*spec[:ndim]) if len(spec) > ndim else spec
        return P()

    def shardings(self, mesh, params: Dict[str, Any]) -> Dict[str, P]:
        return {name: self.spec_for(name, getattr(p, "ndim", 0))
                for name, p in params.items()}


def _refuse_sharded(specs: Dict[str, P]) -> None:
    from paddle_tpu_torch.utils.error import not_ported

    bad = sorted(k for k, s in specs.items() if not s.is_replicated)
    if bad:
        raise not_ported(
            f"a sharded spec for the dense parameter(s) {bad} (tensor "
            f"parallelism: ShardingRules on DTensor)", 8)


def shard_params(mesh, params: Dict[str, torch.Tensor],
                 rules: Optional[ShardingRules] = None
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter whole on this rank's device (``P()``); ``rules``
    may only say so."""
    mesh = as_mesh(mesh)
    if rules is not None:
        _refuse_sharded(rules.shardings(mesh, params))
    return {k: torch.as_tensor(v).to(mesh.device).clone()
            for k, v in params.items()}
