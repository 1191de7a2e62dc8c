"""Sharded embedding table store — counterpart of
``paddle_tpu/pserver/table.py`` (the pserver's parameter memory).

A table of ``V`` rows is padded to ``V_pad``, a multiple of the shard
count ``n`` (the size of the pserver axis), and row-sharded: the rank at
index ``s`` along that axis holds rows ``[s * V_pad / n, (s + 1) * V_pad /
n)`` on its device and nothing else of the table.  Invariants, as in the
reference:

- **vocab padding** (``pad_vocab``): tail rows past ``V`` are zero at init
  and can never be looked up (ids are ``< V``), so they stay zero; with
  padding off, a vocab that does not divide raises a ``ConfigError``
  naming the table;
- **per-shard deterministic init** (``init_shard_rows``): shard ``s``
  draws its rows from its own ``torch.Generator``, seeded from ``(seed,
  s)`` through numpy's ``SeedSequence``, on the CPU, so any process can
  re-derive any shard bit for bit on any device.  The draws are the
  port's own (other numbers than ``jax.random``'s);
- **f32 master / optional compute dtype**: the stored table keeps
  ``dtype``; a lookup may cast the rows it returns to ``compute_dtype``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.utils.error import ConfigError

__all__ = ["TableSpec", "ShardedTable", "pad_vocab", "init_shard_rows"]


def pad_vocab(vocab: int, shards: int, *, pad: bool = True,
              name: str = "table") -> int:
    """Vocab rows padded up to a multiple of ``shards``; with ``pad=False``
    a non-dividing vocab is a ``ConfigError`` naming the table."""
    if vocab <= 0:
        raise ConfigError(f"table {name!r}: vocab must be positive, got "
                          f"{vocab}")
    if shards <= 0:
        raise ConfigError(f"table {name!r}: shard count must be positive, "
                          f"got {shards}")
    rem = vocab % shards
    if rem == 0:
        return vocab
    if not pad:
        raise ConfigError(
            f"table {name!r}: vocab {vocab} does not divide evenly over "
            f"{shards} shards and padding is disabled — enable padding "
            f"(masked tail rows) or resize the vocabulary")
    return vocab + (shards - rem)


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


@dataclass(frozen=True)
class TableSpec:
    """Everything a process needs to re-derive a table's initial shards
    and check a table against the live config."""

    name: str
    vocab: int
    dim: int
    init: str = "normal"            # 'normal' | 'uniform' | 'zeros'
    initial_std: float = 0.01
    initial_mean: float = 0.0
    seed: int = 0
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    #: per-device byte budget of one shard (0 = unchecked): the full table
    #: may exceed it as long as every shard fits
    device_budget_bytes: int = 0

    def padded_vocab(self, shards: int, *, pad: bool = True) -> int:
        return pad_vocab(self.vocab, shards, pad=pad, name=self.name)

    def table_bytes(self) -> int:
        return self.vocab * self.dim * _itemsize(self.dtype)

    def shard_bytes(self, shards: int) -> int:
        vs = self.padded_vocab(shards) // shards
        return vs * self.dim * _itemsize(self.dtype)

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TableSpec":
        return cls(**d)


def init_shard_rows(spec: TableSpec, shard_index: int, shard_rows: int,
                    device=None) -> torch.Tensor:
    """Rows ``[shard_index * shard_rows, ...)`` of the table, drawn on the
    CPU from the shard's own generator; rows past the true vocab are
    zero."""
    state = np.random.SeedSequence([int(spec.seed), int(shard_index)])
    gen = torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    shape = (shard_rows, spec.dim)
    dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        rows = torch.zeros(shape, dtype=dtype)
    elif spec.init == "uniform":
        a = spec.initial_std
        rows = (2 * torch.rand(shape, generator=gen, dtype=dtype) - 1) * a
    else:   # normal, the reference's embedding default
        rows = (spec.initial_mean
                + spec.initial_std * torch.randn(shape, generator=gen,
                                                 dtype=dtype))
    row_id = shard_index * shard_rows + torch.arange(shard_rows)
    rows = rows * (row_id < spec.vocab)[:, None].to(dtype)
    return rows.to(device) if device is not None else rows


class ShardedTable:
    """One live table on one rank: its shard of rows, the shard's dirty
    marks and the placement metadata.  ``data`` is ``[V_pad / n, D]`` and
    ``dirty`` ``[V_pad / n]`` bool, both on the mesh's device."""

    def __init__(self, spec: TableSpec, mesh, *, axis: str = "model",
                 pad: bool = True, data: Optional[torch.Tensor] = None,
                 dirty: Optional[torch.Tensor] = None) -> None:
        self.spec = spec
        self.mesh = mesh
        self.axis = axis
        self.shards = mesh.axis_size(axis)
        self.shard_index = mesh.axis_index(axis)
        self.vocab_padded = spec.padded_vocab(self.shards, pad=pad)
        self.shard_rows = self.vocab_padded // self.shards
        self.row_start = self.shard_index * self.shard_rows
        if spec.device_budget_bytes:
            per = self.shard_rows * spec.dim * _itemsize(spec.dtype)
            if per > spec.device_budget_bytes:
                raise ConfigError(
                    f"table {spec.name!r}: one shard needs {per} bytes "
                    f"({self.shard_rows} x {spec.dim} {spec.dtype}) but the "
                    f"device budget is {spec.device_budget_bytes} — add "
                    f"shards or shrink the table")
        dev = mesh.device
        self.data = (init_shard_rows(spec, self.shard_index,
                                     self.shard_rows, dev)
                     if data is None else data.to(dev))
        self.dirty = (torch.zeros(self.shard_rows, dtype=torch.bool,
                                  device=dev)
                      if dirty is None else dirty.to(dev, torch.bool))

    @property
    def shape(self):
        """The whole table's shape, ``(V_pad, D)``."""
        return (self.vocab_padded, self.spec.dim)

    def gather_full(self, tensor: Optional[torch.Tensor] = None,
                    tag: str = "pserver_gather") -> torch.Tensor:
        """A collective: every shard of ``tensor`` (default the table)
        concatenated on every member, ``[V_pad, ...]`` — for checks and
        checkpoints, never on the step."""
        return self.mesh.all_gather(self.data if tensor is None else tensor,
                                    self.axis, tag=tag)

    def own_rows(self, full: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a whole-table tensor."""
        return full[self.row_start:self.row_start + self.shard_rows]

    def __repr__(self) -> str:
        return (f"<ShardedTable {self.spec.name} {self.spec.vocab}"
                f"(+{self.vocab_padded - self.spec.vocab} pad)x"
                f"{self.spec.dim} shard {self.shard_index}/{self.shards} "
                f"@{self.axis}>")
