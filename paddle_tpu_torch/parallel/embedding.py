"""Sharded embedding tables — counterpart of
``paddle_tpu/parallel/embedding.py``: the compat surface over the pserver
tier's all-to-all lookup (``pserver/lookup.py``).

``shard_table`` keeps this rank's rows of a whole ``[V, D]`` table (the
vocab padded up to a shard multiple with zero rows, or, with
``pad=False``, a ``ConfigError`` naming the table);
``sharded_embedding_lookup`` looks ids up across the axis's ranks and is
differentiable in the shard: its gradient is the row-sparse scatter-add
into this rank's rows.
"""

from __future__ import annotations

import torch

__all__ = ["sharded_embedding_lookup", "shard_table"]


def shard_table(mesh, table, axis: str = "model", *, pad: bool = True,
                name: str = "table") -> torch.Tensor:
    """This rank's ``[V_pad / n, D]`` rows of ``table`` on its device."""
    from paddle_tpu_torch.parallel.mesh import as_mesh
    from paddle_tpu_torch.pserver.table import pad_vocab

    mesh = as_mesh(mesh)
    table = torch.as_tensor(table)
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    v = table.shape[0]
    v_pad = pad_vocab(v, n, pad=pad, name=name)
    if v_pad != v:
        table = torch.cat([table, table.new_zeros((v_pad - v,)
                                                  + table.shape[1:])])
    vs = v_pad // n
    return table[i * vs:(i + 1) * vs].to(mesh.device).clone()


def sharded_embedding_lookup(mesh, table, ids, *, axis: str = "model"):
    """``table``: this rank's shard; ``ids``: the same on every member of
    the axis.  -> ``[*ids.shape, D]`` on every member."""
    from paddle_tpu_torch.parallel.mesh import as_mesh
    from paddle_tpu_torch.pserver.lookup import all_to_all_lookup

    return all_to_all_lookup(as_mesh(mesh), table, ids, axis=axis)
