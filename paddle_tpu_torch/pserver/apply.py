"""Sharded row-sparse update — counterpart of ``paddle_tpu/pserver/
apply.py`` (the pserver's gradient push).

The (ids, row-gradient) segments of a step go to the shards that own
their rows, and each owner applies the optimizer to the touched rows of
its shard only; no ``[V, D]`` gradient or optimizer temporary is built,
nor one of the shard's size:

1. each member of the pserver axis takes its 1/n slice of the flat
   segment stream (the stream is the same on every member),
2. buckets ids and rows by owning shard (the lookup's stable bucketing,
   so a row's duplicates meet in the single-process accumulation order),
3. exchanges id buckets ``[n, cap]`` and row buckets ``[n, cap, D]`` with
   ``all_to_all_single``,
4. the owner sums duplicates in stable id order and updates the touched
   rows of its shard and their slots in place
   (``Optimizer.sparse_apply_rows(inplace=True)``), under the bad-step
   guard's ``where`` when given,
5. the touched rows set their dirty marks.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from paddle_tpu_torch.pserver.lookup import bucket_by_owner

__all__ = ["sharded_row_update"]


@torch.no_grad()
def sharded_row_update(mesh, opt, shard: torch.Tensor, slots: Any,
                       dirty: torch.Tensor, ids: torch.Tensor,
                       row_grads: torch.Tensor, *, axis: str = "model",
                       lr_eff, step, decay: float = 0.0,
                       where: Optional[torch.Tensor] = None) -> None:
    """Apply segments (``ids`` [N] global row ids, sentinels ``>= V_pad``
    allowed; ``row_grads`` [N, D]) to this member's ``shard`` ([V_pad / n,
    D]), its ``slots`` and ``dirty`` marks, all in place."""
    n = mesh.axis_size(axis)
    vs, d = shard.shape
    sentinel = n * vs
    flat_ids = ids.reshape(-1).to(device=shard.device, dtype=torch.long)
    flat_g = row_grads.reshape(-1, d).to(shard.device)
    npad = (-flat_ids.shape[0]) % n
    if npad:
        flat_ids = torch.cat([flat_ids,
                              flat_ids.new_full((npad,), sentinel)])
        flat_g = torch.cat([flat_g, flat_g.new_zeros(npad, d)])
    if n == 1:
        local, recv_rows = flat_ids, flat_g
    else:
        r = mesh.axis_index(axis)
        per = flat_ids.shape[0] // n
        my_ids = flat_ids[r * per:(r + 1) * per]
        my_rows = flat_g[r * per:(r + 1) * per]
        buckets, order, sowner, bpos = bucket_by_owner(my_ids, n, vs,
                                                       sentinel)
        payload = torch.zeros((n, per, d), dtype=flat_g.dtype,
                              device=flat_g.device)
        payload[sowner, bpos] = my_rows[order]
        recv_ids = mesh.all_to_all(buckets.reshape(-1), axis,
                                   tag="push_ids")
        recv_rows = mesh.all_to_all(payload.reshape(n * per, d), axis,
                                    tag="push_rows")
        local = recv_ids - r * vs
    # foreign and sentinel entries park past the end; the apply drops them
    local = torch.where((local >= 0) & (local < vs), local,
                        torch.full_like(local, vs))
    opt.sparse_apply_rows(shard, local, recv_rows, slots, lr_eff=lr_eff,
                          step=step, decay=decay, inplace=True, where=where)
    touched = (local < vs) & (recv_rows != 0).any(dim=1)
    if where is not None:
        touched = touched & where
    idx = local[touched]
    dirty[idx] = True
