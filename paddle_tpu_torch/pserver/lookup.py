"""All-to-all sharded-embedding lookup — counterpart of
``paddle_tpu/pserver/lookup.py`` (the pserver prefetch).

The ranks along the pserver axis share one request (the same local batch:
they differ along that axis only) and one table, row-sharded among them.
Each member:

1. takes its 1/n slice of the flat request ids (the "trainer" role),
2. buckets them by owning shard, stable in id order within a bucket's
   arrival (``bucket_by_owner``, the reference's order),
3. exchanges the id buckets with ``all_to_all_single`` at a fixed
   capacity (the slice length: every id of the slice owned by one shard
   still fits, so nothing overflows),
4. gathers only its own rows for what it received (the "pserver" role),
5. sends the rows back with a second ``all_to_all_single``, puts them in
   its slice's order, and all-gathers the slices so every member holds
   the whole request's rows.

``all_to_all_lookup`` is a ``torch.autograd.Function``.  Its backward runs
only when the table shard itself requires grad (the
``parallel/embedding.py`` path): each member's slice of the output
gradient goes back to the owners by the same route and is scatter-added
into the shard's gradient.  The trainer's tier never asks for it: the
table is not differentiated, each lookup adds a zeros proxy of the request
shape (``TableProxy``), and the proxies' gradients are the (ids,
row-gradient) segments the push applies (``apply.py``) — no table-sized
gradient or temporary exists on that path.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["all_to_all_lookup", "bucket_by_owner", "TableProxy"]


def _bucket_by_key(vals: torch.Tensor, key: torch.Tensor, n_buckets: int,
                   fill: int):
    """Stable-bucket ``vals`` by ``key`` (ints in ``[0, n_buckets)``) ->
    ``(buckets [n_buckets, cap], order, key_sorted, bucket_pos)`` with
    ``cap = len(vals)``; ``(key_sorted, bucket_pos)`` address each sorted
    value's cell, unused cells hold ``fill``."""
    per = vals.shape[0]
    order = torch.argsort(key, stable=True)
    svals = vals[order]
    skey = key[order]
    starts = torch.searchsorted(
        skey, torch.arange(n_buckets, device=key.device, dtype=key.dtype))
    bucket_pos = torch.arange(per, device=key.device) - starts[skey]
    buckets = torch.full((n_buckets, per), fill, dtype=vals.dtype,
                         device=vals.device)
    buckets[skey, bucket_pos] = svals
    return buckets, order, skey, bucket_pos


def bucket_by_owner(ids: torch.Tensor, n_shards: int, shard_rows: int,
                    fill_id: int):
    """``_bucket_by_key`` keyed on the owning shard ``id // shard_rows``."""
    owner = torch.clamp(ids // shard_rows, 0, n_shards - 1)
    return _bucket_by_key(ids, owner, n_shards, fill_id)


class _A2ALookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, flat, mesh, axis, nreq):
        n = mesh.axis_size(axis)
        r = mesh.axis_index(axis)
        vs, d = shard.shape
        per = flat.shape[0] // n
        mine = flat[r * per:(r + 1) * per]
        buckets, order, sowner, bpos = bucket_by_owner(mine, n, vs, n * vs)
        recv = mesh.all_to_all(buckets.reshape(-1), axis, tag="lookup_ids")
        local = recv - r * vs
        inb = (local >= 0) & (local < vs)
        safe = torch.where(inb, local, torch.zeros_like(local))
        rows = shard[safe] * inb[:, None].to(shard.dtype)
        back = mesh.all_to_all(rows, axis, tag="lookup_rows").reshape(
            n, per, d)
        got = back[sowner, bpos]
        out = torch.empty((per, d), dtype=shard.dtype, device=shard.device)
        out[order] = got
        full = mesh.all_gather(out, axis, tag="lookup_gather")[:nreq]
        ctx.mesh, ctx.axis, ctx.per, ctx.vs = mesh, axis, per, vs
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(order, sowner, bpos, safe, inb)
        return full

    @staticmethod
    def backward(ctx, grad_full):
        mesh, axis, per, vs = ctx.mesh, ctx.axis, ctx.per, ctx.vs
        order, sowner, bpos, safe, inb = ctx.saved_tensors
        n = mesh.axis_size(axis)
        r = mesh.axis_index(axis)
        d = grad_full.shape[-1]
        # every member computed the same loss from the gathered rows, so
        # the gradient of this member's slice is its own copy's
        g = torch.zeros((n * per, d), dtype=grad_full.dtype,
                        device=grad_full.device)
        g[:grad_full.shape[0]] = grad_full
        mine = g[r * per:(r + 1) * per]
        payload = torch.zeros((n, per, d), dtype=g.dtype, device=g.device)
        payload[sowner, bpos] = mine[order]
        recv = mesh.all_to_all(payload.reshape(n * per, d), axis,
                               tag="lookup_bwd")
        grad = torch.zeros((vs, d), dtype=g.dtype, device=g.device)
        grad.index_add_(0, safe[inb], recv[inb])
        return grad, None, None, None, None


def all_to_all_lookup(mesh, shard: torch.Tensor, ids: torch.Tensor, *,
                      axis: str = "model",
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """``shard``: this member's ``[V_pad / n, D]`` rows; ``ids``: int of
    any shape, the same on every member of ``axis``'s group.  Returns
    ``[*ids.shape, D]`` rows on every member (``out_dtype`` casts them)."""
    n = mesh.axis_size(axis)
    d = shard.shape[1]
    flat = ids.reshape(-1).to(device=shard.device, dtype=torch.long)
    nreq = flat.shape[0]
    if n == 1:
        out = shard[flat]
    else:
        npad = (-nreq) % n
        if npad:
            flat = torch.cat([flat, flat.new_zeros(npad)])
        out = _A2ALookup.apply(shard, flat, mesh, axis, nreq)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out.reshape(*ids.shape, d)


class TableProxy:
    """The stand-in the trainer hands ``Topology.apply`` for a routed table
    (``param_overrides``).  The table shard rides the step undifferentiated;
    each lookup adds the zeros proxy of its request shape, whose gradient
    is the (per-position) row gradients the push applies.  ``nn.embedding``
    takes this branch when its parameter has ``pserver_lookup``."""

    def __init__(self, name: str, mesh, axis: str, data: torch.Tensor,
                 proxies: Dict[Tuple[str, str], Any],
                 compute_dtype: Optional[torch.dtype] = None,
                 shape: Optional[Tuple[int, int]] = None) -> None:
        self.name = name
        self.mesh = mesh
        self.axis = axis
        self.data = data
        self.proxies = proxies
        self.compute_dtype = compute_dtype
        self.dtype = data.dtype
        self.device = data.device
        self.shape = shape or tuple(data.shape)

    def pserver_lookup(self, ids: torch.Tensor, *, layer: str,
                       pad_to_zero_id=None) -> torch.Tensor:
        rows = all_to_all_lookup(self.mesh, self.data, ids, axis=self.axis)
        proxy = self.proxies.get((self.name, layer))
        if proxy is not None:
            rows = rows + proxy
        if pad_to_zero_id is not None:
            keep = (ids.to(rows.device) != pad_to_zero_id)[..., None]
            rows = rows * keep.to(rows.dtype)
        if self.compute_dtype is not None:
            rows = rows.to(self.compute_dtype)
        return rows
