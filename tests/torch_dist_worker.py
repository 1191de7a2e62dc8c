"""One rank of a multi-process test world (``tests/torch_dist.py``).

    python tests/torch_dist_worker.py CASE DIR

Joins the world the launcher wired (gloo, the CPU), reads ``DIR/in.npz``
and ``DIR/in.json``, runs ``CASE`` and writes ``DIR/out-<rank>.npz`` and
``DIR/out-<rank>.json``.  Imports torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.parallel import distributed as D  # noqa: E402
from paddle_tpu_torch.parallel.mesh import MeshConfig  # noqa: E402

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _np(t):
    return t.detach().float().cpu().numpy()


def _optimizer(cfg):
    from paddle_tpu_torch.param import optimizers as O

    kw = dict(cfg.get("opt_kw", {}))
    return getattr(O, cfg.get("opt", "Adam"))(**kw)


def _net(cfg):
    """The DSL nets of the tests, by name."""
    import paddle_tpu_torch.nn as nn

    nn.reset_naming()
    name = cfg["net"]
    if name == "mlp":
        x = nn.data("x", size=cfg["in_dim"])
        lab = nn.data("label", size=1, dtype="int32")
        h = nn.fc(x, cfg["hid"], act="relu", name="h")
        logits = nn.fc(h, cfg["classes"], act="linear", name="out")
        return nn.classification_cost(logits, lab, name="cost")
    if name == "toy":
        vocab, dim = cfg["vocab"], cfg["dim"]
        uid = nn.data("uid", size=vocab, dtype="int32")
        lab = nn.data("y", size=1)
        emb = nn.embedding(uid, dim, name="u_emb", sparse_grad=True)
        h = nn.fc(emb, 8, act="relu", name="h")
        pred = nn.fc(h, 1, act="linear", name="p")
        return nn.mse_cost(pred, lab, name="cost")
    if name in ("seqcls", "seqcls3"):
        ids = nn.data("ids", size=cfg["vocab"], is_seq=True, dtype="int32")
        tags = nn.data("tags", size=cfg["classes"], is_seq=True,
                       dtype="int32")
        e = nn.embedding(ids, 6, name="emb")
        h = nn.fc(e, 8, act="tanh", name="h")
        logits = nn.fc(h, cfg["classes"], act="linear", name="out")
        cost = nn.classification_cost(logits, tags, name="cost")
        if name == "seqcls":
            return cost
        x = nn.data("x", size=4)
        y = nn.data("y", size=1)
        g = nn.fc(x, 1, act="linear", name="g")
        return [cost, nn.mse_cost(g, y, name="rows"),
                nn.sum_cost(g, name="total")]
    if name == "movielens":
        from paddle_tpu_torch.models.recommender import movielens_net

        return movielens_net(cfg["n_users"], cfg["n_movies"],
                             emb_dim=cfg["emb"], hid_dim=cfg["hid"],
                             sparse_grad=True)[0]
    raise ValueError(name)


def _feeds(arrays, cfg):
    """The global feeds; ``feed<i>.<key>.len`` makes a sequence feed
    (values, lengths)."""
    def value(i, k):
        v = arrays[f"feed{i}.{k}"]
        ln = arrays.get(f"feed{i}.{k}.len")
        return v if ln is None else (v, ln)

    return [{k: value(i, k) for k in cfg["feed_keys"]}
            for i in range(cfg["n_feeds"])]


@case
def dp_seq2seq(mesh, arrays, cfg):
    """``make_parallel_train_step`` on ``Seq2SeqAttention`` over the data
    axis (each rank's loss weighted by its target tokens, the model's
    ``loss_weight``)."""
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.parallel import (make_parallel_train_step,
                                           shard_batch, shard_params)

    m = Seq2SeqAttention(**cfg["widths"], device="cpu")
    params = shard_params(mesh, {k[2:]: torch.from_numpy(v)
                                 for k, v in arrays.items()
                                 if k.startswith("p.")})
    opt = _optimizer(cfg)
    state = opt.init_state(params)
    step = make_parallel_train_step(m.loss, opt, mesh)
    batch = shard_batch(mesh, {k: arrays[k] for k in cfg["batch_keys"]})
    losses = []
    for _ in range(cfg["steps"]):
        loss, params, state = step(params, state, batch)
        losses.append(float(loss))
    return ({f"p.{k}": _np(v) for k, v in params.items()},
            {"losses": losses})


def _trainer(mesh, arrays, cfg, **kw):
    from paddle_tpu_torch.trainer import SGDTrainer

    tr = SGDTrainer(_net(cfg), _optimizer(cfg), mesh=mesh,
                    seed=cfg.get("seed", 1),
                    cost_weights=cfg.get("cost_weights"), **kw)
    with torch.no_grad():
        for k, p in tr.params.items():
            if f"p.{k}" in arrays:
                p.copy_(torch.from_numpy(arrays[f"p.{k}"]).to(p.device))
    if tr.pserver is not None and cfg.get("adopt_tables"):
        full = {"step": 0, "tables": {}, "slots": {}, "dirty": {}}
        for name, t in tr.pserver.tables.items():
            table = torch.from_numpy(arrays[f"t.{name}"]).to(mesh.device)
            full["tables"][name] = table
            full["dirty"][name] = torch.zeros(table.shape[0],
                                              dtype=torch.bool,
                                              device=mesh.device)
            full["slots"][name] = tr.optimizer.init_leaf(table)
        tr.pserver.adopt(full)
    return tr


def _trainer_outputs(tr, losses):
    out = {f"p.{k}": _np(v) for k, v in tr.params.items()}
    if tr.pserver is not None:
        full = tr.pserver.full_state()
        for name in tr.pserver.tables:
            out[f"t.{name}"] = _np(full["tables"][name])
            out[f"d.{name}"] = full["dirty"][name].cpu().numpy()
            for i, s in enumerate(_leaves(full["slots"][name])):
                out[f"s{i}.{name}"] = _np(s)
    from paddle_tpu_torch.__main__ import params_digest
    from paddle_tpu_torch.parallel import comm_stats

    return out, {"losses": losses, "digest": params_digest(tr.params),
                 "bad_steps": tr.bad_steps_total,
                 "calls": {k: v["calls"] for k, v in comm_stats().items()}}


def _leaves(slots):
    return [slots] if torch.is_tensor(slots) else list(slots)


@case
def trainer(mesh, arrays, cfg):
    """``SGDTrainer(mesh=)`` on the global feeds (the data axis cuts each
    rank's rows; the pserver axis routes ``sparse_grad`` tables)."""
    tr = _trainer(mesh, arrays, cfg)
    losses = [float(tr.train_batch(f)) for f in _feeds(arrays, cfg)]
    if cfg.get("nan_feed"):
        bad = dict(_feeds(arrays, cfg)[0])
        bad["y"] = np.full_like(bad["y"], np.nan)
        before = _trainer_outputs(tr, losses)[0]
        tr.train_batch(bad)
        after = _trainer_outputs(tr, losses)[0]
        held = all(np.array_equal(before[k], after[k], equal_nan=True)
                   for k in before)
        out, meta = _trainer_outputs(tr, losses)
        meta["held"] = held
        meta["bad_step"] = int(tr._last_extras["bad_step"])
        return out, meta
    if cfg.get("test"):
        out, meta = _trainer_outputs(tr, losses)
        meta["test_cost"] = tr.test(lambda: iter(_feeds(arrays, cfg)))["cost"]
        return out, meta
    return _trainer_outputs(tr, losses)


@case
def save_load(mesh, arrays, cfg):
    """Train, checkpoint (every rank calls ``save``, rank 0 writes the
    gathered tables), then a fresh trainer of another seed loads it."""
    import torch.distributed as dist

    d = cfg["save_dir"]
    tr = _trainer(mesh, arrays, cfg)
    for f in _feeds(arrays, cfg):
        tr.train_batch(f)
    tr.save(d, 0)
    dist.barrier()
    fresh = _trainer(mesh, arrays, {**cfg, "seed": 9})
    fresh.load(d, 0)
    a, meta = _trainer_outputs(tr, [])
    b, _ = _trainer_outputs(fresh, [])
    meta["equal"] = sorted(k for k in a if np.array_equal(a[k], b[k]))
    meta["keys"] = sorted(a)
    return {}, meta


@case
def tables_by_seed(mesh, arrays, cfg):
    """Two trainers of other seeds: their gathered tables."""
    out = {}
    for seed in (1, 2):
        tr = _trainer(mesh, arrays, {**cfg, "seed": seed})
        full = tr.pserver.full_state()
        for name in tr.pserver.tables:
            out[f"seed{seed}.{name}"] = _np(full["tables"][name])
    return out, {}


@case
def lookup(mesh, arrays, cfg):
    """The all-to-all lookup and its backward into this rank's shard."""
    from paddle_tpu_torch.parallel import (shard_table,
                                           sharded_embedding_lookup)

    axis = cfg.get("axis", "model")
    shard = shard_table(mesh, torch.from_numpy(arrays["table"]), axis,
                        pad=cfg.get("pad", True)).requires_grad_()
    out = {}
    for i in range(cfg["n_ids"]):
        ids = torch.from_numpy(arrays[f"ids{i}"])
        rows = sharded_embedding_lookup(mesh, shard, ids, axis=axis)
        out[f"rows{i}"] = _np(rows)
        if f"ct{i}" in arrays:
            (g,) = torch.autograd.grad(
                (rows * torch.from_numpy(arrays[f"ct{i}"])).sum(), shard)
            out[f"grad{i}"] = _np(mesh.all_gather(g, axis, tag="test"))
    return out, {"shard_rows": int(shard.shape[0])}


@case
def push(mesh, arrays, cfg):
    """``sharded_row_update`` of (ids, row-grads) into an Adam table."""
    from paddle_tpu_torch.parallel import shard_table
    from paddle_tpu_torch.pserver import sharded_row_update

    axis = "model"
    opt = _optimizer(cfg)
    shard = shard_table(mesh, torch.from_numpy(arrays["table"]), axis)
    slots = opt.init_leaf(shard)
    dirty = torch.zeros(shard.shape[0], dtype=torch.bool)
    step = torch.zeros((), dtype=torch.int32)
    for _ in range(cfg["steps"]):
        step = step + 1
        sharded_row_update(mesh, opt, shard, slots, dirty,
                           torch.from_numpy(arrays["ids"]),
                           torch.from_numpy(arrays["g"]), axis=axis,
                           lr_eff=opt.lr_at(step), step=step,
                           decay=opt.l2_rate)
    out = {"table": _np(mesh.all_gather(shard, axis, tag="test")),
           "dirty": mesh.all_gather(dirty, axis, tag="test").numpy()}
    for i, s in enumerate(_leaves(slots)):
        out[f"slot{i}"] = _np(mesh.all_gather(s, axis, tag="test"))
    return out, {}


@case
def no_dense(mesh, arrays, cfg):
    """One tier step under a dispatch mode that records every tensor an
    operation makes, and the autograd graph's saved tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode

    tr = _trainer(mesh, arrays, cfg)
    feed = _feeds(arrays, cfg)[0]
    tr.train_batch(feed)          # warm: the first step's one-off work
    made, saved = [], []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            # an in-place op hands back its operand: nothing is made
            given = {a.data_ptr() for a in args if torch.is_tensor(a)}
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if torch.is_tensor(t) and t.data_ptr() not in given:
                    made.append((str(func), tuple(t.shape)))
            return out

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with Record():
            tr.train_batch(feed)
    shard = tr.pserver.tables["_u_emb.w0"]
    return {}, {"made": made, "saved": saved,
                "shard_rows": shard.shard_rows, "dim": shard.spec.dim,
                "vocab_padded": shard.vocab_padded}


@case
def mesh_checks(mesh, arrays, cfg):
    """Coordinates, per-axis groups and the size check."""
    from paddle_tpu_torch.utils.error import ConfigError

    got = {"coords": mesh.coords, "rank": mesh.rank}
    for axis in mesh.axis_names:
        x = torch.tensor([float(mesh.rank)])
        mesh.all_reduce([x], axis, tag="test")
        got[f"sum_{axis}"] = float(x)
        got[f"gather_{axis}"] = mesh.all_gather(
            torch.tensor([mesh.rank]), axis, tag="test").tolist()
    try:
        MeshConfig.of(data=mesh.size * 2).build()
        got["mismatch"] = None
    except ConfigError as e:
        got["mismatch"] = str(e)
    from paddle_tpu_torch.parallel import comm_stats

    got["stats"] = comm_stats()
    return {}, got


@case
def hang(mesh, arrays, cfg):
    """Rank 1 never reaches the collective rank 0 waits in."""
    import time

    print(f"rank {mesh.rank} about to wait", file=sys.stderr, flush=True)
    if mesh.rank == 1:
        time.sleep(3600)
    mesh.all_reduce([torch.ones(1)], mesh.axis_names[0], tag="test")
    return {}, {}


def main() -> int:
    name, d = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    with open(os.path.join(d, "in.json")) as f:
        cfg = json.load(f)
    with np.load(os.path.join(d, "in.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    D.initialize_distributed(device=cfg.get("device", "cpu"),
                             backend="gloo",
                             timeout_s=cfg.get("timeout_s", 100.0))
    mesh = MeshConfig.of(**cfg.get("mesh", {"data": D.world_size()})
                         ).build()
    out, meta = CASES[name](mesh, arrays, cfg)
    r = mesh.rank
    np.savez(os.path.join(d, f"out-{r}.npz"), **out)
    with open(os.path.join(d, f"out-{r}.json"), "w") as f:
        json.dump(meta, f)
    D.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
