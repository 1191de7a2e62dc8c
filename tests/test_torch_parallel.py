"""The port's data axis (``paddle_tpu_torch/parallel``) against the
reference's single-device computations, in real multi-process worlds.

Every world is 2 (or 4) ranks of ``tests/torch_dist_worker.py`` on gloo,
started by the port's own launcher through ``tests/torch_dist.py``: no
process group in the pytest worker, the rendezvous a file under
``tmp_path``, each world under its own time limit with the whole gang
killed past it.  Nothing of the reference is compiled over a mesh here:
the reference side is single-device ``jax.value_and_grad`` + ``Adam``, or
the reference's ``SGDTrainer`` without a mesh, at widths other than
``tests/test_parallel.py``'s; parameters cross through numpy.

Tolerances: ``tests/test_parallel.py:62-66``'s, loss rtol 1e-5,
parameters rtol 1e-4 / atol 1e-6.

The contract cases of ``tests/test_parallel.py`` run on the port where it
has the feature; the others skip, naming the ROADMAP.md item that ports
them.
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch.parallel as par
from paddle_tpu_torch.parallel.launcher import ClusterLauncher, GangTimeout
from paddle_tpu_torch.parallel.mesh import MeshConfig, parse_mesh_shape
from paddle_tpu_torch.utils.error import ConfigError
from tests.torch_dist import ROOT, run_world

RTOL_LOSS = 1e-5
RTOL_P, ATOL_P = 1e-4, 1e-6

WIDTHS = dict(src_vocab=40, trg_vocab=40, emb_dim=10, enc_dim=12,
              dec_dim=12, att_dim=10)
B, S, T = 6, 7, 5

LEFT = {
    "tp": "tensor-parallel ShardingRules on DTensor (ROADMAP.md Queue 1 "
          "item 8)",
    "ring": "parallel/ring_attention.py (ROADMAP.md Queue 1 item 8)",
    "pipe": "parallel/pipeline.py and pipeline_dsl.py (ROADMAP.md Queue 1 "
            "item 8)",
}


def _seq2seq_batch(rng):
    src = rng.randint(3, WIDTHS["src_vocab"], (B, S)).astype(np.int32)
    core = rng.randint(3, WIDTHS["trg_vocab"], (B, T - 1)).astype(np.int32)
    return {
        "src_ids": src,
        "src_len": rng.randint(2, S + 1, B).astype(np.int32),
        "trg_in": np.concatenate([np.zeros((B, 1), np.int32), core], 1),
        "trg_next": np.concatenate([core, np.ones((B, 1), np.int32)], 1),
        "trg_len": rng.randint(2, T + 1, B).astype(np.int32),
    }


# ---------------------------------------------------------------------------
# data parallelism against the reference
# ---------------------------------------------------------------------------


def test_data_parallel_matches_single_device(tmp_path, rng):
    """``make_parallel_train_step`` on 2 ranks, each on its half of the
    batch, == the reference's ``jax.value_and_grad(loss)`` + ``Adam`` on the
    whole batch, over 2 steps; the ranks end bit-equal."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models import Seq2SeqAttention
    from paddle_tpu.param.optimizers import Adam

    m = Seq2SeqAttention(**WIDTHS)
    params = {k: np.asarray(v) for k, v in
              m.init(jax.random.PRNGKey(3)).items()}
    batch = _seq2seq_batch(rng)
    opt = Adam(learning_rate=1e-3)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = opt.init_state(p)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(m.loss))
    ref_losses = []
    for _ in range(2):
        loss, g = grad_fn(p, jb)
        p, s = opt.update(p, g, s)
        ref_losses.append(float(loss))

    outs = run_world(tmp_path, 2, "dp_seq2seq",
                     {**{f"p.{k}": v for k, v in params.items()}, **batch},
                     {"widths": WIDTHS, "steps": 2, "batch_keys":
                      list(batch), "opt": "Adam",
                      "opt_kw": {"learning_rate": 1e-3}})
    (a0, j0), (a1, j1) = outs
    np.testing.assert_allclose(j0["losses"], ref_losses, rtol=RTOL_LOSS)
    assert j0["losses"] == j1["losses"]
    for k in params:
        np.testing.assert_allclose(a0[f"p.{k}"], np.asarray(p[k]),
                                   rtol=RTOL_P, atol=ATOL_P, err_msg=k)
        assert np.array_equal(a0[f"p.{k}"], a1[f"p.{k}"]), k


def _mlp_feeds(rng, n=3, b=8):
    return [{"x": rng.randn(b, 12).astype(np.float32),
             "label": rng.randint(0, 3, (b, 1)).astype(np.int32)}
            for _ in range(n)]


def _feed_arrays(feeds):
    """The feeds as ``feed<i>.<key>`` arrays; a sequence feed's lengths go
    under ``feed<i>.<key>.len``."""
    out = {}
    for i, f in enumerate(feeds):
        for k, v in f.items():
            if isinstance(v, tuple):
                out[f"feed{i}.{k}"], out[f"feed{i}.{k}.len"] = v
            else:
                out[f"feed{i}.{k}"] = v
    return out


def test_sgdtrainer_data_parallel_matches_reference_trainer(tmp_path, rng):
    """``SGDTrainer(mesh=MeshConfig.of(data=2))`` on 2 ranks, given the
    global batches, == the reference's ``SGDTrainer`` without a mesh on the
    same batches from the same parameters (losses and final parameters);
    the ranks end bit-equal.  A mean over rows weighs every rank the same,
    known from the shapes: one all-reduce a step, of the loss and the
    gradients."""
    import paddle_tpu.nn as jnn
    from paddle_tpu.param.optimizers import Adam
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    jnn.reset_naming()
    x = jnn.data("x", size=12)
    lab = jnn.data("label", size=1, dtype="int32")
    h = jnn.fc(x, 16, act="relu", name="h")
    logits = jnn.fc(h, 3, act="linear", name="out")
    cost = jnn.classification_cost(logits, lab, name="cost")
    jt = JaxTrainer(cost, Adam(learning_rate=1e-2), seed=4)
    p0 = {k: np.asarray(v) for k, v in jt.params.items()}
    feeds = _mlp_feeds(rng)
    ref = [float(jt.train_batch(f)) for f in feeds]
    outs = run_world(
        tmp_path, 2, "trainer",
        {**{f"p.{k}": v for k, v in p0.items()}, **_feed_arrays(feeds)},
        {"net": "mlp", "in_dim": 12, "hid": 16, "classes": 3,
         "opt": "Adam", "opt_kw": {"learning_rate": 1e-2},
         "n_feeds": len(feeds), "feed_keys": ["x", "label"],
         "mesh": {"data": 2}})
    (a0, j0), (a1, j1) = outs
    np.testing.assert_allclose(j0["losses"], ref, rtol=RTOL_LOSS)
    assert j0["digest"] == j1["digest"]
    assert j0["calls"] == {"grad_allreduce": len(feeds)}
    for k in p0:
        np.testing.assert_allclose(a0[f"p.{k}"], np.asarray(jt.params[k]),
                                   rtol=RTOL_P, atol=ATOL_P, err_msg=k)


def test_trainer_with_mesh_runs(tmp_path, rng):
    """``tests/test_parallel.py::test_trainer_with_mesh_runs`` on the port:
    ``SGDTrainer(mesh=...)`` end to end on 2 ranks, the loss falls."""
    feeds = _mlp_feeds(rng, n=1, b=16) * 12
    outs = run_world(
        tmp_path, 2, "trainer", _feed_arrays(feeds),
        {"net": "mlp", "in_dim": 12, "hid": 16, "classes": 3,
         "opt": "Adam", "opt_kw": {"learning_rate": 1e-2},
         "n_feeds": len(feeds), "feed_keys": ["x", "label"],
         "mesh": {"data": 2}})
    losses = outs[0][1]["losses"]
    assert losses[-1] < losses[0]
    assert outs[0][1]["digest"] == outs[1][1]["digest"]


SEQ = {"vocab": 30, "classes": 5}


def _seq_feeds(rng, with_rows, n=3, b=8, t=7):
    """Global batches whose first half (rank 0's rows) has 1-2 real tokens
    a row and whose second half has 6-7: the ranks' token counts differ
    about fivefold, so the mean of the ranks' token means is far from the
    global batch's token mean."""
    feeds = []
    for _ in range(n):
        lens = np.concatenate([rng.randint(1, 3, b // 2),
                               rng.randint(t - 1, t + 1, b // 2)]
                              ).astype(np.int32)
        f = {"ids": (rng.randint(0, SEQ["vocab"], (b, t)).astype(np.int32),
                     lens),
             "tags": (rng.randint(0, SEQ["classes"], (b, t)
                                  ).astype(np.int32), lens)}
        if with_rows:
            f["x"] = rng.randn(b, 4).astype(np.float32)
            f["y"] = rng.randn(b, 1).astype(np.float32)
        feeds.append(f)
    return feeds


def _jax_seq_net(net):
    """The reference's side of ``tests/torch_dist_worker.py``'s ``seqcls``
    nets: a token-mean sequence cost, and for ``seqcls3`` a row-mean
    ``mse_cost`` and a ``sum_cost`` beside it."""
    import paddle_tpu.nn as jnn

    jnn.reset_naming()
    ids = jnn.data("ids", size=SEQ["vocab"], is_seq=True, dtype="int32")
    tags = jnn.data("tags", size=SEQ["classes"], is_seq=True, dtype="int32")
    e = jnn.embedding(ids, 6, name="emb")
    h = jnn.fc(e, 8, act="tanh", name="h")
    logits = jnn.fc(h, SEQ["classes"], act="linear", name="out")
    cost = jnn.classification_cost(logits, tags, name="cost")
    if net == "seqcls":
        return cost
    x = jnn.data("x", size=4)
    y = jnn.data("y", size=1)
    g = jnn.fc(x, 1, act="linear", name="g")
    return [cost, jnn.mse_cost(g, y, name="rows"),
            jnn.sum_cost(g, name="total")]


@pytest.mark.parametrize("net,weights", [("seqcls", None),
                                         ("seqcls3", [1.0, 0.5, 0.01])])
def test_sgdtrainer_data_parallel_weights_each_cost_to_the_global_batch(
        tmp_path, rng, net, weights):
    """A sequence ``classification_cost`` (the mean over the real tokens)
    on 2 ranks whose slices hold very different token counts, alone and
    beside a row-mean ``mse_cost`` and a ``sum_cost``: ==  the reference's
    ``SGDTrainer`` without a mesh on the global batches (losses and final
    parameters); the ranks end bit-equal.  The token counts come from the
    data: one small all-reduce of them a step before the backward."""
    from paddle_tpu.param.optimizers import Adam
    from paddle_tpu.trainer import SGDTrainer as JaxTrainer

    jt = JaxTrainer(_jax_seq_net(net), Adam(learning_rate=1e-2), seed=4,
                    cost_weights=weights)
    p0 = {k: np.asarray(v) for k, v in jt.params.items()}
    feeds = _seq_feeds(rng, with_rows=net == "seqcls3")
    ref = [float(jt.train_batch(f)) for f in feeds]
    outs = run_world(
        tmp_path, 2, "trainer",
        {**{f"p.{k}": v for k, v in p0.items()}, **_feed_arrays(feeds)},
        {"net": net, **SEQ, "cost_weights": weights, "opt": "Adam",
         "opt_kw": {"learning_rate": 1e-2}, "n_feeds": len(feeds),
         "feed_keys": list(feeds[0]), "mesh": {"data": 2}})
    (a0, j0), (a1, j1) = outs
    np.testing.assert_allclose(j0["losses"], ref, rtol=RTOL_LOSS)
    assert j0["losses"] == j1["losses"]
    assert j0["digest"] == j1["digest"]
    assert j0["calls"] == {"grad_allreduce": len(feeds),
                           "loss_norm_allreduce": len(feeds)}
    for k in p0:
        np.testing.assert_allclose(a0[f"p.{k}"], np.asarray(jt.params[k]),
                                   rtol=RTOL_P, atol=ATOL_P, err_msg=k)


def _cost_case(kind):
    """-> (a port cost layer of ``kind``, a feed of 6 rows whose first half
    is shorter where the input is a sequence)."""
    import paddle_tpu_torch.nn as tnn

    r = np.random.RandomState(5)
    B, T = 6, 5
    lens = np.array([1, 2, 2, 5, 4, 5], np.int32)
    tnn.reset_naming()
    x = tnn.data("x", size=4)
    feed = {"x": r.randn(B, 4).astype(np.float32)}

    def seq_in(size, lengths=lens):
        ids = tnn.data("ids", size=9, is_seq=True, dtype="int32")
        feed["ids"] = (r.randint(0, 9, (B, T)).astype(np.int32), lengths)
        return tnn.fc(tnn.embedding(ids, 4), size, act="linear")

    def ints(name, n, size=1, seq=None):
        lab = tnn.data(name, size=n, is_seq=seq is not None, dtype="int32")
        v = r.randint(0, n, (B, T) if seq is not None else (B, size))
        feed[name] = (v.astype(np.int32), seq) if seq is not None else \
            v.astype(np.int32)
        return lab

    def floats(name, size, value):
        feed[name] = value.astype(np.float32)
        return tnn.data(name, size=size)

    if kind == "classification":
        return tnn.classification_cost(tnn.fc(x, 3, act="linear"),
                                       ints("label", 3)), feed
    if kind == "classification_seq":
        return tnn.classification_cost(seq_in(3),
                                       ints("tags", 3, seq=lens)), feed
    if kind == "selfnorm":
        return tnn.cross_entropy_with_selfnorm(
            tnn.fc(x, 3, act="linear"), ints("label", 3)), feed
    if kind == "soft_ce":
        p = r.rand(B, 3)
        return tnn.soft_cross_entropy_cost(
            tnn.fc(x, 3, act="linear"),
            floats("p", 3, p / p.sum(1, keepdims=True))), feed
    if kind == "mbce":
        return tnn.multi_binary_label_cross_entropy(
            tnn.fc(x, 3, act="linear"),
            floats("m", 3, (r.rand(B, 3) > 0.5) * 1.0)), feed
    if kind in ("mse", "huber", "smooth_l1"):
        layer = {"mse": tnn.mse_cost, "huber": tnn.huber_cost,
                 "smooth_l1": tnn.smooth_l1_cost}[kind]
        return layer(tnn.fc(x, 2, act="linear"),
                     floats("y", 2, r.randn(B, 2) * 2)), feed
    if kind == "rank":
        return tnn.rank_cost(tnn.fc(x, 1, act="linear"),
                             tnn.fc(x, 1, act="linear"),
                             floats("l", 1, (r.rand(B, 1) > 0.5) * 1.0)
                             ), feed
    if kind == "sum":
        return tnn.sum_cost(tnn.fc(x, 2, act="linear")), feed
    if kind == "crf":
        return tnn.crf_cost(seq_in(3), ints("tags", 3, seq=lens)), feed
    if kind == "ctc":
        logits = seq_in(4, np.array([3, 3, 3, 5, 5, 5], np.int32))
        lab = tnn.data("lab", size=3, is_seq=True, dtype="int32")
        feed["lab"] = (r.randint(0, 3, (B, 2)).astype(np.int32),
                       np.array([1, 1, 1, 2, 2, 2], np.int32))
        return tnn.ctc_cost(logits, lab), feed
    if kind == "hsigmoid":
        return tnn.hsigmoid_cost(tnn.fc(x, 4, act="linear"),
                                 ints("label", 5), num_classes=5), feed
    assert kind == "lambda"
    rel = tnn.data("rel", size=1, is_seq=True)
    feed["rel"] = (r.randint(0, 3, (B, T, 1)).astype(np.float32), lens)
    return tnn.lambda_cost(seq_in(1), rel), feed


COST_KINDS = ["classification", "classification_seq", "selfnorm",
              "soft_ce", "mbce", "mse", "huber", "smooth_l1", "rank", "sum",
              "crf", "ctc", "hsigmoid", "lambda"]


@pytest.mark.parametrize("kind", COST_KINDS)
def test_cost_norm_weights_the_halves_to_the_whole_batch(kind):
    """Each cost layer's ``COST_NORM`` is what its value averages over: its
    value on each half of a batch (``shard_batch`` on a data axis of 2)
    times that half's share (its norm over both halves' total; 1 for a
    sum) sums to its value on the whole batch, which is what a data axis
    of 2 ranks computes."""
    from paddle_tpu_torch.nn.graph import COST_NORM, Topology
    from paddle_tpu_torch.ops import compute_dtype_scope

    cost, feed = _cost_case(kind)
    topo = Topology([cost], device="cpu")
    with compute_dtype_scope("float32"):
        params, state = topo.init(0)

        def run(f):
            a = topo.apply(params, state, f)[0][cost.name]
            norm = a.state[COST_NORM]
            return a.value, None if norm is None else float(norm)

        whole, _ = run(feed)
        halves = [run(par.shard_batch(
            par.Mesh(MeshConfig.of(data=2), i, {}, torch.device("cpu")),
            feed)) for i in (0, 1)]
    norms = [d for _, d in halves]
    if kind == "sum":
        assert norms == [None, None]
        shares = [1.0, 1.0]
    else:
        shares = [d / max(sum(norms), 1.0) for d in norms]
        if kind in ("classification_seq", "lambda"):
            assert norms[0] < norms[1]       # the halves weigh unequally
    got = sum(float(v) * sh for (v, _), sh in zip(halves, shares))
    assert np.isfinite(float(whole))
    np.testing.assert_allclose(got, float(whole), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["batch_norm", "data_norm",
                                  "unweighted_cost"])
def test_data_axis_refuses_what_it_cannot_weight(case):
    """On a data axis of 2 (a ``Mesh`` bound by hand: these refusals come
    before any collective), a layer of batch statistics is refused at
    construction, naming ROADMAP.md item 8 (each rank would normalise by
    its slice's statistics, the reference by the global batch's); a cost
    layer that does not report what it averages over is refused at its
    first step.  A world of one takes both."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.nn.graph import Act, LayerOutput
    from paddle_tpu_torch.trainer import SGDTrainer

    tnn.reset_naming()
    x = tnn.data("x", size=4)
    lab = tnn.data("label", size=1, dtype="int32")
    h = tnn.fc(x, 6, act="linear")
    if case == "batch_norm":
        h = tnn.batch_norm(h)
    elif case == "data_norm":
        h = tnn.data_norm(h)
    out = tnn.fc(h, 3, act="linear")
    cost = tnn.classification_cost(out, lab)
    if case == "unweighted_cost":
        cost = LayerOutput("plain_mean", "plain_mean", 1, [out],
                           lambda ctx, params, a: Act(value=a.value.mean()))
    feed = {"x": np.ones((4, 4), np.float32),
            "label": np.zeros((4, 1), np.int32)}
    cpu = torch.device("cpu")
    one = SGDTrainer(cost, mesh=MeshConfig.of(data=1), device="cpu")
    assert np.isfinite(float(one.train_batch(feed)))
    two = par.Mesh(MeshConfig.of(data=2), 0, {}, cpu)
    if case != "unweighted_cost":
        with pytest.raises(ConfigError, match=r"batch statistics.*item 8"):
            SGDTrainer(cost, mesh=two, device="cpu")
        return
    tr = SGDTrainer(cost, mesh=two, device="cpu")
    with pytest.raises(ConfigError, match="does not report what its value"):
        tr.train_batch(feed)


# ---------------------------------------------------------------------------
# the launched command line
# ---------------------------------------------------------------------------

CLI_ENV = {"TORCH_TEXTCLF_VOCAB": "40", "TORCH_TEXTCLF_EMB": "6",
           "TORCH_TEXTCLF_HID": "8", "TORCH_TEXTCLF_BATCH": "8",
           "TORCH_TEXTCLF_T": "9", "TORCH_TEXTCLF_N": "24",
           "TORCH_TEXTCLF_TEST_N": "8"}


@pytest.fixture
def restore_flags():
    from paddle_tpu_torch.utils.flags import FLAGS

    before = FLAGS.as_dict()
    yield
    for k, v in before.items():
        setattr(FLAGS, k, v)


def test_cli_train_in_a_launched_world_matches_one_process(
        tmp_path, monkeypatch, restore_flags):
    """``python -m paddle_tpu_torch --job=train --mesh_shape=2`` on 2 ranks
    of the launcher (global batch 8, 4 a rank) == the same command in one
    process: losses, and rank 0's checkpoint against the one-process one;
    both ranks print the same parameter digest."""
    from paddle_tpu_torch.__main__ import main
    from paddle_tpu_torch.resilience.checkpoint_io import pass_dir

    conf = os.path.join(ROOT, "tests", "torch_textclf_conf.py")
    for k, v in CLI_ENV.items():
        monkeypatch.setenv(k, v)
    one = str(tmp_path / "one")
    args = ["--job=train", f"--config={conf}", "--device=cpu",
            "--num_passes=1", "--log_period=0", "--compute_dtype=float32"]
    assert main(args + [f"--save_dir={one}"]) == 0
    with np.load(os.path.join(pass_dir(one, 0), "params.npz")) as z:
        want = {k: z[k] for k in z.files}

    d = str(tmp_path / "world")
    launcher = par.launch_local(
        2, "-m", ["paddle_tpu_torch", *args, "--mesh_shape=2",
                  f"--save_dir={d}/ck"],
        env={**CLI_ENV, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": ROOT + os.pathsep
             + os.environ.get("PYTHONPATH", "")},
        coordinator=f"file://{d}/rendezvous", backend="gloo",
        log_dir=f"{d}/logs", cwd=ROOT)
    codes = launcher.join(120)
    assert codes == [0, 0], launcher.stderr_tails()
    lines = []
    for r in range(2):
        with open(f"{d}/logs/rank-{r}.out") as f:
            lines.append(json.loads(f.read().strip().splitlines()[-1]))
    assert [x["rank"] for x in lines] == [0, 1]
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
    assert lines[0]["losses"] == lines[1]["losses"]
    assert len(lines[0]["losses"]) == 3
    with np.load(os.path.join(pass_dir(f"{d}/ck", 0), "params.npz")) as z:
        got = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_P,
                                   atol=ATOL_P, err_msg=k)


def test_cli_mesh_shape_must_equal_the_world(restore_flags):
    """``--mesh_shape=2`` outside a launched world: a ``ConfigError``
    naming both numbers."""
    from paddle_tpu_torch.__main__ import main

    conf = os.path.join(ROOT, "tests", "torch_textclf_conf.py")
    with pytest.raises(ConfigError, match=r"2 ranks.*1 process"):
        main(["--job=train", f"--config={conf}", "--device=cpu",
              "--mesh_shape=2"])


# ---------------------------------------------------------------------------
# the world: mesh groups, the launcher's limits
# ---------------------------------------------------------------------------


def test_mesh_groups_of_a_4_rank_world(tmp_path):
    """data=2 x model=2: each rank's coordinates (row-major), the sum and
    gather over each axis's group, and a size mismatch naming both
    numbers."""
    outs = run_world(tmp_path, 4, "mesh_checks", {},
                     {"mesh": {"data": 2, "model": 2}})
    for r, (_, got) in enumerate(outs):
        assert got["rank"] == r
        assert got["coords"] == {"data": r // 2, "model": r % 2}
        assert got["sum_data"] == float(r % 2 + (r % 2 + 2))
        assert got["sum_model"] == float(2 * (r // 2) * 2 + 1)
        assert got["gather_model"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["gather_data"] == [r % 2, r % 2 + 2]
        assert "8 ranks" in got["mismatch"]
        assert "4 process" in got["mismatch"]
        assert got["stats"]["test"]["calls"] == 4


def test_a_hung_rank_kills_the_gang_within_its_limit(tmp_path):
    """A rank that never reaches a collective: once both ranks are up, a
    short limit kills every rank, and the error carries each rank's
    stderr tail."""
    import time

    d = tmp_path / "world"
    d.mkdir()
    np.savez(d / "in.npz")
    (d / "in.json").write_text(json.dumps({"mesh": {"data": 2}}))
    launcher = par.launch_local(
        2, os.path.join(ROOT, "tests", "torch_dist_worker.py"),
        ["hang", str(d)],
        env={"OMP_NUM_THREADS": "1", "PADDLE_TPU_TORCH_DEVICE": "cpu",
             "PYTHONPATH": ROOT},
        coordinator=f"file://{d}/rendezvous", backend="gloo",
        log_dir=str(d / "logs"), cwd=ROOT)
    try:
        deadline = time.time() + 100
        while time.time() < deadline and not all(
                "about to wait" in (d / "logs" / f"rank-{r}.err").read_text()
                for r in range(2)):
            assert None in launcher.poll(), launcher.stderr_tails()
            time.sleep(0.2)
        with pytest.raises(GangTimeout) as info:
            launcher.join(3)
    finally:
        launcher.kill_gang()
    assert launcher.poll() == [-9, -9]
    msg = str(info.value)
    assert "rank 0 about to wait" in msg and "rank 1 about to wait" in msg


def test_launcher_wiring_and_refusals(tmp_path):
    """Each rank's environment: rendezvous, world, rank, local rank and
    local world, backend; ``launch_supervised`` names item 9."""
    lau = ClusterLauncher(hosts=["localhost", "localhost", "user@10.0.0.2"],
                          backend="gloo")
    w = lau._wiring(1)
    assert w["PADDLE_TPU_TORCH_COORDINATOR"] == "tcp://127.0.0.1:12355"
    assert (w["PADDLE_TPU_TORCH_NUM_PROCESSES"],
            w["PADDLE_TPU_TORCH_PROCESS_ID"],
            w["PADDLE_TPU_TORCH_LOCAL_RANK"],
            w["PADDLE_TPU_TORCH_LOCAL_WORLD"],
            w["PADDLE_TPU_TORCH_DIST_BACKEND"]) == ("3", "1", "1", "2",
                                                   "gloo")
    assert lau._wiring(2)["PADDLE_TPU_TORCH_LOCAL_RANK"] == "0"
    spec = lau._rank_spec(2, "train.py", ["--x=1"], None, "/w")
    assert spec["args"][-2] == "user@10.0.0.2"
    assert "PADDLE_TPU_TORCH_PROCESS_ID=2" in spec["args"][-1]
    lau = ClusterLauncher(hosts=["localhost"],
                          coordinator=f"file://{tmp_path}/r")
    assert lau._wiring(0)["PADDLE_TPU_TORCH_COORDINATOR"] == \
        f"file://{tmp_path}/r"
    with pytest.raises(ConfigError, match="item 9"):
        par.launch_supervised(2, "x.py")


# ---------------------------------------------------------------------------
# single-process pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes,kw", [
    ((("data", 4),), {}),
    ((("data", 2), ("model", 2)), {"pserver_axis": "model"}),
    ((("dcn", 2), ("data", 2), ("model", 3)), {"dcn_axis": "dcn",
                                               "elastic_axis": "data"}),
])
def test_mesh_config_matches_the_reference(axes, kw):
    """Shape queries, resize, fit_world and the JSON form equal the
    reference's ``MeshConfig`` (which builds nothing here)."""
    from paddle_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    mine, theirs = MeshConfig(axes, **kw), JaxMeshConfig(axes, **kw)
    assert mine.to_json() == theirs.to_json()
    assert MeshConfig.from_json(mine.to_json()) == mine
    assert (mine.size, mine.shape, mine.axis_names, mine.dcn_size,
            mine.pod_size) == (theirs.size, theirs.shape, theirs.axis_names,
                               theirs.dcn_size, theirs.pod_size)
    assert mine.axis_size("absent") == 1
    for n in (mine.size, mine.size * 2, mine.size + 1):
        assert mine.fit_world(n).to_json() == theirs.fit_world(n).to_json()
    assert (mine.resize(data=3, extra=2).to_json()
            == theirs.resize(data=3, extra=2).to_json())
    for r in range(mine.size):
        assert mine.rank_of(mine.coords_of(r)) == r
        assert mine.pod_of(r) == theirs.pod_of(r)
    assert repr(mine) == repr(theirs)


def test_mesh_config_naming_and_errors():
    from paddle_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    for shape, names in (((4,), None), ((2, 2), ["data", "model"]),
                         ((2, 3), ["x"])):
        assert (MeshConfig.named(shape, names).to_json()
                == JaxMeshConfig.named(shape, names).to_json())
    with pytest.raises(ConfigError, match="duplicate"):
        MeshConfig((("data", 2), ("data", 2)))
    with pytest.raises(ConfigError, match=">= 1"):
        MeshConfig.of(data=0)
    with pytest.raises(ConfigError, match="cannot fit"):
        MeshConfig.of(data=2, model=4).fit_world(3)
    assert parse_mesh_shape("", 3) == (3,)
    assert parse_mesh_shape("4x2", 1) == parse_mesh_shape("4,2", 1) == (4, 2)
    assert MeshConfig.of(data=2, model=3).axis_groups("data") == [
        [0, 3], [1, 4], [2, 5]]


def test_world_of_one_needs_no_launcher():
    """A size-1 config builds with no process group; a bigger one in a
    single process names both numbers."""
    mesh = MeshConfig.of(data=1).build(torch.device("cpu"))
    assert mesh.groups == {} and mesh.rank == 0
    x = torch.ones(3)
    mesh.all_reduce([x], "data", tag="t")
    assert torch.equal(x, torch.ones(3))
    assert mesh.all_to_all(x, "data", tag="t") is x
    with pytest.raises(ConfigError, match=r"4 ranks.*1 process"):
        MeshConfig.of(data=4).build(torch.device("cpu"))
    assert par.as_mesh(mesh) is mesh and par.as_mesh(None) is None


def test_backend_choice_is_explicit():
    """NCCL on the CPU, and NCCL for more ranks than cards, raise before
    any process group exists; no backend is switched behind a try."""
    from paddle_tpu_torch.parallel import distributed as D

    with pytest.raises(ConfigError, match="needs a card"):
        D.initialize_distributed("file:///nonexistent/r", 2, 0,
                                 backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()
    assert D.world_size() == 1 and D.rank() == 0


def test_make_parallel_train_step_world_of_one_is_the_plain_step():
    """On a world of one the step is ``value_and_grad`` + ``update``, bit
    for bit."""
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.ops import compute_dtype_scope
    from paddle_tpu_torch.param.optimizers import Adam

    rng = np.random.RandomState(1)
    m = Seq2SeqAttention(**WIDTHS, device="cpu")
    batch = _seq2seq_batch(rng)
    with compute_dtype_scope("float32"):
        a = m.init(0)
        b = {k: v.clone() for k, v in a.items()}
        opt = Adam(learning_rate=1e-3)
        sa, sb = opt.init_state(a), opt.init_state(b)
        step = par.make_parallel_train_step(
            m.loss, opt, MeshConfig.of(data=1).build(torch.device("cpu")))
        loss, a, sa = step(a, sa, par.shard_batch(
            MeshConfig.of(data=1).build(torch.device("cpu")), batch))
        leaves = {k: v.detach().requires_grad_() for k, v in b.items()}
        ref = m.loss(leaves, batch)
        g = torch.autograd.grad(ref, list(leaves.values()),
                                allow_unused=True)
        opt.update(b, {k: (torch.zeros_like(v) if x is None else x)
                       for (k, v), x in zip(leaves.items(), g)}, sb)
    assert float(loss) == float(ref.detach())
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sgdtrainer_world_of_one_is_bit_equal_to_no_mesh(rng):
    """``SGDTrainer(mesh=MeshConfig.of(data=1))`` == no mesh, bit for
    bit."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.ops import compute_dtype_scope
    from paddle_tpu_torch.param.optimizers import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    def build():
        tnn.reset_naming()
        x = tnn.data("x", size=12)
        lab = tnn.data("label", size=1, dtype="int32")
        out = tnn.fc(tnn.fc(x, 16, act="relu"), 3, act="linear")
        return tnn.classification_cost(out, lab)

    feeds = _mlp_feeds(rng, n=3)
    with compute_dtype_scope("float32"):
        a = SGDTrainer(build(), Adam(learning_rate=1e-2), seed=2,
                       device="cpu")
        b = SGDTrainer(build(), Adam(learning_rate=1e-2), seed=2,
                       device="cpu", mesh=MeshConfig.of(data=1))
        la = [float(a.train_batch(f)) for f in feeds]
        lb = [float(b.train_batch(f)) for f in feeds]
    assert la == lb
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_each_data_slice_draws_its_own_dropout(rate):
    """The two ranks of a data axis of 2 (``Mesh``es bound by hand: a mean
    over rows needs no exchange before the backward, so each steps alone)
    given a global batch whose halves are equal: with dropout their losses
    differ, as rows of one global draw would, where one seed for both would
    repeat each mask; without it they are equal."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.ops import compute_dtype_scope
    from paddle_tpu_torch.param.optimizers import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    half = _mlp_feeds(np.random.RandomState(3), n=1, b=4)[0]
    feed = {k: np.concatenate([v, v]) for k, v in half.items()}
    losses = []
    for i in (0, 1):
        tnn.reset_naming()
        x = tnn.data("x", size=12)
        lab = tnn.data("label", size=1, dtype="int32")
        h = tnn.dropout(tnn.fc(x, 16, act="relu"), rate)
        cost = tnn.classification_cost(tnn.fc(h, 3, act="linear"), lab)
        mesh = par.Mesh(MeshConfig.of(data=2), i, {}, torch.device("cpu"))
        with compute_dtype_scope("float32"):
            tr = SGDTrainer(cost, Adam(learning_rate=1e-2), seed=2,
                            device="cpu", mesh=mesh)
            losses.append(float(tr.train_batch(feed)))
    assert (losses[0] != losses[1]) == (rate > 0), losses


def test_shard_batch_cuts_rows_and_refuses_uneven():
    """Rank 1 of a data axis of 2 (a ``Mesh`` bound by hand: slicing needs
    no process group)."""
    half = par.Mesh(MeshConfig.of(data=2), 1, {}, torch.device("cpu"))
    feed = {"x": np.arange(8).reshape(4, 2),
            "s": (np.arange(4), np.array([1, 2, 3, 4]))}
    out = par.shard_batch(half, feed)
    assert out["x"].tolist() == [[4, 5], [6, 7]]
    assert out["s"][1].tolist() == [3, 4]
    with pytest.raises(ConfigError, match="does not divide"):
        par.shard_batch(half, {"x": np.zeros((3, 1))})


def test_sharding_rules_match_the_reference_and_refuse_tensor_parallel():
    from paddle_tpu.parallel.sharding import ShardingRules as JRules
    from paddle_tpu.parallel.sharding import P as JP

    rules = [("*_emb", ("model", None)), ("out_w", (None, "model")),
             ("*", ())]
    mine = par.ShardingRules([(p, par.P(*s)) for p, s in rules])
    theirs = JRules([(p, JP(*s)) for p, s in rules])
    for name, ndim in (("src_emb", 2), ("out_w", 2), ("out_w", 1),
                       ("dec_b", 1)):
        assert tuple(mine.spec_for(name, ndim)) == tuple(
            theirs.spec_for(name, ndim))
    mesh = MeshConfig.of(data=1).build(torch.device("cpu"))
    p = {"src_emb": torch.zeros(4, 2), "dec_b": torch.zeros(2)}
    out = par.shard_params(mesh, p, par.ShardingRules([("*", par.P())]))
    assert set(out) == set(p) and out["src_emb"] is not p["src_emb"]
    with pytest.raises(ConfigError, match=r"tensor parallelism.*item 8"):
        par.shard_params(mesh, p, mine)
    assert par.batch_sharding(mesh, 3) == par.P("data", None, None)
    assert par.replicated(mesh) == par.P()


def test_hierarchy_and_agreement_refusals():
    from paddle_tpu.param.optimizers import Adam

    cfg = MeshConfig((("dcn", 1), ("data", 1)), dcn_axis="dcn")
    with pytest.raises(ConfigError, match=r"hierarchical.*item 8"):
        par.make_parallel_train_step(lambda p, b: 0.0, Adam(), cfg)
    mesh = MeshConfig.of(data=1).build(torch.device("cpu"))
    with pytest.raises(ConfigError, match="needs >=2 replicas"):
        par.agreement_spec(mesh)
    with pytest.raises(ConfigError, match="not in mesh axes"):
        par.agreement_spec(mesh, "model")


def test_make_mesh_and_dump_trainer_config_take_the_mesh(restore_flags):
    """``devices.make_mesh`` from the flags and ``dump_trainer_config(mesh=)``
    (the reference writes the axis names and sizes)."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.config.config_parser import dump_trainer_config
    from paddle_tpu_torch.param.optimizers import SGD
    from paddle_tpu_torch.utils import devices
    from paddle_tpu_torch.utils.flags import FLAGS

    FLAGS.device = "cpu"
    mesh = devices.make_mesh()
    assert mesh.config.to_json()["axes"] == [["data", 1]]
    FLAGS.mesh_shape, FLAGS.mesh_axes = "1x1", "data,model"
    assert devices.make_mesh().axis_names == ("data", "model")
    tnn.reset_naming()
    x = tnn.data("x", size=3)
    cost = tnn.mse_cost(tnn.fc(x, 1), tnn.data("y", size=1))
    tc = dump_trainer_config(tnn.Topology(cost, device="cpu"), SGD(),
                             mesh=MeshConfig.of(data=4, model=2))
    assert list(tc.mesh_axes) == ["data", "model"]
    assert list(tc.mesh_shape) == [4, 2]


@pytest.mark.skip(reason=LEFT["tp"])
def test_tensor_parallel_matches_single_device():
    """tests/test_parallel.py's DP x TP step."""


@pytest.mark.skip(reason=LEFT["tp"])
def test_sgdtrainer_tensor_parallel_matches_single():
    """tests/test_parallel.py's SGDTrainer with sharding rules."""


@pytest.mark.skip(reason=LEFT["ring"])
@pytest.mark.parametrize("case", ["full", "causal", "grads"])
def test_ring_attention(case):
    """tests/test_parallel.py's three ring-attention cases."""


@pytest.mark.skip(reason=LEFT["pipe"])
@pytest.mark.parametrize("case", ["forward", "uneven", "dp_pp_train"])
def test_pipeline(case):
    """tests/test_parallel.py's three pipeline cases."""
