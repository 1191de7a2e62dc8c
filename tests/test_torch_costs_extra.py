"""CTC, NCE, the hierarchical sigmoid, ``selective_fc``, ``sampling_id``
and ``data_norm``'s training pass of the port against the JAX package, on
the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_costs_extra.py -q

``ctc_loss`` is also held against the sum over every alignment
(``tests/test_crf_ctc.py:94-124``).  NCE's noise classes and
``sampling_id``'s ids are drawn from one numpy draw keyed by the shape in
both packages (``share_draws``: ``jax.random.randint`` /
``jax.random.categorical`` patched for the test's duration, and the
port's ``uniform_classes`` / ``categorical``); the port's own
``sampling_id`` draws are checked against ``softmax(input)`` unpatched.

Tolerance: rtol 1e-5 / atol 1e-6 (of the larger of 1 and the reference's
largest entry for ``close``; each gradient's largest difference against its
largest entry for nets); against brute force rtol 1e-4 / atol 1e-5, the
reference test's.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.ops as JO

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
from paddle_tpu_torch.ops import compute_dtype_scope

from torch_compare import (assert_grads_close, close, fwd_grad,
                           loss_and_grads, nonzero_params, share_draws)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


@pytest.fixture
def shared_draws(monkeypatch):
    share_draws(monkeypatch)


def _log_softmax(x):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _brute_force_ctc(lp, label, T, blank):
    """-log of the summed probability of every length-T alignment that
    collapses to ``label``."""
    total = -np.inf
    for path in itertools.product(range(lp.shape[1]), repeat=T):
        col, prev = [], None
        for c in path:
            if c != blank and c != prev:
                col.append(c)
            prev = c
        if col == list(label):
            total = np.logaddexp(total, sum(lp[t, path[t]] for t in range(T)))
    return -total


# ---------------------------------------------------------------------------
# ctc_loss
# ---------------------------------------------------------------------------

CTC_CASES = {
    # name: (labels, label lengths, input lengths, blank, norm_by_times)
    "blank_first": ([[1, 2, 0], [2, 2, 1], [3, 0, 0]], [2, 3, 1],
                    [5, 6, 4], 0, False),
    "blank_last": ([[0, 1, 2], [2, 2, 1], [0, 0, 0]], [3, 2, 1],
                   [6, 5, 3], 4, False),
    "norm_by_times": ([[1, 2, 0], [3, 1, 2], [1, 1, 1]], [2, 3, 3],
                      [6, 4, 6], 0, True),
    "zero_length_label": ([[0, 0, 0], [1, 2, 0], [0, 0, 0]], [0, 2, 0],
                          [6, 5, 2], 0, False),
    # row 1: 3 labels with a repeat need 4 frames, it has 3; row 2: 3
    # frames for 3 distinct labels fit exactly
    "infeasible": ([[1, 2, 3], [2, 2, 1], [1, 2, 3]], [3, 3, 3],
                   [6, 3, 3], 0, False),
}


def _ctc_inputs(case, B=3, T=6, C=5, seed=0):
    labels, lab_len, in_len, blank, norm = CTC_CASES[case]
    logits = np.random.RandomState(seed).randn(B, T, C).astype(np.float32)
    return (_log_softmax(logits), np.asarray(labels, np.int32),
            np.asarray(in_len, np.int32), np.asarray(lab_len, np.int32),
            blank, norm)


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_loss_and_its_gradient_match_reference(case):
    lp, labels, in_len, lab_len, blank, norm = _ctc_inputs(case)
    fwd_grad(lambda x, y, i, l: JO.ctc_loss(x, y, i, l, blank=blank,
                                            norm_by_times=norm),
             lambda x, y, i, l: TO.ctc_loss(x, y, i, l, blank=blank,
                                            norm_by_times=norm),
             lp, labels, in_len, lab_len, argnums=(0,))


@pytest.mark.parametrize("case", ["blank_first", "blank_last",
                                  "zero_length_label", "norm_by_times"])
def test_ctc_loss_equals_the_sum_over_alignments(case):
    lp, labels, in_len, lab_len, blank, norm = _ctc_inputs(case, T=5, C=4)
    labels = np.minimum(labels, 2 if blank == 3 else 3)
    if blank == 4:
        blank = 3
    in_len = np.minimum(in_len, 5)
    got = TO.ctc_loss(*(torch.tensor(a) for a in
                        (lp, labels, in_len, lab_len)), blank=blank,
                      norm_by_times=norm).numpy()
    for b in range(3):
        want = _brute_force_ctc(lp[b, :in_len[b]], labels[b, :lab_len[b]],
                                int(in_len[b]), blank)
        if norm:
            want /= in_len[b]
        np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-5)


def test_ctc_infeasible_label_is_large_and_finite_with_a_finite_gradient():
    lp, labels, in_len, lab_len, blank, _ = _ctc_inputs("infeasible")
    x = torch.tensor(lp, requires_grad=True)
    loss = TO.ctc_loss(x, torch.tensor(labels), torch.tensor(in_len),
                       torch.tensor(lab_len), blank=blank)
    assert loss[1] > 1e29 and torch.isfinite(loss).all()
    assert loss[0] < 100 and loss[2] < 100
    (g,) = torch.autograd.grad(loss.sum(), x)
    assert torch.isfinite(g).all()


def _ctc_net(nn, kind, C=5, **kw):
    xs = nn.data("xs", size=4, is_seq=True)
    lab = nn.data("lab", size=C - 1, is_seq=True, dtype="int32")
    emit = nn.fc(xs, C, act="linear", name="emit")
    return getattr(nn, kind)(emit, lab, name="cost", **kw)


def test_warp_ctc_on_rolled_logits_equals_ctc_cost():
    """``warp_ctc`` (blank 0) over logits whose class axis is rolled by one
    (the last-index blank moved to 0), labels raised by one, equals
    ``ctc_cost`` (blank last): the two differ only in the default blank."""
    rs = np.random.RandomState(5)
    B, T, C = 3, 7, 5
    logits = rs.randn(B, T, C).astype(np.float32)
    lengths = np.array([7, 5, 3], np.int32)
    labels = rs.randint(0, C - 1, (B, 3)).astype(np.int32)
    lab_len = np.array([3, 2, 1], np.int32)
    got = {}
    for kind, x, y in (("ctc_cost", logits, labels),
                       ("warp_ctc", np.roll(logits, 1, axis=-1),
                        labels + 1)):
        tnn.reset_naming()
        v = tnn.data("v", size=C, is_seq=True)
        lab = tnn.data("lab", size=C - 1, is_seq=True, dtype="int32")
        cost = getattr(tnn, kind)(v, lab)
        topo = tnn.Topology(cost, device="cpu")
        got[kind] = topo.apply({}, {}, {"v": (x, lengths),
                                        "lab": (y, lab_len)})[0][
            cost.name].value.item()
    assert got["warp_ctc"] == pytest.approx(got["ctc_cost"], rel=1e-6)


@pytest.mark.parametrize("kind,kw", [("ctc_cost", {}),
                                     ("ctc_cost", {"norm_by_times": True}),
                                     ("warp_ctc", {}),
                                     ("warp_ctc", {"blank": 2})])
def test_ctc_layers_match_reference(kind, kw):
    rs = np.random.RandomState(6)
    B, T = 3, 7
    labels = rs.randint(0, 4, (B, 3)).astype(np.int32)
    if kind == "warp_ctc":
        labels = np.where(labels == kw.get("blank", 0), 4, labels)
    feed = {"xs": (rs.randn(B, T, 4).astype(np.float32),
                   np.array([7, 4, 6], np.int32)),
            "lab": (labels, np.array([3, 1, 2], np.int32))}
    jnn.reset_naming()
    jt = jnn.Topology(_ctc_net(jnn, kind, **kw))
    tnn.reset_naming()
    tt = tnn.Topology(_ctc_net(tnn, kind, **kw), device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(0))
    jv, jg, tv, tg = loss_and_grads(jt, tt, "cost", nonzero_params(jp), js,
                                    feed)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)


def test_ctc_cost_refuses_labels_that_reach_the_default_blank():
    msgs = []
    for nn in (jnn, tnn):
        nn.reset_naming()
        v = nn.data("v", size=5, is_seq=True)
        lab = nn.data("lab", size=5, is_seq=True, dtype="int32")
        with pytest.raises(Exception) as info:
            nn.ctc_cost(v, lab, name="c")
        msgs.append((type(info.value).__name__, str(info.value)))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# NCE and the hierarchical sigmoid
# ---------------------------------------------------------------------------


def _sampled_net(nn, kind, C, D=6, **kw):
    x = nn.data("x", size=5)
    h = nn.fc(x, D, act="tanh", name="h")
    lab = nn.data("lab", size=C, dtype="int32")
    return getattr(nn, kind)(h, lab, num_classes=C, name="cost", **kw)


@pytest.mark.parametrize("kind,C,kw", [
    ("nce_cost", 50, {"num_neg_samples": 5}),
    ("nce_cost", 7, {}),
    ("hsigmoid_cost", 16, {}),
    ("hsigmoid_cost", 30, {}),
    ("hsigmoid_cost", 2, {}),
    ("hsigmoid_cost", 1, {})])
def test_sampled_costs_match_reference(kind, C, kw, shared_draws):
    """Loss and every gradient against the JAX package from the same
    (non-zero) tables; the hierarchical sigmoid with C a power of two and
    not (C = 30: 31 internal nodes), at the smallest trees."""
    rs = np.random.RandomState(7)
    B = 6
    feed = {"x": rs.randn(B, 5).astype(np.float32),
            "lab": rs.randint(0, C, (B, 1)).astype(np.int32)}
    jnn.reset_naming()
    jt = jnn.Topology(_sampled_net(jnn, kind, C, **kw))
    tnn.reset_naming()
    tt = tnn.Topology(_sampled_net(tnn, kind, C, **kw), device="cpu")
    assert {k: s.shape for k, s in tt.param_specs.items()} \
        == {k: s.shape for k, s in jt.param_specs.items()}
    if kind == "hsigmoid_cost":
        depth = max(int(np.ceil(np.log2(max(C, 2)))), 1)
        assert tt.param_specs["_cost.w0"].shape == (2 ** depth - 1, 6)
    jp, js = jt.init(jax.random.PRNGKey(1))
    jv, jg, tv, tg = loss_and_grads(jt, tt, "cost", nonzero_params(jp), js,
                                    feed)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)


def test_hsigmoid_tree_sizes_follow_the_reference():
    for C, nodes in ((30, 31), (2000, 2047), (1024, 1023), (2, 1), (3, 3)):
        tnn.reset_naming()
        cost = tnn.hsigmoid_cost(tnn.data("x", size=4),
                                 tnn.data("y", size=C, dtype="int32"),
                                 num_classes=C)
        assert cost.param_specs[0].shape == (nodes, 4), C


def test_nce_noise_is_drawn_uniformly_with_the_positive_allowed(
        monkeypatch):
    """The port's own draw (unpatched, only watched): uniform over all
    classes, the label included, new numbers each apply."""
    tnn.reset_naming()
    seen = []
    orig = TO.uniform_classes

    def spy(gen, shape, C, device):
        seen.append(orig(gen, shape, C, device))
        return seen[-1]

    monkeypatch.setattr(TO, "uniform_classes", spy)
    cost = _sampled_net(tnn, "nce_cost", 4, num_neg_samples=200)
    topo = tnn.Topology(cost, device="cpu")
    params, _ = topo.init(0)
    feed = {"x": np.zeros((50, 5), np.float32),
            "lab": np.zeros((50, 1), np.int32)}
    topo.apply(params, {}, feed, rng=1)
    topo.apply(params, {}, feed, rng=2)
    a, b = seen
    assert a.shape == (50, 200) and not torch.equal(a, b)
    counts = torch.bincount(a.reshape(-1), minlength=4).double()
    assert (counts / counts.sum() - 0.25).abs().max() < 0.01


# ---------------------------------------------------------------------------
# selective_fc and sampling_id
# ---------------------------------------------------------------------------


def _selective(nn, mode, sparse=False, C=11):
    if sparse:
        x = nn.data("x", size=20, sparse="float")
    else:
        x = nn.data("x", size=6)
    if mode == "ids":
        sel = nn.data("sel", size=4, dtype="int32")
    else:
        sel = nn.data("sel", size=C)
    return nn.selective_fc(x, sel, C, act="tanh", name="sfc",
                           select_mode=mode)


def _selective_feed(rs, B=5, C=11, sparse=False):
    ids = rs.randint(0, C, (B, 4)).astype(np.int32)
    mask = np.zeros((B, C), np.float32)
    np.put_along_axis(mask, ids, 1.0, axis=1)
    if sparse:
        x = (rs.randint(0, 20, (B, 3)).astype(np.int32),
             rs.randn(B, 3).astype(np.float32),
             np.array([3, 1, 0, 2, 3], np.int32))
    else:
        x = rs.randn(B, 6).astype(np.float32)
    return x, ids, mask


@pytest.mark.parametrize("mode,sparse", [("mask", False), ("ids", False),
                                         ("mask", True)])
def test_selective_fc_paths_match_reference(mode, sparse):
    rs = np.random.RandomState(8)
    x, ids, mask = _selective_feed(rs, sparse=sparse)
    feed = {"x": x, "sel": ids if mode == "ids" else mask}
    jnn.reset_naming()
    jt = jnn.Topology(_selective(jnn, mode, sparse))
    tnn.reset_naming()
    tt = tnn.Topology(_selective(tnn, mode, sparse), device="cpu")
    jp, js = jt.init(jax.random.PRNGKey(2))
    w = rs.randn(5, 4 if mode == "ids" else 11).astype(np.float32)
    jv, jg, tv, tg = loss_and_grads(jt, tt, "sfc", nonzero_params(jp), js,
                                    feed, weight=w)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)


def test_selective_fc_ids_mode_equals_mask_mode_on_the_selected_columns():
    """Column j of the ids mode scores candidate ``select[b, j]``: equal to
    the mask mode's output there, which is exactly 0 off the selection
    (``tests/test_sparse_input.py:165-218``)."""
    rs = np.random.RandomState(9)
    x, ids, mask = _selective_feed(rs)
    out = {}
    for mode in ("mask", "ids"):
        tnn.reset_naming()
        topo = tnn.Topology(_selective(tnn, mode), device="cpu")
        if mode == "mask":
            params, _ = topo.init(4)
            params["_sfc.wbias"] = torch.randn(11)
        out[mode] = topo.apply(params, {}, {
            "x": x, "sel": ids if mode == "ids" else mask})[0]["sfc"].value
    got = torch.gather(out["mask"], 1, torch.from_numpy(ids).long())
    close(out["ids"], got.numpy())
    assert (out["mask"][torch.from_numpy(mask) == 0] == 0).all()


def test_sampling_id_matches_reference_on_shared_draws(shared_draws):
    rs = np.random.RandomState(10)
    logits = rs.randn(64, 6).astype(np.float32)
    got = {}
    for name, nn, kw in (("jax", jnn, {}), ("torch", tnn,
                                            {"device": "cpu"})):
        nn.reset_naming()
        s = nn.sampling_id(nn.data("x", size=6), name="sid")
        topo = nn.Topology(s, **kw)
        got[name] = np.asarray(topo.apply({}, {}, {"x": logits})[0][
            "sid"].value)
    assert got["torch"].dtype == np.int32
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert len(np.unique(got["torch"])) > 3


def test_sampling_id_draws_follow_the_softmax_of_its_input():
    """Unpatched: the port's draws over 20000 rows follow softmax(input)
    (the reference's ``jax.random.categorical`` takes its input as logits),
    not the input taken as probabilities; a dominant logit always wins."""
    tnn.reset_naming()
    s = tnn.sampling_id(tnn.data("x", size=4), name="sid")
    topo = tnn.Topology(s, device="cpu")
    row = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    ids = topo.apply({}, {}, {"x": np.tile(row, (20000, 1))},
                     rng=3)[0]["sid"].value
    freq = torch.bincount(ids.long(), minlength=4).double() / 20000
    np.testing.assert_allclose(freq.numpy(), [0.1, 0.2, 0.3, 0.4], atol=0.015)
    probs = np.tile(np.array([0.1, 0.2, 0.3, 0.4], np.float32), (20000, 1))
    ids = topo.apply({}, {}, {"x": probs}, rng=4)[0]["sid"].value
    freq = torch.bincount(ids.long(), minlength=4).double() / 20000
    want = np.exp(probs[0]) / np.exp(probs[0]).sum()
    np.testing.assert_allclose(freq.numpy(), want, atol=0.015)
    big = np.full((8, 5), -20.0, np.float32)
    big[:, 2] = 10.0
    assert topo.apply({}, {}, {"x": big})[0]["sid"].value.tolist() == [2] * 8


# ---------------------------------------------------------------------------
# data_norm's training pass, eos_trim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["z-score", "min-max",
                                      "decimal-scaling"])
def test_data_norm_training_pass_and_state_match_reference(strategy):
    rs = np.random.RandomState(11)
    x = (3 * rs.randn(7, 4) + 1).astype(np.float32)
    # the stored statistics: the initial ones moved off their defaults
    state = {f"_dn.{k}": v + rs.rand(4).astype(np.float32) for k, v in
             (("mean", 0.0), ("var", 1.0), ("min", 0.0), ("max", 1.0))}
    outs = {}
    for name, nn, kw in (("jax", jnn, {}), ("torch", tnn,
                                            {"device": "cpu"})):
        nn.reset_naming()
        topo = nn.Topology(nn.data_norm(nn.data("x", size=4),
                                        strategy=strategy, name="dn"), **kw)
        st = (tnn.params_from_jax(state, "cpu") if name == "torch"
              else {k: jnp.asarray(v) for k, v in state.items()})
        out, new = topo.apply({}, st, {"x": x}, train=True)
        outs[name] = (np.asarray(out["dn"].value),
                      {k: np.asarray(v) for k, v in new.items()})
    close(outs["torch"][0], outs["jax"][0])
    assert sorted(outs["torch"][1]) == ["_dn.max", "_dn.mean", "_dn.min",
                                        "_dn.var"]
    for k, v in outs["jax"][1].items():
        close(outs["torch"][1][k], v, what=k)


def test_eos_trim_cuts_at_the_first_eos():
    ids = np.array([[4, 1, 5, 1, 2], [3, 3, 3, 3, 3], [1, 2, 2, 2, 2],
                    [2, 2, 2, 1, 0]], np.int32)
    lengths = np.array([5, 4, 5, 2], np.int32)
    got = {}
    for name, nn, kw in (("jax", jnn, {}), ("torch", tnn,
                                            {"device": "cpu"})):
        nn.reset_naming()
        out = nn.eos_trim(nn.data("w", size=0, is_seq=True, dtype="int32"),
                          eos_id=1, name="t")
        a = nn.Topology(out, **kw).apply({}, {}, {"w": (ids, lengths)})[0][
            "t"]
        got[name] = [np.asarray(v) for v in (a.value, a.lengths, a.mask)]
    for t, j in zip(got["torch"], got["jax"]):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(got["torch"][1], [1, 4, 0, 2])
