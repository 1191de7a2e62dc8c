"""The port's optimizers, schedules, clipping, averager and pruning hook
against the JAX package's (the dense paths of tests/test_optimizers.py).

Each rule takes the same seeded parameters and gradients in both packages
for 3 steps, with per-parameter learning-rate scales, decays, a static
parameter, L2 and L1, and global-norm clipping; parameters and every slot
are held at rtol 1e-6 / atol 1e-7, the tolerance of the port's Adam test
(tests/test_torch_train.py): the same float32 elementwise arithmetic in
both packages.  The schedules are held at rtol 1e-6 at steps 1 to 1500.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.param import hooks as jhooks
from paddle_tpu.param import optimizers as J

from paddle_tpu_torch.param import hooks as thooks
from paddle_tpu_torch.param import optimizers as P
from paddle_tpu_torch.param.optimizers import commit, slot_leaves

RTOL, ATOL = 1e-6, 1e-7

RULES = {
    "sgd": dict(learning_rate=0.1),
    "momentum": dict(learning_rate=0.05, momentum=0.9),
    "nesterov": dict(learning_rate=0.05, momentum=0.9, use_nesterov=True),
    "adagrad": dict(learning_rate=0.5),
    "adadelta": dict(learning_rate=5.0, rho=0.9),
    "rmsprop": dict(learning_rate=0.05),
    "decayed_adagrad": dict(learning_rate=0.1),
    "adam": dict(learning_rate=0.2),
    "adamax": dict(learning_rate=0.2),
}


def make(module, rule, **extra):
    name = "momentum" if rule == "nesterov" else rule
    cls = (J if module is J else P).OPTIMIZERS.get(name)
    return cls(**RULES[rule], **extra)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"a": (4, 6), "b": (6,), "frozen": (3,), "scaled": (2, 3)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


def _both(rule, steps_kw, opt_kw=None):
    """3 steps in both packages -> (jax params, jax state, port params,
    port state)."""
    params, grads = _inputs()
    jo, to = make(J, rule, **(opt_kw or {})), make(P, rule, **(opt_kw or {}))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = to.init_state(tp)
    for g in grads:
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                           fused=False, **steps_kw)
        to.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                  **steps_kw)
    return jp, js, tp, ts


def _assert_state_close(jp, js, tp, ts):
    assert int(ts["step"]) == int(js["step"])
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        want = js["slots"][k]
        want = [want] if not isinstance(want, tuple) else list(want)
        got = slot_leaves(ts["slots"][k])
        assert len(got) == len(want), k
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


ATTRS = dict(lr_scales={"scaled": 0.1}, statics={"frozen": True},
             decays={"a": 0.5})


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_reference_with_attributes(rule):
    _assert_state_close(*_both(rule, ATTRS, dict(l2_rate=0.01, l1_rate=0.02)))


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
def test_rule_matches_reference_with_clipping(rule):
    _assert_state_close(*_both(rule, {}, dict(
        gradient_clipping_threshold=1.5)))


@pytest.mark.parametrize("schedule,args", [
    ("constant", {}), ("poly", {"decay_a": 0.1, "decay_b": 0.75}),
    ("exp", {"decay_a": 0.5, "decay_b": 2.0}),
    ("discexp", {"decay_a": 0.5, "decay_b": 2.0}),
    ("linear", {"decay_a": 0.01, "decay_b": 0.02}),
    ("warmup_cosine", {"warmup_steps": 2, "total_steps": 10})])
def test_schedules_match_reference(schedule, args):
    for step in (1, 2, 3, 7, 10, 500, 1500):
        want = float(J.lr_schedule(schedule, 0.1, **args)(
            jnp.asarray(step, jnp.int32)))
        got = float(P.lr_schedule(schedule, 0.1, **args)(
            torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(step))
    # and through an update: the schedule runs on the step counter
    _assert_state_close(*_both("sgd", {}, dict(
        learning_rate_schedule=schedule, schedule_args=args)))


def test_registries_match_reference():
    assert P.OPTIMIZERS.names() == J.OPTIMIZERS.names()
    assert P.LR_SCHEDULES.names() == J.LR_SCHEDULES.names()
    assert thooks.PARAM_HOOKS.names() == jhooks.PARAM_HOOKS.names()


def test_lr_at_constant_is_a_float_and_schedules_stay_on_the_counter():
    """The constant schedule leaves the base rate a Python float (the
    direct loop's arithmetic); the others are tensors on the counter's
    device, so no schedule reads the step back."""
    step = torch.tensor(3, dtype=torch.int32)
    assert P.SGD(learning_rate=0.1).lr_at(step) == 0.1
    lr = P.SGD(learning_rate=0.1, learning_rate_schedule="poly").lr_at(step)
    assert torch.is_tensor(lr) and lr.device == step.device
    assert lr.dtype == torch.float32


def test_sgd_and_adam_golden():
    opt = P.SGD(learning_rate=0.1)
    p = {"w": torch.tensor([1.0, 2.0])}
    opt.update(p, {"w": torch.tensor([0.5, -1.0])}, opt.init_state(p))
    np.testing.assert_allclose(p["w"].numpy(), [0.95, 2.1], rtol=1e-6)
    opt = P.Adam(learning_rate=0.1)
    p = {"w": torch.tensor([1.0])}
    opt.update(p, {"w": torch.tensor([2.0])}, opt.init_state(p))
    np.testing.assert_allclose(p["w"].numpy(), [0.9], rtol=1e-5)


def quad_loss(p):
    return (0.5 * (p["w"] - 3.0).square().sum()
            + 0.5 * (p["b"] + 1.0).square().sum())


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_converges_on_a_quadratic(rule):
    opt = make(P, rule)
    p = {"w": torch.zeros(3, requires_grad=True),
         "b": torch.zeros(2, requires_grad=True)}
    s = opt.init_state(p)
    for _ in range(300):
        g = torch.autograd.grad(quad_loss(p), list(p.values()))
        opt.update(p, dict(zip(p, g)), s)
    assert float(quad_loss(p).detach()) < 1e-2, rule


def test_clip_by_value_and_global_norm_match_reference():
    rs = np.random.RandomState(3)
    g = {"x": rs.randn(5).astype(np.float32) * 4,
         "y": rs.randn(2, 2).astype(np.float32)}
    want = J.clip_by_value({k: jnp.asarray(v) for k, v in g.items()}, 1.5)
    got = P.clip_by_value({k: torch.from_numpy(v) for k, v in g.items()},
                          1.5)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jc, jn = J.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                   2.0)
    tc, tn = P.clip_by_global_norm({k: torch.from_numpy(v)
                                    for k, v in g.items()}, 2.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=RTOL, atol=ATOL)


def test_averager_matches_reference():
    rs = np.random.RandomState(4)
    p0 = {"w": rs.randn(3).astype(np.float32)}
    seq = [{"w": rs.randn(3).astype(np.float32)} for _ in range(4)]
    ja, ta = J.ParameterAverager(0.9), P.ParameterAverager(0.9)
    jav = ja.init_state({k: jnp.asarray(v) for k, v in p0.items()})
    tav = ta.init_state({k: torch.from_numpy(v) for k, v in p0.items()})
    for p in seq:
        jav = ja.update(jav, {k: jnp.asarray(v) for k, v in p.items()})
        tav = ta.update(tav, {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(tav["w"].numpy(), np.asarray(jav["w"]),
                               rtol=RTOL, atol=ATOL)


def test_fused_option_gives_the_per_leaf_values():
    """``fused=True`` (the reference's fused apply, bit-identical to its
    per-leaf path) gives the same bits as ``fused=False``."""
    params, grads = _inputs(1)
    out = []
    for fused in (False, True):
        opt = P.Adam(learning_rate=0.1)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = opt.init_state(tp)
        for g in grads:
            opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                       ts, fused=fused)
        out.append(tp)
    for k in params:
        assert torch.equal(out[0][k], out[1][k])


def test_where_false_holds_every_bit_and_the_step():
    """``update(where=False)`` leaves the parameters, the slots and the
    step counter bit for bit; ``where=True`` equals the plain update."""
    params, grads = _inputs(2)
    opt = P.Adam(learning_rate=0.1)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init_state(tp)
    opt.update(tp, {k: torch.from_numpy(v) for k, v in grads[0].items()}, ts)
    before = ({k: v.clone() for k, v in tp.items()},
              {k: [s.clone() for s in slot_leaves(v)]
               for k, v in ts["slots"].items()}, ts["step"].clone())
    g1 = {k: torch.from_numpy(v) for k, v in grads[1].items()}
    opt.update(tp, g1, ts, where=torch.tensor(False))
    for k in tp:
        assert torch.equal(tp[k], before[0][k])
        for a, b in zip(slot_leaves(ts["slots"][k]), before[1][k]):
            assert torch.equal(a, b)
    assert int(ts["step"]) == int(before[2]) == 1
    ref = {k: v.clone() for k, v in tp.items()}
    ref_s = {"step": ts["step"].clone(),
             "slots": {k: tuple(s.clone() for s in v)
                       for k, v in ts["slots"].items()}}
    opt.update(ref, g1, ref_s)
    opt.update(tp, g1, ts, where=torch.tensor(True))
    for k in tp:
        assert torch.equal(tp[k], ref[k])
    assert int(ts["step"]) == 2


def test_new_values_is_functional_and_commit_writes_in_place():
    params, grads = _inputs(5)
    opt = P.Momentum(learning_rate=0.1)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init_state(tp)
    g = {k: torch.from_numpy(v) for k, v in grads[0].items()}
    np_, no = opt.new_values(tp, g, ts)
    for k in tp:
        np.testing.assert_array_equal(tp[k].numpy(), params[k])
    assert int(ts["step"]) == 0 and int(no["step"]) == 1
    ident = {k: id(v) for k, v in tp.items()}
    commit(tp, ts, np_, no)
    assert {k: id(v) for k, v in tp.items()} == ident
    for k in tp:
        assert torch.equal(tp[k], np_[k])
    assert int(ts["step"]) == 1


def test_sparse_rows_and_row_apply_raise_item_8():
    """``sparse_rows`` and ``row_apply`` are ported (their parity:
    ``tests/test_torch_sparse.py``): an untouched row keeps its bits.  The
    pserver's out-of-range drop (``oob_drop=True``) is ported too (its
    parity: ``tests/test_torch_pserver.py``): rows past the end write
    nothing, and the live rows update as without it."""
    opt = P.SGD()
    p = {"t": torch.zeros(4, 2)}
    g = torch.ones(4, 2)
    g[2] = 0.0
    opt.update(p, {"t": g}, opt.init_state(p), sparse_rows={"t": True})
    assert p["t"][2].tolist() == [0.0, 0.0] and p["t"][0, 0] < 0
    rows = torch.tensor([3, 7])
    live = torch.tensor([True, True])
    dropped, _ = opt.row_apply(p["t"], rows, torch.ones(2, 2), (), live,
                               0.1, None, oob_drop=True)
    kept, _ = opt.row_apply(p["t"], rows[:1], torch.ones(1, 2), (),
                            live[:1], 0.1, None)
    assert torch.equal(dropped, kept)


@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5])
def test_pruning_masks_match_reference(ratio):
    """``build_masks``/``apply_masks`` equal the reference's, ties (a
    constant parameter) broken by position as there."""
    rs = np.random.RandomState(6)
    params = {"w": rs.randn(5, 4).astype(np.float32),
              "c": np.ones((7,), np.float32), "free": np.ones(3, np.float32)}
    ratios = {"w": ratio, "c": ratio}
    jm = jhooks.build_masks({k: jnp.asarray(v) for k, v in params.items()},
                            ratios)
    tm = thooks.build_masks({k: torch.from_numpy(v)
                             for k, v in params.items()}, ratios)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    out = thooks.apply_masks({k: torch.from_numpy(v)
                              for k, v in params.items()}, tm)
    want = jhooks.apply_masks({k: jnp.asarray(v) for k, v in params.items()},
                              jm)
    for k in params:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        thooks.StaticPruningHook(1.0)
