"""The port's training step as a whole — ``Seq2SeqAttention.loss``, its 19
gradients and ``Adam.update`` (paddle_tpu_torch/models/seq2seq.py,
param/optimizers.py), with the embedding backward — against the JAX
package: ``jax.value_and_grad(m.loss)`` with the JAX parameters carried
across by ``params_from_jax``, and the JAX ``Adam``.

Small widths, mixed source and target lengths, float32 policy on both
sides.  Tolerances: loss rtol 1e-5; each gradient within 2e-4 of its
largest entry (the decoder file's rtol, summed through the encoder and the
readout); Adam rtol 1e-6 / atol 1e-7 (elementwise float32 arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import Seq2SeqAttention as JaxSeq2Seq
from paddle_tpu.ops.embedding import embedding_lookup as j_lookup
from paddle_tpu.param.optimizers import Adam as JaxAdam
from paddle_tpu_torch.models.seq2seq import Seq2SeqAttention, params_from_jax
from paddle_tpu_torch.ops.embedding import embedding_lookup
from paddle_tpu_torch.ops.numerics import compute_dtype_scope
from paddle_tpu_torch.param import Adam, clip_by_global_norm

CFG = dict(src_vocab=60, trg_vocab=90, emb_dim=16, enc_dim=24, dec_dim=32,
           att_dim=20)


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _batch(seed=0, B=4, S=7, T=6):
    rs = np.random.RandomState(seed)
    core = rs.randint(3, CFG["trg_vocab"], (B, T - 1)).astype(np.int32)
    return {
        "src_ids": rs.randint(3, CFG["src_vocab"], (B, S)).astype(np.int32),
        "src_len": np.array([S, 3, 5, 1][:B], np.int32),
        "trg_in": np.concatenate([np.zeros((B, 1), np.int32), core], 1),
        "trg_next": np.concatenate([core, np.ones((B, 1), np.int32)], 1),
        "trg_len": np.array([T, 2, 4, T][:B], np.int32),
    }


@pytest.fixture(scope="module")
def pair():
    """The JAX model and parameters, and the port's model.  The embeddings
    and ``att_v`` are scaled up from their init (0.01 and 0.05) so that the
    attention's gradients (``att_dec_w``, ``enc_proj_b``) stand well above
    float32 rounding of their many cancelling terms."""
    jm = JaxSeq2Seq(**CFG)
    jp = jm.init(jax.random.PRNGKey(5))
    for k, f in (("src_emb", 50.0), ("trg_emb", 50.0), ("att_v", 20.0)):
        jp[k] = jp[k] * f
    tm = Seq2SeqAttention(**CFG, device="cpu")
    return jm, jp, tm


def _port_params(jp):
    return {k: v.requires_grad_() for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}


def test_loss_and_all_19_gradients_match_jax(pair):
    jm, jp, tm = pair
    batch = _batch()
    l_ref, g_ref = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = _port_params(jp)
    loss = tm.loss(tp, batch)
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert len(grads) == 19
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               rtol=1e-5)
    for name, g in zip(tp, grads):
        want = np.asarray(g_ref[name], np.float64)
        sc = np.abs(want).max()
        assert sc > 0, name
        np.testing.assert_allclose(g.double().numpy() / sc, want / sc,
                                   atol=2e-4, err_msg=name)


def test_adam_steps_reduce_the_loss(pair):
    """As tests/test_models.py's training test: 30 Adam steps on one batch
    take the loss below 0.8 of its start."""
    _, jp, tm = pair
    tp = _port_params(jp)
    batch = _batch(seed=1)
    opt = Adam(learning_rate=5e-3)
    state = opt.init_state(tp)
    losses = []
    for _ in range(30):
        loss = tm.loss(tp, batch)
        grads = torch.autograd.grad(loss, list(tp.values()))
        tp, state = opt.update(tp, dict(zip(tp, grads)), state)
        losses.append(float(loss.detach()))
    assert int(state["step"]) == 30
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.8


_ADAM_CASES = {
    "plain": dict(),
    "clipped": dict(gradient_clipping_threshold=0.5),
    "decay": dict(l2_rate=1e-2, l1_rate=1e-3),
    "bf16_slots": dict(slot_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(_ADAM_CASES))
def test_adam_update_matches_jax(case):
    """Three steps on fixed parameters and gradients: parameters, both
    moments and the step count."""
    kw = _ADAM_CASES[case]
    rs = np.random.RandomState(3)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 2, 4)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jopt = JaxAdam(learning_rate=1e-2, **kw)
    topt = Adam(learning_rate=1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init_state(tp)
    for g in grads:
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, fused=False)
        tp, ts = topt.update(tp, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for got, want in zip(ts["slots"][k], js["slots"][k]):
            assert str(got.dtype).replace("torch.", "") == \
                jnp.dtype(want.dtype).name
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", sorted(_ADAM_CASES))
def test_adam_update_in_place_without_its_return_matches_jax(case):
    """As the caller of the training step does: ``update`` called three
    times with its return value dropped.  The step counter, parameters and
    both moments advance in place and match the JAX ``Adam``."""
    kw = _ADAM_CASES[case]
    rs = np.random.RandomState(7)
    shapes = {"a": (4, 6), "b": (6,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jopt = JaxAdam(learning_rate=1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_state(jp)
    topt = Adam(learning_rate=1e-2, **kw)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    ts = topt.init_state(tp)
    for g in grads:
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js, fused=False)
        topt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for got, want in zip(ts["slots"][k], js["slots"][k]):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_adam_update_is_in_place_and_keeps_leaves():
    p = {"w": torch.ones(3, requires_grad=True)}
    opt = Adam(learning_rate=0.1)
    st = opt.init_state(p)
    ident = id(p["w"])
    p2, st2 = opt.update(p, {"w": torch.ones(3)}, st)
    assert id(p2["w"]) == ident and p2["w"].requires_grad
    assert p2["w"].is_leaf
    assert st2 is st and int(st["step"]) == 1
    torch.testing.assert_close(p2["w"].detach(), torch.full((3,), 0.9))


def test_clip_by_global_norm_scales_to_the_threshold():
    g = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(clipped["a"], torch.tensor([0.6, 0.0]))
    same, _ = clip_by_global_norm(g, 10.0)
    assert torch.equal(same["b"], g["b"])


def test_embedding_backward_with_duplicate_ids_matches_jax():
    rs = np.random.RandomState(4)
    table = rs.randn(11, 5).astype(np.float32)
    ids = np.array([[3, 3, 7, 0], [7, 3, 10, 3]], np.int32)
    ct = rs.randn(2, 4, 5).astype(np.float32)

    def obj(t):
        return jnp.sum(j_lookup(t, jnp.asarray(ids)) * ct)

    want = jax.grad(obj)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    out = embedding_lookup(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    (got,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [tt])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert np.all(got.numpy()[[1, 2, 4, 5, 6, 8, 9]] == 0.0)
