"""The port's attention GRU decoder with its hand-written backward
(paddle_tpu_torch/ops/attention_decoder.py) against the JAX package's
``attention_gru_decoder`` on its scan path (the path this slice ports):
the forward and all nine gradients (every input but the two masks), with
masked source and target rows.  Tolerance: rtol 2e-4 / atol 2e-5, the one
``tests/test_attention_decoder.py`` pins on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention_decoder import \
    attention_gru_decoder as j_decoder
from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder
from paddle_tpu_torch.ops.numerics import compute_dtype_scope

ORDER = ["y_emb", "s0", "enc", "enc_proj", "src_mask", "trg_mask",
         "att_w", "att_v", "wx", "b", "wh"]
DIFF = [0, 1, 2, 3, 6, 7, 8, 9, 10]          # everything but the masks
TOL = dict(rtol=2e-4, atol=2e-5)


def make_args(seed=0, B=4, S=5, T=6, E=8, H2=10, D=8, A=7,
              src_lens=(5, 3, 4, 2), trg_lens=(6, 4, 6, 1)):
    rs = np.random.RandomState(seed)
    f = np.float32
    return dict(
        y_emb=rs.randn(B, T, E).astype(f),
        s0=rs.randn(B, D).astype(f),
        enc=rs.randn(B, S, H2).astype(f),
        enc_proj=rs.randn(B, S, A).astype(f),
        src_mask=(np.arange(S)[None] < np.asarray(src_lens)[:, None]
                  ).astype(f),
        trg_mask=(np.arange(T)[None] < np.asarray(trg_lens)[:, None]
                  ).astype(f),
        att_w=(0.5 * rs.randn(D, A)).astype(f),
        att_v=(0.5 * rs.randn(A)).astype(f),
        wx=(0.4 * rs.randn(E + H2, 3 * D)).astype(f),
        b=(0.1 * rs.randn(3 * D)).astype(f),
        wh=(0.4 * rs.randn(D, 3 * D)).astype(f),
    )


def test_forward_matches_jax():
    vals = [make_args()[k] for k in ORDER]
    want = j_decoder(*(jnp.asarray(v) for v in vals))
    with compute_dtype_scope("float32"):
        got = attention_gru_decoder(*(torch.from_numpy(v) for v in vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # padded target steps emit exact zeros
    mask = make_args()["trg_mask"]
    assert np.all(got.numpy()[mask == 0] == 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_all_gradients_match_jax(seed):
    args = make_args(seed=seed)
    vals = [args[k] for k in ORDER]
    ct = np.random.RandomState(100 + seed).randn(4, 6, 8).astype(np.float32)

    def loss(*dv):
        full = [jnp.asarray(v) for v in vals]
        for i, ix in enumerate(DIFF):
            full[ix] = dv[i]
        return jnp.sum(j_decoder(*full) * ct)

    want = jax.grad(loss, argnums=tuple(range(len(DIFF))))(
        *(jnp.asarray(vals[i]) for i in DIFF))
    with compute_dtype_scope("float32"):
        ts = [torch.from_numpy(v) for v in vals]
        for i in DIFF:
            ts[i] = ts[i].clone().requires_grad_()
        out = attention_gru_decoder(*ts)
        got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                  [ts[i] for i in DIFF])
    assert len(got) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"grad {ORDER[DIFF[i]]}")


def test_bf16_cached_encoder_grads_stay_close():
    """bfloat16 policy with bf16 enc/enc_proj (what ``encode`` hands the
    decoder): the port's forward and gradients stay within bf16 rounding of
    the JAX decoder under the same policy."""
    from paddle_tpu.utils.flags import FLAGS

    args = make_args(seed=2)
    vals = [args[k] for k in ORDER]
    old = FLAGS.compute_dtype
    FLAGS.compute_dtype = "bfloat16"
    try:
        def loss(*dv):
            full = [jnp.asarray(v) for v in vals]
            full[2] = full[2].astype(jnp.bfloat16)
            full[3] = full[3].astype(jnp.bfloat16)
            for i, ix in enumerate((8, 10)):
                full[ix] = dv[i]
            return jnp.sum(j_decoder(*full) ** 2)

        want = jax.value_and_grad(loss, argnums=(0, 1))(
            jnp.asarray(vals[8]), jnp.asarray(vals[10]))
    finally:
        FLAGS.compute_dtype = old
    with compute_dtype_scope("bfloat16"):
        ts = [torch.from_numpy(v) for v in vals]
        ts[2], ts[3] = ts[2].bfloat16(), ts[3].bfloat16()
        ts[8] = ts[8].clone().requires_grad_()
        ts[10] = ts[10].clone().requires_grad_()
        loss_t = (attention_gru_decoder(*ts) ** 2).sum()
        got = torch.autograd.grad(loss_t, [ts[8], ts[10]])
    np.testing.assert_allclose(float(loss_t.detach()), float(want[0]),
                               rtol=2e-2)
    for g, w in zip(got, want[1]):
        w = np.asarray(w, np.float64)
        sc = np.abs(w).max()
        np.testing.assert_allclose(g.double().numpy() / sc, w / sc,
                                   atol=3e-2)
