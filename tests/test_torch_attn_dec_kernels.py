"""The attention-decoder kernels' plain versions
(paddle_tpu_torch/ops/kernels/attention_decoder.py: K5 ``attn_dec_fwd``, K6
``attn_dec_bwd``) against the JAX package's Pallas kernels
(``attn_dec_fwd_pallas``, ``attn_dec_bwd_pallas``), which run in interpret
mode on the CPU backend, fed the same numpy inputs; and the wrappers'
argument checks.  Tolerance: rtol 2e-4 / atol 2e-5, the one
``tests/test_attention_decoder.py`` pins on the CPU (f32 policy on both
sides: ``tests/conftest.py`` pins the reference, ``compute_dtype_scope``
the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas_kernels import (attn_dec_bwd_pallas,
                                           attn_dec_fwd_pallas)
from paddle_tpu_torch.ops.attention_decoder import recompute_gates
from paddle_tpu_torch.ops.kernels import (attn_dec_bwd, attn_dec_bwd_plain,
                                          attn_dec_fwd, attn_dec_fwd_plain,
                                          launch_counts)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope

TOL = dict(rtol=2e-4, atol=2e-5)
FWD_NAMES = ("states", "probs", "ctx", "s_prev")
BWD_NAMES = ("d_xp", "sum_dpre", "d_enc_proj", "d_v", "d_s0")
#: (B, S, T, D, A, 2H), source and target lengths
SHAPES = {
    "tails": ((4, 5, 6, 8, 7, 10), (5, 3, 4, 2), (6, 4, 6, 1)),
    "short_rows": ((4, 6, 5, 12, 9, 16), (6, 2, 1, 4), (3, 5, 1, 5)),
}


def fwd_inputs(case, seed=0):
    """K5's time-major inputs as float32 numpy arrays."""
    (B, S, T, D, A, H2), src_lens, trg_lens = SHAPES[case]
    rs = np.random.RandomState(seed)
    f = np.float32
    return dict(
        xp_y=(0.5 * rs.randn(T, B, 3 * D)).astype(f),
        m=(np.arange(T)[:, None] < np.asarray(trg_lens)[None]).astype(f),
        s0=rs.randn(B, D).astype(f),
        enc=rs.randn(B, S, H2).astype(f),
        enc_proj=rs.randn(B, S, A).astype(f),
        src_mask=(np.arange(S)[None] < np.asarray(src_lens)[:, None]
                  ).astype(f),
        att_w=(0.5 * rs.randn(D, A)).astype(f),
        att_v=(0.5 * rs.randn(A)).astype(f),
        wx_c=(0.4 * rs.randn(H2, 3 * D)).astype(f),
        wh=(0.4 * rs.randn(D, 3 * D)).astype(f))


FWD_ORDER = ("xp_y", "m", "s0", "enc", "enc_proj", "src_mask", "att_w",
             "att_v", "wx_c", "wh")


def _torch(x):
    return [torch.from_numpy(x[k]) for k in FWD_ORDER]


def bwd_inputs(case, seed=0):
    """K6's inputs: the port's forward residuals at f32, the gates and
    queries recomputed from them, and a cotangent, as numpy arrays."""
    x = fwd_inputs(case, seed)
    with compute_dtype_scope("float32"):
        _, _, ctxs, s_prev = attn_dec_fwd_plain(*_torch(x))
        r, u, cand, q = recompute_gates(
            torch.from_numpy(x["xp_y"]), ctxs, s_prev,
            torch.from_numpy(x["wx_c"]), torch.from_numpy(x["wh"]),
            torch.from_numpy(x["att_w"]))
    T, B, D = s_prev.shape
    d_out = np.random.RandomState(100 + seed).randn(T, B, D).astype(
        np.float32)
    return x, dict(d_out=d_out, s_prev=s_prev.numpy(), r=r.numpy(),
                   u=u.numpy(), cand=cand.numpy(), q=q.numpy())


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("whole_batch", [False, True])
def test_fwd_plain_matches_pallas(case, whole_batch):
    """All four outputs, with a batch block of 2 rows (uneven blocks) and of
    the whole batch; masked source and target tails."""
    x = fwd_inputs(case)
    B = x["s0"].shape[0]
    want = attn_dec_fwd_pallas(*(jnp.asarray(x[k]) for k in FWD_ORDER),
                               block_b=B if whole_batch else 2)
    with compute_dtype_scope("float32"):
        got = attn_dec_fwd_plain(*_torch(x))
    for g, w, name in zip(got, want, FWD_NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    assert np.all(got[0].numpy()[x["m"] == 0] == 0.0)


@pytest.mark.parametrize("case", sorted(SHAPES))
@pytest.mark.parametrize("whole_batch", [False, True])
def test_bwd_plain_matches_pallas(case, whole_batch):
    """All five outputs from the same s_prev / r / u / cand / q; the
    per-block d_enc_proj and d_v of the Pallas kernel must assemble to the
    plain loop's."""
    x, res = bwd_inputs(case)
    B = x["s0"].shape[0]
    j = {k: jnp.asarray(v) for k, v in {**x, **res}.items()}
    want = attn_dec_bwd_pallas(
        j["d_out"], j["m"], j["s_prev"], j["r"], j["u"], j["cand"], j["q"],
        j["enc"], j["enc_proj"], j["src_mask"], j["att_w"], j["att_v"],
        j["att_v"], j["wh"], j["wx_c"], block_b=B if whole_batch else 2)
    t = {k: torch.from_numpy(v) for k, v in {**x, **res}.items()}
    with compute_dtype_scope("float32"):
        got = attn_dec_bwd_plain(
            t["d_out"], t["m"], t["s_prev"], t["r"], t["u"], t["cand"],
            t["q"], t["enc"], t["enc_proj"], t["src_mask"], t["att_w"],
            t["att_v"], t["wh"], t["wx_c"])
    for g, w, name in zip(got, want, BWD_NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_bwd_deferred_denc_dv_matches_the_loop_and_pallas(case):
    """The card's order for d_enc_proj and d_v (one pass after the loop
    from the steps' d_score, ``denc_dv_after_loop``) against the plain
    loop's in-loop sums and the Pallas kernel (batch blocks of 2 rows);
    the other three outputs do not move."""
    x, res = bwd_inputs(case)
    j = {k: jnp.asarray(v) for k, v in {**x, **res}.items()}
    want = attn_dec_bwd_pallas(
        j["d_out"], j["m"], j["s_prev"], j["r"], j["u"], j["cand"], j["q"],
        j["enc"], j["enc_proj"], j["src_mask"], j["att_w"], j["att_v"],
        j["att_v"], j["wh"], j["wx_c"], block_b=2)
    t = {k: torch.from_numpy(v) for k, v in {**x, **res}.items()}
    args = [t[k] for k in ("d_out", "m", "s_prev", "r", "u", "cand", "q",
                           "enc", "enc_proj", "src_mask", "att_w", "att_v",
                           "wh", "wx_c")]
    with compute_dtype_scope("float32"):
        got = attn_dec_bwd_plain(*args, deferred=True)
        loop = attn_dec_bwd_plain(*args)
    for g, lp, w, name in zip(got, loop, want, BWD_NAMES):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(g.numpy(), lp.numpy(), **TOL,
                                   err_msg=name)
    for i in (0, 1, 4):
        assert torch.equal(got[i], loop[i])


def test_wrappers_on_cpu_run_plain_versions_and_count_no_launch():
    x, res = bwd_inputs("tails")
    t = {k: torch.from_numpy(v) for k, v in {**x, **res}.items()}
    bwd_args = [t[k] for k in ("d_out", "m", "s_prev", "r", "u", "cand", "q",
                               "enc", "enc_proj", "src_mask", "att_w",
                               "att_v", "wh", "wx_c")]
    before = launch_counts()
    with compute_dtype_scope("float32"):
        for a, b in zip(attn_dec_fwd(*_torch(x)),
                        attn_dec_fwd_plain(*_torch(x))):
            assert torch.equal(a, b)
        for a, b in zip(attn_dec_bwd(*bwd_args),
                        attn_dec_bwd_plain(*bwd_args)):
            assert torch.equal(a, b)
    after = launch_counts()
    assert after["attn_dec_fwd"] == before["attn_dec_fwd"]
    assert after["attn_dec_bwd"] == before["attn_dec_bwd"]


#: (argument index, replacement, message) for K5's wrapper
_BAD_FWD = [
    (0, torch.zeros(6, 4, 25), "xp_y must be"),             # 3D not whole
    (1, torch.ones(6, 3), "mask must be"),
    (2, torch.zeros(4, 9), "s0 must be"),
    (7, torch.zeros(8), "att_v must be"),
    (9, torch.zeros(8, 23), "wh must be"),
    (2, torch.zeros(4, 8, dtype=torch.float64), "s0 must be float32"),
    (3, torch.zeros(4, 5, 10).bfloat16(), "enc must be cast to the compute"),
]


@pytest.mark.parametrize("i,bad,msg", _BAD_FWD)
def test_fwd_wrapper_rejects_what_the_kernel_does_not_take(i, bad, msg):
    args = _torch(fwd_inputs("tails"))
    args[i] = bad
    with compute_dtype_scope("float32"), pytest.raises(ValueError,
                                                       match=msg):
        attn_dec_fwd(*args)


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    x, res = bwd_inputs("tails")
    t = {k: torch.from_numpy(v) for k, v in {**x, **res}.items()}
    names = ("d_out", "m", "s_prev", "r", "u", "cand", "q", "enc",
             "enc_proj", "src_mask", "att_w", "att_v", "wh", "wx_c")
    cases = [("q", t["q"][:, :, :-1], "q must be"),
             ("cand", t["cand"][:-1], "cand must be"),
             ("wx_c", t["wx_c"].t(), "wx_c must be"),
             ("wh", t["wh"].bfloat16(), "wh must be float32"),
             ("enc_proj", t["enc_proj"].bfloat16(),
              "enc_proj must be cast to the compute")]
    with compute_dtype_scope("float32"):
        for name, bad, msg in cases:
            args = [bad if n == name else t[n] for n in names]
            with pytest.raises(ValueError, match=msg):
                attn_dec_bwd(*args)


def test_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version; a device that is neither
    CPU nor CUDA is refused, never computed some other way."""
    meta = torch.device("meta")
    args = [a.to(meta) for a in _torch(fwd_inputs("tails"))]
    with compute_dtype_scope("float32"), pytest.raises(ValueError,
                                                       match="cpu or cuda"):
        attn_dec_fwd(*args)
