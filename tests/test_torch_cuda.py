"""Tests of the port that need a CUDA card; each skips, with its reason,
where there is none.

This file imports neither jax nor the JAX package, so that it also runs on
a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)  ``chip_smoke.py``
holds the kernels at the main path's full shapes; these hold them at small
and ragged ones.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import (ce_readout_bwd, ce_readout_bwd_plain,
                                          ce_readout_fwd, ce_readout_fwd_plain,
                                          gru_backward, gru_backward_plain,
                                          gru_forward, gru_forward_plain,
                                          launch_counts, topk_lse_readout,
                                          topk_lse_readout_plain)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,H", [(5, 9, 16), (3, 4, 40), (33, 6, 96)])
def test_gru_kernel_matches_plain_version(dev, B, T, H):
    """Ragged shapes (B, H not multiples of the 32-wide tiles), f32 policy,
    boot state, padded rows; and the launch counter moves by one."""
    rng = np.random.RandomState(B)
    xp = torch.from_numpy((0.3 * rng.randn(B, T, 3 * H)).astype(np.float32))
    lens = rng.randint(1, T + 1, (B,))
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32))
    w_h = torch.from_numpy((0.2 * rng.randn(H, 3 * H)).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(B, H).astype(np.float32))
    args = [t.to(dev) for t in (xp, mask, w_h, h0)]
    with compute_dtype_scope("float32"):
        before = launch_counts()["gru_forward"]
        got = gru_forward(*args)
        assert launch_counts()["gru_forward"] == before + 1
        want = gru_forward_plain(*args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,D,V,k", [(40, 128, 515, 4), (3, 96, 131, 3),
                                     (7, 64, 16, 16)])
def test_topk_kernel_matches_plain_version(dev, N, D, V, k):
    """Ragged vocab tails, k up to 16 and k == V, -inf bias entries."""
    rng = np.random.RandomState(N)
    s = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.1 * rng.randn(D, V)).astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32))
    b[::5] = -float("inf")
    b = b.to(dev)
    before = launch_counts()["topk_lse_readout"]
    kv, ki, kl = topk_lse_readout(s, w, b, k)
    assert launch_counts()["topk_lse_readout"] == before + 1
    pv, pi, pl = topk_lse_readout_plain(s, w, b, k)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-5)


def test_topk_kernel_ties_and_all_inf_tiles(dev):
    """All-tie rows resolve to the lowest ids across tiles; rows whose
    leading vocab tiles are all -inf keep a finite lse."""
    N, V, k = 8, 1100, 3
    s = torch.zeros(N, 128, device=dev)
    s[torch.arange(N), torch.arange(N)] = 1.0
    w = torch.zeros(128, V, device=dev)
    b = torch.zeros(V, device=dev)
    _, ki, _ = topk_lse_readout(s, w, b, k)
    assert torch.equal(ki.cpu(), torch.arange(k).repeat(N, 1))
    b[:900] = -float("inf")
    w[:N, 900:] = torch.randn(N, 200, device=dev)
    kv, ki, kl = topk_lse_readout(s, w, b, k)
    pv, pi, pl = topk_lse_readout_plain(s, w, b, k)
    assert torch.isfinite(kl).all()
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-5)


def test_beam_search_on_the_card_matches_the_cpu(dev):
    """A small model end to end at f32: the card (both kernels) against the
    CPU (their plain versions), ids exact."""
    from paddle_tpu_torch.models import Seq2SeqAttention

    cfg = dict(src_vocab=60, trg_vocab=300, emb_dim=16, enc_dim=32,
               dec_dim=32, att_dim=16)
    cpu = Seq2SeqAttention(**cfg, device="cpu")
    card = Seq2SeqAttention(**cfg, device=dev)
    params = cpu.init(seed=2)
    rng = np.random.RandomState(2)
    src = rng.randint(3, 60, (4, 9))
    lens = np.array([9, 4, 7, 1])
    before = launch_counts()
    with compute_dtype_scope("float32"):
        ct, cs = cpu.beam_search(params, src, lens, beam_size=3, max_len=6)
        gt, gs = card.beam_search({k: v.to(dev) for k, v in params.items()},
                                  src, lens, beam_size=3, max_len=6)
    after = launch_counts()
    assert after["gru_forward"] == before["gru_forward"] + 2
    assert after["topk_lse_readout"] > before["topk_lse_readout"]
    assert torch.equal(gt.cpu(), ct)
    torch.testing.assert_close(gs.cpu(), cs, rtol=1e-5, atol=1e-5)


def _rel_close(got, want, tol):
    """max |got - want| within ``tol`` of max |want|."""
    scale = want.abs().max().item() + 1e-12
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,V", [(40, 128, 515), (3, 96, 131),
                                   (130, 64, 64)])
def test_ce_kernels_match_plain_versions(dev, cd, N, D, V):
    """K1 and K2 at ragged row, depth and vocab counts, with a masked row
    (scale 0) and an out-of-vocab label; each wrapper launches once.  f32:
    the same sums in another order (1e-5); bf16: exact products, but a
    last-bit difference in a float32 d_l can round its bf16 operand the
    other way (1e-2 of the largest gradient)."""
    rng = np.random.RandomState(N + V)
    dt = getattr(torch, cd)
    s = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev).to(dt)
    w = torch.from_numpy((0.1 * rng.randn(D, V)).astype(np.float32)
                         ).to(dev).to(dt)
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32)).to(dev)
    lab = torch.from_numpy(rng.randint(0, V, (N,))).to(dev)
    lab[-1] = V + 3
    scale = torch.from_numpy((rng.rand(N) / N).astype(np.float32)).to(dev)
    scale[0] = 0.0
    before = launch_counts()
    pt, lse, logits = ce_readout_fwd(s, w, b, lab)
    ds, dw, db = ce_readout_bwd(logits, s, w, lab, lse, scale)
    after = launch_counts()
    assert after["ce_readout_fwd"] == before["ce_readout_fwd"] + 1
    assert after["ce_readout_bwd"] == before["ce_readout_bwd"] + 1
    ppt, plse, plogits = ce_readout_fwd_plain(s, w, b, lab)
    pds, pdw, pdb = ce_readout_bwd_plain(logits, s, w, lab, lse, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pt, ppt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits.float(), plogits.float(),
                               rtol=1e-2 if cd == "bfloat16" else 1e-5,
                               atol=1e-5)
    tol = 1e-2 if cd == "bfloat16" else 1e-5
    for got, want in ((ds, pds), (dw, pdw), (db, pdb)):
        _rel_close(got, want, tol)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H", [(5, 9, 16), (33, 6, 96)])
def test_gru_training_kernels_match_plain_versions(dev, cd, B, T, H):
    """K3 with residuals and K4 at ragged shapes, with a boot state and
    padded rows.  bf16: residuals are stored in bf16 on both sides; a
    last-bit difference in the f32 carry can round one of them the other
    way, so 5e-3 of the largest value."""
    rng = np.random.RandomState(B * T)
    xp = torch.from_numpy((0.3 * rng.randn(B, T, 3 * H)).astype(np.float32))
    lens = rng.randint(1, T + 1, (B,))
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32))
    w_h = torch.from_numpy((0.2 * rng.randn(H, 3 * H)).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(B, H).astype(np.float32))
    d_out = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).to(dev)
    d_hfin = torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
    args = [t.to(dev) for t in (xp, mask, w_h, h0)]
    tol = 5e-3 if cd == "bfloat16" else 1e-5
    with compute_dtype_scope(cd):
        before = launch_counts()
        got = gru_forward(*args, residuals=True)
        want = gru_forward_plain(*args, residuals=True)
        assert got[2].dtype == want[2].dtype
        m_tb = args[1].t().contiguous()
        w_t = args[2].t().contiguous()
        g_dz, g_dh0 = gru_backward(d_out, m_tb, got[2], got[3], w_t, d_hfin)
        p_dz, p_dh0 = gru_backward_plain(d_out, m_tb, got[2], got[3], w_t,
                                         d_hfin)
        after = launch_counts()
    assert after["gru_forward"] == before["gru_forward"] + 1
    assert after["gru_backward"] == before["gru_backward"] + 1
    for a, b in zip(got, want):
        _rel_close(a, b, tol)
    # the reverse loop from the same residuals: f32 sums in another order
    _rel_close(g_dz, p_dz, 1e-5)
    _rel_close(g_dh0, p_dh0, 1e-5)


@pytest.mark.parametrize("rows", [1, 3, 192, 2048])
def test_products_are_batch_invariant(dev, rows):
    """Under bf16 at WMT14 widths, a row's result does not depend on how
    many rows share the call: linear, the attention scores' [B, S, A].[A]
    product and the context's batched [B, 1, S] x [B, S, 2H] product, each
    held bit for bit against the row computed alone."""
    from paddle_tpu_torch.ops.attention import context_product, score_product
    from paddle_tpu_torch.ops.matmul import linear

    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, 1536, generator=g).to(dev)
    w = (0.03 * torch.randn(1536, 1536, generator=g)).to(dev)
    bias = torch.randn(1536, generator=g).to(dev)
    S, A, H2 = 32, 512, 1024
    pre = torch.tanh(torch.randn(rows, S, A, generator=g)).to(dev).bfloat16()
    v = (0.05 * torch.randn(A, generator=g)).to(dev)
    wts = torch.softmax(torch.randn(rows, S, generator=g), -1).to(dev)
    vals = torch.randn(rows, S, H2, generator=g).to(dev).bfloat16()
    with compute_dtype_scope("bfloat16"):
        y = linear(x, w, bias)
        sc = score_product(pre, v)
        ctx = context_product(wts, vals)
        for i in sorted({0, rows // 2, rows - 1}):
            sl = slice(i, i + 1)
            assert torch.equal(y[i], linear(x[sl], w, bias)[0]), i
            assert torch.equal(sc[i], score_product(pre[sl], v)[0]), i
            assert torch.equal(ctx[i], context_product(wts[sl],
                                                       vals[sl])[0]), i


@pytest.mark.parametrize("n_ids", [1000, 12288])
def test_embedding_backward_is_deterministic(dev, n_ids):
    """Many duplicate ids (both of the CUDA backward's regimes): the table
    gradient is the same bits on every run and equals the CPU's up to
    summation order."""
    from paddle_tpu_torch.ops.embedding import embedding_lookup

    rng = np.random.RandomState(n_ids)
    table = torch.from_numpy(rng.randn(3000, 64).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 300, (n_ids,)))
    ct = torch.from_numpy(rng.randn(n_ids, 64).astype(np.float32))

    def grad(t, i, c):
        t = t.clone().requires_grad_()
        out = embedding_lookup(t, i)
        return torch.autograd.grad((out * c).sum(), [t])[0]

    runs = [grad(table.to(dev), ids.to(dev), ct.to(dev)) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    torch.testing.assert_close(runs[0].cpu(), grad(table, ids, ct),
                               rtol=1e-5, atol=1e-5)


def test_training_step_on_the_card_matches_the_cpu(dev):
    """A small model's loss and 19 gradients at f32: the card (the four
    training kernels) against the CPU (their plain versions)."""
    from paddle_tpu_torch.models import Seq2SeqAttention

    cfg = dict(src_vocab=60, trg_vocab=300, emb_dim=16, enc_dim=32,
               dec_dim=32, att_dim=16)
    cpu = Seq2SeqAttention(**cfg, device="cpu")
    card = Seq2SeqAttention(**cfg, device=dev)
    params = cpu.init(seed=3)
    # embeddings and att_v scaled up from their init (0.01, 0.05): at init
    # the attention's gradients (~1e-10) are float32 noise of their many
    # cancelling terms
    for k, f in (("src_emb", 50.0), ("trg_emb", 50.0), ("att_v", 20.0)):
        params[k] = params[k] * f
    rng = np.random.RandomState(3)
    B, S, T = 6, 9, 7
    core = rng.randint(3, 300, (B, T - 1))
    batch = {"src_ids": rng.randint(3, 60, (B, S)),
             "src_len": np.array([9, 4, 7, 1, 9, 2]),
             "trg_in": np.concatenate([np.zeros((B, 1), int), core], 1),
             "trg_next": np.concatenate([core, np.ones((B, 1), int)], 1),
             "trg_len": np.array([7, 3, 1, 7, 5, 6])}
    out = {}
    before = launch_counts()
    with compute_dtype_scope("float32"):
        for name, model, dv in (("cpu", cpu, "cpu"), ("card", card, dev)):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            loss = model.loss(p, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
            out[name] = (loss.detach().cpu(), [g.cpu() for g in grads])
    after = launch_counts()
    for k in ("gru_forward", "gru_backward", "ce_readout_fwd",
              "ce_readout_bwd"):
        assert after[k] > before[k], k
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for got, want in zip(out["card"][1], out["cpu"][1]):
        _rel_close(got, want, 1e-4)
