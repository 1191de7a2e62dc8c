"""Tests of the port that need a CUDA card; each skips, with its reason,
where there is none.

This file imports neither jax nor the JAX package, so that it also runs on
a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)  ``chip_smoke.py``
holds the kernels at the main path's full shapes; these hold them at small
and ragged ones.
"""

import os
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import (attn_dec_bwd, attn_dec_bwd_plain,
                                          attn_dec_fwd, attn_dec_fwd_plain,
                                          bigru_backward,
                                          bigru_backward_plain,
                                          bigru_forward, bigru_forward_plain,
                                          ce_readout_bwd, ce_readout_bwd_plain,
                                          ce_readout_fwd, ce_readout_fwd_plain,
                                          gru_backward, gru_backward_plain,
                                          gru_forward, gru_forward_plain,
                                          launch_counts, logsumexp_rows,
                                          logsumexp_rows_plain,
                                          lstm_backward,
                                          lstm_backward_plain, lstm_forward,
                                          lstm_forward_plain,
                                          topk_lse_logits,
                                          topk_lse_logits_plain,
                                          topk_lse_readout,
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


#: shapes the TMA + wgmma kernels take in bf16 (D an instantiated depth,
#: V % 8 == 0), crossing their row tiles, vocab chunks and the ragged tail
_CE_TMA_SHAPES = [(12288, 512, 30000), (257, 512, 4096), (128, 64, 30000),
                  (130, 64, 64)]


def _ce_inputs(dev, dt, N, D, V, seed):
    rng = np.random.RandomState(seed)
    s = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev).to(dt)
    w = torch.from_numpy((0.1 * rng.randn(D, V)).astype(np.float32)
                         ).to(dev).to(dt)
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32)).to(dev)
    lab = torch.from_numpy(rng.randint(0, V, (N,))).to(dev)
    lab[-1] = V + 3
    scale = torch.from_numpy((rng.rand(N) / N).astype(np.float32)).to(dev)
    scale[0] = 0.0
    return s, w, b, lab, scale


def _ce_path_launches():
    from paddle_tpu_torch.ops.kernels.ce_readout import (CE_READOUT_BWD,
                                                         CE_READOUT_FWD)
    return (dict(CE_READOUT_FWD.launches_by_path),
            dict(CE_READOUT_BWD.launches_by_path))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,V", [(40, 128, 515), (3, 96, 131),
                                   (130, 64, 64), (12288, 512, 30000),
                                   (257, 512, 4096), (128, 64, 30000)])
def test_ce_kernels_match_plain_versions(dev, cd, N, D, V):
    """K1 and K2 at ragged row, depth and vocab counts, with a masked row
    (scale 0) and an out-of-vocab label; each wrapper launches once, on the
    path the shape asks for (bf16: TMA + wgmma where TMA takes the shape,
    else WMMA; f32: CUDA cores).  f32: the same sums in another order
    (1e-5); bf16: exact products, but a last-bit difference in a float32
    d_l can round its bf16 operand the other way (1e-2 of the largest
    gradient)."""
    dt = getattr(torch, cd)
    s, w, b, lab, scale = _ce_inputs(dev, dt, N, D, V, N + V)
    path = ("simt" if cd == "float32" else
            "wgmma" if (N, D, V) in _CE_TMA_SHAPES else "wmma")
    before = launch_counts()
    paths_before = _ce_path_launches()
    pt, lse, logits = ce_readout_fwd(s, w, b, lab)
    ds, dw, db = ce_readout_bwd(logits, s, w, lab, lse, scale)
    after = launch_counts()
    assert after["ce_readout_fwd"] == before["ce_readout_fwd"] + 1
    assert after["ce_readout_bwd"] == before["ce_readout_bwd"] + 1
    for got, was in zip(_ce_path_launches(), paths_before):
        assert got.get(path, 0) == was.get(path, 0) + 1
        assert sum(got.values()) == sum(was.values()) + 1
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


@pytest.mark.parametrize("N,D,V", [(257, 512, 4096), (40, 128, 515)])
def test_ce_kernels_are_deterministic(dev, N, D, V):
    """Two calls on the same inputs are bit-equal on either bf16 path: no
    atomics, every sum in a fixed order."""
    s, w, b, lab, scale = _ce_inputs(dev, torch.bfloat16, N, D, V, 7)
    f1 = ce_readout_fwd(s, w, b, lab)
    f2 = ce_readout_fwd(s, w, b, lab)
    g1 = ce_readout_bwd(f1[2], s, w, lab, f1[1], scale)
    g2 = ce_readout_bwd(f1[2], s, w, lab, f1[1], scale)
    for a, c in zip(f1 + g1, f2 + g2):
        assert torch.equal(a, c)


@pytest.mark.parametrize("D,V", [(512, 30000), (128, 515)])
def test_ce_forward_rows_do_not_depend_on_n(dev, D, V):
    """K1's outputs for the first 64 rows are bit-equal at N = 64 and
    N = 12288: the vocab chunks and the order of every sum depend on V and
    D alone (batch invariance)."""
    s, w, b, lab, _ = _ce_inputs(dev, torch.bfloat16, 12288, D, V, 11)
    big = ce_readout_fwd(s, w, b, lab)
    small = ce_readout_fwd(s[:64].clone(), w, b, lab[:64].clone())
    for a, c in zip(big, small):
        assert torch.equal(a[:64], c)


def test_ce_misaligned_operands_take_the_wmma_path(dev):
    """An operand whose base is not 16-byte aligned cannot be a TMA source:
    the bf16 call takes the WMMA kernel, with the same results."""
    N, D, V = 96, 512, 4096
    s, w, b, lab, scale = _ce_inputs(dev, torch.bfloat16, N, D, V, 5)
    buf = torch.empty(N * D + 1, dtype=torch.bfloat16, device=dev)
    s_odd = buf[1:].view(N, D)
    s_odd.copy_(s)
    assert s_odd.data_ptr() % 16 != 0
    paths_before = _ce_path_launches()
    pt, lse, logits = ce_readout_fwd(s_odd, w, b, lab)
    ds, dw, db = ce_readout_bwd(logits, s_odd, w, lab, lse, scale)
    for got, was in zip(_ce_path_launches(), paths_before):
        assert got.get("wmma", 0) == was.get("wmma", 0) + 1
    want = ce_readout_fwd(s, w, b, lab)
    torch.testing.assert_close(lse, want[1], rtol=1e-5, atol=1e-5)
    gw = ce_readout_bwd(want[2], s, w, lab, want[1], scale)
    for got, ref in zip((ds, dw, db), gw):
        _rel_close(got, ref, 1e-2)


def test_ce_backward_with_no_rows_writes_zero_weights_grads(dev):
    """N == 0: d_w and d_b are written, all zero."""
    D, V = 512, 4096
    s = torch.zeros(0, D, dtype=torch.bfloat16, device=dev)
    w = torch.randn(D, V, device=dev).bfloat16()
    lab = torch.zeros(0, dtype=torch.long, device=dev)
    z = torch.zeros(0, device=dev)
    ds, dw, db = ce_readout_bwd(torch.zeros(0, V, dtype=torch.bfloat16,
                                            device=dev), s, w, lab, z, z)
    torch.cuda.synchronize()
    assert ds.shape == (0, D)
    assert not dw.any() and not db.any()


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
    """A small model's loss and 19 gradients at f32: the card (the six
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
              "ce_readout_bwd", "attn_dec_fwd", "attn_dec_bwd"):
        assert after[k] > before[k], k
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for got, want in zip(out["card"][1], out["cpu"][1]):
        _rel_close(got, want, 1e-4)


def _attn_dec_inputs(B, S, T, D, A, H2, seed):
    """K5's inputs at float32 with source and target tails (and, for B > 3,
    a row with no source position), weights scaled by their fan-in."""
    rng = np.random.RandomState(seed)
    f = np.float32

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(f)

    src_len = rng.randint(1, S + 1, (B,))
    trg_len = rng.randint(1, T + 1, (B,))
    src_len[0], trg_len[0] = S, T
    if B > 3:
        src_len[1] = 0
    arrs = dict(
        xp_y=(0.5 * rng.randn(T, B, 3 * D)).astype(f),
        m=(np.arange(T)[:, None] < trg_len[None]).astype(f),
        s0=(0.5 * rng.randn(B, D)).astype(f),
        enc=rng.randn(B, S, H2).astype(f),
        enc_proj=rng.randn(B, S, A).astype(f),
        src_mask=(np.arange(S)[None] < src_len[:, None]).astype(f),
        att_w=w(D, A), att_v=(2.0 * w(A)).astype(f), wx_c=w(H2, 3 * D),
        wh=w(D, 3 * D))
    return {k: torch.from_numpy(v) for k, v in arrs.items()}


@pytest.mark.parametrize("shape,cd", [
    ((4, 5, 6, 8, 7, 10), "float32"),
    ((33, 17, 9, 96, 80, 160), "float32"),
    ((3, 32, 4, 128, 128, 256), "float32"),
    ((33, 17, 9, 96, 80, 160), "bfloat16")])
def test_attn_dec_kernels_match_plain_versions(dev, shape, cd):
    """K5 and K6 at ragged (B, S, T, D, A, 2H), masked source and target
    tails.  K6 takes K5's residuals and the gates recomputed from them, on
    both sides.  f32: the same sums in another order over the steps (2e-5
    of each output's largest entry); bf16: a last-bit difference in a
    float32 sum can round an operand the other way (2^-8 relative), which
    the recurrence carries (5e-3 forward, 1e-2 backward)."""
    from paddle_tpu_torch.ops.attention_decoder import recompute_gates

    x = {k: v.to(dev) for k, v in _attn_dec_inputs(*shape, seed=7).items()}
    T, B, D = x["xp_y"].shape[0], x["xp_y"].shape[1], shape[3]
    with compute_dtype_scope(cd):
        dt = getattr(torch, cd)
        fwd_args = [x["xp_y"], x["m"], x["s0"]] + [
            x[k].to(dt) for k in ("enc", "enc_proj")] + [x["src_mask"]] + [
            x[k].to(dt) for k in ("att_w", "att_v", "wx_c", "wh")]
        before = launch_counts()
        got = attn_dec_fwd(*fwd_args)
        assert launch_counts()["attn_dec_fwd"] == before["attn_dec_fwd"] + 1
        want = attn_dec_fwd_plain(*fwd_args)
        states, probs, ctxs, s_prev = got
        assert ctxs.dtype == want[2].dtype == dt
        r, u, cand, q = recompute_gates(x["xp_y"], ctxs, s_prev, x["wx_c"],
                                        x["wh"], x["att_w"])
        d_out = torch.from_numpy(np.random.RandomState(8).randn(
            T, B, D).astype(np.float32)).to(dev)
        bwd_args = [d_out, x["m"], s_prev, r, u, cand, q,
                    fwd_args[3], fwd_args[4], x["src_mask"], x["att_w"],
                    x["att_v"], x["wh"], x["wx_c"]]
        g_bwd = attn_dec_bwd(*bwd_args)
        assert launch_counts()["attn_dec_bwd"] == before["attn_dec_bwd"] + 1
        p_bwd = attn_dec_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    tol_f, tol_b = (2e-5, 2e-5) if cd == "float32" else (5e-3, 1e-2)
    for a, b in zip(got, want):
        _rel_close(a, b, tol_f)
    padded = x["m"] == 0
    assert torch.equal(states[padded], torch.zeros_like(states[padded]))
    for a, b in zip(g_bwd, p_bwd):
        assert torch.isfinite(a).all()
        _rel_close(a, b, tol_b)


def test_attention_decoder_on_the_card_matches_the_cpu(dev):
    """The whole decoder at f32, forward and the nine gradients: the card
    (K5, K6) against the CPU (their plain versions), uneven sizes, masked
    rows."""
    from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder

    rng = np.random.RandomState(11)
    B, S, T, E, H2, D, A = 5, 7, 6, 12, 20, 16, 9
    f = np.float32
    vals = [(0.5 * rng.randn(B, T, E)).astype(f),
            (0.5 * rng.randn(B, D)).astype(f),
            rng.randn(B, S, H2).astype(f), rng.randn(B, S, A).astype(f),
            (np.arange(S)[None] < np.array([7, 3, 1, 5, 7])[:, None]
             ).astype(f),
            (np.arange(T)[None] < np.array([6, 2, 6, 4, 1])[:, None]
             ).astype(f),
            (0.3 * rng.randn(D, A)).astype(f), rng.randn(A).astype(f),
            (0.3 * rng.randn(E + H2, 3 * D)).astype(f),
            (0.1 * rng.randn(3 * D)).astype(f),
            (0.3 * rng.randn(D, 3 * D)).astype(f)]
    ct = rng.randn(B, T, D).astype(f)
    diff = [0, 1, 2, 3, 6, 7, 8, 9, 10]
    out = {}
    before = launch_counts()
    with compute_dtype_scope("float32"):
        for name, dv in (("cpu", "cpu"), ("card", dev)):
            ts = [torch.from_numpy(v).to(dv) for v in vals]
            for i in diff:
                ts[i].requires_grad_()
            states = attention_gru_decoder(*ts)
            grads = torch.autograd.grad(
                (states * torch.from_numpy(ct).to(dv)).sum(),
                [ts[i] for i in diff])
            out[name] = [states.detach().cpu()] + [g.cpu() for g in grads]
    after = launch_counts()
    assert after["attn_dec_fwd"] == before["attn_dec_fwd"] + 1
    assert after["attn_dec_bwd"] == before["attn_dec_bwd"] + 1
    for got, want in zip(out["card"], out["cpu"]):
        _rel_close(got, want, 1e-4)


def _lstm_inputs(B, T, H, seed):
    """K9's inputs at float32: mixed lengths (a full row and a length-1
    row), a boot state, nonzero peepholes."""
    rng = np.random.RandomState(seed)
    f = np.float32
    lens = rng.randint(1, T + 1, (B,))
    lens[0], lens[-1] = T, 1
    arrs = [(0.4 * rng.randn(B, T, 4 * H)).astype(f),
            (np.arange(T)[None] < lens[:, None]).astype(f),
            (rng.randn(H, 4 * H) / np.sqrt(H)).astype(f),
            (0.3 * rng.randn(H)).astype(f), (0.3 * rng.randn(H)).astype(f),
            (0.3 * rng.randn(H)).astype(f),
            (0.5 * rng.randn(B, H)).astype(f),
            (0.5 * rng.randn(B, H)).astype(f)]
    return [torch.from_numpy(a) for a in arrs], rng


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H", [(5, 9, 100), (64, 20, 256)])
def test_lstm_kernels_match_plain_versions(dev, cd, B, T, H):
    """K9 (inference and with residuals) and K10 from K9's residuals, at a
    ragged shape (H = 100, not a multiple of the tiles) and at b64h256, with
    a boot state, nonzero peepholes and padded rows; each wrapper launches
    once per call.  f32: the same sums in another order (1e-5 of the
    largest value); bf16: a last-bit difference in the f32 carry can round
    a bf16 operand or residual the other way (5e-3).  K10 from the same
    residuals: f32 sums in another order (1e-5)."""
    ins, rng = _lstm_inputs(B, T, H, B + H)
    args = [t.to(dev) for t in ins]
    d_out = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).to(dev)
    d_hfin = torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
    d_cfin = torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
    tol = 5e-3 if cd == "bfloat16" else 1e-5
    with compute_dtype_scope(cd):
        before = launch_counts()
        inf = lstm_forward(*args)
        got = lstm_forward(*args, residuals=True)
        assert launch_counts()["lstm_forward"] == before["lstm_forward"] + 2
        want = lstm_forward_plain(*args, residuals=True)
        assert got[3].dtype == want[3].dtype
        m_tb = args[1].t().contiguous()
        w_t = args[2].t().contiguous()
        bargs = [d_out, m_tb, got[3], got[5], w_t, *args[3:6], d_hfin,
                 d_cfin]
        g_bwd = lstm_backward(*bargs)
        assert launch_counts()["lstm_backward"] == \
            before["lstm_backward"] + 1
        p_bwd = lstm_backward_plain(*bargs)
    torch.cuda.synchronize()
    for a, b in zip(inf, got[:3]):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        _rel_close(a, b, tol)
    padded = args[1] == 0
    assert torch.equal(got[0][padded], torch.zeros_like(got[0][padded]))
    for a, b in zip(g_bwd, p_bwd):
        assert torch.isfinite(a).all()
        _rel_close(a, b, 1e-5)
    no_cn = lstm_backward(*bargs, want_cn=False)
    assert no_cn[1] is None
    for a, b in zip((no_cn[0], no_cn[2], no_cn[3]),
                    (g_bwd[0], g_bwd[2], g_bwd[3])):
        assert torch.equal(a, b)


def test_lstm_wrappers_raise_on_mixed_devices(dev):
    ins, _ = _lstm_inputs(3, 4, 8, 0)
    args = [t.to(dev) for t in ins]
    for i in range(len(args)):
        mixed = list(args)
        mixed[i] = mixed[i].cpu()
        with pytest.raises(ValueError, match="span devices"):
            lstm_forward(*mixed)
    res = lstm_forward(*args, residuals=True)
    T, B, H = res[3].shape[0], res[3].shape[1], 8
    bargs = [torch.zeros(T, B, H, device=dev), args[1].t().contiguous(),
             res[3], res[5], args[2].t().contiguous(), *args[3:6],
             torch.zeros(B, H, device=dev), torch.zeros(B, H, device=dev)]
    for i in range(len(bargs)):
        mixed = list(bargs)
        mixed[i] = mixed[i].cpu()
        with pytest.raises(ValueError, match="span devices"):
            lstm_backward(*mixed)


def test_lstm_benchmark_net_on_the_card_matches_the_cpu(dev):
    """The text-classification net at small widths (H = 40, not a multiple
    of the tiles) in f32: loss and all 15 gradients on the card (K9 with
    residuals, K10) against the CPU (their plain versions), nonzero
    peepholes and biases, mixed lengths; the inference pass (K9 without
    residuals) gives the same logits."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import lstm_benchmark_net

    nn.reset_naming()
    cost, _ = lstm_benchmark_net(60, emb_dim=16, hid_dim=40)
    cpu, card = nn.Topology(cost, device="cpu"), nn.Topology(cost, device=dev)
    params, _ = cpu.init(5)
    rng = np.random.RandomState(5)
    for k, v in params.items():
        if ".check_" in k or k.endswith(".wbias"):
            params[k] = torch.from_numpy(
                (0.3 * rng.randn(*v.shape)).astype(np.float32))
    params["_emb.w0"] = params["_emb.w0"] * 50.0
    B, T = 6, 11
    lens = rng.randint(1, T + 1, B)
    lens[0], lens[1] = T, 1
    feed = {"words": (rng.randint(3, 60, (B, T)), lens),
            "label": rng.randint(0, 2, (B, 1))}
    out = {}
    before = launch_counts()
    with compute_dtype_scope("float32"):
        for name, topo, dv in (("cpu", cpu, "cpu"), ("card", card, dev)):
            p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
            outs, _ = topo.apply(p, {}, feed, train=True)
            loss = outs[cost.name].value
            grads = torch.autograd.grad(loss, list(p.values()))
            with torch.no_grad():
                logits = topo.apply(p, {}, feed)[0]["logits"].value
            out[name] = (loss.detach().cpu(), [g.cpu() for g in grads],
                         outs["logits"].value.detach().cpu(), logits.cpu())
    after = launch_counts()
    assert after["lstm_forward"] == before["lstm_forward"] + 4
    assert after["lstm_backward"] == before["lstm_backward"] + 2
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    assert len(out["card"][1]) == 15
    for got, want in zip(out["card"][1], out["cpu"][1]):
        _rel_close(got, want, 1e-4)
    torch.testing.assert_close(out["card"][3], out["card"][2], rtol=0, atol=0)
    torch.testing.assert_close(out["card"][3], out["cpu"][3], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("N,V,k,dt", [(40, 515, 4, torch.float32),
                                      (3, 131, 3, torch.bfloat16),
                                      (7, 16, 16, torch.float32),
                                      (192, 30000, 3, torch.bfloat16)])
def test_topk_logits_kernel_matches_plain_version(dev, N, V, k, dt):
    """K8: ragged vocab tails, k up to 16 and k == V, integer-valued tie
    rows, -inf entries and a row that is all -inf: ids and values
    identical (the same logits, the same order), lse to rounding."""
    rng = np.random.RandomState(N + V)
    x = rng.randn(N, V).astype(np.float32)
    x[0] = rng.randint(-2, 3, V)
    x[1, ::3] = -np.inf
    x[2] = -np.inf
    logits = torch.from_numpy(x).to(dev, dt)
    before = launch_counts()["topk_lse_logits"]
    kv, ki, kl = topk_lse_logits(logits, k)
    assert launch_counts()["topk_lse_logits"] == before + 1
    pv, pi, pl = topk_lse_logits_plain(logits, k)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.isfinite(kl).all()
    torch.testing.assert_close(kl, pl, rtol=1e-6, atol=1e-5)


def test_topk_logits_wrapper_checks(dev):
    """The wrapper refuses what the kernel does not take on the card too,
    and a strided view gives what its contiguous copy gives."""
    x = torch.randn(6, 40, device=dev)
    for bad, k in ((x[0], 1), (x, 0), (x, 17), (x.double(), 2)):
        with pytest.raises(ValueError):
            topk_lse_logits(bad, k)
    view = torch.randn(40, 6, device=dev).t()
    for a, b in zip(topk_lse_logits(view, 3),
                    topk_lse_logits(view.contiguous(), 3)):
        assert torch.equal(a, b)


def _k8_rows(N, V, seed):
    """Gaussian logits with an integer-valued tie row, a row of zeros, a
    row with every third logit -inf and an all -inf row."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, V).astype(np.float32)
    x[0] = rng.randint(-2, 3, V)
    x[1] = 0.0
    x[2, ::3] = -np.inf
    x[3] = -np.inf
    return x


def _k8_same_as_plain(got, logits, k):
    pv, pi, pl = topk_lse_logits_plain(logits, k)
    assert torch.equal(got[1], pi) and torch.equal(got[0], pv)
    assert torch.isfinite(got[2]).all()
    torch.testing.assert_close(got[2], pl, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [30000, 30001])
def test_topk_logits_rows_do_not_depend_on_n(dev, dt, V):
    """K8: an N = 1 or N = 37 call gives the same rows as the N = 192
    call, bit for bit, lse included; at V = 30001 the rows of a call on
    rows 5..41 start at other 16-byte offsets than in the N = 192 call."""
    x = torch.from_numpy(_k8_rows(192, V, 8)).to(dev, dt)
    full = topk_lse_logits(x, 3)
    for rows in (slice(0, 1), slice(0, 37), slice(5, 42), slice(155, 192)):
        part = topk_lse_logits(x[rows].contiguous(), 3)
        for a, b in zip(part, full):
            assert torch.equal(a, b[rows])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [30001, 29999])
def test_topk_logits_misaligned_rows_match_plain_version(dev, dt, V):
    """K8 on a contiguous view whose base lies one element past the
    allocation's (no row starts 16-byte aligned in the usual way) and on
    ragged vocabularies: ids and values identical to the plain version."""
    N = 40
    flat = torch.from_numpy(_k8_rows(N, V, V).reshape(-1))
    buf = torch.empty(N * V + 1, dtype=dt, device=dev)
    buf[1:] = flat.to(dev, dt)
    view = buf[1:].view(N, V)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _k8_same_as_plain(topk_lse_logits(view, 3), view, 3)
    for a, b in zip(topk_lse_logits(view, 3),
                    topk_lse_logits(view.clone(), 3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_topk_logits_ties_and_inf_rows_match_plain_version(dev, dt, k):
    """K8 at the generation vocabulary: tie rows, a row with -inf entries
    and an all -inf row (whose top-k are -inf logits at the lowest ids)
    give ids and values identical to the plain version."""
    x = _k8_rows(16, 30000, k)
    x[4, 7:] = -np.inf                   # fewer finite logits than k = 16
    logits = torch.from_numpy(x).to(dev, dt)
    got = topk_lse_logits(logits, k)
    _k8_same_as_plain(got, logits, k)
    assert got[1][3].tolist() == list(range(k))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_topk_logits_every_plan_matches_plain_version(dev, dt):
    """K8 under every split the kernel takes (1, 2, 4 or 8 blocks a row;
    slices staged in one chunk or in many): ids and values identical to
    the plain version."""
    from paddle_tpu_torch.ops.kernels import topk_logits as TL

    logits = torch.from_numpy(_k8_rows(12, 30001, 4)).to(dev, dt)
    for clusters in (1, 2, 4, 8):
        for chunk_bytes in (4096, TL._MAX_CHUNK_BYTES):
            plan = TL._plan_for(30001, dt, clusters, chunk_bytes)
            _k8_same_as_plain(TL._launch(logits, 16, plan), logits, 16)


def test_topk_logits_is_one_launch_a_call(dev):
    """Each K8 call adds one to its count and runs one device kernel (the
    outputs are allocated, nothing else); N = 0 launches nothing.  The
    trace opens with one fill kernel of its own: the tracer can miss the
    first kernel after it starts."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(192, 30000, device=dev)
    topk_lse_logits(x, 3)
    torch.cuda.synchronize()
    before = launch_counts()["topk_lse_logits"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=dev)
        torch.cuda.synchronize()
        for _ in range(3):
            topk_lse_logits(x, 3)
        torch.cuda.synchronize()
    assert launch_counts()["topk_lse_logits"] == before + 3
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    k8 = [n for n in kernels if "topk_logits_cluster_kernel" in n]
    assert len(k8) == 3, kernels
    assert len(kernels) - len(k8) <= 1, kernels
    out = topk_lse_logits(x[:0], 3)
    assert [tuple(t.shape) for t in out] == [(0, 3), (0, 3), (0,)]
    assert launch_counts()["topk_lse_logits"] == before + 3


def test_seqtoseq_generation_on_the_card_matches_the_cpu(dev):
    """The DSL's seqToseq generation net at small widths in f32: the card
    (K3 for the encoder, K8 every decode step) against the CPU (their plain
    versions), ids exact, scores to 1e-5."""
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2.networks as networks
    from torch_seqtoseq_net import seqtoseq_generator

    nn.reset_naming()
    gen = seqtoseq_generator(nn, networks, V=300, E=16, H=24, D=20, A=8,
                             beam=3, max_len=9)
    cpu, card = nn.Topology(gen, device="cpu"), nn.Topology(gen, device=dev)
    params, _ = cpu.init(3)
    params["_readout.w0"] = params["_readout.w0"] * 8.0
    rng = np.random.RandomState(3)
    feed = {"src": (rng.randint(3, 300, (4, 9)), np.array([9, 4, 7, 1]))}
    before = launch_counts()
    with compute_dtype_scope("float32"):
        ct = cpu.apply(params, {}, feed)[0]["gen"]
        gt = card.apply({k: v.to(dev) for k, v in params.items()}, {},
                        feed)[0]["gen"]
    after = launch_counts()
    assert after["gru_forward"] == before["gru_forward"] + 2
    assert after["topk_lse_logits"] > before["topk_lse_logits"]
    assert torch.equal(gt.value.cpu(), ct.value)
    torch.testing.assert_close(gt.state["scores"].cpu(), ct.state["scores"],
                               rtol=1e-5, atol=1e-5)


def _bigru_inputs(B, T, H, seed):
    """A stacked bidirectional batch: 2B rows, ragged lengths, the backward
    half's mask flipped in time (padding at the front)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, (B,))
    lens[0] = T
    m = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    m2 = np.concatenate([m, m[:, ::-1]]).T.copy()             # [T, 2B]
    xp = (0.5 * rng.randn(T, 2 * B, 3 * H)).astype(np.float32)
    w2 = ((2.0 / (4 * H)) ** 0.5 * rng.randn(2 * H, 3 * H)).astype(
        np.float32)
    d_out = rng.randn(T, 2 * B, H).astype(np.float32)
    d_hfin = rng.randn(2 * B, H).astype(np.float32)
    return [torch.from_numpy(a) for a in (xp, m2, w2, d_out, d_hfin)]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H", [(5, 9, 40), (384, 6, 128)])
def test_bigru_kernels_bit_identical_to_two_gru_calls(dev, cd, B, T, H):
    """K11 (inference and residual variants, and the reverse loop) against
    K3/K4 called once per direction on the same rows: every output bit for
    bit, since a row's arithmetic and its order are shared
    (csrc/gru_common.cuh).  B = 5 leaves a partial row block on each side
    of the split; each wrapper launches once."""
    xp, m2, w2, d_out, d_hfin = (t.to(dev) for t in _bigru_inputs(
        B, T, H, B + H))
    halves = ((slice(0, B), w2[:H]), (slice(B, None), w2[H:]))
    with compute_dtype_scope(cd):
        before = launch_counts()
        inf = bigru_forward(xp, m2, w2, residuals=False, batch_split=B)
        res = bigru_forward(xp, m2, w2, residuals=True, batch_split=B)
        w_t = torch.cat([w2[:H].t(), w2[H:].t()], 1).contiguous()
        d_z, d_h0 = bigru_backward(d_out, m2, res[2], res[3], w_t, d_hfin,
                                   batch_split=B)
        after = launch_counts()
        assert after["bigru_forward"] == before["bigru_forward"] + 2
        assert after["bigru_backward"] == before["bigru_backward"] + 1
        assert after["gru_forward"] == before["gru_forward"]
        assert after["gru_backward"] == before["gru_backward"]
        for rows, w in halves:
            x, m = xp[:, rows].transpose(0, 1), m2[:, rows].t()
            h_seq, h_fin = gru_forward(x, m, w)
            assert torch.equal(inf[0][:, rows], h_seq.transpose(0, 1))
            assert torch.equal(inf[1][rows], h_fin)
            r = gru_forward(x, m, w, residuals=True)
            assert torch.equal(res[0][:, rows], r[0].transpose(0, 1))
            for got, want in zip(res[1:], (r[1], r[2], r[3])):
                assert torch.equal(got[rows] if got.dim() == 2
                                   else got[:, rows], want)
            dz, dh0 = gru_backward(d_out[:, rows], m2[:, rows],
                                   res[2][:, rows], res[3][:, rows],
                                   w.t().contiguous(), d_hfin[rows])
            assert torch.equal(d_z[:, rows], dz)
            assert torch.equal(d_h0[rows], dh0)


@pytest.mark.parametrize("B,T,H", [(3, 7, 16), (33, 5, 96)])
def test_bigru_kernels_match_plain_versions(dev, B, T, H):
    """K11 against its plain version (two one-direction step loops) at f32:
    the same sums in another order."""
    xp, m2, w2, d_out, d_hfin = (t.to(dev) for t in _bigru_inputs(
        B, T, H, 7 * B))
    w_t = torch.cat([w2[:H].t(), w2[H:].t()], 1)
    with compute_dtype_scope("float32"):
        got = bigru_forward(xp, m2, w2, residuals=True, batch_split=B)
        want = bigru_forward_plain(xp, m2, w2, residuals=True,
                                   batch_split=B)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        g = bigru_backward(d_out, m2, got[2], got[3], w_t, d_hfin,
                           batch_split=B)
        p = bigru_backward_plain(d_out, m2, got[2], got[3], w_t, d_hfin,
                                 batch_split=B)
    for a, b in zip(g, p):
        _rel_close(a, b, 1e-5)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,V", [(37, 50), (9, 3), (20, 30000),
                                 (11, 1031)])
def test_logsumexp_kernel_matches_plain_version(dev, N, V, dt):
    """K12 at row widths that are and are not 16-byte aligned (V = 50 in
    bf16 is 100 bytes a row), a row with -inf entries and an all -inf row
    (nan on both sides, the reference's answer); one launch."""
    rng = np.random.RandomState(N + V)
    x = (3.0 * rng.randn(N, V)).astype(np.float32)
    x[1, ::2] = -np.inf
    x[2] = -np.inf
    xt = torch.from_numpy(x).to(dev, dt)
    before = launch_counts()["logsumexp_rows"]
    got = logsumexp_rows(xt)
    assert launch_counts()["logsumexp_rows"] == before + 1
    want = logsumexp_rows_plain(xt)
    assert torch.isnan(got[2]) and torch.isnan(want[2])
    keep = torch.arange(N, device=dev) != 2
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-6, atol=1e-5)
    # a strided view reads as its contiguous copy (nan included)
    torch.testing.assert_close(logsumexp_rows(xt.t().contiguous().t()), got,
                               rtol=0, atol=0, equal_nan=True)


def test_fused_encoder_and_lse_readout_train_on_the_card_as_on_the_cpu(dev):
    """A small model's loss and 19 gradients at f32 with both switches on:
    the card (K11 and K12 with the decoder's kernels) against the CPU
    (their plain versions); the two-call encoder and K1/K2 not launched."""
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.ops import losses
    from paddle_tpu_torch.utils.flags import FLAGS

    cfg = dict(src_vocab=60, trg_vocab=300, emb_dim=16, enc_dim=32,
               dec_dim=32, att_dim=16)
    cpu = Seq2SeqAttention(**cfg, device="cpu")
    card = Seq2SeqAttention(**cfg, device=dev)
    params = cpu.init(seed=4)
    for k, f in (("src_emb", 50.0), ("trg_emb", 50.0), ("att_v", 20.0)):
        params[k] = params[k] * f
    rng = np.random.RandomState(4)
    B, S, T = 5, 8, 6
    core = rng.randint(3, 300, (B, T - 1))
    batch = {"src_ids": rng.randint(3, 60, (B, S)),
             "src_len": np.array([8, 3, 6, 1, 5]),
             "trg_in": np.concatenate([np.zeros((B, 1), int), core], 1),
             "trg_next": np.concatenate([core, np.ones((B, 1), int)], 1),
             "trg_len": np.array([6, 2, 1, 6, 4])}
    out = {}
    old = FLAGS.fused_bigru, losses._USE_LSE_READOUT
    FLAGS.fused_bigru, losses._USE_LSE_READOUT = True, True
    try:
        before = launch_counts()
        with compute_dtype_scope("float32"):
            for name, model, dv in (("cpu", cpu, "cpu"), ("card", card, dev)):
                p = {k: v.to(dv).requires_grad_() for k, v in params.items()}
                loss = model.loss(p, batch)
                grads = torch.autograd.grad(loss, list(p.values()))
                out[name] = (loss.detach().cpu(), [g.cpu() for g in grads])
        after = launch_counts()
    finally:
        FLAGS.fused_bigru, losses._USE_LSE_READOUT = old
    for k in ("bigru_forward", "bigru_backward", "logsumexp_rows"):
        assert after[k] == before[k] + 1, k
    for k in ("gru_forward", "gru_backward", "ce_readout_fwd",
              "ce_readout_bwd"):
        assert after[k] == before[k], k
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for got, want in zip(out["card"][1], out["cpu"][1]):
        _rel_close(got, want, 1e-4)


def _topk_inputs(dev, N, D, V, seed):
    rng = np.random.RandomState(seed)
    s = torch.from_numpy(np.tanh(rng.randn(N, D)).astype(np.float32))
    w = torch.from_numpy((rng.randn(D, V) / np.sqrt(D)).astype(np.float32))
    b = torch.from_numpy((0.01 * rng.randn(V)).astype(np.float32))
    return s.to(dev).bfloat16(), w.to(dev).bfloat16(), b.to(dev)


def _topk_paths():
    from paddle_tpu_torch.ops.kernels.topk_readout import TOPK_LSE_READOUT
    return dict(TOPK_LSE_READOUT.launches_by_path)


@pytest.mark.parametrize("N,D,V,k", [(192, 512, 30000, 3), (40, 128, 4096, 16),
                                     (3, 64, 16, 16), (7, 256, 2056, 4),
                                     (130, 512, 392, 1)])
def test_topk_wgmma_path_matches_plain_version(dev, N, D, V, k):
    """K7's TMA + wgmma pass 1 (bf16, D an instantiated depth, V % 8 == 0)
    across row blocks, vocab chunks, a chunk whose second half lies past V
    (V = 2056, 392) and k == V: one launch on the wgmma path; values and lse
    within 1e-5 (exact bf16 products, f32 sums in another order), ids equal
    wherever the plain top-(k+1) values are further apart than that."""
    s, w, b = _topk_inputs(dev, N, D, V, N + V)
    before = _topk_paths()
    kv, ki, kl = topk_lse_readout(s, w, b, k)
    after = _topk_paths()
    assert after.get("wgmma", 0) == before.get("wgmma", 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    pv, pi, pl = topk_lse_readout_plain(s, w, b, k)
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-5)
    if k < V:
        logits = s.float() @ w.float() + b
        pv1 = torch.sort(logits, dim=1, descending=True).values[:, :k + 1]
        decisive = (pv1[:, :-1] - pv1[:, 1:]).min(dim=1).values > 1e-5
    else:
        decisive = torch.ones(N, dtype=torch.bool, device=dev)
    assert torch.equal(ki[decisive], pi[decisive])


@pytest.mark.parametrize("k", [1, 3, 16])
def test_topk_wgmma_rows_do_not_depend_on_n(dev, k):
    """A solo decode's rows (N = 3) are bit-equal to the same rows of the
    slot table's call (N = 192), wherever they sit in the 64-row tile."""
    s, w, b = _topk_inputs(dev, 192, 512, 30000, 5)
    big = topk_lse_readout(s, w, b, k)
    for r0 in (0, 61, 96, 189):
        small = topk_lse_readout(s[r0:r0 + 3].clone(), w, b, k)
        for a, c in zip(small, big):
            assert torch.equal(a, c[r0:r0 + 3])


def test_topk_wgmma_ties_and_inf_bias(dev):
    """On the wgmma path: all-tie rows resolve to the lowest ids across
    tiles and chunks; -inf logits stay selectable after every finite one
    and leave the lse finite."""
    N, D, V, k = 8, 128, 1024, 5
    s = torch.zeros(N, D, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(D, V, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(V, device=dev)
    before = _topk_paths()
    _, ki, _ = topk_lse_readout(s, w, b, k)
    assert torch.equal(ki.cpu(), torch.arange(k).repeat(N, 1))
    b[:1021] = -float("inf")
    kv, ki, kl = topk_lse_readout(s, w, b, k)
    assert _topk_paths().get("wgmma", 0) == before.get("wgmma", 0) + 2
    pv, pi, pl = topk_lse_readout_plain(s, w, b, k)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ki[0].cpu(), torch.tensor([1021, 1022, 1023, 0, 1]))
    assert torch.isfinite(kl).all()
    torch.testing.assert_close(kl, pl, rtol=1e-6, atol=1e-6)


def test_topk_shapes_tma_cannot_take_keep_the_simt_path(dev):
    """V % 8 != 0 and an unaligned states base take the SIMT pass 1, with
    the plain version's results."""
    s, w, b = _topk_inputs(dev, 96, 512, 30001, 9)
    buf = torch.empty(96 * 512 + 1, dtype=torch.bfloat16, device=dev)
    s_odd = buf[1:].view(96, 512)
    s_odd.copy_(s)
    w8, b8 = w[:, :30000].contiguous(), b[:30000].contiguous()
    before = _topk_paths()
    got = [topk_lse_readout(s, w, b, 3), topk_lse_readout(s_odd, w8, b8, 3)]
    assert _topk_paths().get("simt", 0) == before.get("simt", 0) + 2
    for (kv, ki, kl), args in zip(got, ((s, w, b), (s, w8, b8))):
        pv, pi, pl = topk_lse_readout_plain(*args, 3)
        torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1][1], topk_lse_readout(s, w8, b8, 3)[1])


def _lstm_bwd_args(dev, T, B, H, rd, seed):
    rng = np.random.RandomState(seed)
    f = np.float32
    lens = rng.randint(1, T + 1, (B,))
    lens[0] = T
    m_tb = (np.arange(T)[:, None] < lens[None]).astype(f)
    arrs = [rng.randn(T, B, H), m_tb, rng.randn(T, B, 4 * H),
            rng.randn(T, B, H), rng.randn(4 * H, H) / np.sqrt(2 * H),
            0.3 * rng.randn(H), 0.3 * rng.randn(H), 0.3 * rng.randn(H),
            rng.randn(B, H), rng.randn(B, H)]
    out = [torch.from_numpy(a.astype(f)).to(dev) for a in arrs]
    out[2], out[3] = out[2].to(rd), out[3].to(rd)
    return out


def _lstm_paths():
    from paddle_tpu_torch.ops.kernels.lstm import LSTM_BACKWARD
    return dict(LSTM_BACKWARD.launches_by_path)


@pytest.mark.parametrize("T,B,H,rd", [(9, 37, 1280, torch.float32),
                                      (20, 64, 256, torch.bfloat16),
                                      (7, 5, 100, torch.float32),
                                      (6, 200, 64, torch.bfloat16),
                                      (4, 1, 1280, torch.float32)])
def test_lstm_backward_persistent_matches_plain_version(dev, T, B, H, rd):
    """K10's persistent kernel (one cooperative launch, w_t in shared
    memory) at ragged B and H, several row blocks (B = 200), masked tails
    and nonzero peepholes: one launch on that path; f32 sums in another
    order (1e-5 of the largest value); the per-step kernel, reached through
    the wrapper's internal entry, agrees to the same tolerance."""
    from paddle_tpu_torch.ops.kernels.lstm import _launch_bwd

    args = _lstm_bwd_args(dev, T, B, H, rd, B + H)
    before = _lstm_paths()
    got = lstm_backward(*args)
    after = _lstm_paths()
    assert after.get("persistent", 0) == before.get("persistent", 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want = lstm_backward_plain(*args)
    steps = _launch_bwd(*args, True, "steps")
    for a, c, d in zip(got, want, steps):
        assert torch.isfinite(a).all()
        _rel_close(a, c, 1e-5)
        _rel_close(d, c, 1e-5)
    again = lstm_backward(*args, want_cn=False)
    assert again[1] is None
    for a, c in zip((again[0], again[2], again[3]),
                    (got[0], got[2], got[3])):
        assert torch.equal(a, c)


def test_lstm_backward_persistent_rows_do_not_depend_on_b(dev):
    """Rows of a 5-row call are bit-equal to the same rows of a 70-row
    call: the split of w_t and the order of every sum depend on H and the
    SM count, not on B."""
    T, B, H = 8, 70, 256
    args = _lstm_bwd_args(dev, T, B, H, torch.float32, 3)
    big = lstm_backward(*args)
    rows = slice(30, 35)
    sub = [a[:, rows] if a.dim() == 3 or i == 1 else a
           for i, a in enumerate(args)]
    sub[8], sub[9] = args[8][rows], args[9][rows]
    small = lstm_backward(*[a.contiguous() for a in sub])
    for a, c in zip(small, big):
        ref = c[:, rows] if c.dim() == 3 else c[rows]
        assert torch.equal(a, ref)


def test_lstm_backward_beyond_the_persistent_limits_takes_the_steps(dev):
    """B above the persistent kernel's row limit takes the per-step
    kernel, with the plain version's results."""
    args = _lstm_bwd_args(dev, 5, 300, 32, torch.float32, 4)
    before = _lstm_paths()
    got = lstm_backward(*args)
    assert _lstm_paths().get("steps", 0) == before.get("steps", 0) + 1
    for a, c in zip(got, lstm_backward_plain(*args)):
        _rel_close(a, c, 1e-5)


def _lstm_fwd_paths():
    from paddle_tpu_torch.ops.kernels.lstm import LSTM_FORWARD
    return dict(LSTM_FORWARD.launches_by_path)


def _lstm_fwd_args(dev, B, T, H, seed):
    """K9's inputs at the text-classification scale: lengths from T/2 to T
    with a full row and a length-1 row, boot state, nonzero peepholes."""
    rng = np.random.RandomState(seed)
    f = np.float32
    lens = rng.randint(T // 2, T + 1, (B,))
    lens[0], lens[-1] = T, 1
    arrs = [0.5 * rng.randn(B, T, 4 * H),
            np.arange(T)[None] < lens[:, None],
            rng.randn(H, 4 * H) * np.sqrt(2.0 / (5 * H)),
            0.1 * rng.randn(H), 0.1 * rng.randn(H), 0.1 * rng.randn(H),
            0.5 * rng.randn(B, H), 0.5 * rng.randn(B, H)]
    return [torch.from_numpy(a.astype(f)).to(dev) for a in arrs]


@pytest.mark.parametrize("H", [256, 1280])
@pytest.mark.parametrize("residuals", [False, True])
def test_lstm_forward_persistent_matches_plain_version(dev, H, residuals):
    """K9's persistent kernel (one cooperative launch, bf16 w_h in shared
    memory, tensor-core products) at b64 and the benchmark widths, ragged
    lengths, both variants, under the bf16 policy: one launch on that path;
    a last-bit difference in the f32 carry can round a bf16 operand or
    residual the other way (5e-3 of the largest value, as the step
    kernel's test); padded steps emit exact zeros."""
    args = _lstm_fwd_args(dev, 64, 30, H, H)
    with compute_dtype_scope("bfloat16"):
        before = _lstm_fwd_paths()
        got = lstm_forward(*args, residuals=residuals)
        after = _lstm_fwd_paths()
        want = lstm_forward_plain(*args, residuals=residuals)
    torch.cuda.synchronize()
    assert after.get("persistent", 0) == before.get("persistent", 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.isfinite(a).all()
        _rel_close(a, b, 5e-3)
    padded = args[1] == 0
    assert torch.equal(got[0][padded], torch.zeros_like(got[0][padded]))


def test_lstm_forward_persistent_rows_do_not_depend_on_b(dev):
    """Rows 0..36 of a 64-row call are bit-equal to a 37-row call on the
    same rows, with residuals: the split of w_h and every k order depend
    on H and the SM count, not on B."""
    T, H = 12, 1280
    args = _lstm_fwd_args(dev, 64, T, H, 5)
    n = 37
    sub = [a[:n].contiguous() if i in (0, 1, 6, 7) else a
           for i, a in enumerate(args)]
    with compute_dtype_scope("bfloat16"):
        big = lstm_forward(*args, residuals=True)
        small = lstm_forward(*sub, residuals=True)
    for i, (s, b) in enumerate(zip(small, big)):
        assert torch.equal(s, b[:, :n] if i >= 3 else b[:n])


def test_lstm_forward_beyond_the_persistent_limits_takes_the_steps(dev):
    """The f32 policy, H not a multiple of 8 and B above the row limit take
    the per-step kernel, with the plain version's results."""
    cases = [("float32", 5, 64), ("bfloat16", 5, 100),
             ("bfloat16", 300, 32)]
    for cd, B, H in cases:
        args = _lstm_fwd_args(dev, B, 6, H, B + H)
        with compute_dtype_scope(cd):
            before = _lstm_fwd_paths()
            got = lstm_forward(*args, residuals=True)
            assert _lstm_fwd_paths().get("steps", 0) == \
                before.get("steps", 0) + 1
            want = lstm_forward_plain(*args, residuals=True)
        for a, b in zip(got, want):
            _rel_close(a, b, 1e-5 if cd == "float32" else 5e-3)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_attn_dec_bwd_rows_do_not_depend_on_b(dev, cd):
    """K6's rows 0..36 of a 96-row call are bit-equal to a 37-row call on
    the same rows (d_xp, sum_dpre, d_enc_proj, d_s0): every product's k
    order and the attention's sums depend on the widths alone; d_v sums
    over the rows and is held against the plain version instead."""
    from paddle_tpu_torch.ops.attention_decoder import recompute_gates

    shape = (96, 17, 7, 128, 96, 256)
    x = {k: v.to(dev) for k, v in _attn_dec_inputs(*shape, seed=3).items()}
    T, D = shape[2], shape[3]
    dt = getattr(torch, cd)
    n = 37
    with compute_dtype_scope(cd):
        fa = [x["xp_y"], x["m"], x["s0"], x["enc"].to(dt),
              x["enc_proj"].to(dt), x["src_mask"], x["att_w"].to(dt),
              x["att_v"].to(dt), x["wx_c"].to(dt), x["wh"].to(dt)]
        _, _, ctxs, s_prev = attn_dec_fwd(*fa)
        r, u, cand, q = recompute_gates(x["xp_y"], ctxs, s_prev, x["wx_c"],
                                        x["wh"], x["att_w"])
        d_out = torch.from_numpy(np.random.RandomState(4).randn(
            T, shape[0], D).astype(np.float32)).to(dev)
        args = [d_out, x["m"], s_prev, r, u, cand, q, fa[3], fa[4],
                x["src_mask"], x["att_w"], x["att_v"], x["wh"], x["wx_c"]]
        big = attn_dec_bwd(*args)
        sub = [a[:, :n] if i <= 6 else a[:n] if i <= 9 else a
               for i, a in enumerate(args)]
        small = attn_dec_bwd(*[a.contiguous() for a in sub])
        plain = attn_dec_bwd_plain(*[a.contiguous() for a in sub])
    torch.cuda.synchronize()
    assert torch.equal(small[0], big[0][:, :n])
    assert torch.equal(small[1], big[1][:, :n])
    assert torch.equal(small[2], big[2][:n])
    assert torch.equal(small[4], big[4][:n])
    _rel_close(small[3], plain[3], 1e-5 if cd == "float32" else 1e-2)


def _gru_bwd_args(dev, T, B, H, rd, seed):
    """K4's inputs: cotangents, a mask with a full row and ragged tails,
    residuals in ``rd`` and a transposed weight scaled by its fan-in."""
    rng = np.random.RandomState(seed)
    f = np.float32
    lens = rng.randint(1, T + 1, (B,))
    lens[0] = T
    arrs = [rng.randn(T, B, H), (np.arange(T)[:, None] < lens[None]),
            rng.randn(T, B, 3 * H), rng.randn(T, B, H),
            rng.randn(3 * H, H) / np.sqrt(2 * H), rng.randn(B, H)]
    out = [torch.from_numpy(a.astype(f)).to(dev) for a in arrs]
    out[2], out[3] = out[2].to(rd), out[3].to(rd)
    return out


def _gru_bwd_paths(name="gru_backward"):
    from paddle_tpu_torch.ops.kernels.build import LIBRARIES
    return dict(LIBRARIES[name].launches_by_path)


@pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(9, 37, 512), (6, 384, 128), (5, 3, 40),
                                   (4, 70, 96)])
def test_gru_backward_persistent_matches_plain_version(dev, T, B, H, rd):
    """K4's persistent kernel (one cooperative launch, w_t in shared
    memory) at ragged B and H, several 16-row tiles a row group (B = 384),
    masked tails, f32 and bf16 residuals: one launch on that path; f32
    sums in another order (1e-5 of the largest value); the steps kernels,
    reached through the wrapper's internal entry, agree to the same."""
    from paddle_tpu_torch.ops.kernels.gru import _launch_bwd

    args = _gru_bwd_args(dev, T, B, H, rd, B + H)
    before = _gru_bwd_paths()
    got = gru_backward(*args)
    after = _gru_bwd_paths()
    assert after.get("persistent", 0) == before.get("persistent", 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    want = gru_backward_plain(*args)
    steps = _launch_bwd(*args, "steps")
    for a, c, d in zip(got, want, steps):
        assert torch.isfinite(a).all()
        _rel_close(a, c, 1e-5)
        _rel_close(d, c, 1e-5)


def test_gru_backward_persistent_rows_do_not_depend_on_b(dev):
    """The first 37 rows of a 384-row call are bit-equal to a 37-row call
    on the same rows: every output's k order depends on H alone, and the
    row groups only decide which block computes a row."""
    T, B, H, n = 7, 384, 512, 37
    args = _gru_bwd_args(dev, T, B, H, torch.bfloat16, 5)
    big = gru_backward(*args)
    sub = [a[:, :n] for a in args[:4]] + [args[4], args[5][:n]]
    small = gru_backward(*[a.contiguous() for a in sub])
    assert torch.equal(small[0], big[0][:, :n])
    assert torch.equal(small[1], big[1][:n])


@pytest.mark.parametrize("B,H", [(384, 512), (37, 96)])
def test_bigru_backward_persistent_bit_identical_to_two_gru_calls(dev, B, H):
    """K11's reverse on its persistent path (blocks each serving one
    direction) against K4 on its persistent path, once per direction:
    identical bits, as the fused encoder's step-1 loss requires."""
    T = 6
    fw = _gru_bwd_args(dev, T, B, H, torch.bfloat16, 1)
    bw = _gru_bwd_args(dev, T, B, H, torch.bfloat16, 2)
    both = [torch.cat([a, b], 1) for a, b in zip(fw[:4], bw[:4])]
    w_t = torch.cat([fw[4], bw[4]], 1).contiguous()
    d_hfin = torch.cat([fw[5], bw[5]])
    before = _gru_bwd_paths("bigru_backward")
    got = bigru_backward(*both, w_t, d_hfin, batch_split=B)
    assert _gru_bwd_paths("bigru_backward").get("persistent", 0) == \
        before.get("persistent", 0) + 1
    before = _gru_bwd_paths()
    for rows, one_args in ((slice(0, B), fw), (slice(B, None), bw)):
        one = gru_backward(*one_args)
        assert torch.equal(got[0][:, rows], one[0])
        assert torch.equal(got[1][rows], one[1])
    assert _gru_bwd_paths().get("persistent", 0) == \
        before.get("persistent", 0) + 2
    want = bigru_backward_plain(*both, w_t, d_hfin, batch_split=B)
    for a, c in zip(got, want):
        _rel_close(a, c, 1e-5)


@pytest.mark.parametrize("B,H", [(1025, 16), (5, 516), (5, 42)])
def test_gru_backward_beyond_the_persistent_limits_takes_the_steps(dev, B,
                                                                    H):
    """Past the row limit, past the w_t slice's room (H > 512) and with
    rows not in 16-byte pieces (H % 4), K4 and K11's reverse take the
    steps kernels, with the plain versions' results."""
    args = _gru_bwd_args(dev, 3, B, H, torch.float32, 6)
    before = _gru_bwd_paths()
    got = gru_backward(*args)
    assert _gru_bwd_paths().get("steps", 0) == before.get("steps", 0) + 1
    for a, c in zip(got, gru_backward_plain(*args)):
        _rel_close(a, c, 1e-5)
    both = [torch.cat([a, a], 1) for a in args[:4]]
    w_t = torch.cat([args[4], args[4]], 1).contiguous()
    before = _gru_bwd_paths("bigru_backward")
    got = bigru_backward(*both, w_t, torch.cat([args[5], args[5]]),
                         batch_split=B)
    assert _gru_bwd_paths("bigru_backward").get("steps", 0) == \
        before.get("steps", 0) + 1
    for a, c in zip(got, bigru_backward_plain(
            *both, w_t, torch.cat([args[5], args[5]]), batch_split=B)):
        _rel_close(a, c, 1e-5)


def _attn_fwd_paths():
    from paddle_tpu_torch.ops.kernels.attention_decoder import ATTN_DEC_FWD
    return dict(ATTN_DEC_FWD.launches_by_path)


def _attn_fwd_args(shape, dt, dev, seed):
    x = {k: v.to(dev) for k, v in _attn_dec_inputs(*shape, seed=seed).items()}
    return [x["xp_y"], x["m"], x["s0"]] + [
        x[k].to(dt) for k in ("enc", "enc_proj")] + [x["src_mask"]] + [
        x[k].to(dt) for k in ("att_w", "att_v", "wx_c", "wh")]


@pytest.mark.parametrize("shape", [(37, 17, 9, 128, 128, 256),
                                   (40, 5, 4, 64, 128, 96),
                                   (3, 7, 5, 32, 32, 64),
                                   (384, 32, 3, 512, 512, 1024)])
def test_attn_dec_fwd_persistent_matches_plain_version(dev, shape):
    """K5's persistent kernel (bf16: one cooperative launch, weights in
    shared memory, mma.sync products) at ragged B and S, 8 and 16 units a
    block, masked source and target tails and a row with no source
    position: one launch on that path; a last-bit difference in a float32
    sum can round an operand the other way (2^-8 relative), which the
    recurrence carries (5e-3, as the steps kernels); the steps kernels
    agree to the same."""
    from paddle_tpu_torch.ops.kernels.attention_decoder import _launch_fwd

    with compute_dtype_scope("bfloat16"):
        args = _attn_fwd_args(shape, torch.bfloat16, dev, 9)
        before = _attn_fwd_paths()
        got = attn_dec_fwd(*args)
        after = _attn_fwd_paths()
        assert after.get("persistent", 0) == before.get("persistent", 0) + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want = attn_dec_fwd_plain(*args)
        steps = _launch_fwd(*args, "steps")
    assert got[2].dtype == torch.bfloat16
    for a, c, d in zip(got, want, steps):
        assert torch.isfinite(a.float()).all()
        _rel_close(a, c, 5e-3)
        _rel_close(d, c, 5e-3)
    padded = args[1] == 0
    assert torch.equal(got[0][padded], torch.zeros_like(got[0][padded]))


def test_attn_dec_fwd_persistent_rows_do_not_depend_on_b(dev):
    """The first 37 rows of a 384-row call (bf16, the training widths) are
    bit-equal to a 37-row call on the same rows: each output's k order
    depends on the widths alone and each row's attention runs in one
    block."""
    n = 37
    with compute_dtype_scope("bfloat16"):
        args = _attn_fwd_args((384, 32, 4, 512, 512, 1024), torch.bfloat16,
                              dev, 4)
        big = attn_dec_fwd(*args)
        sub = [a[:, :n] if i < 2 else a[:n] if i < 6 else a
               for i, a in enumerate(args)]
        small = attn_dec_fwd(*[a.contiguous() for a in sub])
    for a, c in zip(small, big):
        assert torch.equal(a, c[:, :n])


@pytest.mark.parametrize("shape,cd", [((513, 5, 2, 512, 512, 1024),
                                       "bfloat16"),
                                      ((33, 17, 3, 96, 80, 160), "bfloat16"),
                                      ((37, 17, 3, 128, 128, 256),
                                       "float32")])
def test_attn_dec_fwd_beyond_the_persistent_limits_takes_the_steps(dev, shape,
                                                                   cd):
    """Past the row limit (B > 128 a row group), widths the plan cannot
    split, and the f32 policy: K5 takes the steps kernels, with the plain
    version's results."""
    with compute_dtype_scope(cd):
        args = _attn_fwd_args(shape, getattr(torch, cd), dev, 5)
        before = _attn_fwd_paths()
        got = attn_dec_fwd(*args)
        assert _attn_fwd_paths().get("steps", 0) == \
            before.get("steps", 0) + 1
        want = attn_dec_fwd_plain(*args)
    for a, c in zip(got, want):
        _rel_close(a, c, 2e-5 if cd == "float32" else 5e-3)


def _gru_fwd_args(dev, T, B, H, seed, boot=True):
    """K3's inputs, batch-major: an input projection, a mask with a full row
    and ragged tails, a recurrent weight scaled by its fan-in and (``boot``)
    a boot state."""
    rng = np.random.RandomState(seed)
    f = np.float32
    lens = rng.randint(1, T + 1, (B,))
    lens[0] = T
    arrs = [0.5 * rng.randn(B, T, 3 * H),
            np.arange(T)[None] < lens[:, None],
            rng.randn(H, 3 * H) * np.sqrt(2.0 / (4 * H))]
    if boot:
        arrs.append(0.5 * rng.randn(B, H))
    return [torch.from_numpy(a.astype(f)).to(dev) for a in arrs]


def _gru_fwd_paths(name="gru_forward"):
    from paddle_tpu_torch.ops.kernels.build import LIBRARIES
    return dict(LIBRARIES[name].launches_by_path)


def _gru_fwd_close(got, want, tol=5e-3):
    """chip_smoke.py's bf16 tolerances: h_seq and h_final within ``tol``
    (max abs); the bf16 residuals within ``tol`` plus one bf16 rounding
    step, which a last-bit difference in the f32 carry can flip."""
    for a, c in zip(got[:2], want[:2]):
        assert torch.isfinite(a).all()
        assert (a - c).abs().max().item() <= tol
    for a, c in zip(got[2:], want[2:]):
        assert a.dtype == c.dtype
        assert bool(((a.float() - c.float()).abs()
                     <= tol + 2.0 ** -7 * c.float().abs()).all())


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("T,B,H", [(9, 37, 512), (6, 384, 128), (5, 3, 96),
                                   (4, 70, 64), (3, 20, 544)])
def test_gru_forward_persistent_matches_plain_version(dev, T, B, H,
                                                      residuals):
    """K3's persistent kernel (bf16: one cooperative launch, W in shared
    memory, mma.sync products) at ragged B, several 16-row tiles a warp
    (B = 384 at H = 128: 8 unit groups x 16 row groups), masked tails and a
    boot state, with and without residuals (bf16 up to H = 512, f32 at
    H = 544):
    one launch on that path, the plain version's results within the
    smoke's bf16 tolerances, and the steps kernels, reached through the
    wrapper's internal entry, within the same."""
    from paddle_tpu_torch.ops.kernels.gru import _launch_fwd

    xp, mask, w_h, h0 = _gru_fwd_args(dev, T, B, H, B + H)
    with compute_dtype_scope("bfloat16"):
        before = _gru_fwd_paths()
        got = gru_forward(xp, mask, w_h, h0, residuals=residuals)
        after = _gru_fwd_paths()
        assert after.get("persistent", 0) == before.get("persistent", 0) + 1
        assert sum(after.values()) == sum(before.values()) + 1
        want = gru_forward_plain(xp, mask, w_h, h0, residuals=residuals)
        steps = _launch_fwd(xp, mask, w_h, h0, residuals, "steps")
    assert len(got) == (4 if residuals else 2)
    _gru_fwd_close(got, want)
    _gru_fwd_close(steps, want)
    padded = mask == 0
    assert torch.equal(got[0][padded], torch.zeros_like(got[0][padded]))


def test_gru_forward_persistent_rows_do_not_depend_on_b(dev):
    """The first rows of a 384-row call (bf16, the flagship's width, with
    residuals) are bit-equal to calls of 1, 37 and 64 rows on the same rows
    (a solo decode, a ragged batch, a full prefill): each output's k order
    depends on H alone, and the row groups only decide which block computes
    a row.  The inference variant's rows equal the residual variant's."""
    xp, mask, w_h = _gru_fwd_args(dev, 8, 384, 512, 3, boot=False)
    with compute_dtype_scope("bfloat16"):
        big = gru_forward(xp, mask, w_h, residuals=True)
        for n in (1, 37, 64):
            small = gru_forward(xp[:n].contiguous(), mask[:n].contiguous(),
                                w_h, residuals=True)
            assert torch.equal(small[0], big[0][:n])
            assert torch.equal(small[1], big[1][:n])
            assert torch.equal(small[2], big[2][:, :n])
            assert torch.equal(small[3], big[3][:, :n])
        inf = gru_forward(xp[:64].contiguous(), mask[:64].contiguous(), w_h)
    assert torch.equal(inf[0], big[0][:64])
    assert torch.equal(inf[1], big[1][:64])


@pytest.mark.parametrize("B,T,H", [(384, 6, 512), (37, 5, 96)])
def test_bigru_forward_persistent_bit_identical_to_two_gru_calls(dev, B, T,
                                                                  H):
    """K11's forward on its persistent path (blocks each serving one
    direction) against K3 on its persistent path, once per direction, with
    and without residuals: identical bits, as the fused encoder's step-1
    loss and the fused serve's ids require."""
    xp, m2, w2, _, _ = (t.to(dev) for t in _bigru_inputs(B, T, H, 11))
    with compute_dtype_scope("bfloat16"):
        before = _gru_fwd_paths("bigru_forward")
        inf = bigru_forward(xp, m2, w2, residuals=False, batch_split=B)
        res = bigru_forward(xp, m2, w2, residuals=True, batch_split=B)
        assert _gru_fwd_paths("bigru_forward").get("persistent", 0) == \
            before.get("persistent", 0) + 2
        before = _gru_fwd_paths()
        for rows, w in ((slice(0, B), w2[:H]), (slice(B, None), w2[H:])):
            x, m = xp[:, rows].transpose(0, 1), m2[:, rows].t()
            one = gru_forward(x, m, w)
            assert torch.equal(inf[0][:, rows], one[0].transpose(0, 1))
            assert torch.equal(inf[1][rows], one[1])
            one = gru_forward(x, m, w, residuals=True)
            assert torch.equal(res[0][:, rows], one[0].transpose(0, 1))
            assert torch.equal(res[1][rows], one[1])
            assert torch.equal(res[2][:, rows], one[2])
            assert torch.equal(res[3][:, rows], one[3])
        assert _gru_fwd_paths().get("persistent", 0) == \
            before.get("persistent", 0) + 4
        want = bigru_forward_plain(xp, m2, w2, residuals=True,
                                   batch_split=B)
    _gru_fwd_close(res, want)


@pytest.mark.parametrize("cd,B,H", [("float32", 37, 512),
                                    ("bfloat16", 5, 40),
                                    ("bfloat16", 1025, 32)])
def test_gru_forward_beyond_the_persistent_limits_takes_the_steps(dev, cd, B,
                                                                  H):
    """Under the f32 policy, with H % 32 != 0 and past the row limit, K3
    and K11's forward take the steps kernels, with the plain versions'
    results (f32: the same sums in another order)."""
    tol = 1e-5 if cd == "float32" else 5e-3
    xp, mask, w_h, h0 = _gru_fwd_args(dev, 4, B, H, 8)
    with compute_dtype_scope(cd):
        before = _gru_fwd_paths()
        got = gru_forward(xp, mask, w_h, h0, residuals=True)
        assert _gru_fwd_paths().get("steps", 0) == \
            before.get("steps", 0) + 1
        _gru_fwd_close(got, gru_forward_plain(xp, mask, w_h, h0,
                                              residuals=True), tol)
        xb = torch.cat([xp, xp]).transpose(0, 1).contiguous()
        mb = torch.cat([mask, mask]).t().contiguous()
        w2 = torch.cat([w_h, w_h])
        before = _gru_fwd_paths("bigru_forward")
        got = bigru_forward(xb, mb, w2, residuals=True, batch_split=B)
        assert _gru_fwd_paths("bigru_forward").get("steps", 0) == \
            before.get("steps", 0) + 1
        _gru_fwd_close(got, bigru_forward_plain(xb, mb, w2, residuals=True,
                                                batch_split=B), tol)


# ---------------------------------------------------------------------------
# the served entry point: InferenceServer over the slot table on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def hard_alarm():
    """A hard ``signal.alarm`` around a server test, as the reference's
    serving tests have: a wedged worker fails the test, never the run."""
    import signal

    def _abort(signum, frame):
        raise RuntimeError("server test exceeded 120 s")

    prev = signal.signal(signal.SIGALRM, _abort)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


#: a small flagship whose prefill takes K3's persistent kernel (H % 32 ==
#: 0) and whose readout takes K7's wgmma pass 1 (D = 128, V % 8 == 0)
_SERVE_CFG = dict(src_vocab=200, trg_vocab=256, emb_dim=64, enc_dim=64,
                  dec_dim=128, att_dim=64)


def _served_flagship(dev, *, max_len=12, never_eos=False):
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.models.seq2seq import EOS
    from paddle_tpu_torch.serving import Seq2SeqSlotBackend

    m = Seq2SeqAttention(**_SERVE_CFG, device=dev)
    p = m.init(seed=3)
    if never_eos:       # the flagship's straggler: EOS never scores
        p = dict(p, out_b=p["out_b"].clone())
        p["out_b"][EOS] = -1e4
    return Seq2SeqSlotBackend(m, p, src_len=16, beam_size=3,
                              max_len=max_len)


def _src_feeds(n, seed=0):
    rng = np.random.default_rng(seed)
    feeds = []
    for _ in range(n):
        t = int(rng.integers(3, 17))
        feeds.append({"src": (rng.integers(3, 200, (1, t)),
                              np.asarray([t]))})
    return feeds


def _direct(backend, feeds, slots):
    """The oracle: the same requests through a SlotScheduler driven by
    hand (admit as slots free up, step, harvest)."""
    from paddle_tpu_torch.serving import (Request, ServingFuture,
                                          SlotScheduler, canonicalize_feed)

    reqs = []
    for f in feeds:
        canon, rows, sig = canonicalize_feed(f)
        reqs.append(Request(feed=canon, rows=rows, signature=sig,
                            future=ServingFuture(), deadline=None,
                            t_submit=0.0))
    sched = SlotScheduler(backend, slots=slots)
    out, pending = {}, list(reqs)
    while pending or sched.occupied():
        for req, res, _ in sched.harvest():
            out[id(req)] = res
        while pending and sched.free_count():
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()
    return [out[id(r)] for r in reqs]


def _serve(backend, feeds, slots, **kw):
    """The same requests through InferenceServer(mode="generation"); the
    launch counts are those of the submits alone (after the warmup)."""
    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving import InferenceServer

    srv = InferenceServer(backend, mode="generation", slots=slots,
                          max_queue=64, batch_delay_ms=0.0,
                          default_deadline_ms=60000.0, **kw)
    with srv:
        srv.start(warmup_feed=feeds[0])
        reset_launch_counts()
        futs = [srv.submit(f) for f in feeds]
        results = [f.result(120) for f in futs]
        torch.cuda.synchronize()
        return results, launch_counts(), srv.healthz()


def test_server_on_the_card_matches_a_direct_slot_table_run(dev,
                                                            hard_alarm):
    """Per request, ids and scores identical to a direct SlotScheduler run
    of the same requests (bf16 compute, 4 slots, 10 requests)."""
    with compute_dtype_scope("bfloat16"):
        backend = _served_flagship(dev)
        feeds = _src_feeds(10)
        want = _direct(backend, feeds, slots=4)
        got, _, hz = _serve(backend, feeds, slots=4)
    assert hz["counters"]["completed"] == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["scores"], w["scores"])


def test_server_kernels_launch_from_the_worker_thread(dev, hard_alarm):
    """K3 (persistent) and K7 (wgmma pass 1) launch for the served
    requests, and only from the server's worker thread."""
    with compute_dtype_scope("bfloat16"):
        _, launches, _ = _serve(_served_flagship(dev), _src_feeds(6, 1),
                                slots=4)
    for name, path in (("gru_forward", "persistent"),
                       ("topk_lse_readout", "wgmma")):
        n = launches[name]
        assert n > 0, name
        assert launches.by_path[name] == {path: n}, launches.by_path[name]
        assert all(t.startswith("serving-worker-")
                   for t in launches.by_thread[name]), \
            launches.by_thread[name]
        assert sum(launches.by_thread[name].values()) == n


def test_server_evicts_an_expired_request_typed_on_the_card(dev,
                                                            hard_alarm):
    """A never-EOS request whose deadline (50 ms) is far shorter than its
    256-step decode fails DeadlineExceeded mid-generation, its slot is
    recycled, and the next request is served."""
    from paddle_tpu_torch.serving import DeadlineExceeded, InferenceServer

    with compute_dtype_scope("bfloat16"):
        backend = _served_flagship(dev, max_len=256, never_eos=True)
        feeds = _src_feeds(2, 2)
        srv = InferenceServer(backend, mode="generation", slots=2,
                              max_queue=8, batch_delay_ms=0.0,
                              default_deadline_ms=60000.0)
        with srv:
            srv.start(warmup_feed=feeds[0])
            err = srv.submit(feeds[0], deadline_ms=50.0).error(120)
            assert isinstance(err, DeadlineExceeded), err
            assert "mid-generation" in str(err)
            ok = srv.submit(feeds[1], max_len=4).result(120)
            hz = srv.healthz()
    assert ok["tokens"].shape == (1, 3, 4)
    assert hz["counters"]["slot_evicted"] == 1
    assert hz["slots"]["occupied"] == 0 and hz["slots"]["recycled"] == 2


# ---------------------------------------------------------------------------
# speculative decoding, the prefix cache and host paging on the card
# ---------------------------------------------------------------------------


def test_topk_wgmma_rows_identical_at_the_wide_verify_row_count(dev):
    """The wide verify reads out (k+1)·S = 320 rows where the plain step
    reads 64: greedy verification is bit-identical only if a row's
    (vals, idx, lse) do not depend on N.  Rows at N = 64, 128 and 192 are
    bit-equal to the same rows of the N = 320 call, and every call takes
    the wgmma pass 1."""
    s, w, b = _topk_inputs(dev, 320, 512, 30000, 11)
    before = _topk_paths()
    big = topk_lse_readout(s, w, b, 1)
    calls = 1
    for n in (64, 128, 192):
        for r0 in range(0, 320 - n + 1, 64):
            part = topk_lse_readout(s[r0:r0 + n].clone(), w, b, 1)
            calls += 1
            for a, c in zip(part, big):
                assert torch.equal(a, c[r0:r0 + n]), (n, r0)
    after = _topk_paths()
    assert after.get("wgmma", 0) - before.get("wgmma", 0) == calls
    assert sum(after.values()) - sum(before.values()) == calls


def _greedy_flagship(dev, width=None, max_len=16):
    from paddle_tpu_torch.models import Seq2SeqAttention
    from paddle_tpu_torch.serving import Seq2SeqSlotBackend

    m = (Seq2SeqAttention(device=dev) if width is None
         else Seq2SeqAttention(**width, device=dev))
    p = m.init(seed=4)
    return Seq2SeqSlotBackend(m, p, src_len=16, beam_size=1,
                              max_len=max_len)


def _requests(feeds):
    from paddle_tpu_torch.serving import (Request, ServingFuture,
                                          canonicalize_feed)

    reqs = []
    for f in feeds:
        canon, rows, sig = canonicalize_feed(f)
        reqs.append(Request(feed=canon, rows=rows, signature=sig,
                            future=ServingFuture(), deadline=None,
                            t_submit=0.0))
    return reqs


def _drive(sched, reqs, hook=None):
    out, pending, cycle = {}, list(reqs), 0
    while (pending or sched.occupied()
           or (sched.pager is not None and len(sched.pager))):
        if hook is not None:
            hook(sched, cycle)
        cycle += 1
        if sched.pager is not None:
            sched.page_in()
        for req, res, _ in sched.harvest():
            out[id(req)] = res
        while pending and sched.free_count():
            sched.admit([pending.pop(0)])
        if sched.occupied():
            sched.step()
    return [out[id(r)] for r in reqs]


def test_extract_restore_slot_round_trip_through_the_host(dev):
    """A slot's decode context copied to the host and written back into
    its slot of a table that has since been overwritten gives the
    original table back, bit for bit (bf16 state leaves included)."""
    from paddle_tpu_torch.ops.decode import (decode_step, extract_slot,
                                             init_slot_carry, restore_slot,
                                             write_slot)
    from paddle_tpu_torch.serving import canonicalize_feed

    with compute_dtype_scope("bfloat16"), torch.no_grad():
        be = _greedy_flagship(dev, width=_SERVE_CFG)
        feeds = _src_feeds(3, 7)
        tpl = be.prefill(be.example_feed(1))
        c = init_slot_carry(tpl, slots=3, beam_size=1, max_len=be.max_len)
        for slot, f in enumerate(feeds):
            write_slot(c, slot, be.prefill(canonicalize_feed(f)[0]))
        for _ in range(3):
            c = decode_step(be.step_fn, be.readout, c,
                            vocab_size=be.vocab_size)
        # a bf16 leaf, which numpy cannot hold, rides the round trip too
        c["state"]["enc"] = c["state"]["enc"].bfloat16()
        saved = extract_slot(c, 1)
        host = {k: ({n: t.cpu() for n, t in v.items()}
                    if isinstance(v, dict) else v.cpu())
                for k, v in saved.items()}
        assert host["state"]["enc"].dtype == torch.bfloat16
        orig = {k: ({n: t.clone() for n, t in v.items()}
                    if isinstance(v, dict) else v.clone())
                for k, v in c.items()}
        write_slot(c, 1, be.prefill(canonicalize_feed(feeds[0])[0]))
        c["active"][1] = False
        restore_slot(c, 1, host)
        torch.cuda.synchronize()
    for name in ("tokens", "logp", "finished", "active", "step"):
        assert torch.equal(c[name], orig[name]), name
    for name in orig["state"]:
        assert torch.equal(c["state"][name], orig["state"][name]), name


def test_spec_cache_paging_arm_equals_plain_arm_at_full_width(dev,
                                                              hard_alarm):
    """The flagship at its full width (30k/30k, 512-d), beam 1, bf16: 12
    requests over 3 sources through 4 slots with spec_k=4, the prefix
    cache and a page-out every 3 cycles give the plain arm's tokens and
    scores bit for bit, and each equals the request's solo greedy decode;
    every K7 launch (N = 4 at the plain step, 20 at the wide one) takes
    the wgmma pass 1."""
    from paddle_tpu_torch.ops.decode import greedy_decode
    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.serving import SlotScheduler, canonicalize_feed

    with compute_dtype_scope("bfloat16"):
        be = _greedy_flagship(dev)
        src = _src_feeds(3, 9)
        feeds = [src[i % 3] for i in range(12)]
        plain = _drive(SlotScheduler(be, slots=4), _requests(feeds))
        reset_launch_counts()
        full = SlotScheduler(be, slots=4, spec_k=4, prefix_cache_mb=64.0,
                             page_pool_mb=64.0)
        got = _drive(full, _requests(feeds),
                     hook=lambda s, cyc: cyc % 3 == 2 and s.page_out_victim())
        launches = launch_counts()
        solo = []
        for f in src:
            st0 = be.prefill(canonicalize_feed(f)[0])
            t, sc = greedy_decode(be.step_fn, be.readout, st0, batch_size=1,
                                  vocab_size=be.vocab_size,
                                  max_len=be.max_len)
            solo.append((t.cpu().numpy(), sc.cpu().numpy()))
    for i, (g, w) in enumerate(zip(got, plain)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_array_equal(g["tokens"][:, 0], solo[i % 3][0])
        np.testing.assert_array_equal(g["scores"][:, 0], solo[i % 3][1])
    assert full.spec_steps > 0 and full.spec_accepted > 0
    assert full.prefix_cache.hits == 9
    assert full.pager.paged_out == full.pager.paged_in > 0
    assert launches["topk_lse_readout"] == full.steps_run
    assert launches.by_path["topk_lse_readout"] == {
        "wgmma": full.steps_run}


def test_server_worker_relaunch_under_load(dev, hard_alarm):
    """``chaos.kill_worker`` three times while requests are in flight:
    every request resolves (an answer, or ``WorkerCrashed`` for those the
    dead worker held); resubmitted, every answer equals the direct run;
    after the last relaunch K3/K7 launch only from the live worker
    (``serving-worker-<generation>``); and device memory does not grow by
    a cuBLAS workspace (32 MiB) per relaunch."""
    import time

    from paddle_tpu_torch.ops.kernels import reset_launch_counts
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import InferenceServer, WorkerCrashed

    workspace = 32 * 2 ** 20
    with compute_dtype_scope("bfloat16"):
        backend = _served_flagship(dev)
        feeds = _src_feeds(12, 4)
        want = _direct(backend, feeds, slots=4)
        srv = InferenceServer(backend, mode="generation", slots=4,
                              max_queue=64, batch_delay_ms=0.0,
                              default_deadline_ms=60000.0, max_restarts=5,
                              restart_backoff_s=0.01,
                              max_restart_backoff_s=0.05)
        with srv:
            srv.start(warmup_feed=feeds[0])
            got = {i: f.result(120) for i, f in
                   enumerate([srv.submit(f) for f in feeds])}
            torch.cuda.synchronize()
            mem = [torch.cuda.memory_allocated(dev)]
            crashed = 0
            for kill in range(3):
                futs = {i: srv.submit(f) for i, f in enumerate(feeds)}
                chaos.kill_worker(srv)
                for i, f in futs.items():
                    err = f.error(120)
                    if err is None:
                        got[i] = f.result(0)
                    else:
                        assert isinstance(err, WorkerCrashed), err
                        crashed += 1
                deadline = time.monotonic() + 30
                while (srv.supervisor.restarts < kill + 1
                       or not srv.supervisor.alive()):
                    assert time.monotonic() < deadline, "no relaunch"
                    time.sleep(0.01)
                again = {i: srv.submit(f) for i, f in enumerate(feeds)}
                for i, f in again.items():
                    np.testing.assert_array_equal(f.result(120)["tokens"],
                                                  want[i]["tokens"])
                    np.testing.assert_array_equal(
                        f.result(0)["scores"], want[i]["scores"])
                torch.cuda.synchronize()
                mem.append(torch.cuda.memory_allocated(dev))
            reset_launch_counts()
            live = f"serving-worker-{srv.supervisor._generation}"
            for f in [srv.submit(f) for f in feeds]:
                f.result(120)
            launches = launch_counts()
            hz = srv.healthz()
    assert crashed > 0, "no kill landed on a resident request"
    assert hz["worker"]["restarts"] == 3
    for i, g in got.items():
        np.testing.assert_array_equal(g["tokens"], want[i]["tokens"])
        np.testing.assert_array_equal(g["scores"], want[i]["scores"])
    for name in ("gru_forward", "topk_lse_readout"):
        assert launches[name] > 0
        assert launches.by_thread[name] == {live: launches[name]}, \
            launches.by_thread[name]
    growth = (mem[-1] - mem[0]) / 3
    print(f"device memory after each relaunch: {mem} bytes; growth "
          f"{growth:.0f} bytes a relaunch")
    assert growth < workspace, mem


# ---------------------------------------------------------------------------
# the trainer on the card
# ---------------------------------------------------------------------------


def _textclf_trainer(device, seed=0, **kw):
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    nn.reset_naming()
    cost, _ = lstm_benchmark_net(48, emb_dim=8, hid_dim=16, num_layers=2)
    return SGDTrainer(cost, Adam(learning_rate=1e-2), seed=seed,
                      device=device, **kw)


def _textclf_feeds(n=3, B=6, T=10):
    rng = np.random.RandomState(4)
    return [{"words": (rng.randint(3, 48, (B, T)).astype(np.int32),
                       rng.randint(2, T + 1, B).astype(np.int32)),
             "label": rng.randint(0, 2, (B, 1))} for _ in range(n)]


def _trainer_state(tr):
    from paddle_tpu_torch.param.optimizers import slot_leaves

    return ({k: v.detach().cpu() for k, v in tr.params.items()},
            {k: [s.cpu() for s in slot_leaves(v)]
             for k, v in tr.opt_state["slots"].items()},
            int(tr.opt_state["step"]))


def test_trainer_on_the_card_matches_the_cpu_trainer(dev):
    """Three ``train_batch`` calls of a small ``lstm_benchmark_net`` in f32
    on the card (K9r, K10 on their steps kernels under f32) and on the CPU
    (plain versions), from the same ``seed``: losses within rtol 1e-5, each
    parameter and slot within 1e-4 of its largest entry (f32 sums in
    another order, carried through Adam's normalised update)."""
    feeds = _textclf_feeds()
    with compute_dtype_scope("float32"):
        card, cpu = _textclf_trainer(dev), _textclf_trainer("cpu")
        before = launch_counts()
        got = [float(card.train_batch(f)) for f in feeds]
        after = launch_counts()
        want = [float(cpu.train_batch(f)) for f in feeds]
    assert after["lstm_forward"] - before["lstm_forward"] == 6
    assert after["lstm_backward"] - before["lstm_backward"] == 6
    np.testing.assert_allclose(got, want, rtol=1e-5)
    a, b = _trainer_state(card), _trainer_state(cpu)
    assert a[2] == b[2] == 3
    worst = 0.0
    for k in a[0]:
        for x, y in zip([a[0][k], *a[1][k]], [b[0][k], *b[1][k]]):
            rel = (x - y).abs().max().item() / max(y.abs().max().item(),
                                                   1e-12)
            worst = max(worst, rel)
            assert rel <= 1e-4, k
    print(f"trainer card vs CPU, 3 f32 steps: loss max rel diff "
          f"{max(abs(g - w) / abs(w) for g, w in zip(got, want)):.3e}, "
          f"worst array max |diff| / max |entry| {worst:.3e}")


def test_trainer_checkpoints_cross_the_card_and_the_cpu(dev, tmp_path):
    """A checkpoint written on the card loads on the CPU, and one written
    on the CPU loads on the card, every array bit for bit and on the
    loader's device."""
    feeds = _textclf_feeds(2)
    card = _textclf_trainer(dev)
    card.train_batch(feeds[0])
    card.save(str(tmp_path / "card"), 0)
    cpu = _textclf_trainer("cpu", seed=9)
    cpu.load(str(tmp_path / "card"), 0)
    a, b = _trainer_state(card), _trainer_state(cpu)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
        for x, y in zip(a[1][k], b[1][k]):
            assert torch.equal(x, y), k
    assert a[2] == b[2] == 1
    cpu.train_batch(feeds[1])
    cpu.save(str(tmp_path / "cpu"), 0)
    back = _textclf_trainer(dev, seed=3)
    back.load(str(tmp_path / "cpu"), 0)
    assert back.opt_state["step"].device.type == "cuda"
    assert all(v.device.type == "cuda" and v.requires_grad
               for v in back.params.values())
    a, b = _trainer_state(cpu), _trainer_state(back)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert a[2] == b[2] == 2


def test_guard_skip_on_the_card_holds_every_bit(dev):
    """A NaN batch on the card: the parameters, the slots and the step
    counter stay bit for bit (selected on the card), the counters move,
    and the next finite batch trains."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.trainer import SGDTrainer

    nn.reset_naming()
    x = nn.data("x", size=4)
    lab = nn.data("label", size=1, dtype="int32")
    cost = nn.classification_cost(nn.fc(nn.fc(x, 8, act="tanh"), 3,
                                        act="linear"), lab)
    tr = SGDTrainer(cost, Adam(learning_rate=0.05), seed=0, device=dev)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(4, 4).astype(np.float32),
              "label": rng.randint(0, 3, (4, 1))} for _ in range(2)]
    tr.train_batch(feeds[0])
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    slots = {k: [s.clone() for s in v] for k, v in
             tr.opt_state["slots"].items()}
    step = tr.opt_state["step"].clone()
    loss = tr.train_batch(chaos.nan_feed(feeds[1]))
    assert not torch.isfinite(loss) and tr.bad_steps_total == 1
    for k, v in tr.params.items():
        assert torch.equal(v.detach(), before[k]), k
        for s, s0 in zip(tr.opt_state["slots"][k], slots[k]):
            assert torch.equal(s, s0), k
    assert torch.equal(tr.opt_state["step"], step)
    assert tr.opt_state["step"].device.type == "cuda"
    tr.train_batch(feeds[1])
    assert int(tr.opt_state["step"]) == 2 and tr.bad_steps_streak == 0


def test_trainer_test_and_infer_launch_k9_only(dev):
    """``test`` and ``infer`` run the inference variant: K9 launches, K10
    does not."""
    tr = _textclf_trainer(dev)
    feeds = _textclf_feeds(2)
    before = launch_counts()
    res = tr.test(lambda: iter(feeds))
    out = tr.infer([l for l in tr.topology.layers if l.name == "logits"],
                   feeds[0])
    after = launch_counts()
    assert after["lstm_forward"] - before["lstm_forward"] == 6
    assert after["lstm_backward"] == before["lstm_backward"]
    assert np.isfinite(res["cost"]) and out["logits"].shape == (6, 2)


# ---------------------------------------------------------------------------
# the image tier (ops/conv.py, ops/misc.py, the image layers, the trainer)
# ---------------------------------------------------------------------------

#: card vs CPU at f32 for one image op (max |diff| against the largest
#: entry): f32 sums of up to kh*kw*Cin terms in another order (cuDNN's
#: algorithms against the CPU's); pools, maxout and the element-wise ops
#: are exact or one rounding apart
TOL_IMAGE_OP = 1e-5


def _image_op_on_both(dev, fn, *arrays):
    """``fn`` on the card and on the CPU at f32: forward and the gradient
    of a seeded cotangent with respect to every input.  The ops are called
    directly, so ``resolve_device`` (which every entry point calls) pins
    real f32 on the card first: PyTorch's default lets cuDNN run f32
    convolutions in TF32."""
    from paddle_tpu_torch.device import resolve_device

    resolve_device(dev)
    out = []
    with compute_dtype_scope("float32"):
        for where in (dev, torch.device("cpu")):
            args = [torch.tensor(a, device=where, requires_grad=True)
                    for a in arrays]
            y = fn(*args)
            ct = np.random.RandomState(7).randn(*y.shape).astype(np.float32)
            grads = torch.autograd.grad(y, args,
                                        torch.tensor(ct, device=where))
            out.append([y.detach().cpu()] + [g.cpu() for g in grads])
    for got, want in zip(*out):
        scale = max(want.abs().max().item(), 1e-30)
        assert (got - want).abs().max().item() <= TOL_IMAGE_OP * scale


def _image(seed, *shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.mark.parametrize("k,s,pad,g", [(3, 1, "SAME", 1), (3, 2, "SAME", 1),
                                       (11, 4, [(1, 1), (1, 1)], 1),
                                       (5, 1, "VALID", 2),
                                       (1, 2, "SAME", 1)])
def test_conv2d_on_the_card_matches_the_cpu(dev, k, s, pad, g):
    from paddle_tpu_torch.ops import conv2d

    _image_op_on_both(
        dev, lambda x, w: conv2d(x, w, stride=(s, s), padding=pad,
                                 groups=g),
        _image(1, 2, 19, 18, 8), _image(2, k, k, 8 // g, 12, scale=0.2))


@pytest.mark.parametrize("k,s", [(3, 2), (4, 2), (3, 1), (2, 3)])
def test_conv2d_transpose_on_the_card_matches_the_cpu(dev, k, s):
    from paddle_tpu_torch.ops import conv2d_transpose

    _image_op_on_both(
        dev, lambda x, w: conv2d_transpose(x, w, stride=(s, s)),
        _image(3, 2, 7, 6, 5), _image(4, k, k, 5, 6, scale=0.3))


@pytest.mark.parametrize("op", ["max_pool2d", "avg_pool2d"])
@pytest.mark.parametrize("pad,k,s", [("SAME", 3, 2), ("VALID", 2, 2),
                                     (((0, 0), (1, 2), (1, 2), (0, 0)), 3,
                                      2)])
def test_pools_on_the_card_match_the_cpu(dev, op, pad, k, s):
    import paddle_tpu_torch.ops as O

    _image_op_on_both(dev, lambda x: getattr(O, op)(x, (k, k), (s, s), pad),
                      _image(5, 2, 13, 12, 4))


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_on_the_card_matches_the_cpu(dev, train):
    from paddle_tpu_torch.ops import batch_norm

    rm, rv = _image(6, 6), np.abs(_image(7, 6)) + 0.5

    def fn(x, scale, bias):
        y, nm, nv = batch_norm(x, scale, bias,
                               torch.tensor(rm, device=x.device),
                               torch.tensor(rv, device=x.device),
                               train=train)
        return y * 1.0 + 0.0 * (nm.sum() + nv.sum())

    _image_op_on_both(dev, fn, _image(8, 4, 5, 5, 6, scale=2.0) + 1.0,
                      np.abs(_image(9, 6)) + 0.5, _image(10, 6))


@pytest.mark.parametrize("name", ["cmr_norm", "bilinear_up",
                                  "bilinear_down", "maxout", "softmax",
                                  "softrelu", "stanh", "brelu"])
def test_image_ops_on_the_card_match_the_cpu(dev, name):
    import paddle_tpu_torch.ops as O

    fns = {"cmr_norm": lambda x: O.cmr_norm(x * 30.0, size=5),
           "bilinear_up": lambda x: O.bilinear_interp(x, 15, 11),
           "bilinear_down": lambda x: O.bilinear_interp(x, 3, 4),
           "maxout": lambda x: O.maxout(x, 2),
           "softmax": O.get_activation("softmax"),
           "softrelu": O.get_activation("softrelu"),
           "stanh": O.get_activation("stanh"),
           "brelu": lambda x: O.get_activation("brelu")(x * 20.0)}
    _image_op_on_both(dev, fns[name], _image(11, 2, 7, 6, 8))


def test_dropout_draws_on_the_cards_generator(dev):
    """The mask is drawn on the card by a CUDA generator seeded from the
    apply's CPU stream: the same seed gives the same mask, which is the
    one that generator draws, and nothing is drawn on the CPU."""
    from paddle_tpu_torch.ops import dropout

    x = torch.ones(256, 300, device=dev)
    y = dropout(torch.Generator().manual_seed(3), x, 0.25, train=True)
    again = dropout(torch.Generator().manual_seed(3), x, 0.25, train=True)
    assert y.device.type == "cuda" and torch.equal(y, again)
    seed = int(torch.randint(0, 2 ** 62, (1,),
                             generator=torch.Generator().manual_seed(3)))
    g = torch.Generator(device=dev).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=dev) < 0.75
    assert torch.equal(y != 0, keep)
    assert torch.allclose(y[keep], torch.full_like(y[keep], 1 / 0.75))
    assert abs(keep.float().mean().item() - 0.75) < 0.01
    cpu = dropout(torch.Generator().manual_seed(3), x.cpu(), 0.25,
                  train=True)
    assert not torch.equal(cpu != 0, keep.cpu())


def _resnet_trainer(dev, seed=0):
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.models import resnet_cifar
    from paddle_tpu_torch.param import Momentum
    from paddle_tpu_torch.trainer import SGDTrainer

    nn.reset_naming()
    cost, _ = resnet_cifar(depth=8)
    return SGDTrainer(cost, Momentum(learning_rate=0.1), seed=seed,
                      device=dev)


def _resnet_feeds(n, B=16):
    rng = np.random.RandomState(1)
    return [{"pixel": rng.rand(B, 32, 32, 3).astype(np.float32),
             "label": rng.randint(0, 10, (B, 1))} for _ in range(n)]


def test_resnet_training_is_deterministic_and_resumes_bit_for_bit(
        dev, tmp_path):
    """Two runs of four ``Momentum`` steps from one seed give the same
    losses bit for bit, and a run resumed from the checkpoint of step 2
    (batch-norm state included) gives steps 3-4 bit for bit: the image
    path's cuDNN kernels are deterministic under ``resolve_device``'s
    settings."""
    feeds = _resnet_feeds(4)
    runs = []
    for _ in range(2):
        tr = _resnet_trainer(dev)
        runs.append([tr.train_batch(f).item() for f in feeds])
    assert runs[0] == runs[1], runs
    tr = _resnet_trainer(dev)
    for f in feeds[:2]:
        tr.train_batch(f)
    tr.save(str(tmp_path), 1)
    resumed = _resnet_trainer(dev, seed=9)
    resumed.load(str(tmp_path), 1)
    assert [resumed.train_batch(f).item() for f in feeds[2:]] == runs[0][2:]
    assert any("moving_mean" in k for k in resumed.state)


def test_resnet_step_on_the_card_matches_the_cpu(dev):
    """One f32 ``train_batch`` of resnet at depth 8 on the card and on the
    CPU from the same weights: the loss (rel 1e-5) and the updated
    parameters and running stats (1e-4 of each array's largest entry: the
    update is ``-0.1 * grad`` from gradients equal to ~1e-5)."""
    feeds = _resnet_feeds(1, B=4)
    with compute_dtype_scope("float32"):
        card, cpu = _resnet_trainer(dev), _resnet_trainer("cpu")
        got = card.train_batch(feeds[0]).item()
        want = cpu.train_batch(feeds[0]).item()
    assert abs(got - want) <= 1e-5 * abs(want)
    for mine, theirs in ((card.params, cpu.params), (card.state, cpu.state)):
        for k, v in theirs.items():
            diff = (mine[k].detach().cpu() - v.detach()).abs().max().item()
            assert diff <= 1e-4 * max(v.abs().max().item(), 1e-6), k


# ---------------------------------------------------------------------------
# the text tier (sequence ops, the CRF, the text nets, recurrent groups)
# ---------------------------------------------------------------------------

#: card vs CPU at f32 for a text net: the loss (rel) and each gradient's
#: max |diff| against its largest entry (f32 sums in another order; the
#: GRU and LSTM kernels' steps kernels against their plain versions)
TOL_TEXT_LOSS, TOL_TEXT_GRAD = 1e-5, 1e-4


def _text_nets():
    """name -> (builder () -> cost layer, feed) at small widths."""
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2.networks as networks
    from torch_seqtoseq_net import seqtoseq_feed, seqtoseq_trainer
    from torch_text_nets import db_lstm_net, srl_net

    rng = np.random.RandomState(0)
    V, B, T = 50, 5, 9
    lens = np.array([9, 1, 4, 7, 3], np.int32)
    words = (rng.randint(0, V, (B, T)).astype(np.int32), lens)
    labels = (rng.randint(0, 7, (B, T)).astype(np.int32), lens)
    srl = {k: words for k in ("word_data", "ctx_n2_data", "ctx_n1_data",
                              "ctx_0_data", "ctx_p1_data", "ctx_p2_data",
                              "verb_data")}
    srl.update(mark_data=((words[0] % 2).astype(np.int32), lens),
               target=labels)
    cls = {"words": words, "label": rng.randint(0, 2, (B, 1))}

    def bidi():
        w = nn.data("words", size=V, is_seq=True, dtype="int32")
        h = networks.bidirectional_lstm(nn.embedding(w, 8, name="emb"), 6,
                                        name="bi")
        logits = nn.fc(nn.pooling(h), 2, act="linear", name="logits")
        return nn.classification_cost(logits, nn.data("label", size=1,
                                                      dtype="int32"))

    def group(kind):
        def build():
            w = nn.data("words", size=V, is_seq=True, dtype="int32")
            mult = 4 if kind == "lstm" else 3
            proj = nn.fc(nn.embedding(w, 8, name="emb"), mult * 6,
                         act="linear", name="proj")
            g = (networks.lstmemory_group(proj, 6, reverse=True, name="g")
                 if kind == "lstm" else networks.gru_group(proj, 6,
                                                           name="g"))
            logits = nn.fc(nn.last_seq(g), 2, act="linear", name="logits")
            return nn.classification_cost(
                logits, nn.data("label", size=1, dtype="int32"))
        return build

    return {
        "seqtoseq": (lambda: seqtoseq_trainer(nn, networks, V=V, E=8, H=6,
                                              D=5, A=4),
                     seqtoseq_feed(rng, B, V, 8)),
        "stacked_lstm_net": (lambda: models.stacked_lstm_net(
            V, emb_dim=8, hid_dim=12)[0], cls),
        "convolution_net": (lambda: models.convolution_net(
            V, emb_dim=8, hid_dim=12)[0], cls),
        "db_lstm": (lambda: db_lstm_net(nn, V, 7, word_dim=6, mark_dim=3,
                                        hidden_dim=16, depth=3)[0], srl),
        "srl_gru": (lambda: srl_net(nn, V, 7, 6, 5)[0],
                    {"words": words, "predicate": rng.randint(0, V, (B, 1)),
                     "labels": labels}),
        "bidirectional_lstm": (bidi, cls),
        "lstmemory_group": (group("lstm"), cls),
        "gru_group": (group("gru"), cls),
    }


@pytest.mark.parametrize("name", ["seqtoseq", "stacked_lstm_net",
                                  "convolution_net", "db_lstm", "srl_gru",
                                  "bidirectional_lstm", "lstmemory_group",
                                  "gru_group"])
def test_text_net_on_the_card_matches_the_cpu(dev, name):
    """One f32 training apply of a text net on the card and on the CPU from
    the same parameters (every all-zero one set to seeded normals, so the
    CRF's paths do not tie): the loss and every gradient."""
    import paddle_tpu_torch.nn as nn

    build, feed = _text_nets()[name]
    nn.reset_naming()
    cost = build()
    out = {}
    with compute_dtype_scope("float32"):
        for where in (dev, "cpu"):
            topo = nn.Topology(cost, device=where)
            params, _ = topo.init(3)
            rs = np.random.RandomState(5)
            params = {k: (torch.from_numpy(
                (0.3 * rs.randn(*v.shape)).astype(np.float32)).to(where)
                if not v.abs().max() > 0 else v).requires_grad_()
                for k, v in params.items()}
            outs, _ = topo.apply(params, {}, feed, train=True)
            loss = outs[cost.name].value
            grads = torch.autograd.grad(loss, list(params.values()))
            out[where if where == "cpu" else "card"] = (
                loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
    got, want = out["card"], out["cpu"]
    assert np.isfinite(want[0])
    assert abs(got[0] - want[0]) <= TOL_TEXT_LOSS * abs(want[0])
    for k, g in want[1].items():
        scale = max(g.abs().max().item(), 1e-30)
        assert (got[1][k] - g).abs().max().item() <= TOL_TEXT_GRAD * scale, k


def test_text_ops_on_the_card_match_the_cpu(dev):
    """The sequence ops and the CRF's log-likelihood, forward and
    gradient, on the card against the CPU at f32."""
    import paddle_tpu_torch.ops as O

    B, T, D = 4, 7, 3
    lens = torch.tensor([7, 1, 4, 5])
    m = O.mask_from_lengths(lens, T)
    tags = torch.from_numpy(np.random.RandomState(1).randint(0, D, (B, T)))
    cases = {
        "seq_reverse": lambda x: O.seq_reverse(x, lens.to(x.device)),
        "seq_concat": lambda x: O.seq_concat(x, lens.to(x.device), x[:, :3],
                                             (lens.clamp(max=3)).to(
                                                 x.device))[0],
        "context_projection": lambda x: O.context_projection(
            x, m.to(x.device), 3, -2),
        "context_projection_trainable": lambda x: (
            O.context_projection_trainable(x, lens.to(x.device),
                                           m.to(x.device), 4, -1,
                                           x[0, :3] * 0.5)),
        "crf_log_likelihood": lambda x: O.crf_log_likelihood(
            x, tags.to(x.device), m.to(x.device), x[0, 0], x[1, 0],
            x[2, :3]),
    }
    for name, fn in cases.items():
        _image_op_on_both(dev, fn, _image(3, B, T, D))


def test_crf_decode_on_the_card_matches_the_cpu(dev):
    """Viterbi tags and scores on the card equal the CPU's (f32)."""
    import paddle_tpu_torch.ops as O

    rs = np.random.RandomState(2)
    B, T, C = 6, 11, 5
    emis = torch.from_numpy(rs.randn(B, T, C).astype(np.float32))
    start, end = (torch.from_numpy(rs.randn(C).astype(np.float32))
                  for _ in range(2))
    trans = torch.from_numpy(rs.randn(C, C).astype(np.float32))
    m = O.mask_from_lengths(torch.tensor([11, 1, 5, 9, 2, 11]), T)
    args = (emis, m, start, end, trans)
    tags, score = O.crf_decode(*args)
    ctags, cscore = O.crf_decode(*(a.to(dev) for a in args))
    assert torch.equal(ctags.cpu(), tags)
    torch.testing.assert_close(cscore.cpu(), score, rtol=1e-6, atol=1e-5)


def test_text_paths_launch_their_kernels(dev):
    """Under bf16, at widths the persistent kernels take (H = 32):
    ``bidirectional_lstm`` trains through K9r and K10 once a direction;
    the seqToseq group through K3r and K4 once a direction and never
    K5/K6; ``stacked_lstm_net``'s relu LSTMs and the CRF of ``db_lstm``
    launch no kernel."""
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2.networks as networks
    from torch_seqtoseq_net import seqtoseq_feed, seqtoseq_trainer

    nets = _text_nets()
    V = 50
    feed = nets["bidirectional_lstm"][1]

    def bidi():
        w = nn.data("words", size=V, is_seq=True, dtype="int32")
        h = networks.bidirectional_lstm(nn.embedding(w, 16, name="emb"), 32,
                                        name="bi")
        logits = nn.fc(nn.pooling(h), 2, act="linear", name="logits")
        return nn.classification_cost(logits, nn.data("label", size=1,
                                                      dtype="int32"))

    cases = {
        "bidirectional_lstm": (bidi, feed, {"lstm_forward": 2,
                                            "lstm_backward": 2}),
        "seqtoseq": (lambda: seqtoseq_trainer(nn, networks, V=V, E=16, H=32,
                                              D=32, A=16),
                     seqtoseq_feed(np.random.RandomState(0), 5, V, 8),
                     {"gru_forward": 2, "gru_backward": 2}),
        "stacked_lstm_net": (lambda: models.stacked_lstm_net(
            V, emb_dim=16, hid_dim=32)[0], feed, {}),
        "db_lstm": (*nets["db_lstm"], {}),
    }
    for name, (build, feed, counts) in cases.items():
        nn.reset_naming()
        cost = build()
        topo = nn.Topology(cost, device=dev)
        params, _ = topo.init(0)
        params = {k: v.requires_grad_() for k, v in params.items()}
        before = launch_counts()
        with compute_dtype_scope("bfloat16"):
            loss = topo.apply(params, {}, feed, train=True)[0][
                cost.name].value
            torch.autograd.grad(loss, list(params.values()))
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == counts, (name, moved)
        for k in counts:
            paths = {p: n - before.by_path[k].get(p, 0)
                     for p, n in after.by_path[k].items()
                     if n != before.by_path[k].get(p, 0)}
            assert paths == {"persistent": counts[k]}, (name, k, paths)


# ---------------------------------------------------------------------------
# the sparse and sampled-cost tier (chip_smoke.py's sparse phase)
# ---------------------------------------------------------------------------

#: card vs CPU on the sparse nets at f32: the loss (rel) and each
#: gradient's max |diff| against its largest entry (f32 sums in another
#: order; the CTC net's LSTM through the kernels' steps paths)
TOL_SPARSE_LOSS, TOL_SPARSE_GRAD = 1e-5, 1e-4


def _sparse_nets():
    """name -> (builder () -> cost layer, feed) at small widths: the
    sparse phase's nets (``tests/torch_sparse_nets.py``,
    ``models/recommender.py``)."""
    import paddle_tpu_torch.models as models
    import paddle_tpu_torch.nn as nn
    import torch_sparse_nets as N

    rs = np.random.RandomState(0)
    B = 6
    cats = (rs.randint(0, 18, (B, 8)).astype(np.int32),
            np.array([1, 3, 2, 8, 1, 2], np.int32))
    title = (rs.randint(0, 5175, (B, 8)).astype(np.int32),
             np.array([8, 2, 5, 3, 8, 4], np.int32))
    ids = lambda n: rs.randint(0, n, (B, 1)).astype(np.int32)  # noqa: E731
    score = (1 + 4 * rs.rand(B, 1)).astype(np.float32)
    feature_feed = {"user_id": ids(6040), "gender_id": ids(2),
                    "age_id": ids(7), "job_id": ids(21),
                    "movie_id": ids(3952), "category_id": cats,
                    "movie_title": title, "score": score}
    ngram = {**{f"w{i}": ids(64) for i in range(4)}, "next_word": ids(64)}
    T = 12
    ctc_feed = {"feats": (rs.randn(B, T, 5).astype(np.float32),
                          np.array([12, 7, 9, 12, 5, 10], np.int32)),
                "labels": (rs.randint(0, 6, (B, 4)).astype(np.int32),
                           np.array([4, 2, 3, 1, 0, 4], np.int32))}
    return {
        "movielens_feature_net": (lambda: models.movielens_feature_net(
            emb_dim=8, fusion_dim=12)[0], feature_feed),
        "movielens_net_sparse_grad": (lambda: models.movielens_net(
            emb_dim=8, hid_dim=6, sparse_grad=True)[0],
            {"user_id": ids(6040), "movie_id": ids(3952), "score": score}),
        "sparse_lr": (lambda: N.sparse_lr_net(nn, 100)[0],
                      {"words": (rs.randint(0, 100, (B, 16)).astype(
                          np.int32), np.array([16, 3, 0, 9, 1, 12],
                                              np.int32)),
                       "label": ids(2)}),
        "word2vec_hsigmoid": (lambda: N.ngram_net(nn, 64, 8, 12, 5,
                                                  "hsigmoid"), ngram),
        "word2vec_nce": (lambda: N.ngram_net(nn, 64, 8, 12, 5, "nce"),
                         ngram),
        "ctc": (lambda: N.ctc_net(nn, 5, 8, 7)[0], ctc_feed),
    }


@pytest.mark.parametrize("name", ["movielens_feature_net",
                                  "movielens_net_sparse_grad", "sparse_lr",
                                  "word2vec_hsigmoid", "word2vec_nce",
                                  "ctc"])
def test_sparse_net_on_the_card_matches_the_cpu(dev, name, monkeypatch):
    """One f32 training apply of each sparse-phase net on the card and on
    the CPU from the same parameters (every all-zero one set to seeded
    normals): the loss and every gradient.  NCE's noise classes are drawn
    on the CPU for both (the card's generator draws other numbers)."""
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.ops as O

    real = O.uniform_classes
    monkeypatch.setattr(O, "uniform_classes", lambda g, shape, C, d: real(
        g, shape, C, "cpu").to(d))
    build, feed = _sparse_nets()[name]
    nn.reset_naming()
    cost = build()
    out = {}
    with compute_dtype_scope("float32"):
        for where in (dev, "cpu"):
            topo = nn.Topology(cost, device=where)
            params, _ = topo.init(3)
            rs = np.random.RandomState(5)
            params = {k: (torch.from_numpy(
                (0.3 * rs.randn(*v.shape)).astype(np.float32)).to(where)
                if not v.abs().max() > 0 else v).requires_grad_()
                for k, v in params.items()}
            outs, _ = topo.apply(params, {}, feed, train=True, rng=1)
            loss = outs[cost.name].value
            grads = torch.autograd.grad(loss, list(params.values()))
            out[where if where == "cpu" else "card"] = (
                loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
    got, want = out["card"], out["cpu"]
    assert np.isfinite(want[0])
    assert abs(got[0] - want[0]) <= TOL_SPARSE_LOSS * abs(want[0])
    for k, g in want[1].items():
        scale = max(g.abs().max().item(), 1e-30)
        diff = (got[1][k] - g).abs().max().item()
        assert diff <= TOL_SPARSE_GRAD * scale, (k, diff, scale)


def test_sparse_ops_and_ctc_on_the_card_match_the_cpu(dev):
    """The sparse products (duplicate ids, an all-padding row) and
    ``ctc_loss`` (blank 0 and last, an infeasible and an empty label),
    forward and gradient, on the card against the CPU at f32."""
    import paddle_tpu_torch.ops as O

    rs = np.random.RandomState(3)
    ids = torch.from_numpy(rs.randint(0, 30, (5, 6)))
    ids[0, 1] = ids[0, 0]
    mask = (torch.arange(6)[None] < torch.tensor([6, 0, 3, 1, 4])[:, None]
            ).float()
    sel = torch.from_numpy(rs.randint(0, 40, (5, 7)))
    csr = O.CsrMatrix.from_dense(np.where(rs.rand(5, 30) < 0.3,
                                          rs.randn(5, 30), 0.0))
    labels = torch.tensor([[1, 2, 3], [2, 2, 1], [0, 0, 0], [3, 1, 2]])
    lab_len = torch.tensor([3, 3, 0, 2])
    in_len = torch.tensor([9, 3, 6, 9])
    cases = {
        "sparse_gather_matmul": (lambda w, c: O.sparse_gather_matmul(
            ids.to(w.device), c, mask.to(w.device), w),
            (_image(1, 30, 8), _image(2, 5, 6))),
        "sparse_to_dense": (lambda c: O.sparse_to_dense(
            ids.to(c.device), c, mask.to(c.device), 30),
            (_image(2, 5, 6),)),
        "selective_columns_matmul": (lambda x, w, b: (
            O.selective_columns_matmul(x, sel.to(x.device), w, b)),
            (_image(3, 5, 8), _image(4, 8, 40), _image(5, 40))),
        "csr_matmul": (lambda w: O.csr_matmul(csr, w), (_image(6, 30, 4),)),
        "matmul_dense_csc": (lambda x: O.matmul_dense_csc(x, csr.T),
                             (_image(7, 3, 30),)),
    }
    for blank in (0, 4):
        cases[f"ctc_loss_blank{blank}"] = (lambda lp, blank=blank: (
            O.ctc_loss(torch.log_softmax(lp, -1), labels.to(lp.device),
                       in_len.to(lp.device), lab_len.to(lp.device),
                       blank=blank)), (_image(8, 4, 9, 5),))
    for name, (fn, arrays) in cases.items():
        _image_op_on_both(dev, fn, *arrays)


def test_selective_fc_ids_mode_matches_mask_mode_at_30000_columns(dev):
    """``selective_fc``'s candidate-id path on the card equals its dense
    mask path on the selected columns at a 30000-column front (bf16), and
    the mask path is exactly 0 off the selection."""
    import paddle_tpu_torch.nn as nn

    rs = np.random.RandomState(4)
    B, D, V, C = 16, 256, 30000, 64
    x = rs.randn(B, D).astype(np.float32)
    ids = np.stack([rs.choice(V, C, replace=False) for _ in range(B)]
                   ).astype(np.int32)
    mask = np.zeros((B, V), np.float32)
    np.put_along_axis(mask, ids, 1.0, axis=1)
    out = {}
    params = None
    for mode in ("mask", "ids"):
        nn.reset_naming()
        sel = (nn.data("sel", size=C, dtype="int32") if mode == "ids"
               else nn.data("sel", size=V))
        layer = nn.selective_fc(nn.data("x", size=D), sel, V, act="tanh",
                                name="sfc", select_mode=mode)
        topo = nn.Topology(layer, device=dev)
        if params is None:
            params, _ = topo.init(0)
            params["_sfc.wbias"] = torch.randn(V, device=dev)
        with compute_dtype_scope("bfloat16"):
            out[mode] = topo.apply(params, {}, {
                "x": x, "sel": ids if mode == "ids" else mask})[0][
                "sfc"].value
    picked = torch.gather(out["mask"], 1, torch.from_numpy(ids).long().to(
        dev))
    torch.testing.assert_close(out["ids"], picked, rtol=1e-2, atol=1e-2)
    assert (out["mask"][torch.from_numpy(mask).to(dev) == 0] == 0).all()


def test_row_sparse_update_keeps_untouched_rows_on_the_card(dev):
    """``movielens_net(sparse_grad=True)`` through ``SGDTrainer`` on the
    card, 3 Adam steps: the rows no batch looked up keep their value and
    zero Adam slots bit for bit, and every parameter equals the same
    trainer's on the CPU (f32)."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    build, _ = _sparse_nets()["movielens_net_sparse_grad"]
    rs = np.random.RandomState(6)
    feeds = [{"user_id": rs.randint(0, 6040, (16, 1)).astype(np.int32),
              "movie_id": rs.randint(0, 3952, (16, 1)).astype(np.int32),
              "score": (1 + 4 * rs.rand(16, 1)).astype(np.float32)}
             for _ in range(3)]
    trainers = {}
    with compute_dtype_scope("float32"):
        for where in (dev, "cpu"):
            nn.reset_naming()
            tr = SGDTrainer(build(), Adam(learning_rate=1e-2), seed=0,
                            device=where)
            before = {k: v.detach().clone() for k, v in tr.params.items()}
            for f in feeds:
                tr.train_batch(f)
            trainers[str(where)] = (tr, before)
    tr, before = trainers[str(dev)]
    cpu, _ = trainers["cpu"]
    assert tr.sparse_rows == {"_user_emb.w0": True, "_movie_emb.w0": True}
    for key, table in (("user_id", "_user_emb.w0"),
                       ("movie_id", "_movie_emb.w0")):
        seen = torch.zeros(tr.params[table].shape[0], dtype=torch.bool)
        for f in feeds:
            seen[torch.from_numpy(f[key]).long().reshape(-1)] = True
        untouched = (~seen).to(dev)
        assert torch.equal(tr.params[table].detach()[untouched],
                           before[table][untouched])
        for slot in tr.opt_state["slots"][table]:
            assert not slot[untouched].any()
    for k, v in tr.params.items():
        torch.testing.assert_close(v.detach().cpu(), cpu.params[k].detach(),
                                   rtol=1e-5, atol=1e-6)


def test_sparse_paths_launch_their_kernels(dev):
    """Under bf16, at a width the persistent LSTM kernels take (H = 32):
    the CTC net trains through K9r and K10 once each; the recommender, the
    sparse LR and the word2vec nets launch no kernel."""
    import paddle_tpu_torch.nn as nn
    import torch_sparse_nets as N

    nets = _sparse_nets()
    cases = {"ctc": (lambda: N.ctc_net(nn, 5, 32, 7)[0], nets["ctc"][1],
                     {"lstm_forward": 1, "lstm_backward": 1})}
    for name in ("movielens_feature_net", "sparse_lr", "word2vec_nce"):
        cases[name] = (*nets[name], {})
    for name, (build, feed, counts) in cases.items():
        nn.reset_naming()
        cost = build()
        topo = nn.Topology(cost, device=dev)
        params, _ = topo.init(0)
        params = {k: v.requires_grad_() for k, v in params.items()}
        before = launch_counts()
        with compute_dtype_scope("bfloat16"):
            loss = topo.apply(params, {}, feed, train=True)[0][
                cost.name].value
            torch.autograd.grad(loss, list(params.values()))
        after = launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert moved == counts, (name, moved)
        for k in counts:
            paths = {p: n - before.by_path[k].get(p, 0)
                     for p, n in after.by_path[k].items()
                     if n != before.by_path[k].get(p, 0)}
            assert paths == {"persistent": counts[k]}, (name, k, paths)


# ---------------------------------------------------------------------------
# nested and packed sequences (the seqdata phase's paths at small widths)
# ---------------------------------------------------------------------------

#: card vs the card's unpacked run or the CPU at f32: the loss (rel) and
#: each gradient's max |diff| against its largest entry (the same f32 math
#: summed in another order over at most 16 steps)
TOL_SEQDATA_LOSS, TOL_SEQDATA_GRAD = 1e-5, 1e-4


def _moved(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _packing_case(vocab=40):
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.data import DataFeeder
    from paddle_tpu_torch.datapipe import PackedDataFeeder, pack_samples
    from paddle_tpu_torch.models import lstm_benchmark_net

    rs = np.random.RandomState(1)
    samples = [(rs.randint(1, vocab, rs.randint(2, 9)).tolist(),
                int(rs.randint(0, 2))) for _ in range(8)]
    types = {"words": "ids_seq", "label": "int"}
    nn.reset_naming()
    cost, _ = lstm_benchmark_net(vocab, emb_dim=8, hid_dim=32, num_layers=2)
    return (cost, DataFeeder(types)(samples),
            PackedDataFeeder(types, max_segments=4)(
                pack_samples(samples, max_len=16, max_segments=4)))


def _loss_grads(cost, params, feed, where):
    import paddle_tpu_torch.nn as nn

    topo = nn.Topology(cost, device=where)
    p = {k: v.to(where).requires_grad_() for k, v in params.items()}
    loss = topo.apply(p, {}, feed, train=True)[0][cost.name].value
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.item(), {k: g.cpu() for k, g in zip(p, grads)}


def _assert_loss_grads_close(got, want):
    assert np.isfinite(want[0])
    assert abs(got[0] - want[0]) <= TOL_SEQDATA_LOSS * abs(want[0])
    for k, g in want[1].items():
        scale = max(g.abs().max().item(), 1e-30)
        diff = (got[1][k] - g).abs().max().item()
        assert diff <= TOL_SEQDATA_GRAD * scale, (k, diff, scale)


def _nonzero(params, seed=5):
    rs = np.random.RandomState(seed)
    return {k: torch.from_numpy((0.3 * rs.randn(*v.shape)).astype(
        np.float32)) if not v.abs().max() > 0 else v.cpu()
        for k, v in params.items()}


def test_packed_f32_step_matches_unpacked_and_the_cpu(dev):
    """``lstm_benchmark_net`` at f32 on a packed feed (8 samples in rows of
    16 tokens and 4 segments): its loss and every gradient on the card
    against the unpacked feed on the card (K9r/K10's f32 path) and against
    the packed feed on the CPU."""
    import paddle_tpu_torch.nn as nn

    cost, feed_u, feed_p = _packing_case()
    params = _nonzero(nn.Topology(cost, device="cpu").init(2)[0])
    with compute_dtype_scope("float32"):
        before = launch_counts()
        card_p = _loss_grads(cost, params, feed_p, dev)
        assert _moved(before, launch_counts()) == {}
        card_u = _loss_grads(cost, params, feed_u, dev)
        cpu_p = _loss_grads(cost, params, feed_p, "cpu")
    _assert_loss_grads_close(card_p, card_u)
    _assert_loss_grads_close(card_p, cpu_p)


def test_packed_bf16_step_launches_no_lstm_kernel(dev):
    """Under bf16 the packed step's reset LSTMs take the scan (no K9/K10,
    as the reference routes a reset); the same net unpacked launches K9r and
    K10 twice, persistent."""
    import paddle_tpu_torch.nn as nn

    cost, feed_u, feed_p = _packing_case()
    topo = nn.Topology(cost, device=dev)
    params, _ = topo.init(0)
    params = {k: v.requires_grad_() for k, v in params.items()}
    for feed, want in ((feed_p, {}),
                       (feed_u, {"lstm_forward": 2, "lstm_backward": 2})):
        before = launch_counts()
        with compute_dtype_scope("bfloat16"):
            loss = topo.apply(params, {}, feed, train=True)[0][
                cost.name].value
            torch.autograd.grad(loss, list(params.values()))
        after = launch_counts()
        assert torch.isfinite(loss)
        assert _moved(before, after) == want
        for k, n in want.items():
            assert after.by_path[k]["persistent"] - before.by_path[k].get(
                "persistent", 0) == n


def test_nested_net_launches_per_outer_step_and_matches_the_cpu(dev):
    """The two-level LSTM classifier (``tests/torch_nested_nets.py``) at
    small widths: under bf16 a training apply launches K9r and K10 once an
    outer step (To = 4), all persistent, and an inference apply K9 once an
    outer step; at f32 its loss and every gradient on the card equal the
    CPU's, an empty sentence included."""
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.data import DataFeeder
    import torch_nested_nets as NN

    rs = np.random.RandomState(3)
    flat = [(rs.randint(1, 50, rs.randint(3, 30)).tolist(),
             int(rs.randint(0, 2))) for _ in range(5)]
    docs = NN.nested_samples(flat, 4, 8)
    docs[0] = ([[4, 5, 6], []] + docs[0][0][:2], docs[0][1])
    feed = DataFeeder({"words": "ids_nested", "label": "int"},
                      buckets=(4, 8))(docs)
    To = feed["words"][0].shape[1]
    assert To == 4
    nn.reset_naming()
    cost, prob = NN.hier_lstm_net(nn, 50, 8, 32)
    topo = nn.Topology(cost, device=dev)
    params, _ = topo.init(0)
    params = {k: v.requires_grad_() for k, v in params.items()}
    with compute_dtype_scope("bfloat16"):
        before = launch_counts()
        loss = topo.apply(params, {}, feed, train=True)[0][cost.name].value
        torch.autograd.grad(loss, list(params.values()))
        after = launch_counts()
        assert _moved(before, after) == {"lstm_forward": To,
                                         "lstm_backward": To}
        for k in ("lstm_forward", "lstm_backward"):
            assert after.by_path[k]["persistent"] - before.by_path[k].get(
                "persistent", 0) == To
        before = launch_counts()
        with torch.no_grad():
            topo.apply(params, {}, feed, train=False)
        assert _moved(before, launch_counts()) == {"lstm_forward": To}
    params = _nonzero(params)
    with compute_dtype_scope("float32"):
        _assert_loss_grads_close(_loss_grads(cost, params, feed, dev),
                                 _loss_grads(cost, params, feed, "cpu"))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_fully_masked_frame_through_the_lstm_kernels(dev, cd):
    """A nested frame whose rows are all empty (and one with some empty
    rows): K9 holds the boot carries and emits zeros there, K10 passes the
    final cotangents through to d_h0/d_c0 and gives zero d_z, each equal to
    its plain version."""
    ins, rng = _lstm_inputs(6, 5, 32, 7)
    for empty_rows in (slice(None), slice(0, 3)):
        mask = ins[1].clone()
        mask[empty_rows] = 0
        args = [t.to(dev) for t in (ins[0], mask, *ins[2:])]
        T, B, H = 5, 6, 32
        d_out = torch.from_numpy(rng.randn(T, B, H).astype(
            np.float32)).to(dev)
        d_hfin = torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
        d_cfin = torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
        with compute_dtype_scope(cd):
            got = lstm_forward(*args, residuals=True)
            want = lstm_forward_plain(*args, residuals=True)
            m_tb = args[1].t().contiguous()
            w_t = args[2].t().contiguous()
            bargs = [d_out, m_tb, got[3], got[5], w_t, *args[3:6], d_hfin,
                     d_cfin]
            g_bwd = lstm_backward(*bargs)
            p_bwd = lstm_backward_plain(*bargs)
        torch.cuda.synchronize()
        e = empty_rows
        assert torch.equal(got[0][e], torch.zeros_like(got[0][e]))
        assert torch.equal(got[1][e], args[6][e].float())
        assert torch.equal(got[2][e], args[7][e].float())
        assert torch.equal(g_bwd[0][:, e], torch.zeros_like(g_bwd[0][:, e]))
        assert torch.equal(g_bwd[2][e], d_hfin[e])
        assert torch.equal(g_bwd[3][e], d_cfin[e])
        for a, b in zip(got[:3], want[:3]):
            _rel_close(a, b, 5e-3 if cd == "bfloat16" else 1e-5)
        for a, b in zip(g_bwd, p_bwd):
            if a is not None:
                _rel_close(a, b, 1e-5)


# ---------------------------------------------------------------------------
# mixed precision (--amp), remat and the batch prefetcher
# ---------------------------------------------------------------------------


@pytest.fixture
def amp(monkeypatch):
    from paddle_tpu_torch.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "amp", True)
    yield


def _within_ulp_of(got, want, tol):
    """Each entry within ``tol`` plus one bf16 ulp of its plain value (a
    stored bf16 residual may round either way)."""
    g, w = got.float(), want.float()
    assert torch.all((g - w).abs() <= tol + w.abs() * 2.0 ** -8)


def test_amp_lstm_kernels_take_bf16_inputs(dev, amp):
    """Under --amp K9r gets the bf16 input projection and bf16 peepholes
    (as ``lstm_layer`` hands them over) and K10 the bf16 residuals: each
    equals its plain version on the same tensors (h/c within 5e-3, the
    kernels' bf16 tolerance; residuals within it plus one bf16 ulp; K10
    within 1e-5 of each output's largest entry), one launch each."""
    ins, rng = _lstm_inputs(7, 9, 32, 21)
    bf = torch.bfloat16
    xp = ins[0].to(dev).to(bf)
    peeps = [p.to(dev).to(bf) for p in ins[3:6]]
    args = [xp, ins[1].to(dev), ins[2].to(dev), *peeps]
    counts = launch_counts()
    got = lstm_forward(*args, residuals=True)
    want = lstm_forward_plain(*args, residuals=True)
    assert launch_counts()["lstm_forward"] == counts["lstm_forward"] + 1
    for a, b in zip(got[:3], want[:3]):
        _rel_close(a, b, 5e-3)
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == b.dtype == bf
        _within_ulp_of(a, b, 5e-3)
    T, B, H = 9, 7, 32
    d_out = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).to(dev)
    d_fin = [torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
             for _ in range(2)]
    bargs = [d_out, args[1].t().contiguous(), got[3], got[5],
             args[2].t().contiguous(), *peeps, *d_fin]
    g_bwd = lstm_backward(*bargs)
    assert launch_counts()["lstm_backward"] == counts["lstm_backward"] + 1
    for a, b in zip(g_bwd, lstm_backward_plain(*bargs)):
        _rel_close(a, b, 1e-5)


def test_amp_gru_kernels_take_bf16_inputs(dev, amp):
    """K3r with a bf16 input projection and K4 from its bf16 residuals
    under --amp, against their plain versions (as the LSTM's)."""
    rng = np.random.RandomState(22)
    B, T, H = 6, 8, 64
    xp = torch.from_numpy((0.4 * rng.randn(B, T, 3 * H)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    lens = rng.randint(1, T + 1, (B,))
    lens[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(
        np.float32)).to(dev)
    w_h = torch.from_numpy((rng.randn(H, 3 * H) / np.sqrt(H)).astype(
        np.float32)).to(dev)
    got = gru_forward(xp, mask, w_h, residuals=True)
    want = gru_forward_plain(xp, mask, w_h, residuals=True)
    for a, b in zip(got[:2], want[:2]):
        _rel_close(a, b, 5e-3)
    for a, b in zip(got[2:], want[2:]):
        _within_ulp_of(a, b, 5e-3)
    d_out = torch.from_numpy(rng.randn(T, B, H).astype(np.float32)).to(dev)
    d_fin = torch.from_numpy(rng.randn(B, H).astype(np.float32)).to(dev)
    bargs = [d_out, mask.t().contiguous(), got[2], got[3],
             w_h.t().contiguous(), d_fin]
    for a, b in zip(gru_backward(*bargs), gru_backward_plain(*bargs)):
        _rel_close(a, b, 1e-5)


def test_amp_attention_decoder_and_readout_on_the_card_match_the_cpu(
        dev, amp):
    """The attention decoder (K5/K6) and the CE readout (K1/K2) under
    --amp, forward and every gradient, on the card against the CPU (plain
    versions) from the same inputs: bf16 activations whose float32 sums
    run in another order there, so a few bf16 roundings go the other way:
    8 bf16 ulps of each array's largest entry (2^-5)."""
    from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder
    from paddle_tpu_torch.ops.losses import sequence_softmax_ce_readout

    rng = np.random.RandomState(23)
    B, S, T, E, H2, D, A, V = 8, 6, 7, 32, 64, 64, 32, 512
    f = np.float32
    src = (np.arange(S)[None] < rng.randint(1, S + 1, (B, 1))).astype(f)
    trg = (np.arange(T)[None] < rng.randint(1, T + 1, (B, 1))).astype(f)
    src[0], trg[0] = 1, 1
    vals = [rng.randn(B, T, E), rng.randn(B, D), rng.randn(B, S, H2),
            rng.randn(B, S, A), 0.3 * rng.randn(D, A), 0.3 * rng.randn(A),
            0.2 * rng.randn(E + H2, 3 * D), 0.1 * rng.randn(3 * D),
            0.2 * rng.randn(D, 3 * D), 0.2 * rng.randn(D, V),
            0.1 * rng.randn(V)]
    labels = torch.from_numpy(rng.randint(0, V, (B, T)))
    out = {}
    before = launch_counts()
    for where in (dev, torch.device("cpu")):
        ts = [torch.from_numpy(v.astype(f)).to(where).requires_grad_()
              for v in vals]
        sm, tm = (torch.from_numpy(m).to(where) for m in (src, trg))
        states = attention_gru_decoder(*ts[:4], sm, tm, *ts[4:9])
        loss = sequence_softmax_ce_readout(states.to(torch.bfloat16),
                                           ts[9], ts[10], labels.to(where),
                                           tm)
        grads = torch.autograd.grad(loss, ts)
        out[where.type] = [loss.detach().cpu()] + [g.cpu() for g in grads]
    after = launch_counts()
    for name in ("attn_dec_fwd", "attn_dec_bwd", "ce_readout_fwd",
                 "ce_readout_bwd"):
        assert after[name] == before[name] + 1, name
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        _rel_close(a, b, 8 * 2.0 ** -8)


def test_amp_kernel_plain_versions_ignore_amp_on_the_card(dev, monkeypatch):
    """The plain versions of K4, K6 and K10 multiply float32 under --amp
    (``float32_products``), as the kernels do: on the card each equals
    the same call without --amp (bf16 policy both) bit for bit."""
    from paddle_tpu_torch.utils.flags import FLAGS

    rng = np.random.RandomState(24)
    T, B, H, S, A, H2 = 5, 4, 32, 6, 16, 24

    def t(*shape, dt=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(
            np.float32)).to(dev).to(dt)

    bf = torch.bfloat16
    m_tb = (torch.arange(T, device=dev)[:, None]
            < torch.tensor([5, 3, 1, 4], device=dev)[None]).float()
    smask = (torch.arange(S, device=dev)[None]
             < torch.tensor([6, 2, 5, 1], device=dev)[:, None]).float()
    g4 = [t(T, B, H), m_tb, t(T, B, 3 * H, dt=bf), t(T, B, H, dt=bf),
          t(3 * H, H), t(B, H)]
    g10 = [t(T, B, H), m_tb, t(T, B, 4 * H, dt=bf), t(T, B, H, dt=bf),
           t(4 * H, H), t(H), t(H), t(H), t(B, H), t(B, H)]
    gates = [torch.sigmoid(t(T, B, H)) for _ in range(3)]
    g6 = [t(T, B, H), m_tb, t(T, B, H), *gates, t(T, B, A),
          t(B, S, H2, dt=bf), t(B, S, A, dt=bf), smask, t(H, A),
          t(A, dt=bf), t(H, 3 * H), t(H2, 3 * H)]
    runs = []
    monkeypatch.setattr(FLAGS, "compute_dtype", "bfloat16")
    for amp_on in (False, True):
        monkeypatch.setattr(FLAGS, "amp", amp_on)
        runs.append([*gru_backward_plain(*g4), *lstm_backward_plain(*g10),
                     *attn_dec_bwd_plain(*g6)])
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)


def test_amp_products_rows_do_not_depend_on_the_batch(dev, amp):
    """Under ``dot_dtype() == bfloat16`` the fixed-shape cuBLAS chunks
    still make a row's bits independent of the row count: rows of 37-
    and 1-row calls equal the same rows of a 384-row call bit for bit."""
    from paddle_tpu_torch.ops import linear
    from paddle_tpu_torch.ops.numerics import dot_dtype

    assert dot_dtype() == torch.bfloat16
    rng = np.random.RandomState(25)
    x = torch.from_numpy(rng.randn(384, 512).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.05 * rng.randn(512, 1536)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.randn(1536)).astype(np.float32)).to(dev)
    full = linear(x, w, b)
    assert full.dtype == torch.bfloat16
    for rows in (slice(0, 37), slice(100, 101), slice(383, 384)):
        assert torch.equal(linear(x[rows], w, b), full[rows])


def _card_lstm_trainer(dev, **kw):
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.trainer import SGDTrainer

    tnn.reset_naming()
    cost, _ = lstm_benchmark_net(60, emb_dim=16, hid_dim=32)
    return SGDTrainer(cost, Adam(learning_rate=1e-2), seed=3, device=dev,
                      **kw)


def _card_lstm_feeds(n, B=8, T=12):
    rng = np.random.RandomState(26)
    return [{"words": (rng.randint(3, 60, (B, T)).astype(np.int32),
                       rng.randint(1, T + 1, B).astype(np.int32)),
             "label": rng.randint(0, 2, (B, 1)).astype(np.int32)}
            for _ in range(n)]


def test_remat_on_the_card_is_bit_for_bit_and_reruns_k9r(dev):
    """``SGDTrainer(remat=True)`` on the card: three steps equal the plain
    steps bit for bit (the same kernels on the same values), and K9r runs
    twice a step (the recompute), K10 once."""
    feeds = _card_lstm_feeds(3)
    runs = {}
    for remat in (False, True):
        tr = _card_lstm_trainer(dev, remat=remat)
        before = launch_counts()
        losses = [tr.train_batch(f).item() for f in feeds]
        after = launch_counts()
        runs[remat] = (losses, {k: v.detach().clone()
                                for k, v in tr.params.items()},
                       after["lstm_forward"] - before["lstm_forward"],
                       after["lstm_backward"] - before["lstm_backward"])
    assert runs[False][0] == runs[True][0]
    for k in runs[False][1]:
        assert torch.equal(runs[False][1][k], runs[True][1][k]), k
    assert (runs[False][2], runs[False][3]) == (2 * 3, 2 * 3)
    assert (runs[True][2], runs[True][3]) == (4 * 3, 2 * 3)


def test_amp_overflow_on_the_card_skips_and_halves_the_scale(dev, amp):
    """An inf planted in one gradient (the loss stays finite): the step is
    skipped with parameters and slots held bit for bit, the scale halves,
    the abort streak does not move; the next clean step trains."""
    from paddle_tpu_torch.param.optimizers import slot_leaves

    tr = _card_lstm_trainer(dev)
    feeds = _card_lstm_feeds(3)
    tr.train_batch(feeds[0])

    def snapshot():
        return [v.detach().clone() for k in sorted(tr.params)
                for v in (tr.params[k], *slot_leaves(
                    tr.opt_state["slots"][k]))]

    before, scale = snapshot(), float(tr.opt_state["amp"]["scale"])
    hook = tr.params["_logits.wbias"].register_hook(
        lambda g: g + float("inf"))
    loss = tr.train_batch(feeds[1]).item()
    hook.remove()
    assert np.isfinite(loss)
    assert int(tr._last_extras["amp_overflow"]) == 1
    assert int(tr._last_extras["bad_step"]) == 0
    assert tr.bad_steps_streak == 0 and tr.amp_overflows_total == 1
    assert float(tr.opt_state["amp"]["scale"]) == scale / 2
    assert all(torch.equal(a, b) for a, b in zip(before, snapshot()))
    tr.train_batch(feeds[2])
    assert int(tr._last_extras["amp_overflow"]) == 0
    assert not all(torch.equal(a, b) for a, b in zip(before, snapshot()))


def test_prefetch_side_stream_on_the_card_bit_equal(dev, monkeypatch):
    """``--prefetch_depth=2`` on the card: the feeds are pinned and copied
    on the prefetcher's side stream (``SGDTrainer._device_feed(pinned=
    True)`` runs in the producer thread, off the default stream), and two
    passes' losses and parameters equal ``--prefetch_depth=0``'s bit for
    bit."""
    import threading

    from paddle_tpu_torch.trainer import SGDTrainer
    from paddle_tpu_torch.trainer import events as ev
    from paddle_tpu_torch.utils.flags import FLAGS

    monkeypatch.setattr(FLAGS, "log_period", 0)
    monkeypatch.setattr(FLAGS, "save_dir", "")
    feeds = _card_lstm_feeds(4)
    copies = []
    real = SGDTrainer._device_feed

    def spy(self, feed, pinned=False):
        if pinned:
            stream = torch.cuda.current_stream(dev)
            copies.append((threading.current_thread().name,
                           stream != torch.cuda.default_stream(dev)))
        return real(self, feed, pinned=pinned)

    monkeypatch.setattr(SGDTrainer, "_device_feed", spy)
    runs = {}
    for depth in (0, 2):
        monkeypatch.setattr(FLAGS, "prefetch_depth", depth)
        tr = _card_lstm_trainer(dev)
        got = []
        tr.train(lambda: iter(feeds), num_passes=2,
                 event_handler=lambda e: got.append(e.cost)
                 if isinstance(e, ev.EndIteration) else None)
        runs[depth] = (got, {k: v.detach().clone()
                             for k, v in tr.params.items()})
        assert tr._prefetcher is None
    assert runs[0][0] == runs[2][0]
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[2][1][k]), k
    assert copies == [("batch-prefetch", True)] * 8


# ---------------------------------------------------------------------------
# deploy bundles (config/deploy.py) served in bucket mode
# ---------------------------------------------------------------------------


def _card_bundles(dev, tmp_path, modes=(None, "bf16", "int8")):
    """The small textclf net trained two steps on the card, its inference
    graph merged in each mode -> ({mode: path}, the trained parameters)."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.config import merge_model

    tr = _card_lstm_trainer(dev)
    for f in _card_lstm_feeds(2):
        tr.train_batch(f)
    logits = next(l for l in tr.topology.layers if l.name == "logits")
    topo = tnn.Topology(logits, device=dev)
    return {m: merge_model(str(tmp_path / f"{m}.ptz"), topo, tr.params,
                           tr.state, quantize=m) for m in modes}, tr.params


def test_load_inference_model_puts_every_parameter_on_the_card(dev,
                                                               tmp_path):
    from paddle_tpu_torch.config import load_inference_model

    m = load_inference_model(_card_bundles(dev, tmp_path, (None,))[0][None])
    assert m.device.type == "cuda"
    assert m.params and all(p.device.type == "cuda"
                            for p in m.params.values())


@pytest.mark.parametrize("bucket", [1, 2, 4, 8])
def test_bundle_served_in_bucket_mode_equals_solo_infer(dev, tmp_path,
                                                        bucket):
    """Requests whose rows fill the batch bucket ``bucket`` (one request of
    ``bucket`` rows, or several whose rows sum to it), with lengths 2-12
    padded up to the batch's length bucket: each reply equals ``infer`` of
    the request alone, unpadded, bit for bit; K9 runs from the worker."""
    from paddle_tpu_torch.config import load_inference_model
    from paddle_tpu_torch.serving import InferenceServer

    m = load_inference_model(_card_bundles(dev, tmp_path, (None,))[0][None])
    rng = np.random.RandomState(bucket)
    sizes = {1: [1], 2: [1, 1], 4: [3, 1], 8: [2, 4, 1, 1]}[bucket]
    reqs = []
    for rows in sizes:
        lens = rng.randint(2, 13, rows).astype(np.int32)
        lens[0] = 12  # every request in the length bucket 16: one batch
        reqs.append({"words": (rng.randint(3, 60, (rows, int(lens.max())))
                               .astype(np.int32), lens)})
    srv = InferenceServer(m, max_batch=8, batch_delay_ms=50.0)
    srv.start(warmup_feed={"words": (np.full((1, 12), 3, np.int32),
                                     np.asarray([12], np.int32))})
    try:
        before = launch_counts()
        futs = [srv.submit(f) for f in reqs]
        got = [f.result(60)["logits"] for f in futs]
        after = launch_counts()
        assert srv.healthz()["counters"]["batches"] == 1
    finally:
        srv.close()
    threads = {t for t, n in after.by_thread["lstm_forward"].items()
               if n != before.by_thread["lstm_forward"].get(t, 0)}
    assert after["lstm_forward"] - before["lstm_forward"] == 2
    assert all(t.startswith("serving-worker-") for t in threads), threads
    for f, g in zip(reqs, got):
        np.testing.assert_array_equal(g, m.infer(f)["logits"])


#: a bundle's logits on the card against the same bundle on the CPU (max
#: |diff| / max |CPU|), chip_smoke.py's deploy phase's tolerance
TOL_DEPLOY_CPU = 2e-3


def _half_steps(model, trained, mode):
    """The largest |loaded - trained| of a quantized bundle's parameters
    over half a quantization step, computed from the trained values (int8:
    the channel's max |w| / 127 over the last axis, for ndim >= 2 and size
    >= 256; bfloat16: at most 2**-8 |w|)."""
    worst = 0.0
    for name, p in model.params.items():
        w = trained[name].detach().cpu().numpy().astype(np.float64)
        got = p.detach().cpu().numpy().astype(np.float64)
        if mode == "int8" and w.ndim >= 2 and w.size >= 256:
            half = (0.5 * np.abs(w).max(axis=tuple(range(w.ndim - 1)),
                                        keepdims=True) / 127.0
                    + 2.0 ** -22 * np.abs(w))
        else:
            half = 2.0 ** -8 * np.abs(w)
        worst = max(worst, float((np.abs(got - w)
                                  / np.maximum(half, 1e-30)).max()))
    return worst


def test_quantized_bundles_within_their_gate_on_the_card(dev, tmp_path):
    """bf16 and int8 bundles pass their export gate on the card; each
    loaded parameter is within half a quantization step of the trained
    value it was merged from; each bundle's logits on the card agree with
    the same bundle on the CPU; and they stay within the gate's tolerance
    of the f32 bundle's."""
    import json
    import zipfile

    from paddle_tpu_torch.config import load_inference_model

    paths, trained = _card_bundles(dev, tmp_path)
    feed = _card_lstm_feeds(1)[0]
    feed = {"words": feed["words"]}
    ref = load_inference_model(paths[None]).infer(feed)["logits"]
    for mode in ("bf16", "int8"):
        q = json.loads(zipfile.ZipFile(paths[mode]).read(
            "manifest.json"))["quantize"]
        assert q["mode"] == mode and 0 <= q["max_abs_err"] <= q["tol"]
        model = load_inference_model(paths[mode])
        assert _half_steps(model, trained, mode) <= 1.0, mode
        got = model.infer(feed)["logits"]
        cpu = load_inference_model(paths[mode], device="cpu").infer(
            feed)["logits"]
        assert (np.abs(got - cpu).max() / np.abs(cpu).max()
                <= TOL_DEPLOY_CPU), mode
        assert np.abs(got - ref).max() <= q["tol"], mode


# ---------------------------------------------------------------------------
# the user's entry points: the paddle.v2 facade and the demo copies
# ---------------------------------------------------------------------------

#: card vs CPU at f32 through the v2 facade and the demo copy: the loss of
#: each step (rel; f32 sums in another order, carried by Adam) and the
#: generated scores (abs, about -20 from up to 8 steps)
TOL_V2_LOSS, TOL_V2_SCORE = 1e-5, 1e-4


def _same_or_near_tie(ids, scores, want_ids, want_scores, tol):
    """Per source: the same ids and scores within ``tol``; where the ids
    differ (a near tie of nearly flat random-init logits), each beam's
    score within ``tol`` of the other side's beam of the same rank."""
    np.testing.assert_allclose(scores, want_scores, atol=tol)
    for b in range(len(ids)):
        if not np.array_equal(ids[b], want_ids[b]):
            gaps = np.abs(np.diff(np.asarray(want_scores[b], np.float64)))
            assert gaps.min() <= 2 * tol, (b, want_scores[b])


def _launched(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _v2_run(where, monkeypatch, V=50, steps=3, B=8):
    """The v2 seqToseq script at small widths on ``where`` (f32): its costs,
    the launches of the training run and of the generation, the ids and
    scores generated."""
    import io

    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch.utils.flags import FLAGS
    from torch_v2_seqtoseq import (FEEDING, v2_seqtoseq_generator,
                                   v2_seqtoseq_reader, v2_seqtoseq_trainer,
                                   v2_test_sources)

    monkeypatch.setattr(FLAGS, "device", FLAGS.device)
    monkeypatch.setattr(FLAGS, "log_period", 0)
    paddle.init([f"--device={where}"])
    dims = dict(V=V, E=12, H=16, D=16, A=8)
    with compute_dtype_scope("float32"):
        nn.reset_naming()
        cost = v2_seqtoseq_trainer(paddle, **dims)
        params = paddle.parameters.create(cost, seed=4)
        costs = []
        trainer = paddle.trainer.SGD(
            cost=cost, parameters=params,
            update_equation=paddle.optimizer.Adam(learning_rate=5e-3))
        before = launch_counts()
        trainer.train(v2_seqtoseq_reader(paddle, V, steps * B, B),
                      event_handler=lambda e: costs.append(e.cost) if
                      isinstance(e, paddle.event.EndIteration) else None,
                      feeding=FEEDING)
        train_launches = _launched(before, launch_counts())
        buf = io.BytesIO()
        trainer.save_parameter_to_tar(buf)
        nn.reset_naming()
        gen = v2_seqtoseq_generator(paddle, beam=3, max_len=8, **dims)
        gparams = paddle.parameters.create(gen)
        gparams.from_tar(io.BytesIO(buf.getvalue()))
        before = launch_counts()
        prob, ids = paddle.infer(output_layer=gen, parameters=gparams,
                                 input=v2_test_sources(paddle, V, 4),
                                 field=["prob", "id"])
        gen_launches = _launched(before, launch_counts())
        before = launch_counts()
        empty = paddle.infer(output_layer=gen, parameters=gparams, input=[],
                             field=["prob", "id"])
        empty_launches = _launched(before, launch_counts())
    return (costs, train_launches, prob, ids, gen_launches, empty,
            empty_launches)


def test_v2_seqtoseq_script_on_the_card_matches_the_cpu(dev, monkeypatch):
    """The v2 script through paddle.parameters.create / trainer.SGD /
    infer on the card and on the CPU from the same seed: costs, the
    kernels of each part (K3r and K4 twice a step; K3 twice and K8 once a
    decode step), the generated ids and scores, and a zero-row infer that
    launches nothing."""
    card = _v2_run("cuda", monkeypatch)
    cpu = _v2_run("cpu", monkeypatch)
    costs, train_l, prob, ids, gen_l, empty, empty_l = card
    assert len(costs) == 3
    np.testing.assert_allclose(costs, cpu[0], rtol=TOL_V2_LOSS)
    assert train_l == {"gru_forward": 6, "gru_backward": 6}, train_l
    assert gen_l["gru_forward"] == 2 and set(gen_l) == {
        "gru_forward", "topk_lse_logits"}, gen_l
    assert 1 <= gen_l["topk_lse_logits"] <= 8
    _same_or_near_tie(ids, prob, cpu[3], cpu[2], TOL_V2_SCORE)
    assert empty_l == {} and empty[1].shape == (0, 3, 8)
    assert cpu[1] == {} and cpu[4] == {}


def test_seqtoseq_demo_copy_on_the_card_matches_the_cpu(dev):
    """The demo copy's main at small widths, f32, on the card and on the
    CPU: the same losses; the card run launches the training kernels
    (K3r, K4, K5, K6, K1, K2) every step and K3/K7 in --generate."""
    from paddle_tpu_torch.demo.seqToseq import train as demo

    args = ["--n", "24", "--batch-size", "8", "--dict-size", "60",
            "--emb-dim", "16", "--hid-dim", "32", "--generate"]
    with compute_dtype_scope("float32"):
        before = launch_counts()
        card = demo.main(args + ["--device", "cuda"])
        launched = _launched(before, launch_counts())
        cpu = demo.main(args + ["--device", "cpu"])
    np.testing.assert_allclose(card["losses"], cpu["losses"],
                               rtol=TOL_V2_LOSS)
    for name in ("ce_readout_fwd", "ce_readout_bwd", "attn_dec_fwd",
                 "attn_dec_bwd"):
        assert launched[name] == 3, (name, launched)
    assert launched["gru_backward"] == 6
    assert launched["gru_forward"] == 6 + 2
    assert 1 <= launched["topk_lse_readout"] <= 20
    _same_or_near_tie(card["tokens"], card["scores"], cpu["tokens"],
                      cpu["scores"], TOL_V2_SCORE)


# ---------------------------------------------------------------------------
# continuous delivery: the compile cache and the hot swap on the card
# ---------------------------------------------------------------------------


def test_compile_cache_warm_boot_loads_k9_with_zero_nvcc_runs(
        dev, tmp_path, monkeypatch):
    """K9's library built into an empty ``_build`` under a compile cache is
    stored (a miss); with ``_build`` empty again it loads from the cache
    with no ``nvcc`` run, after its smoke call (each of its three kernels
    against the plain version), and the wrapper's outputs are bit-equal
    to the built library's; a corrupted entry is a logged miss and a
    rebuild."""
    from paddle_tpu_torch.config import compile_cache as cc
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels.lstm import (LSTM_FORWARD,
                                                   _smoke_inputs)
    from paddle_tpu_torch.resilience import chaos

    args = _smoke_inputs(7, 9, 64, dev)
    cache = cc.CompileCacheDir(str(tmp_path / "cache"))
    monkeypatch.setattr(LSTM_FORWARD, "_lib", None)

    def boot(name):
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / name))
        LSTM_FORWARD._lib = None
        with compute_dtype_scope("bfloat16"), cc.priming(cache) as counts:
            out = lstm_forward(*args)
        torch.cuda.synchronize()
        return counts, out

    builds = LSTM_FORWARD.builds
    counts, cold = boot("b0")
    assert counts["libraries"] == {"lstm_forward": "miss"}
    assert LSTM_FORWARD.builds == builds + 1
    counts, warm = boot("b1")
    assert counts["libraries"] == {"lstm_forward": "hit"}
    assert LSTM_FORWARD.builds == builds + 1          # zero nvcc runs
    assert LSTM_FORWARD.origin == "cache"
    assert set(LSTM_FORWARD.smoke_result) == {
        "steps_float32", "steps_bfloat16", "persistent_bfloat16"}
    for a, b in zip(cold, warm):
        assert torch.equal(a, b)
    assert chaos.corrupt_compile_cache(cache.root) is not None
    counts, again = boot("b2")
    assert counts["libraries"] == {"lstm_forward": "miss"}
    assert LSTM_FORWARD.builds == builds + 2 and LSTM_FORWARD.origin == \
        "built"
    for a, b in zip(cold, again):
        assert torch.equal(a, b)


def test_hot_swap_under_load_on_the_card(dev, tmp_path):
    """A small ``lstm_benchmark_net`` (bf16) trained on the card and
    published twice: a bucket-mode server booted from v1 serves client
    threads while the ``HotSwapManager`` swaps v2 in; every reply is
    bit-equal to one version's solo ``infer``, none fails, the publish
    dir's cache is hit on the reload, and K9 launches from the worker
    thread twice a batch, all persistent (the swap's warm step launches
    from the caller's thread)."""
    import os
    import threading

    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.config import load_inference_model
    from paddle_tpu_torch.models import lstm_benchmark_net
    from paddle_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.param import Adam
    from paddle_tpu_torch.publish import (publish_cache_dir,
                                          publish_from_checkpoints,
                                          version_dir)
    from paddle_tpu_torch.serving import (HotSwapManager, InferenceServer,
                                          load_published)
    from paddle_tpu_torch.trainer import SGDTrainer

    rng = np.random.RandomState(0)

    def feed(B, T):
        return {"words": (rng.randint(3, 200, (B, T)).astype(np.int32),
                          rng.randint(T // 2, T + 1, B).astype(np.int32)),
                "label": rng.randint(0, 2, (B, 1))}

    with compute_dtype_scope("bfloat16"):
        nn.reset_naming()
        cost, logits = lstm_benchmark_net(200, emb_dim=16, hid_dim=64)
        tr = SGDTrainer(cost, Adam(learning_rate=1e-2), seed=0, device=dev)
        save, pub = str(tmp_path / "ck"), str(tmp_path / "pub")
        for p in range(2):
            tr.train_batch(feed(8, 12))
            tr.save(save, p)
            publish_from_checkpoints(pub, tr.topology, save, pass_id=p,
                                     device=dev)
        pool = [{"words": feed(rng.randint(1, 4), 12)["words"]}
                for _ in range(32)]
        solo = {}
        for v in (1, 2):
            m = load_inference_model(os.path.join(version_dir(pub, v),
                                                  "model.ptz"))
            solo[v] = [m.infer(f, outputs=[logits.name])[logits.name]
                       for f in pool]
        model, info, v = load_published(pub, max_version=1)
        srv = InferenceServer(model, outputs=[logits.name], max_batch=8,
                              batch_delay_ms=1.0, max_queue=256,
                              default_deadline_ms=0.0)
        srv.start(compile_cache=publish_cache_dir(pub))
        mgr = HotSwapManager(srv, pub, probation_requests=8)
        mgr.attach_current(v, info)
        records, stop = [], threading.Event()

        def client(c):
            k = 0
            while k < 8 or not stop.is_set():
                i = (c + 4 * k) % len(pool)
                records.append((i, srv.submit(pool[i]).result(60)))
                k += 1

        try:
            reset_launch_counts()
            threads = [threading.Thread(target=client, args=(c,),
                                        daemon=True) for c in range(4)]
            for t in threads:
                t.start()
            for _ in range(2000):
                mgr.poll()
                if mgr.current_version == 2 and not mgr.in_probation:
                    break
                threading.Event().wait(0.002)
            stop.set()
            for t in threads:
                t.join(60)
            counts = launch_counts()
            hz = srv.healthz()
        finally:
            stop.set()
            srv.close()
    assert mgr.current_version == 2
    versions = []
    for i, out in records:
        ks = [v for v in (1, 2) if np.array_equal(out[logits.name],
                                                  solo[v][i])]
        assert len(ks) == 1
        versions.append(ks[0])
    assert {1, 2} <= set(versions)
    assert hz["counters"]["compile_cache_misses"] == 0
    assert hz["counters"]["compile_cache_hits"] > 0
    worker = {t: n for t, n in counts.by_thread["lstm_forward"].items()
              if t.startswith("serving-worker-")}
    assert sum(worker.values()) == 2 * hz["counters"]["batches"]
    assert set(counts.by_path["lstm_forward"]) == {"persistent"}
    assert counts["lstm_backward"] == 0


def test_every_kernel_library_passes_its_smoke_call(dev):
    """Each of the 13 kernel libraries has a smoke call (what a library
    loaded from a compile cache runs before it is trusted): one small
    launch of each of its kernels against the kernels' plain versions.
    Each passes on the built library, reports an error per kernel, and
    counts no launch."""
    from paddle_tpu_torch.ops.kernels import LIBRARIES, build_all

    build_all()
    before = launch_counts()
    for name, lib in LIBRARIES.items():
        assert lib.smoke is not None, name
        errs = lib.smoke()
        assert errs and all(e >= 0.0 for e in errs.values()), (name, errs)
    torch.cuda.synchronize()
    assert launch_counts() == before
    assert launch_counts().by_path == before.by_path


# ---------------------------------------------------------------------------
# data parallelism and the pserver tier (chip_smoke.py's phase 21), small
# ---------------------------------------------------------------------------

PAR_TEXTCLF_ENV = {"TORCH_TEXTCLF_VOCAB": "300", "TORCH_TEXTCLF_EMB": "16",
                   "TORCH_TEXTCLF_HID": "32", "TORCH_TEXTCLF_BATCH": "16",
                   "TORCH_TEXTCLF_T": "20", "TORCH_TEXTCLF_N": "64",
                   "TORCH_TEXTCLF_TEST_N": "16"}


@pytest.fixture
def kept_flags():
    from paddle_tpu_torch.utils.flags import FLAGS

    before = FLAGS.as_dict()
    yield
    for k, v in before.items():
        setattr(FLAGS, k, v)


def test_parallel_textclf_cli_two_ranks_on_one_card(dev, tmp_path,
                                                     monkeypatch,
                                                     kept_flags):
    """``python -m paddle_tpu_torch --job=train --mesh_shape=2`` on 2 gloo
    ranks of this card (global batch 16, f32): the ranks' parameters
    bit-equal, losses and rank 0's checkpoint against the same command in
    this process (rtol 1e-5; rtol 1e-4 / atol 1e-6), K9r and K10 2 a step
    on each rank."""
    import json

    from paddle_tpu_torch.__main__ import main
    from paddle_tpu_torch.parallel import launch_local
    from paddle_tpu_torch.resilience.checkpoint_io import pass_dir

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for k, v in PAR_TEXTCLF_ENV.items():
        monkeypatch.setenv(k, v)
    args = ["--job=train", f"--config={root}/tests/torch_textclf_conf.py",
            "--num_passes=1", "--log_period=0", "--compute_dtype=float32"]
    one = str(tmp_path / "one")
    assert main(args + ["--device=cuda", f"--save_dir={one}"]) == 0
    d = str(tmp_path / "world")
    launcher = launch_local(
        2, "-m", ["paddle_tpu_torch", *args, "--mesh_shape=2",
                  f"--save_dir={d}/ck"],
        env={**PAR_TEXTCLF_ENV, "PYTHONPATH": root},
        coordinator=f"file://{d}/rendezvous", backend="gloo",
        log_dir=f"{d}/logs", cwd=root)
    codes = launcher.join(300)
    assert codes == [0, 0], launcher.stderr_tails()
    lines = []
    for r in range(2):
        with open(f"{d}/logs/rank-{r}.out") as f:
            lines.append(json.loads(f.read().strip().splitlines()[-1]))
    assert lines[0]["params_sha256"] == lines[1]["params_sha256"]
    for x in lines:
        assert x["launches"]["by_library"] == {"lstm_forward": 8,
                                               "lstm_backward": 8}
    for name in ("params",):
        with np.load(os.path.join(pass_dir(one, 0), f"{name}.npz")) as z:
            want = {k: z[k] for k in z.files}
        with np.load(os.path.join(pass_dir(f"{d}/ck", 0),
                                  f"{name}.npz")) as z:
            got = {k: z[k] for k in z.files}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_pserver_movielens_two_ranks_on_one_card(dev, tmp_path):
    """``movielens_net(sparse_grad=True)`` with its tables on ``model=2``
    (gloo, this card, f32) against the one-process masked path from the
    same tables: losses rtol 1e-6, tables and Adam slots rtol 1e-6 / atol
    1e-7, dirty rows exactly the rows whose slots moved."""
    import paddle_tpu_torch.nn as tnn
    from paddle_tpu_torch.models.recommender import movielens_net
    from paddle_tpu_torch.param.optimizers import Adam, slot_leaves
    from paddle_tpu_torch.trainer import SGDTrainer

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_dist import run_world

    rng = np.random.RandomState(11)
    feeds = [{"user_id": rng.randint(0, 300, (32, 1)).astype(np.int32),
              "movie_id": rng.randint(0, 200, (32, 1)).astype(np.int32),
              "score": (rng.rand(32, 1) * 5).astype(np.float32)}
             for _ in range(3)]
    tnn.reset_naming()
    with compute_dtype_scope("float32"):
        one = SGDTrainer(movielens_net(300, 200, emb_dim=16, hid_dim=16,
                                       sparse_grad=True)[0],
                         Adam(learning_rate=0.01), seed=0, device=dev)
        p0 = {k: v.detach().cpu().numpy().copy()
              for k, v in one.params.items()}
        ref = [float(one.train_batch(f)) for f in feeds]
    tables = ["_user_emb.w0", "_movie_emb.w0"]
    inputs = {**{f"p.{k}": v for k, v in p0.items() if k not in tables},
              **{f"t.{k}": p0[k] for k in tables},
              **{f"feed{i}.{k}": v for i, f in enumerate(feeds)
                 for k, v in f.items()}}
    outs = run_world(tmp_path, 2, "trainer", inputs,
                     {"net": "movielens", "n_users": 300, "n_movies": 200,
                      "emb": 16, "hid": 16, "mesh": {"model": 2},
                      "opt": "Adam", "opt_kw": {"learning_rate": 0.01},
                      "adopt_tables": True, "n_feeds": 3,
                      "feed_keys": ["user_id", "movie_id", "score"]},
                     device="cuda")
    arrays, meta = outs[0]
    np.testing.assert_allclose(meta["losses"], ref, rtol=1e-6)
    for k in tables:
        v = one.params[k].detach().cpu().numpy()
        np.testing.assert_allclose(arrays[f"t.{k}"][:v.shape[0]], v,
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        slots = slot_leaves(one.opt_state["slots"][k])
        for i, s in enumerate(slots):
            np.testing.assert_allclose(arrays[f"s{i}.{k}"][:v.shape[0]],
                                       s.cpu().numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} slot {i}")
        moved = slots[0].ne(0).any(dim=1).cpu().numpy()
        np.testing.assert_array_equal(arrays[f"d.{k}"][:v.shape[0]], moved)
