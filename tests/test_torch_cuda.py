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

from paddle_tpu_torch.ops.kernels import (gru_forward, gru_forward_plain,
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
