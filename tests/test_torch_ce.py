"""The port's fused readout + softmax CE (paddle_tpu_torch/ops/losses.py and
the K1/K2 kernels of ops/kernels/ce_readout.py) against the JAX package's
vocab-tiled path, which runs its Pallas kernels in interpret mode here
(``_tiled_ce_cfg`` forced to (8, 128), as ``tests/test_pallas_ce.py`` does).

On the CPU each kernel wrapper runs its plain version.  Inputs come from
numpy seeds and go through both packages.  Tolerances are the ones
``tests/test_pallas_ce.py`` pins: float32 rtol 1e-6 on the loss and 2e-6
on gradients normalised by their largest entry; bfloat16 2e-2 / 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import losses as JL
from paddle_tpu.ops.pallas_kernels import (ce_readout_bwd_pallas,
                                           ce_readout_fwd_pallas)
from paddle_tpu_torch.ops.kernels import (ce_readout_bwd, ce_readout_bwd_plain,
                                          ce_readout_fwd, ce_readout_fwd_plain,
                                          launch_counts)
from paddle_tpu_torch.ops.losses import (masked_token_mean,
                                         sequence_softmax_ce_readout)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope


def _data(rng, B=4, T=6, D=128, V=300, lens=(6, 4, 5, 2)):
    states = (rng.randn(B, T, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, V) * 0.1).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(
        np.float32)
    return states, w, b, labels, mask


def _jax_tiled(monkeypatch, states, w, b, labels, mask):
    monkeypatch.setattr(JL, "_tiled_ce_cfg", lambda B, T, D, V: (8, 128))

    def loss(s, w_, b_):
        return JL.sequence_softmax_ce_readout(s, w_, b_, jnp.asarray(labels),
                                              jnp.asarray(mask))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(states), jnp.asarray(w), jnp.asarray(b))
    return float(val), [np.asarray(g, np.float64) for g in grads]


def _port(states, w, b, labels, mask):
    ts, tw, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (states, w, b))
    loss = sequence_softmax_ce_readout(ts, tw, tb,
                                       torch.from_numpy(labels).long(),
                                       torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, [ts, tw, tb])
    return float(loss.detach()), [g.double().numpy() for g in grads]


def _assert_grads_close(want, got, atol):
    for a, c, nm in zip(want, got, ("d_states", "d_w", "d_b")):
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(a / scale, c / scale, atol=atol,
                                   err_msg=nm)


@pytest.mark.parametrize("V", [300, 256])   # ragged and whole vocab tiles
def test_ce_readout_matches_jax_tiled_f32(monkeypatch, rng, V):
    data = _data(rng, V=V)
    l_ref, g_ref = _jax_tiled(monkeypatch, *data)
    with compute_dtype_scope("float32"):
        l_got, g_got = _port(*data)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-6)
    _assert_grads_close(g_ref, g_got, 2e-6)


def test_ce_readout_matches_jax_tiled_bf16(monkeypatch, rng):
    from paddle_tpu.utils.flags import FLAGS

    data = _data(rng)
    monkeypatch.setattr(FLAGS, "compute_dtype", "bfloat16")
    l_ref, g_ref = _jax_tiled(monkeypatch, *data)
    with compute_dtype_scope("bfloat16"):
        l_got, g_got = _port(*data)
    assert abs(l_got - l_ref) / abs(l_ref) < 2e-2
    _assert_grads_close(g_ref, g_got, 3e-2)


def _padded(w, b, v_tile):
    """The reference wrapper's padding: zero columns, bias -1e30."""
    V = w.shape[1]
    Vp = -(-V // v_tile) * v_tile
    w_p = np.pad(w, ((0, 0), (0, Vp - V)))
    b_p = np.pad(b, (0, Vp - V), constant_values=-1e30)[None]
    return w_p, b_p


@pytest.mark.parametrize("V", [300, 256])
def test_ce_kernels_match_pallas_kernels(rng, V):
    """K1 and K2 (plain versions) against ce_readout_fwd/bwd_pallas run in
    interpret mode on the padded vocab: statistics, the logits residual and
    all three gradients, with a masked (scale 0) row."""
    N, D = 24, 128
    states = (rng.randn(N, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, V) * 0.1).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, (N,)).astype(np.int32)
    scale = (rng.rand(N) / N).astype(np.float32)
    scale[3] = 0.0
    w_p, b_p = _padded(w, b, 128)
    pt, lse, logits = ce_readout_fwd_pallas(
        jnp.asarray(states), jnp.asarray(w_p), jnp.asarray(b_p),
        jnp.asarray(labels[:, None]), row_block=8, v_tile=128)
    d_s, d_w, d_b = ce_readout_bwd_pallas(
        logits, jnp.asarray(states), jnp.asarray(w_p),
        jnp.asarray(labels[:, None]), lse, jnp.asarray(scale[:, None]),
        v_tile=128)
    t = torch.from_numpy
    with compute_dtype_scope("float32"):
        g_pt, g_lse, g_logits = ce_readout_fwd(t(states), t(w), t(b),
                                               t(labels))
        g_ds, g_dw, g_db = ce_readout_bwd(g_logits, t(states), t(w),
                                          t(labels), g_lse, t(scale))
    np.testing.assert_allclose(g_pt.numpy(), np.asarray(pt)[:, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_lse.numpy(), np.asarray(lse)[:, 0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_logits.numpy(), np.asarray(logits)[:, :V],
                               rtol=1e-6, atol=1e-6)
    for want, got, nm in ((d_s, g_ds, "d_states"), (np.asarray(d_w)[:, :V],
                                                    g_dw, "d_w"),
                          (np.asarray(d_b)[0, :V], g_db, "d_b")):
        want = np.asarray(want, np.float64)
        sc = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got.double().numpy() / sc, want / sc,
                                   atol=2e-6, err_msg=nm)


def test_ce_wrappers_on_cpu_run_plain_versions_and_count_no_launch(rng):
    N, D, V = 10, 16, 40
    states = torch.from_numpy(rng.randn(N, D).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.randn(D, V)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, V, (N,)))
    scale = torch.full((N,), 1.0 / N)
    before = launch_counts()
    fwd = ce_readout_fwd(states, w, b, labels)
    bwd = ce_readout_bwd(fwd[2], states, w, labels, fwd[1], scale)
    assert launch_counts() == before
    for got, want in zip(fwd + bwd,
                         ce_readout_fwd_plain(states, w, b, labels)
                         + ce_readout_bwd_plain(fwd[2], states, w, labels,
                                                fwd[1], scale)):
        assert torch.equal(got, want)
    # the loss gradient of one row's per_tok is softmax - onehot
    p = torch.softmax(states @ w + b, -1)
    p[torch.arange(N), labels] -= 1.0
    torch.testing.assert_close(bwd[2], (p / N).sum(0), rtol=1e-5, atol=1e-6)


def test_ce_wrappers_reject_bad_inputs(rng):
    s = torch.zeros(4, 8)
    w = torch.zeros(8, 20)
    b = torch.zeros(20)
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="depth"):
        ce_readout_fwd(s, torch.zeros(9, 20), b, lab)
    with pytest.raises(ValueError, match="labels"):
        ce_readout_fwd(s, w, b, torch.zeros(5, dtype=torch.long))
    with pytest.raises(ValueError, match="compute dtype"):
        ce_readout_fwd(s, w.bfloat16(), b, lab)
    with pytest.raises(ValueError, match="scale"):
        ce_readout_bwd(torch.zeros(4, 20), s, w, lab, torch.zeros(4),
                       torch.zeros(3))


def test_masked_token_mean_matches_jax(rng):
    per_tok = rng.randn(3, 5).astype(np.float32)
    mask = (rng.rand(3, 5) > 0.4).astype(np.float32)
    want = float(JL.masked_token_mean(jnp.asarray(per_tok),
                                      jnp.asarray(mask)))
    got = masked_token_mean(torch.from_numpy(per_tok), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # an all-padded batch divides by 1, not 0
    zero = masked_token_mean(torch.from_numpy(per_tok), torch.zeros(3, 5))
    assert float(zero) == 0.0


_BF, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("N,D,V,dtype,ptrs,want", [
    # the flagship's training readout and the card tests' TMA shapes
    (12288, 512, 30000, _BF, (0, 256, 4096), "wgmma"),
    (257, 512, 4096, _BF, (16, 32, 48), "wgmma"),
    (128, 64, 30000, _BF, (0, 0, 0), "wgmma"),
    (130, 64, 64, _BF, (0, 0, 0), "wgmma"),
    # V % 8 != 0: a logits or w row is not a multiple of 16 bytes
    (40, 128, 515, _BF, (0, 0, 0), "wmma"),
    (12288, 512, 30001, _BF, (0, 0, 0), "wmma"),
    (12288, 512, 30004, _BF, (0, 0, 0), "wmma"),
    # D % 64 != 0, or a depth the kernels are not instantiated for
    (3, 96, 131, _BF, (0, 0, 0), "wmma"),
    (64, 96, 4096, _BF, (0, 0, 0), "wmma"),
    (64, 384, 4096, _BF, (0, 0, 0), "wmma"),
    (64, 1024, 4096, _BF, (0, 0, 0), "wmma"),
    # a base that is not 16-byte aligned
    (64, 512, 4096, _BF, (2, 0, 0), "wmma"),
    (64, 512, 4096, _BF, (0, 0, 8), "wmma"),
    # no rows: only the backward's zero d_w / d_b remain
    (0, 512, 4096, _BF, (0, 0, 0), "wmma"),
    # float32 (the f32 policy): CUDA cores at every shape
    (12288, 512, 30000, _F32, (0, 0, 0), "simt"),
    (40, 128, 515, _F32, (0, 0, 0), "simt"),
])
def test_ce_path_is_a_function_of_shape_dtype_and_alignment(N, D, V, dtype,
                                                            ptrs, want):
    from paddle_tpu_torch.ops.kernels.ce_readout import _ce_path

    assert _ce_path(N, D, V, dtype, ptrs) == want


@pytest.mark.parametrize("N,D,V,fwd,bwd", [
    (12288, 512, 30000, (3, 15, 12288), (12288, 512)),
    (257, 512, 4096, (3, 2, 257), (257, 512)),
    (128, 64, 30000, (3, 15, 128), (128, 64)),
    (130, 64, 64, (3, 1, 130), (130, 64)),
    (7, 128, 2048, (3, 1, 7), (7, 128)),
    (7, 128, 2056, (3, 2, 7), (7, 128)),
])
def test_ce_scratch_shapes_follow_the_vocab_chunks(N, D, V, fwd, bwd):
    """The wgmma forward keeps (max, sum-exp, label logit) for each row and
    2048-column vocab chunk; the backward one [N, D] partial d_states.  The
    chunk count depends on V alone; the other paths take no scratch."""
    from paddle_tpu_torch.ops.kernels.ce_readout import _ce_scratch

    assert _ce_scratch(N, D, V, "wgmma") == {"fwd": fwd, "bwd": bwd}
    assert _ce_scratch(N, D, V, "wmma") == {"fwd": (0,), "bwd": (0,)}
    assert _ce_scratch(N, D, V, "simt") == {"fwd": (0,), "bwd": (0,)}


def test_ce_path_counts_split_by_path_and_reset():
    from paddle_tpu_torch.ops.kernels.build import reset_launch_counts
    from paddle_tpu_torch.ops.kernels.ce_readout import CE_READOUT_FWD

    before = CE_READOUT_FWD.launches
    CE_READOUT_FWD.count("wgmma")
    CE_READOUT_FWD.count("wmma")
    CE_READOUT_FWD.count("wgmma")
    assert CE_READOUT_FWD.launches == before + 3
    assert CE_READOUT_FWD.launches_by_path["wgmma"] >= 2
    reset_launch_counts()
    assert CE_READOUT_FWD.launches == 0
    assert CE_READOUT_FWD.launches_by_path == {}
