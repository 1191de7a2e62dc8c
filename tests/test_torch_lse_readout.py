"""The port's logsumexp readout — K12's plain version
(``paddle_tpu_torch/ops/kernels/logsumexp.py``) and
``sequence_softmax_ce_readout`` with ``_USE_LSE_READOUT`` on
(ops/losses.py ``_CEReadoutLSE``) — against the JAX package.

The JAX side runs ``logsumexp_rows_pallas`` in interpret mode, and
``_ce_readout_fused`` as ``tests/test_pallas_ce.py`` does.  On the CPU the
port's wrapper runs its plain version.  Tolerances are that file's: loss
rtol 1e-6, gradients rtol 1e-5 / atol 1e-6; the row logsumexp itself rtol
1e-6 (float32 sums of exps in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import losses as j_losses
from paddle_tpu.ops.pallas_kernels import logsumexp_rows_pallas
from paddle_tpu_torch.ops import losses, sequence_softmax_ce_readout
from paddle_tpu_torch.ops.kernels import (launch_counts, logsumexp_rows,
                                          logsumexp_rows_plain)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt", sorted(_DTYPES))
@pytest.mark.parametrize("N,V,row_tile", [(16, 50, 8), (8, 300, 8),
                                          (24, 7, 24)])
def test_logsumexp_rows_matches_pallas(rng, N, V, row_tile, dt):
    """K12's plain version against the reference kernel on the same bf16
    or f32 rows, with a row holding -inf entries and an all -inf row (nan
    on both sides: -inf - -inf)."""
    x = (3.0 * rng.randn(N, V)).astype(np.float32)
    x[1, ::2] = -np.inf
    x[3] = -np.inf
    jdt, tdt = _DTYPES[dt]
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(logsumexp_rows_pallas(xj, row_tile=row_tile))
    got = logsumexp_rows_plain(torch.from_numpy(np.array(
        xj.astype(jnp.float32))).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    assert np.isnan(want[3]) and torch.isnan(got[3])
    keep = np.arange(N) != 3
    np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-6)


def test_logsumexp_rows_on_the_cpu_runs_the_plain_version_and_checks(rng):
    x = torch.from_numpy(rng.randn(5, 11).astype(np.float32))
    before = launch_counts()["logsumexp_rows"]
    assert torch.equal(logsumexp_rows(x), logsumexp_rows_plain(x))
    assert torch.equal(logsumexp_rows(x.bfloat16()),
                       logsumexp_rows_plain(x.bfloat16()))
    assert launch_counts()["logsumexp_rows"] == before
    for bad in (x[0], x.double(), torch.zeros(3, 0), x[None]):
        with pytest.raises(ValueError):
            logsumexp_rows(bad)


def _ce_inputs(rng, B, T, D, V, lengths):
    states = (rng.randn(B, T, D) * 0.3).astype(np.float32)
    w = (rng.randn(D, V) * 0.1).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    return states, w, b, labels, mask


#: B*T = 9 is odd: gcd(9, 64) = 1, where the reference's fused readout
#: takes its XLA reduction; B*T = 8 and 24 reach its Pallas kernel
_CE_CASES = [(3, 3, 16, 50, [3, 1, 2]), (2, 4, 16, 50, [4, 4]),
             (4, 6, 24, 90, [6, 2, 4, 6])]


@pytest.mark.parametrize("B,T,D,V,lengths", _CE_CASES)
def test_lse_readout_matches_the_reference_fused_readout(
        monkeypatch, rng, B, T, D, V, lengths):
    """``sequence_softmax_ce_readout`` with ``_USE_LSE_READOUT`` on
    against the reference's ``_ce_readout_fused``: loss, d_states, d_w,
    d_b."""
    import jax

    states, w, b, labels, mask = _ce_inputs(rng, B, T, D, V, lengths)
    lab_j, mask_j = jnp.asarray(labels), jnp.asarray(mask)

    def fused(s, w_, b_):
        return j_losses._ce_readout_fused(s, w_, b_, lab_j, mask_j)

    l_ref, g_ref = jax.value_and_grad(fused, argnums=(0, 1, 2))(
        jnp.asarray(states), jnp.asarray(w), jnp.asarray(b))
    monkeypatch.setattr(losses, "_USE_LSE_READOUT", True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (states, w, b)]
    loss = sequence_softmax_ce_readout(*leaves, torch.from_numpy(labels),
                                       torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-6)
    for g, want, name in zip(grads, g_ref, ("d_states", "d_w", "d_b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("B,T,D,V,lengths", _CE_CASES)
def test_lse_readout_matches_the_tiled_readout(monkeypatch, rng, B, T, D,
                                               V, lengths):
    """The port's two readouts compute one loss: the logsumexp readout
    against K1/K2's plain versions (the default), loss and gradients to
    float32 rounding; the switch changes which kernels run."""
    states, w, b, labels, mask = _ce_inputs(rng, B, T, D, V, lengths)
    out = []
    for on in (False, True):
        monkeypatch.setattr(losses, "_USE_LSE_READOUT", on)
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (states, w, b)]
        loss = sequence_softmax_ce_readout(*leaves, torch.from_numpy(labels),
                                           torch.from_numpy(mask))
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(float(l1.detach()), float(l0.detach()),
                               rtol=1e-6)
    for a, c, name in zip(g1, g0, ("d_states", "d_w", "d_b")):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_lse_readout_under_bf16_rounds_logits_and_d_logits(monkeypatch,
                                                          rng):
    """Under the bf16 policy the logits and d_logits are rounded to bf16,
    as the reference's are: loss within 1e-3 relative of the f32 loss,
    gradients float32, finite, of the parameters' shapes."""
    states, w, b, labels, mask = _ce_inputs(rng, 3, 5, 16, 70,
                                            [5, 2, 4])
    monkeypatch.setattr(losses, "_USE_LSE_READOUT", True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (states, w, b)]
    args = (torch.from_numpy(labels), torch.from_numpy(mask))
    l32 = sequence_softmax_ce_readout(*leaves, *args)
    with compute_dtype_scope("bfloat16"):
        l16 = sequence_softmax_ce_readout(*leaves, *args)
        grads = torch.autograd.grad(l16, leaves)
    assert l16.dtype == torch.float32
    np.testing.assert_allclose(float(l16.detach()), float(l32.detach()),
                               rtol=1e-3)
    for g, leaf in zip(grads, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        assert torch.isfinite(g).all()


def test_lse_readout_is_off_by_default():
    """As the reference's ``_USE_PALLAS_LSE_READOUT``."""
    assert losses._USE_LSE_READOUT is False
