"""The port's kernels (paddle_tpu_torch/ops/kernels) against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
as the JAX package's own tests run them (``gru_forward_pallas`` in
interpret mode, ``topk_lse_readout_pallas`` through
``_forced_kernel_config``).  Inputs come from numpy seeds and go through
both packages.  Tolerances are the ones the JAX tests pin:
``tests/test_pallas_kernels.py`` (GRU, rtol 1e-5 / atol 1e-6) and
``tests/test_decode.py`` (top-k ids exact, values and lse 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
from paddle_tpu.ops.decode import _forced_kernel_config
from paddle_tpu.ops.pallas_kernels import (_gru_reference, gru_forward_pallas,
                                           topk_lse_readout_pallas)
from paddle_tpu_torch.ops import gru_layer as t_gru_layer
from paddle_tpu_torch.ops.kernels import (gru_forward, gru_forward_plain,
                                          launch_counts, stable_topk,
                                          topk_lse_readout,
                                          topk_lse_readout_plain)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope


@pytest.fixture(autouse=True)
def f32_compute():
    # conftest pins the JAX side to f32 compute; the port sets its own
    with compute_dtype_scope("float32"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K3: GRU forward
# ---------------------------------------------------------------------------

_GRU_SHAPES = [(4, 6, 8, [6, 3, 5, 1]), (5, 9, 16, [9, 1, 4, 9, 7]),
               (8, 4, 32, [4, 4, 2, 3, 1, 4, 2, 3])]


def _gru_data(rng, B, T, H, lengths):
    xp = (rng.randn(B, T, 3 * H) * 0.3).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray(lengths)[:, None]).astype(
        np.float32)
    w_h = (rng.randn(H, 3 * H) * 0.2).astype(np.float32)
    return xp, mask, w_h


@pytest.mark.parametrize("B,T,H,lengths", _GRU_SHAPES)
def test_gru_forward_matches_pallas_interpret_and_reference(rng, B, T, H,
                                                           lengths):
    xp, mask, w_h = _gru_data(rng, B, T, H, lengths)
    h_seq, h_fin = gru_forward(_t(xp), _t(mask), _t(w_h))
    hp_seq, hp_fin = gru_forward_pallas(jnp.asarray(xp), jnp.asarray(mask),
                                        jnp.asarray(w_h))
    hr_seq, hr_fin = _gru_reference(jnp.asarray(xp), jnp.asarray(mask),
                                    jnp.asarray(w_h))
    for want_seq, want_fin in ((hp_seq, hp_fin), (hr_seq, hr_fin)):
        np.testing.assert_allclose(h_seq.numpy(), np.asarray(want_seq),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(h_fin.numpy(), np.asarray(want_fin),
                                   rtol=1e-5, atol=1e-6)
    # padded steps emit exact zeros
    assert np.all(h_seq.numpy()[mask == 0] == 0.0)


def test_gru_forward_cpu_runs_plain_version_and_counts_no_launch(rng):
    xp, mask, w_h = _gru_data(rng, 4, 6, 8, [6, 3, 5, 1])
    before = launch_counts()["gru_forward"]
    got = gru_forward(_t(xp), _t(mask), _t(w_h))
    want = gru_forward_plain(_t(xp), _t(mask), _t(w_h))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert launch_counts()["gru_forward"] == before


def test_gru_forward_bf16_policy_matches_reference(rng):
    """Under the bf16 compute policy both packages round the h / r*h
    operands and W to bf16 and accumulate in f32."""
    from paddle_tpu.utils.flags import FLAGS

    xp, mask, w_h = _gru_data(rng, 4, 6, 8, [6, 3, 5, 1])
    old = FLAGS.compute_dtype
    FLAGS.compute_dtype = "bfloat16"
    try:
        hr_seq, hr_fin = _gru_reference(jnp.asarray(xp), jnp.asarray(mask),
                                        jnp.asarray(w_h))
    finally:
        FLAGS.compute_dtype = old
    with compute_dtype_scope("bfloat16"):
        h_seq, h_fin = gru_forward(_t(xp), _t(mask), _t(w_h))
    np.testing.assert_allclose(h_seq.numpy(), np.asarray(hr_seq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h_fin.numpy(), np.asarray(hr_fin), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_gru_layer_with_boot_state_matches_jax(rng, reverse):
    """gru_layer with an explicit h0 and the reverse flip, against the JAX
    gru_layer (its scan path: the Pallas kernel boots from zeros)."""
    B, T, D, H = 3, 5, 6, 8
    x = rng.randn(B, T, D).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([5, 2, 4])[:, None]).astype(
        np.float32)
    w_x = (0.3 * rng.randn(D, 3 * H)).astype(np.float32)
    w_h = (0.3 * rng.randn(H, 3 * H)).astype(np.float32)
    b = (0.1 * rng.randn(3 * H)).astype(np.float32)
    h0 = rng.randn(B, H).astype(np.float32)
    j_seq, j_fin = JO.gru_layer(*(jnp.asarray(a) for a in (x, mask, w_x, w_h,
                                                          b)),
                                h0=jnp.asarray(h0), reverse=reverse)
    t_seq, t_fin = t_gru_layer(_t(x), _t(mask), _t(w_x), _t(w_h), _t(b),
                               h0=_t(h0), reverse=reverse)
    np.testing.assert_allclose(t_seq.numpy(), np.asarray(j_seq), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t_fin.numpy(), np.asarray(j_fin), rtol=1e-5,
                               atol=1e-6)


def test_gru_forward_rejects_bad_shapes():
    with pytest.raises(ValueError, match="w_h"):
        gru_forward(torch.zeros(2, 3, 12), torch.ones(2, 3),
                    torch.zeros(4, 11))
    with pytest.raises(ValueError, match="mask"):
        gru_forward(torch.zeros(2, 3, 12), torch.ones(3, 2),
                    torch.zeros(4, 12))


# ---------------------------------------------------------------------------
# K7: top-k + logsumexp readout
# ---------------------------------------------------------------------------

#: the shapes of tests/test_decode.py::_KERNEL_SHAPES
_KERNEL_SHAPES = [(16, 128, 300, 3), (8, 128, 512, 1), (32, 256, 1000, 5),
                  (40, 128, 515, 4), (8, 128, 2048, 8)]


def _jax_readout(s, w, b, k):
    """The JAX kernel in interpret mode, padded as LinearReadout pads."""
    N, D = s.shape
    V = w.shape[1]
    rb, vt = _forced_kernel_config(N, D, V, k)
    vp = -(-V // vt) * vt
    w_p = jnp.pad(jnp.asarray(w), ((0, 0), (0, vp - V)))
    b_p = jnp.pad(jnp.asarray(b).reshape(1, V), ((0, 0), (0, vp - V)),
                  constant_values=-1e30)
    tv, ti, lse = topk_lse_readout_pallas(jnp.asarray(s), w_p, b_p, vocab=V,
                                          k=k, row_block=rb, v_tile=vt)
    return np.asarray(tv[:, :k]), np.asarray(ti[:, :k]), np.asarray(lse[:, 0])


@pytest.mark.parametrize("N,D,V,k", _KERNEL_SHAPES)
def test_topk_lse_readout_matches_pallas_interpret(rng, N, D, V, k):
    s = rng.randn(N, D).astype(np.float32)
    w = (0.1 * rng.randn(D, V)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    tv, ti, tl = topk_lse_readout(_t(s), _t(w), _t(b), k)
    jv, ji, jl = _jax_readout(s, w, b, k)
    np.testing.assert_array_equal(ti.numpy(), ji)             # ids exact
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=1e-5)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64


def _onehot_states(N, D=128):
    s = np.zeros((N, D), np.float32)
    s[np.arange(N), np.arange(N)] = 1.0
    return s


def test_topk_tie_break_prefers_lowest_vocab_index():
    """Equal logits across the kernel's vocab tiles resolve as lax.top_k
    (lowest index first)."""
    N, V, k = 8, 1200, 4
    logits = np.zeros((N, V), np.float32)        # ALL-ties rows
    logits[:, 700] = 1.0
    w = np.zeros((128, V), np.float32)
    w[:N] = logits
    s = _onehot_states(N)
    b = np.zeros((V,), np.float32)
    _, ti, _ = topk_lse_readout(_t(s), _t(w), _t(b), k)
    _, ri = jax.lax.top_k(jnp.asarray(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    _, ji, _ = _jax_readout(s, w, b, k)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_topk_masked_rows_never_leak_pad_indices(rng):
    """-inf (banned) logits with fewer than k finite entries per row match
    lax.top_k exactly and every id stays < vocab."""
    N, V, k, D = 8, 600, 4, 128
    b = np.full((V,), -np.inf, np.float32)
    b[10], b[300] = 1.0, 0.5                     # two finite entries a row
    s = rng.randn(N, D).astype(np.float32)
    w = np.zeros((D, V), np.float32)
    tv, ti, _ = topk_lse_readout(_t(s), _t(w), _t(b), k)
    rv, ri = jax.lax.top_k(jnp.broadcast_to(jnp.asarray(b), (N, V)), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert ti.numpy().max() < V
    # a -inf BIAS banning half the vocabulary under random weights
    w2 = (0.1 * rng.randn(D, V)).astype(np.float32)
    b2 = np.zeros((V,), np.float32)
    b2[::2] = -np.inf
    _, ti2, _ = topk_lse_readout(_t(s), _t(w2), _t(b2), k)
    _, ri2 = jax.lax.top_k(jnp.asarray(s) @ jnp.asarray(w2) + jnp.asarray(b2),
                           k)
    np.testing.assert_array_equal(ti2.numpy(), np.asarray(ri2))
    _, ji2, _ = _jax_readout(s, w2, b2, k)
    np.testing.assert_array_equal(ti2.numpy(), ji2)


def test_topk_all_inf_leading_tiles_keep_lse_finite():
    """Rows whose leading vocab tiles are all -inf keep a finite lse equal
    to the two-pass reference over the finite tail."""
    N, V, k = 8, 1100, 2
    tail = np.random.RandomState(0).randn(N, 200).astype(np.float32)
    w = np.zeros((128, V), np.float32)
    w[:N, 900:] = tail
    b = np.zeros((V,), np.float32)
    b[:900] = -np.inf
    s = _onehot_states(N)
    tv, ti, tl = topk_lse_readout(_t(s), _t(w), _t(b), k)
    logits = np.full((N, V), -np.inf, np.float32)
    logits[:, 900:] = tail
    lf = jnp.asarray(logits)
    rv, ri = jax.lax.top_k(lf, k)
    m = jnp.max(lf, axis=-1)
    rlse = m + jnp.log(jnp.sum(jnp.exp(lf - m[:, None]), axis=-1))
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rlse), rtol=1e-5,
                               atol=1e-5)


def test_stable_topk_matches_lax_top_k_on_ties(rng):
    x = rng.randint(0, 3, (6, 40)).astype(np.float32)   # many ties
    x[0] = -np.inf
    for k in (1, 3, 7):
        tv, ti = stable_topk(_t(x), k)
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_topk_readout_cpu_runs_plain_version_and_checks_args(rng):
    s = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 50).astype(np.float32))
    b = torch.zeros(50)
    before = launch_counts()["topk_lse_readout"]
    for a, c in zip(topk_lse_readout(s, w, b, 3),
                    topk_lse_readout_plain(s, w, b, 3)):
        assert torch.equal(a, c)
    assert launch_counts()["topk_lse_readout"] == before
    with pytest.raises(ValueError, match="k must be"):
        topk_lse_readout(s, w, b, 17)
    with pytest.raises(ValueError, match="compute dtype"):
        topk_lse_readout(s.bfloat16(), w, b, 3)


def test_kernel_sources_exist_and_name_what_they_replace():
    """Each kernel library has its CUDA source in the package, and the
    source's note names the TPU kernel it replaces."""
    from paddle_tpu_torch.ops.kernels.build import LIBRARIES

    want = {"gru_forward": "_gru_pallas_raw",
            "gru_backward": "_gru_bwd_pallas_raw",
            "ce_readout_fwd": "ce_readout_fwd_pallas",
            "ce_readout_bwd": "ce_readout_bwd_pallas",
            "topk_lse_readout": "topk_lse_readout_pallas"}
    assert set(LIBRARIES) == set(want)
    for name, lib in LIBRARIES.items():
        with open(lib.source) as f:
            src = f.read()
        assert f"Replaces: paddle_tpu/ops/pallas_kernels.py::{want[name]}" \
            in src
        assert "sm_90a" in src


def test_kernel_library_path_is_content_addressed(tmp_path):
    """A library is named by a hash of its source and nvcc flags: an edited
    source builds anew, an unchanged one is loaded as it is."""
    from paddle_tpu_torch.ops.kernels.build import BUILD_DIR, CudaLibrary

    lib = CudaLibrary("probe", {})
    lib.source = str(tmp_path / "probe.cu")
    (tmp_path / "probe.cu").write_text("// one\n")
    first = lib.path()
    assert first == lib.path()
    assert first.startswith(BUILD_DIR) and first.endswith(".so")
    (tmp_path / "probe.cu").write_text("// two\n")
    assert lib.path() != first


def test_wrappers_refuse_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other device that is
    not CUDA is refused, never computed some other way."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gru_forward(torch.zeros(2, 3, 12, device=meta),
                    torch.ones(2, 3, device=meta),
                    torch.zeros(4, 12, device=meta))
    with pytest.raises(ValueError, match="cpu or cuda"):
        topk_lse_readout(torch.zeros(4, 8, device=meta),
                         torch.zeros(8, 20, device=meta),
                         torch.zeros(20, device=meta), 3)
