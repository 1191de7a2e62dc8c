"""K8 of the port: ``topk_lse_logits`` (its plain version here) and
``LogitsReadout`` against the JAX package's ``topk_lse_logits_pallas``
(interpret mode on the CPU, as ``tests/test_decode.py`` runs it) and
``LogitsReadout``; and the decode drivers over ``LogitsReadout`` on the
EOS-prone toy GRU LM of ``tests/test_decode.py``.

Ids and values must be equal (the same float32 logits, the same total
order); the logsumexp within rtol 1e-6 (sums in another order).  Decoded
ids equal, scores within 1e-5 (``tests/test_decode.py``'s tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops as JO
import paddle_tpu.ops.decode as JD
from paddle_tpu.ops.pallas_kernels import topk_lse_logits_pallas
import paddle_tpu_torch.ops as TO
import paddle_tpu_torch.ops.decode as TD
import paddle_tpu_torch.ops.kernels.topk_logits as TL
from paddle_tpu_torch.ops.kernels import (launch_counts, topk_lse_logits,
                                          topk_lse_logits_plain)
from paddle_tpu_torch.ops.numerics import compute_dtype_scope


@pytest.fixture(autouse=True)
def f32_compute():
    with compute_dtype_scope("float32"):
        yield


def _logits(rng, N, V, rows):
    """Gaussian logits with special rows: ``ties`` (integer values in
    [-2, 2], so most entries tie), ``neginf`` (every third logit -inf) and
    ``allneginf`` (the whole row -inf)."""
    x = rng.randn(N, V).astype(np.float32)
    if "ties" in rows:
        x[0] = rng.randint(-2, 3, V)
        x[1] = 0.0
    if "neginf" in rows:
        x[2, ::3] = -np.inf
        x[3, :V - 2] = -np.inf
    if "allneginf" in rows:
        x[4] = -np.inf
    return x


def _jax_k8(x, k):
    rb, vt = JD._forced_kernel_config(x.shape[0], None, x.shape[1], k)
    V = x.shape[1]
    l_p = jnp.pad(jnp.asarray(x), ((0, 0), (0, -(-V // vt) * vt - V)),
                  constant_values=-1e30)
    tv, ti, lse = topk_lse_logits_pallas(l_p, vocab=V, k=k, row_block=rb,
                                         v_tile=vt)
    return (np.asarray(tv[:, :k]), np.asarray(ti[:, :k]),
            np.asarray(lse[:, 0]))


def _assert_same(got, want, rtol=1e-6):
    gv, gi, gl = (t.numpy() for t in got)
    wv, wi, wl = want
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(gl, wl, rtol=rtol, atol=0)


# ragged V (not a multiple of the 512-column tile) with ties and -inf
# entries; V a multiple of the tile with a whole row -inf (no pad column,
# so the reference's lse is the clamp's finfo.min too)
@pytest.mark.parametrize("N,V,k,rows", [
    (8, 300, 1, ("ties", "neginf")),
    (16, 1200, 3, ("ties", "neginf")),
    (8, 999, 16, ("ties", "neginf")),
    (8, 1024, 3, ("ties", "neginf", "allneginf")),
    (24, 512, 16, ("ties", "allneginf")),
])
def test_plain_k8_matches_the_reference_kernel(N, V, k, rows):
    x = _logits(np.random.RandomState(V + k), N, V, rows)
    _assert_same(topk_lse_logits_plain(torch.from_numpy(x), k),
                 _jax_k8(x, k))


def test_plain_k8_reads_bf16_logits_as_the_reference_does():
    x = _logits(np.random.RandomState(5), 16, 700, ("ties", "neginf"))
    xb = torch.from_numpy(x).bfloat16()
    want = _jax_k8(np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32), 3)
    _assert_same(topk_lse_logits_plain(xb, 3), want)
    before = launch_counts()["topk_lse_logits"]
    _assert_same(topk_lse_logits(xb, 3), want)       # CPU: the plain version
    assert launch_counts()["topk_lse_logits"] == before


@pytest.mark.parametrize("bad,k,match", [
    (torch.zeros(4), 1, r"\[N, V\]"),
    (torch.zeros(2, 8), 0, "k must be"),
    (torch.zeros(2, 8), 17, "k must be"),
    (torch.zeros(2, 8), 9, "k must be"),
    (torch.zeros(2, 8, dtype=torch.float64), 2, "float32 or bfloat16"),
])
def test_k8_wrapper_refuses_what_the_kernel_does_not_take(bad, k, match):
    with pytest.raises(ValueError, match=match):
        topk_lse_logits(bad, k)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("V", [1, 16, 131, 515, 29999, 30000, 30001])
def test_k8_plan_covers_each_column_once(V, k, dt):
    """The kernel's split of a row depends on V and the dtype alone (no N,
    no k: the function takes neither), and its slices cover [0, V) once:
    no empty slice, no overlap, lengths the kernel takes (multiples of 8
    columns, a chunk within its staging buffer, at most 8 blocks a row)."""
    import inspect

    assert list(inspect.signature(TL._k8_plan).parameters) == ["V", "dtype"]
    plan = TL._k8_plan(V, dt)
    TL._k8_plan.cache_clear()
    assert TL._k8_plan(V, dt) == plan
    C, S, CH = plan
    assert 1 <= C <= TL._MAX_CLUSTER
    assert S % TL._ALIGN == 0 and CH % TL._ALIGN == 0 and 0 < CH <= S
    assert CH * torch.finfo(dt).bits // 8 <= TL._MAX_CHUNK_BYTES
    cover = np.zeros(V, np.int64)
    for r in range(C):
        lo, hi = r * S, min((r + 1) * S, V)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()
    if k <= V:                      # what the wrapper takes for this k
        topk_lse_logits(torch.zeros(2, V, dtype=dt), k)


def test_k8_plan_at_the_generation_readout():
    """The measured split at the DSL generation's readout (N = 192,
    V = 30000): 2 blocks a row, each slice staged in one chunk, in f32 and
    bf16; a larger vocabulary takes more blocks, up to 8, and stages a
    slice in several chunks."""
    assert TL._k8_plan(30000, torch.float32) == (2, 15000, 15000)
    assert TL._k8_plan(30000, torch.bfloat16) == (2, 15000, 15000)
    assert TL._k8_plan(250000, torch.float32) == (8, 31256, 16384)


@pytest.mark.parametrize("N,V,k,forced", [
    (16, 1200, 3, True), (8, 300, 16, True),     # the reference's kernel
    (16, 1200, 3, False), (8, 40, 20, False),    # its unfused statistics
    (8, 12, 12, True)])
def test_logits_readout_matches_the_reference(N, V, k, forced):
    """k <= 16 and V >= k: the port's kernel route against the reference
    forced through its kernel (exact) or its unfused path (ids exact, lse
    within rtol 1e-6); k > 16: both take the unfused statistics."""
    x = _logits(np.random.RandomState(N + V), N, V, ("ties", "neginf"))
    want = [np.asarray(a) for a in JD.LogitsReadout()(
        jnp.asarray(x), k, use_kernel=forced if k <= 16 else None)]
    got = TO.LogitsReadout()(torch.from_numpy(x), k)
    _assert_same(got, want)


def test_logits_readout_gate_is_decided_by_shape_alone(monkeypatch):
    """k > 16 and V < k never reach the kernel's wrapper; other shapes
    always do."""
    calls = []
    monkeypatch.setattr(TD, "topk_lse_logits",
                        lambda l, k: calls.append(k) or (None, None, None))
    x = torch.randn(4, 30)
    TO.LogitsReadout()(x, 17)
    TO.LogitsReadout()(x[:, :5], 6)
    assert calls == []
    TO.LogitsReadout()(x, 16)
    TO.LogitsReadout()(x[:, :5], 5)
    assert calls == [16, 5]


def _lm(rng, V=12, H=8, eos_boost=3.0):
    """``tests/test_decode.py``'s EOS-prone toy GRU LM, returning full
    logits, in both packages."""
    p = {
        "emb": (0.5 * rng.randn(V, H)).astype(np.float32),
        "wx": (0.5 * rng.randn(H, 3 * H)).astype(np.float32),
        "wh": (0.5 * rng.randn(H, 3 * H)).astype(np.float32),
        "out": rng.randn(H, V).astype(np.float32),
        "outb": (np.eye(1, V, 1)[0] * eos_boost).astype(np.float32),
    }
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}

    def j_step(tokens, state):
        e = jnp.take(jp["emb"], tokens, axis=0)
        h2 = JO.gru_step(JO.linear(e, jp["wx"]), state["h"], jp["wh"])
        return JO.linear(h2, jp["out"], jp["outb"]), {"h": h2}

    def t_step(tokens, state):
        e = TO.embedding_lookup(tp["emb"], tokens)
        h2 = TO.gru_step(TO.linear(e, tp["wx"]), state["h"], tp["wh"])
        return TO.linear(h2, tp["out"], tp["outb"]), {"h": h2}

    return j_step, t_step


@pytest.mark.parametrize("driver", ["beam", "greedy"])
@pytest.mark.parametrize("early", [True, False])
def test_decode_over_logits_readout_matches_the_reference(driver, early):
    rng = np.random.RandomState(0)
    j_step, t_step = _lm(rng)
    h0 = rng.randn(3, 8).astype(np.float32)
    kw = dict(batch_size=3, vocab_size=12, max_len=15, early_exit=early)
    if driver == "beam":
        kw["beam_size"] = 3
        jt, js = JD.beam_decode(j_step, JD.LogitsReadout(),
                                {"h": jnp.asarray(h0)}, **kw)
        tt, ts = TD.beam_decode(t_step, TD.LogitsReadout(),
                                {"h": torch.from_numpy(h0)}, **kw)
    else:
        jt, js = JD.greedy_decode(j_step, JD.LogitsReadout(),
                                  {"h": jnp.asarray(h0)}, **kw)
        tt, ts = TD.greedy_decode(t_step, TD.LogitsReadout(),
                                  {"h": torch.from_numpy(h0)}, **kw)
    assert (tt.numpy()[..., -1] == 1).any()        # beams really finished
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
