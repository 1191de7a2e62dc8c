"""Training through ``recurrent_group`` on the port against the JAX
package, on the CPU: the demo/seqToseq training composition
(``tests/torch_seqtoseq_net.py::seqtoseq_trainer``), ``lstmemory_group``
and ``gru_group`` (forward and reverse) give the reference's loss and
every gradient, and take the reference's ``Adam`` steps through
``SGDTrainer``; the group decoder gives the port's own fused attention
decoder's outputs and gradients (``ops/attention_decoder.py``, whose
kernels K5/K6 run their plain versions here) on carried weights, as
``tests/test_seq2seq_group_decoder.py`` holds the reference's.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_group_train.py -q

Tolerance: the loss at rtol 1e-5 / atol 1e-6; each gradient by its
largest difference against its largest entry, 1e-5 (1e-6 absolute where
it vanishes): float32 sums in another order over the group's steps.  The
fused decoder hoists the target half of the input projection out of the
loop, which the group's ``mixed`` layer sums step by step: the same
tolerance holds.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.v2.networks as jnet
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
import paddle_tpu_torch.v2.networks as tnet
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.ops.attention_decoder import attention_gru_decoder
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.flags import FLAGS

from torch_compare import assert_grads_close, loss_and_grads, nonzero_params
from torch_seqtoseq_net import seqtoseq_feed, seqtoseq_trainer

RTOL, ATOL = 1e-5, 1e-6
V, S = 12, 7


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    with compute_dtype_scope("float32"):
        yield


def _group_net(kind, reverse):
    def build(nn, net):
        x = nn.data("x", size=5, is_seq=True)
        H = 4
        mult = 4 if kind == "lstmemory_group" else 3
        proj = nn.fc(x, mult * H, act="linear", name="proj")
        if kind == "lstmemory_group":
            grp = net.lstmemory_group(proj, H, reverse=reverse,
                                      mixed_bias_attr=True, name="g")
        else:
            grp = net.gru_group(proj, H, reverse=reverse, name="g")
        tgt = nn.data("tgt", size=H, is_seq=True)
        return nn.mse_cost(nn.pooling(nn.addto([grp, tgt], act="tanh"),
                                      pooling_type="sum"),
                           nn.data("y", size=H), name="cost")

    def feed(rng):
        lens = np.array([6, 1, 4], np.int32)
        return {"x": (rng.randn(3, 6, 5).astype(np.float32), lens),
                "tgt": (rng.randn(3, 6, 4).astype(np.float32), lens),
                "y": rng.randn(3, 4).astype(np.float32)}

    return build, feed


NETS = {
    "seqtoseq": (lambda nn, net: seqtoseq_trainer(nn, net, V=V, E=6, H=5,
                                                  D=4, A=3),
                 lambda rng: seqtoseq_feed(rng, 4, V, S)),
    "lstmemory_group": _group_net("lstmemory_group", False),
    "lstmemory_group_reverse": _group_net("lstmemory_group", True),
    "gru_group": _group_net("gru_group", False),
    "gru_group_reverse": _group_net("gru_group", True),
}


def both(name):
    build, feed = NETS[name]
    jnn.reset_naming()
    jc = build(jnn, jnet)
    tnn.reset_naming()
    tc = build(tnn, tnet)
    return jc, tc, feed


@pytest.mark.parametrize("name", sorted(NETS))
def test_group_net_loss_and_gradients_match_reference(name):
    jc, tc, feed_fn = both(name)
    jt, tt = jnn.Topology(jc), tnn.Topology(tc, device="cpu")
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    assert {k: s.shape for k, s in tt.param_specs.items()} \
        == {k: s.shape for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(4))
    jv, jg, tv, tg = loss_and_grads(jt, tt, jc.name, nonzero_params(jp),
                                    js, feed_fn(np.random.RandomState(0)))
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)
    assert all(np.abs(g).max() > 0 for k, g in tg.items()
               if not k.startswith("feed:")), "a parameter got no gradient"


@pytest.mark.parametrize("name", ["seqtoseq", "lstmemory_group"])
def test_group_net_trains_like_reference(name, tmp_path):
    """3 ``Adam`` steps through each package's ``SGDTrainer`` from the JAX
    trainer's initial checkpoint: the losses agree."""
    jc, tc, feed_fn = both(name)
    jtr = JaxTrainer(jc, jopt.Adam(learning_rate=4e-3), seed=0)
    jtr.save(str(tmp_path), 0)
    ttr = SGDTrainer(tc, topt.Adam(learning_rate=4e-3), seed=0,
                     device="cpu")
    ttr.load(str(tmp_path), 0)
    rng = np.random.RandomState(7)
    feeds = [feed_fn(rng) for _ in range(3)]
    jl = [float(jtr.train_batch(f)) for f in feeds]
    tl = [ttr.train_batch(f).item() for f in feeds]
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert int(ttr.opt_state["step"]) == 3


def _group_decoder(E, H2, A, D):
    """``tests/test_seq2seq_group_decoder.py``'s decoder on the port."""
    y = tnn.data("y_emb", size=E, is_seq=True)
    enc_l = tnn.data("enc", size=H2, is_seq=True)
    encp_l = tnn.data("enc_proj", size=A, is_seq=True)
    s0_l = tnn.data("s0", size=D)

    def step(y_t, enc_s, encp_s, s_mem):
        ctx = tnet.simple_attention(enc_s, encp_s, s_mem, name="att")
        m = tnn.mixed(3 * D, input=[tnn.full_matrix_projection(y_t),
                                    tnn.full_matrix_projection(ctx)],
                      bias_attr=True, name="dec_in")
        h = tnet.gru_unit(m, s_mem, size=D, gru_bias_attr=False,
                          name="dec_gru")
        return [h, h]

    return tnn.recurrent_group(
        step, input=[y, tnn.StaticInput(enc_l), tnn.StaticInput(encp_l)],
        memories=[tnn.Memory("s", D, boot=s0_l)], name="dec")


def test_group_decoder_gradients_match_the_fused_decoder():
    B, Sx, T = 3, 5, 4
    E, H2, A, D = 6, 8, 4, 5
    tnn.reset_naming()
    grp = _group_decoder(E, H2, A, D)
    topo = tnn.Topology(grp, device="cpu")
    params, _ = topo.init(1)
    params["_dec_in.wbias"] = 0.3 * torch.randn(
        3 * D, generator=torch.Generator().manual_seed(2))
    rs = np.random.RandomState(0)
    inputs = {"y_emb": rs.randn(B, T, E), "enc": rs.randn(B, Sx, H2),
              "enc_proj": rs.randn(B, Sx, A), "s0": rs.randn(B, D)}
    inputs = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
              for k, v in inputs.items()}
    src_len = torch.tensor([Sx, 3, 1])
    trg_len = torch.tensor([T, 2, 1])
    p = {k: v.requires_grad_() for k, v in params.items()}
    outs, _ = topo.apply(p, {}, {
        "y_emb": (inputs["y_emb"], trg_len), "enc": (inputs["enc"], src_len),
        "enc_proj": (inputs["enc_proj"], src_len), "s0": inputs["s0"]})
    got = outs["dec"].value
    w = torch.tensor(rs.randn(B, T, D), dtype=torch.float32)
    leaves = [*p.values(), *inputs.values()]
    g_group = torch.autograd.grad((got * w).sum(), leaves)

    src_mask = TO.mask_from_lengths(src_len, Sx)
    trg_mask = TO.mask_from_lengths(trg_len, T)
    p2 = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    in2 = {k: v.detach().clone().requires_grad_() for k, v in inputs.items()}
    want = attention_gru_decoder(
        in2["y_emb"], in2["s0"], in2["enc"], in2["enc_proj"], src_mask,
        trg_mask, p2["_att.w0"], p2["_att.v"],
        torch.cat([p2["_dec_in.w0"], p2["_dec_in.w1"]], 0),
        p2["_dec_in.wbias"], p2["_dec_gru.w0"])
    m = trg_mask[..., None]
    torch.testing.assert_close(got * m, want * m, rtol=RTOL, atol=ATOL)
    g_fused = torch.autograd.grad((want * w).sum(),
                                  [*p2.values(), *in2.values()])
    names = [*p, *(f"feed:{k}" for k in inputs)]
    assert_grads_close({k: g.double().numpy() for k, g in
                        zip(names, g_group)},
                       {k: g.double().numpy() for k, g in
                        zip(names, g_fused)}, RTOL, ATOL)
