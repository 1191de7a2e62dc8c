"""The port's image models, ``v2.networks`` image helpers and ``SGDTrainer``
on them, against the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_image_bench.py -q

Each model's loss, every gradient and the new batch-norm state are held
against ``jax.value_and_grad`` over the reference ``Topology`` from the same
parameters (``params_from_jax``) and feed; resnet at depth 8 and AlexNet
at 67x67, as the reference's own tests size them
(``tests/test_models.py``).  Dropout draws other numbers in each package,
so AlexNet's and VGG's checks run both packages' ``dropout`` on one numpy
mask, keyed by the activation's shape (monkeypatched in this process
only).

Tolerances: the loss at rtol 1e-5; each gradient by its largest
difference against its largest entry (``TOL_GRAD``), set from how far each
package's float32 gradients lie from a float64 computation of the same net
on the CPU (the port's, run in float64): 1e-4 where both are within 2e-5
(lenet5, smallnet, resnet at depth 8, alexnet); 2e-4 for VGG (the
reference 4.9e-5, the port 1.6e-5: its last batch norms see 8 samples
each, which amplifies rounding); GoogLeNet's gradients are ill-conditioned
at random init, through 57 layers: 3e-2 without ``fused_reduce`` (the
reference 1.2e-2, the port 7.7e-4) and 5e-3 with it (the reference
8.3e-4, the port 1.1e-3).  New running stats at rtol 1e-5 / atol 1e-6.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.models as jmodels
import paddle_tpu.nn as jnn
import paddle_tpu.ops as JO
import paddle_tpu.v2.networks as jnet
from paddle_tpu.param import optimizers as jopt
from paddle_tpu.trainer import SGDTrainer as JaxTrainer
from paddle_tpu.utils.flags import FLAGS as JFLAGS

import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.models as tmodels
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO
import paddle_tpu_torch.v2.networks as tnet
from paddle_tpu_torch.models.image_bench import _inception
from paddle_tpu_torch.ops import compute_dtype_scope
from paddle_tpu_torch.param import optimizers as topt
from paddle_tpu_torch.trainer import SGDTrainer
from paddle_tpu_torch.utils.flags import FLAGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_LOSS = 1e-5
TOL_GRAD = {"vgg_cifar": 2e-4, "googlenet": 3e-2, "googlenet_fused": 5e-3}


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    for flags in (FLAGS, JFLAGS):
        monkeypatch.setattr(flags, "log_period", 0)
        monkeypatch.setattr(flags, "save_dir", "")
        monkeypatch.setattr(flags, "test_period", 0)
    with compute_dtype_scope("float32"):
        yield


def shape_mask(shape, rate):
    """The dropout mask both packages share in these tests: a numpy draw
    seeded by the activation's shape."""
    rs = np.random.RandomState(zlib.crc32(repr(tuple(shape)).encode()))
    return rs.rand(*shape) >= rate


@pytest.fixture
def shared_dropout(monkeypatch):
    """Both packages' ``dropout`` (the name their layers call) on
    ``shape_mask``: inverted dropout, ``x / keep`` where kept."""

    def jax_dropout(rng, x, rate, *, train):
        if not train or rate <= 0.0:
            return x
        m = jnp.asarray(shape_mask(x.shape, rate))
        return jnp.where(m, x / (1.0 - rate), 0.0).astype(x.dtype)

    def torch_dropout(gen, x, rate, *, train):
        if not train or rate <= 0.0:
            return x
        m = torch.from_numpy(shape_mask(tuple(x.shape), rate)).to(x.device)
        return torch.where(m, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(JO, "dropout", jax_dropout)
    monkeypatch.setattr(TO, "dropout", torch_dropout)


#: name -> (builder over a models module, feed shape)
MODELS = {
    "lenet5": (lambda m: m.lenet5(), (4, 28, 28, 1)),
    "smallnet": (lambda m: m.smallnet(), (3, 32, 32, 3)),
    "resnet_cifar": (lambda m: m.resnet_cifar(depth=8), (4, 32, 32, 3)),
    "vgg_cifar": (lambda m: m.vgg_cifar(), (2, 32, 32, 3)),
    "alexnet": (lambda m: m.alexnet(num_classes=10, height=67, width=67),
                (2, 67, 67, 3)),
    "googlenet": (lambda m: m.googlenet(num_classes=10), (2, 224, 224, 3)),
    "googlenet_fused": (lambda m: m.googlenet(num_classes=10,
                                              fused_reduce=True),
                        (2, 224, 224, 3)),
}


def both(name):
    """(JAX cost, logits, Topology), (the port's) for ``MODELS[name]``."""
    build, _ = MODELS[name]
    jnn.reset_naming()
    jc, jl = build(jmodels)
    tnn.reset_naming()
    tc, tl = build(tmodels)
    return ((jc, jl, jnn.Topology([jc, jl])),
            (tc, tl, tnn.Topology([tc, tl], device="cpu")))


def feed_for(name, seed=0):
    B, H, W, C = MODELS[name][1]
    rs = np.random.RandomState(seed)
    return {"pixel": rs.rand(B, H, W, C).astype(np.float32),
            "label": rs.randint(0, 10, (B, 1)).astype(np.int32)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_loss_gradients_and_state_match_reference(name,
                                                        shared_dropout):
    (jc, jl, jt), (tc, tl, tt) = both(name)
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    assert {k: (s.shape, s.is_state) for k, s in tt.param_specs.items()} \
        == {k: (s.shape, s.is_state) for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(1))
    feed = feed_for(name)

    def jloss(p):
        outs, ns = jt.apply(p, js, feed, train=True,
                            rng=jax.random.PRNGKey(2))
        return outs[jc.name].value, ns

    (jv, jns), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_() for k, v in tnn.params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu").items()}
    ts = tnn.params_from_jax({k: np.asarray(v) for k, v in js.items()},
                             "cpu")
    outs, tns = tt.apply(tp, ts, feed, train=True, rng=2)
    tv = outs[tc.name].value
    tg = dict(zip(tp, torch.autograd.grad(tv, list(tp.values()))))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL_LOSS)
    tol = TOL_GRAD.get(name, 1e-4)
    for k, g in tg.items():
        want = np.asarray(jg[k], np.float64)
        diff = np.abs(g.double().numpy() - want).max()
        assert diff <= tol * max(np.abs(want).max(), 1e-12), (k, diff)
    assert set(tns) == set(jns)
    for k in jns:
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not tns[k].requires_grad
    if js:
        assert any(not torch.equal(tns[k], ts[k]) for k in js)


def test_googlenet_pools_to_one_by_one_before_the_fc():
    """The stage table lands on 7x7, then 1x1, before the logits fc (a 0x0
    map would make the logits the bias alone)."""
    tnn.reset_naming()
    _, logits = tmodels.googlenet(num_classes=10)
    assert logits.parents[0].meta.get("hw") == (1, 1)
    tnn.reset_naming()
    cost, logits = tmodels.googlenet(num_classes=10, fused_reduce=True)
    topo = tnn.Topology([cost, logits], device="cpu")
    params, state = topo.init(0)
    rs = np.random.RandomState(0)
    feed = {"pixel": rs.rand(1, 224, 224, 3).astype(np.float32),
            "label": np.zeros((1, 1), np.int32)}
    with torch.no_grad():
        a = topo.apply(params, state, feed)[0][logits.name].value
        feed["pixel"] = rs.rand(1, 224, 224, 3).astype(np.float32)
        b = topo.apply(params, state, feed)[0][logits.name].value
    assert a.shape == (1, 10) and (a - b).abs().max() > 1e-6


def test_inception_fused_reduce_computes_the_same_function():
    """``fused_reduce`` merges the three 1x1 convs that read the input
    into one: with the merged kernel and bias the concat of the three,
    the module's output is the same (pins the slice offsets)."""
    spec = (4, 3, 5, 2, 3, 3)  # f1, f3r, f3, f5r, f5, proj

    def build(fused):
        tnn.reset_naming()
        x = tnn.data("x", size=6, height=5, width=5)
        out = _inception(x, *spec, fused_reduce=fused)
        return out, tnn.Topology(out, device="cpu")

    plain, tp = build(False)
    fused, tf = build(True)
    params, _ = tp.init(3)
    # plain: conv0 b1, conv1 r3, conv2 b3, conv3 r5, conv4 b5, conv5 bp;
    # fused: conv0 merged (b1|r3|r5), conv1 b3, conv2 b5, conv3 bp
    p = lambda i, s: params[f"___conv_{i}__.{s}"]
    fparams = {
        "___conv_0__.w0": torch.cat([p(0, "w0"), p(1, "w0"), p(3, "w0")],
                                    -1),
        "___conv_0__.wbias": torch.cat([p(0, "wbias"), p(1, "wbias"),
                                        p(3, "wbias")]),
        "___conv_1__.w0": p(2, "w0"), "___conv_1__.wbias": p(2, "wbias"),
        "___conv_2__.w0": p(4, "w0"), "___conv_2__.wbias": p(4, "wbias"),
        "___conv_3__.w0": p(5, "w0"), "___conv_3__.wbias": p(5, "wbias")}
    assert set(fparams) == set(tf.param_specs)
    x = np.random.RandomState(4).randn(2, 5, 5, 6).astype(np.float32)
    a = tp.apply(params, {}, {"x": x})[0][plain.name].value
    b = tf.apply(fparams, {}, {"x": x})[0][fused.name].value
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# v2.networks image helpers
# ---------------------------------------------------------------------------

NETS = {
    "simple_img_conv_pool": lambda n, nn, img: n.simple_img_conv_pool(
        img, 3, 4, 2, pool_stride=2),
    "img_conv_bn_pool": lambda n, nn, img: n.img_conv_bn_pool(
        img, 3, 4, 3, conv_padding=1, pool_stride=2, pool_padding=1,
        pool_type="avg", name="cbp"),
    "img_conv_group": lambda n, nn, img: n.img_conv_group(
        img, [4, 6], conv_batchnorm=True, conv_batchnorm_drop_rate=[0.3, 0],
        pool_size=2, pool_stride=2),
    "small_vgg": lambda n, nn, img: n.small_vgg(img, num_classes=5),
    "vgg_16_network": lambda n, nn, img: n.vgg_16_network(img,
                                                          num_classes=5),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_image_network_helper_matches_reference(name, shared_dropout):
    """Layer and parameter names and shapes, the output's spatial dims, and
    the outputs and new state of one training apply (the shared dropout
    masks)."""
    outs = []
    for n, nn, make in ((jnet, jnn, lambda o: jnn.Topology(o)),
                        (tnet, tnn, lambda o: tnn.Topology(o,
                                                           device="cpu"))):
        nn.reset_naming()
        img = nn.data("pixel", size=3, height=32, width=32)
        out = NETS[name](n, nn, img)
        outs.append((out, make(out)))
    (jo, jt), (to, tt) = outs
    assert (to.name, to.size, to.meta.get("hw")) == \
        (jo.name, jo.size, jo.meta.get("hw"))
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    assert {k: s.shape for k, s in tt.param_specs.items()} == \
        {k: s.shape for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(0))
    feed = {"pixel": np.random.RandomState(1).rand(2, 32, 32, 3).astype(
        np.float32)}
    jouts, jns = jt.apply(jp, js, feed, train=True,
                          rng=jax.random.PRNGKey(0))
    touts, tns = tt.apply(
        tnn.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            "cpu"),
        tnn.params_from_jax({k: np.asarray(v) for k, v in js.items()},
                            "cpu"), feed, train=True)
    want = np.asarray(jouts[jo.name].value)
    np.testing.assert_allclose(touts[to.name].value.detach().numpy(), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())
    for k in jns:
        np.testing.assert_allclose(tns[k].numpy(), np.asarray(jns[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# SGDTrainer + Momentum on resnet_cifar(depth=8)
# ---------------------------------------------------------------------------

B = 8


def resnet(nn, models):
    nn.reset_naming()
    return models.resnet_cifar(depth=8)[0]


def cifar_batches(data, n=3 * B):
    feeder = data.DataFeeder({"pixel": "dense", "label": "int"})
    return data.batch(data.datasets.cifar10("train", n=n), B), feeder


#: the trainer comparison on the cifar10 stream: each step's loss (rel),
#: and each array's norm of difference over its norm, by checkpoint file.
#: The first loss is one forward from the same weights.  After it the
#: reference's own float32 error dominates: on this stream its gradients
#: lie ~1e-3 of their largest entry from a float64 computation (the
#: port's ~3e-6; measured on the CPU, resnet depth 8 at seeds 0 and 5),
#: and each Momentum(0.1) step through batch norms over 8 samples
#: amplifies the difference (measured: losses 2e-7, 4.5e-5, 9.9e-4;
#: arrays 3.1e-2, 6.6e-2, 6.7e-3)
RTOL_TRAIN_LOSS = (1e-5, 2e-4, 3e-3)
TOL_TRAIN_STATE = {"params.npz": 0.1, "opt_state.npz": 0.2,
                   "state.npz": 0.03}


def test_trainer_momentum_resnet_matches_reference(tmp_path):
    """Three ``train_batch`` steps of ``Momentum(0.1)`` from the JAX
    trainer's initial checkpoint: the losses, and every parameter,
    momentum slot and batch-norm running stat after them (the same keys,
    shapes and dtypes; values within ``TOL_TRAIN_STATE``)."""
    import paddle_tpu.data as jdata

    jtr = JaxTrainer(resnet(jnn, jmodels), jopt.Momentum(learning_rate=0.1),
                     seed=3)
    jtr.save(str(tmp_path / "init"), 0)
    ttr = SGDTrainer(resnet(tnn, tmodels),
                     topt.Momentum(learning_rate=0.1), seed=3, device="cpu")
    ttr.load(str(tmp_path / "init"), 0)
    jreader, jfeeder = cifar_batches(jdata)
    treader, tfeeder = cifar_batches(tdata)
    for rtol, jb, tb in zip(RTOL_TRAIN_LOSS, jreader(), treader()):
        want = float(jtr.train_batch(jfeeder(jb)))
        got = ttr.train_batch(tfeeder(tb)).item()
        np.testing.assert_allclose(got, want, rtol=rtol)
    jtr.save(str(tmp_path / "jax"), 3)
    ttr.save(str(tmp_path / "torch"), 3)
    for fname, tol in TOL_TRAIN_STATE.items():
        got = np.load(tmp_path / "torch" / "pass-00003" / fname)
        want = np.load(tmp_path / "jax" / "pass-00003" / fname)
        assert sorted(got.files) == sorted(want.files), fname
        for k in want.files:
            assert (got[k].dtype, got[k].shape) == \
                (want[k].dtype, want[k].shape), (fname, k)
            diff = np.linalg.norm(got[k].astype(np.float64) - want[k])
            assert diff <= tol * max(np.linalg.norm(want[k]), 1e-6), \
                (fname, k, diff)
    state = np.load(tmp_path / "torch" / "pass-00003" / "state.npz")
    assert any("moving_mean" in k for k in state.files)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_resnet_checkpoint_resumes_across_packages(direction, tmp_path):
    """A checkpoint written by one package after two steps, batch-norm
    state included, is loaded by the other, whose next step gives the
    writer's next loss and running stats."""
    import paddle_tpu.data as jdata

    jtr = JaxTrainer(resnet(jnn, jmodels), jopt.Momentum(learning_rate=0.1),
                     seed=4)
    jtr.save(str(tmp_path / "init"), 0)
    ttr = SGDTrainer(resnet(tnn, tmodels),
                     topt.Momentum(learning_rate=0.1), seed=4, device="cpu")
    ttr.load(str(tmp_path / "init"), 0)
    jreader, jfeeder = cifar_batches(jdata)
    treader, tfeeder = cifar_batches(tdata)
    jb, tb = list(jreader()), list(treader())
    writer, reader_ = ((jtr, ttr) if direction == "jax_to_torch"
                       else (ttr, jtr))
    wfeed = jfeeder if writer is jtr else tfeeder
    wbatches = jb if writer is jtr else tb
    for batch in wbatches[:2]:
        writer.train_batch(wfeed(batch))
    writer.save(str(tmp_path / "mid"), 1)
    reader_.load(str(tmp_path / "mid"), 1)
    rfeed = jfeeder if reader_ is jtr else tfeeder
    rbatches = jb if reader_ is jtr else tb
    want = float(writer.train_batch(wfeed(wbatches[2])))
    got = float(reader_.train_batch(rfeed(rbatches[2])))
    np.testing.assert_allclose(got, want, rtol=RTOL_LOSS)
    for k, v in writer.state.items():
        np.testing.assert_allclose(np.asarray(reader_.state[k]),
                                   np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_real_mnist_fixture_lenet_converges():
    """The port's counterpart of tests/test_convergence.py's: LeNet-5 on
    1000 real MNIST digits (the fixture, shuffled with the same seed), 8
    epochs of Adam(1e-3) at B = 100 -> at least 0.90 on the held-out
    227."""
    data = np.load(os.path.join(ROOT, "tests", "fixtures",
                                "mnist_real.npz"))
    imgs = data["images"].astype(np.float32)[..., None] / 255.0
    labs = data["labels"].astype(np.int32)
    order = np.random.RandomState(42).permutation(len(imgs))
    imgs, labs = imgs[order], labs[order]
    train_x, train_y = imgs[:1000], labs[:1000]
    test_x, test_y = imgs[1000:], labs[1000:]
    tnn.reset_naming()
    cost, logits = tmodels.lenet5()
    tr = SGDTrainer(cost, topt.Adam(learning_rate=1e-3), seed=0,
                    device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(8):
        perm = rng.permutation(len(train_x))
        for i in range(0, len(train_x), 100):
            sel = perm[i:i + 100]
            tr.train_batch({"pixel": train_x[sel],
                            "label": train_y[sel][:, None]})
    out = tr.infer([logits], {"pixel": test_x})["logits"]
    acc = float((np.argmax(np.asarray(out), -1) == test_y).mean())
    assert acc >= 0.90, f"LeNet held-out accuracy {acc:.4f} < 0.90"
