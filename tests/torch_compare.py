"""Helpers of the port's CPU tests that hold the port against the JAX
package: an op on the same arrays (``close``, ``fwd_grad``), a net's one
training or inference apply from the same parameters and feed, its loss
and every gradient (parameters and float inputs), the shared dropout
mask and the shared draws of the sampling layers (``share_draws``).

``close`` holds a result at rtol 1e-5 and an absolute 1e-6 of the larger
of 1 and the reference's largest entry, the tolerance
``tests/test_rnn_fused.py`` pins."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.ops as JO

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.ops as TO


RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    want = np.asarray(want, np.float64)
    got = (got.detach().double().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()),
        err_msg=what)


def fwd_grad(jf, tf, *arrays, argnums=None, seed=0, **tol):
    """``jf``/``tf`` on the same arrays: outputs, and the vjp of a seeded
    cotangent with respect to each array in ``argnums`` (every float
    array by default)."""
    if argnums is None:
        argnums = tuple(i for i, a in enumerate(arrays)
                        if np.asarray(a).dtype.kind == "f")
    jargs = [jnp.asarray(a) for a in arrays]
    want, vjp = jax.vjp(lambda *a: jf(*a), *jargs)
    ct = np.asarray(np.random.RandomState(seed + 1).randn(*want.shape),
                    np.float32)
    jgrads = vjp(jnp.asarray(ct))
    targs = [torch.tensor(a, requires_grad=i in argnums)
             for i, a in enumerate(arrays)]
    got = tf(*targs)
    close(got, want, what="forward", **tol)
    tgrads = torch.autograd.grad(got, [targs[i] for i in argnums],
                                 torch.tensor(ct))
    for i, g in zip(argnums, tgrads):
        close(g, jgrads[i], what=f"gradient {i}", **tol)


def randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def shape_mask(shape, rate):
    """The dropout mask both packages share: a numpy draw seeded by the
    activation's shape."""
    rs = np.random.RandomState(zlib.crc32(repr(tuple(shape)).encode()))
    return rs.rand(*shape) >= rate


def share_dropout(monkeypatch):
    """Both packages' ``dropout`` (the name their layers call) on
    ``shape_mask``: inverted dropout, ``x / keep`` where kept."""

    def jax_dropout(rng, x, rate, *, train):
        if not train or rate <= 0.0:
            return x
        return jnp.where(jnp.asarray(shape_mask(x.shape, rate)),
                         x / (1.0 - rate), 0.0).astype(x.dtype)

    def torch_dropout(gen, x, rate, *, train):
        if not train or rate <= 0.0:
            return x
        keep = torch.from_numpy(shape_mask(tuple(x.shape), rate))
        return torch.where(keep.to(x.device), x / (1.0 - rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    monkeypatch.setattr(JO, "dropout", jax_dropout)
    monkeypatch.setattr(TO, "dropout", torch_dropout)


def shape_ints(shape, high):
    """The integer draws both packages share: uniform over [0, high), a
    numpy draw seeded by the shape and the range."""
    rs = np.random.RandomState(zlib.crc32(repr(("ints", tuple(shape),
                                                int(high))).encode()))
    return rs.randint(0, high, tuple(shape)).astype(np.int32)


def shape_gumbel(shape):
    """The Gumbel noise both packages' categorical draws share (seeded by
    the shape): ``argmax(logits + g)`` samples ``softmax(logits)``."""
    rs = np.random.RandomState(zlib.crc32(repr(("gumbel",
                                                tuple(shape))).encode()))
    u = np.clip(rs.rand(*shape), np.finfo(np.float32).tiny, 1.0)
    return (-np.log(-np.log(u))).astype(np.float32)


def share_draws(monkeypatch):
    """Both packages' random draws of the sampling layers on the same
    numbers: ``jax.random.randint`` / ``jax.random.categorical`` (which the
    JAX package's NCE and ``sampling_id`` call) and the port's
    ``uniform_classes`` / ``categorical`` on ``shape_ints`` and
    ``shape_gumbel``."""

    def jax_randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(minval + shape_ints(shape, maxval - minval),
                           dtype)

    def jax_categorical(key, logits, axis=-1, shape=None):
        return jnp.argmax(logits + jnp.asarray(shape_gumbel(logits.shape)),
                          axis=axis)

    def torch_uniform_classes(gen, shape, num_classes, device):
        return torch.from_numpy(shape_ints(shape, num_classes)).to(
            torch.long).to(device)

    def torch_categorical(gen, logits):
        g = torch.from_numpy(shape_gumbel(tuple(logits.shape)))
        return torch.argmax(logits.float() + g.to(logits.device), dim=-1)

    monkeypatch.setattr(jax.random, "randint", jax_randint)
    monkeypatch.setattr(jax.random, "categorical", jax_categorical)
    monkeypatch.setattr(TO, "uniform_classes", torch_uniform_classes)
    monkeypatch.setattr(TO, "categorical", torch_categorical)


def nonzero_params(jp, seed=5, scale=0.3):
    """The JAX parameters as numpy, with every all-zero parameter (biases,
    the CRF's transitions, peepholes) replaced by seeded normals."""
    rs = np.random.RandomState(seed)
    return {k: (scale * rs.randn(*v.shape)).astype(np.float32)
            if not np.any(np.asarray(v)) else np.asarray(v, np.float32)
            for k, v in jp.items()}


def float_feeds(feed):
    """The float leaves of a feed: {name: array} (a sequence feed's
    values)."""
    out = {}
    for k, v in feed.items():
        val = np.asarray(v[0] if isinstance(v, tuple) else v)
        if val.dtype == np.float32:
            out[k] = val
    return out


def with_leaves(feed, leaves):
    return {k: ((leaves[k], v[1]) if isinstance(v, tuple) else leaves[k])
            if k in leaves else v for k, v in feed.items()}


def loss_and_grads(jt, tt, out_name, jp, js, feed, *, train=True, rng=2,
                   weight=None):
    """One apply of the JAX topology ``jt`` and the port's ``tt`` (on the
    CPU) from the same parameters ``jp`` (numpy) and state: the loss (the
    layer ``out_name``'s value, or its sum weighted by ``weight``) and its
    gradient with respect to every parameter and every float input (keys
    ``feed:<name>``), as float64 numpy -> (jax loss, jax grads, port
    loss, port grads)."""
    xs = float_feeds(feed)

    def jloss(p, x):
        outs, _ = jt.apply(p, js, with_leaves(feed, x), train=train,
                           rng=jax.random.PRNGKey(rng))
        v = outs[out_name].value
        return v if weight is None else jnp.sum(v * jnp.asarray(weight))

    jv, (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()},
        {k: jnp.asarray(v) for k, v in xs.items()})
    jg = {**{k: np.asarray(v, np.float64) for k, v in gp.items()},
          **{f"feed:{k}": np.asarray(v, np.float64) for k, v in gx.items()}}
    tp = {k: v.requires_grad_() for k, v in
          tnn.params_from_jax(jp, "cpu").items()}
    tx = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in xs.items()}
    ts = tnn.params_from_jax({k: np.asarray(v) for k, v in js.items()},
                             "cpu")
    outs, _ = tt.apply(tp, ts, with_leaves(feed, tx), train=train, rng=rng)
    tv = outs[out_name].value
    if weight is not None:
        tv = (tv * torch.from_numpy(np.asarray(weight))).sum()
    keys = list(tp) + [f"feed:{k}" for k in tx]
    leaves = [*tp.values(), *tx.values()]
    grads = torch.autograd.grad(tv, leaves, allow_unused=True) \
        if leaves else []
    tg = {k: (np.zeros(jg[k].shape) if g is None else g.double().numpy())
          for k, g in zip(keys, grads)}
    return float(jv), jg, tv.item(), tg


def assert_grads_close(tg, jg, rtol, atol):
    """Each gradient's largest difference within ``rtol`` of its largest
    entry, or within ``atol`` (one that vanishes in exact arithmetic)."""
    assert set(tg) == set(jg)
    for k, g in tg.items():
        diff = np.abs(g - jg[k]).max() if g.size else 0.0
        bound = max(rtol * (np.abs(jg[k]).max() if g.size else 0.0), atol)
        assert diff <= bound, (k, diff, bound)
