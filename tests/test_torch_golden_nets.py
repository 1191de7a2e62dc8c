"""The reference's 23 canonical nets (``tests/golden_nets.py``) on the port
against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_golden_nets.py -q

The builders are ``tests/torch_golden_nets.py``, one copy for either
package's DSL.  For each of the 23 nets: the same layer names and
parameter specs, then the loss of one training apply and its gradient with
respect to every parameter and every float input against
``jax.value_and_grad`` over the JAX net (``tests/torch_compare.py``), from
the same parameters (``params_from_jax``) and the reference's feed
(``_cls_feed`` with ``RandomState(0)``).  Parameters the reference
initialises to zero (biases, the CRF's transitions, peepholes, NCE's and
the hierarchical sigmoid's tables' biases) are set to seeded normals
first, or the CRF's every path would tie.  Dropout and NCE's noise classes
draw other numbers in each package, so both packages' ``dropout`` run on
one numpy mask keyed by the activation's shape, and both packages' draws
on one numpy draw keyed by the shape (``share_draws``).

Tolerance: the loss at rtol 1e-5; each gradient by its largest difference
against its largest entry, 1e-5: float32 sums in another order (the CPU's
row products are chunked in the port, ``ops/matmul.py``).  A gradient that
vanishes in exact arithmetic (a conv bias ahead of a batch norm: ~1e-7 of
float32 noise) is held to 1e-6 absolute instead.
"""

import jax
import numpy as np
import pytest

import paddle_tpu.nn as jnn
import paddle_tpu.v2.networks as jnet

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.v2.networks as tnet
from paddle_tpu_torch.ops import compute_dtype_scope

import torch_golden_nets as G
from torch_compare import (assert_grads_close, loss_and_grads,
                           nonzero_params, share_draws, share_dropout)

RTOL_LOSS, TOL_GRAD, ATOL_GRAD = 1e-5, 1e-5, 1e-6
PORTED = sorted(G.GOLDEN_NETS)


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


@pytest.fixture
def shared_dropout(monkeypatch):
    share_dropout(monkeypatch)
    share_draws(monkeypatch)


def test_the_split_covers_the_reference_list():
    assert len(G.GOLDEN_NETS) == 23 and len(PORTED) == 23


@pytest.mark.parametrize("name", PORTED)
def test_golden_net_loss_and_gradients_match_reference(name,
                                                       shared_dropout):
    build = G.GOLDEN_NETS[name]
    jnn.reset_naming()
    jt, feed_fn = build(jnn, jnet)
    tnn.reset_naming()
    tt, _ = build(tnn, tnet, "cpu")
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    assert {k: (s.shape, s.is_state) for k, s in tt.param_specs.items()} \
        == {k: (s.shape, s.is_state) for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(3))
    feed = feed_fn(np.random.RandomState(0))
    cost = jt.outputs[0].name
    jv, jg, tv, tg = loss_and_grads(jt, tt, cost, nonzero_params(jp), js,
                                    feed)
    np.testing.assert_allclose(tv, jv, rtol=RTOL_LOSS)
    assert_grads_close(tg, jg, TOL_GRAD, ATOL_GRAD)
