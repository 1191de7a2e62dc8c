"""Every layer, projection, operator and cost of the port against the JAX
package's, one case each (``tests/torch_layer_cases.py``: the cases of
``tests/test_layer_grad_sweep.py`` the port can build, and the port's own
for the options that sweep does not reach), on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_layer_sweep.py -q

Each case is built with both packages from the same seeded feed; the
layer names and parameter specs must agree.  From the JAX net's
parameters (every all-zero one set to seeded normals, ``params_from_jax``)
one apply (``train=False``, as the reference sweep runs) gives the output,
and a fixed random weighting of it the loss, whose gradient with respect
to every parameter and every float input is held against
``jax.value_and_grad`` (``tests/torch_compare.py``).  Argmax, sampled
ids, EOS flags, Viterbi tags and the prior boxes (``FORWARD_ONLY``) are
held equal, element for element.  NCE's noise classes and
``sampling_id``'s draws come from one numpy draw in both packages
(``share_draws``).

Tolerance: the output and the loss at rtol 1e-5 / atol 1e-6, each
gradient by its largest difference against its largest entry, 1e-5 (or
1e-6 absolute where it vanishes): float32 sums taken in another order.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.ops import compute_dtype_scope

from torch_compare import (assert_grads_close, loss_and_grads,
                           nonzero_params, share_draws)
from torch_layer_cases import CASES, FORWARD_ONLY

RTOL, ATOL = 1e-5, 1e-6

#: public constructors that are not computable layers of their own
EXCLUDED = {"data", "reset_naming", "device_pin", "beam_search",
            "recurrent_group", "mixed"}


@pytest.fixture(autouse=True)
def _f32():
    with compute_dtype_scope("float32"):
        yield


def _constructors(nn):
    out = set()
    for n in dir(nn):
        f = getattr(nn, n)
        if n.startswith("_") or not inspect.isfunction(f):
            continue
        if "LayerOutput" in str(inspect.signature(f).return_annotation):
            out.add(n)
    return out


def test_every_ported_layer_has_a_case():
    """Every public layer constructor of the port (the not-ported stand-ins
    carry no annotation) is reached by a case or excluded; projections and
    operators are reached through ``mixed`` cases."""
    names = set(CASES) | {c.split("_", 1)[0] for c in CASES}
    missing = _constructors(tnn) - names - EXCLUDED - {
        "sequence_softmax"}
    missing = {m for m in missing if not any(c.startswith(m)
                                             for c in CASES)}
    assert not missing, sorted(missing)
    src = "\n".join(inspect.getsource(f) for f in CASES.values())
    import paddle_tpu_torch.nn.projections as P

    for proj in P.__all__:
        if proj[0].islower() and proj != "mixed":
            assert f"nn.{proj}(" in src, proj


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_reference(name, monkeypatch):
    share_draws(monkeypatch)
    jnn.reset_naming()
    jout, feed = CASES[name](jnn, np.random.RandomState(0))
    tnn.reset_naming()
    tout, _ = CASES[name](tnn, np.random.RandomState(0))
    jt, tt = jnn.Topology(jout), tnn.Topology(tout, device="cpu")
    assert tout.name == jout.name and tout.size == jout.size
    assert [l.name for l in tt.layers] == [l.name for l in jt.layers]
    assert {k: (s.shape, s.is_state) for k, s in tt.param_specs.items()} \
        == {k: (s.shape, s.is_state) for k, s in jt.param_specs.items()}
    jp, js = jt.init(jax.random.PRNGKey(7))
    jp = nonzero_params(jp)
    want = np.asarray(jt.apply(jp, js, feed)[0][jout.name].value)
    with torch.no_grad():
        got = tt.apply(tnn.params_from_jax(jp, "cpu"),
                       tnn.params_from_jax(js, "cpu"),
                       feed)[0][tout.name].value.numpy()
    assert got.shape == want.shape
    if name in FORWARD_ONLY:
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))
    w = np.asarray(np.random.RandomState(11).randn(*want.shape),
                   np.float32)
    _, jg, tv, tg = loss_and_grads(jt, tt, jout.name, jp, js, feed,
                                   train=False, weight=w)
    # the loss against the exact sum of the reference's own output: its f32
    # sum may cancel by a factor of thousands, and the reference's
    # reduction order (hence its rounding) depends on the XLA CPU build
    exact = float(np.sum(want.astype(np.float64) * w.astype(np.float64)))
    np.testing.assert_allclose(tv, exact, rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL)
