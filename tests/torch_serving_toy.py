"""The toy LM of ``tests/test_serving_slots.py`` on both packages, shared by
the port's serving tests: an EOS-prone GRU LM behind the slot protocol,
whose readout is ``LogitsReadout`` (K8; its plain version on the CPU).

``toy_params`` draws the reference's parameters as numpy arrays;
``ToyLM`` is the port's backend over them, ``jax_toy_lm`` the reference's
(its JAX imports happen inside, so the port's side imports no JAX).
"""

import numpy as np
import torch

from paddle_tpu_torch.ops import gru_step, linear
from paddle_tpu_torch.ops.decode import LogitsReadout
from paddle_tpu_torch.serving import SlotBackend

V, H, K = 12, 8, 3


def toy_params(rng, eos_boost=3.0):
    """The reference ToyLM's parameters as numpy arrays (same draws)."""
    return {
        "emb": 0.5 * rng.randn(V, H).astype(np.float32),
        "wx": 0.5 * rng.randn(H, 3 * H).astype(np.float32),
        "wh": 0.5 * rng.randn(H, 3 * H).astype(np.float32),
        "out": rng.randn(H, V).astype(np.float32),
        "outb": np.eye(1, V, 1)[0].astype(np.float32) * eos_boost,
    }


class ToyLM(SlotBackend):
    """``tests/test_serving_slots.py::ToyLM`` on the port: an EOS-prone GRU
    LM behind the slot protocol.  The per-request state is the GRU carry
    plus an EOS-logit bias read from the feed (``chaos.straggler_request``'s
    convention: -1e9 = never EOS)."""

    beam_size, vocab_size, bos, eos = K, V, 0, 1
    length_penalty = 0.0

    def __init__(self, rng=None, *, max_len=10, eos_boost=3.0, params=None):
        self.max_len = max_len
        p = params if params is not None else toy_params(rng, eos_boost)
        self.p = {k: torch.from_numpy(v) for k, v in p.items()}
        self.readout = LogitsReadout()

    def prefill(self, feed):
        return {"h": torch.as_tensor(np.asarray(feed["h"]),
                                     dtype=torch.float32),
                "bias": torch.as_tensor(np.asarray(feed["eos_bias"]),
                                        dtype=torch.float32)}

    def step_fn(self, tokens, state):
        e = self.p["emb"][tokens]
        h2 = gru_step(linear(e, self.p["wx"]), state["h"], self.p["wh"])
        logits = linear(h2, self.p["out"], self.p["outb"]).clone()
        logits[:, self.eos] += state["bias"][:, 0]
        return logits, dict(state, h=h2)

    def example_feed(self, rows=1):
        return {"h": np.zeros((rows, H), np.float32),
                "eos_bias": np.zeros((rows, 1), np.float32)}


def jax_toy_lm(params, max_len):
    """The reference's toy LM (tests/test_serving_slots.py::ToyLM) over the
    given numpy parameters."""
    import jax.numpy as jnp

    import paddle_tpu.ops as O
    from paddle_tpu.ops.decode import LogitsReadout as JaxLogitsReadout
    from paddle_tpu.serving import SlotBackend as JaxSlotBackend

    class JaxToyLM(JaxSlotBackend):
        beam_size, vocab_size, bos, eos = K, V, 0, 1
        length_penalty = 0.0
        use_kernel = None

        def __init__(self):
            self.max_len = max_len
            self.p = {k: jnp.asarray(v) for k, v in params.items()}
            self.readout = JaxLogitsReadout()

        def prefill(self, feed):
            return {"h": jnp.asarray(feed["h"], jnp.float32),
                    "bias": jnp.asarray(feed["eos_bias"], jnp.float32)}

        def step_fn(self, tokens, state):
            e = jnp.take(self.p["emb"], tokens, axis=0)
            h2 = O.gru_step(O.linear(e, self.p["wx"]), state["h"],
                            self.p["wh"])
            logits = O.linear(h2, self.p["out"], self.p["outb"])
            logits = logits.at[:, self.eos].add(state["bias"][:, 0])
            return logits, dict(state, h=h2)

        def example_feed(self, rows=1):
            return {"h": np.zeros((rows, H), np.float32),
                    "eos_bias": np.zeros((rows, 1), np.float32)}

    return JaxToyLM()
