"""Text-classification models — counterpart of ``paddle_tpu/models/text.py``
for ``lstm_benchmark_net``: the 2-layer LSTM config of the reference's
published RNN benchmark (benchmark/paddle/rnn/rnn.py: embedding, stacked
LSTM layers, max-pool over time, fc softmax), built with the port's nn DSL.

``stacked_lstm_net`` and ``convolution_net`` are not ported yet: their
non-default activations and ``context_projection`` need more layers.
"""

from __future__ import annotations

import paddle_tpu_torch.nn as nn

__all__ = ["lstm_benchmark_net"]


def lstm_benchmark_net(vocab_size: int = 30000, *, emb_dim: int = 128,
                       hid_dim: int = 256, num_layers: int = 2,
                       num_classes: int = 2):
    """The benchmark RNN config: embedding, ``num_layers`` stacked LSTM
    layers, max-pool, softmax.  Returns (cost, logits) layer outputs."""
    words = nn.data("words", size=vocab_size, is_seq=True, dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    h = nn.embedding(words, emb_dim, name="emb")
    for i in range(num_layers):
        h = nn.lstmemory(h, hid_dim, name=f"lstm{i}")
    pool = nn.pooling(h, pooling_type="max", name="pool")
    logits = nn.fc(pool, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits
