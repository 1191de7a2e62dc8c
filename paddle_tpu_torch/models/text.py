"""Text-classification models — counterpart of ``paddle_tpu/models/text.py``,
built with the port's nn DSL:

- ``stacked_lstm_net``: demo/sentiment's stacked-LSTM classifier
  (embedding, fc + relu ``lstmemory`` blocks with alternating directions,
  max pools of the last fc and the last LSTM, fc softmax).  Its LSTMs run
  ``act="relu"``, the plain scan path in both packages, so no LSTM kernel
  launches for it;
- ``convolution_net``: the sequence-conv classifier (embedding,
  ``context_projection`` window, fc relu, max pool, fc softmax);
- ``lstm_benchmark_net``: the 2-layer LSTM config of the reference's
  published RNN benchmark (benchmark/paddle/rnn/rnn.py: embedding, stacked
  LSTM layers, max-pool over time, fc softmax).

``stacked_lstm_pp_net`` needs the pipeline tier: it is reached under its
name and raises ``ConfigError`` naming ROADMAP.md Queue 1 item 8.
"""

from __future__ import annotations

import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.utils.error import not_ported

__all__ = ["stacked_lstm_net", "stacked_lstm_pp_net", "convolution_net",
           "lstm_benchmark_net"]


def stacked_lstm_net(vocab_size: int, *, emb_dim: int = 128,
                     hid_dim: int = 512, stacked_num: int = 3,
                     num_classes: int = 2):
    """demo/sentiment's stacked LSTM net.  Returns (cost, logits)."""
    assert stacked_num % 2 == 1
    words = nn.data("words", size=vocab_size, is_seq=True, dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    emb = nn.embedding(words, emb_dim, name="emb")
    fc1 = nn.fc(emb, hid_dim, act="linear", name="fc0")
    lstm1 = nn.lstmemory(fc1, hid_dim, act="relu", name="lstm0")
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        f = nn.fc(inputs, hid_dim, act="linear", name=f"fc{i - 1}")
        lstm = nn.lstmemory(f, hid_dim, act="relu", reverse=(i % 2 == 0),
                            name=f"lstm{i - 1}")
        inputs = [f, lstm]
    fc_last = nn.pooling(inputs[0], pooling_type="max", name="fc_pool")
    lstm_last = nn.pooling(inputs[1], pooling_type="max", name="lstm_pool")
    logits = nn.fc([fc_last, lstm_last], num_classes, act="linear",
                   name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


def stacked_lstm_pp_net(vocab_size: int, **kwargs):
    """The pipeline-partitioned stacked LSTM: not ported (its stages need
    the pipeline tier)."""
    raise not_ported("stacked_lstm_pp_net (the pipeline tier)", 8)


def convolution_net(vocab_size: int, *, emb_dim: int = 128,
                    hid_dim: int = 256, context_len: int = 3,
                    num_classes: int = 2):
    """Sequence conv + max-pool text classifier.  Returns (cost,
    logits)."""
    words = nn.data("words", size=vocab_size, is_seq=True, dtype="int32")
    label = nn.data("label", size=1, dtype="int32")
    emb = nn.embedding(words, emb_dim, name="emb")
    ctx = nn.context_projection(emb, context_len=context_len, name="ctx")
    conv = nn.fc(ctx, hid_dim, act="relu", name="seq_conv")
    pool = nn.pooling(conv, pooling_type="max", name="pool")
    logits = nn.fc(pool, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


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
