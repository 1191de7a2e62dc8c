"""Nets and feeds over nested sequences, written once for either
package's layer DSL (each builder takes the package's ``nn``).
``tests/test_torch_nested_seq.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` build them.  Imports neither jax nor torch."""

import numpy as np


def hier_lstm_net(nn, vocab, emb_dim, hid_dim):
    """A two-level LSTM text classifier over nested ids ``words``: an outer
    ``recurrent_group`` over sentences whose step embeds the sentence,
    runs ``lstmemory`` over it, takes its ``last_seq`` and puts
    ``fc([sentence, outer memory], tanh)`` into the outer memory; then the
    document's ``last_seq`` -> a 2-way softmax ``fc`` ->
    ``classification_cost`` against ``label``.  -> (cost, the softmax
    output)."""
    words = nn.data("words", size=vocab, is_seq=True, dtype="int32",
                    nested=True)

    def sentence_step(frame, doc_mem):
        emb = nn.embedding(frame, emb_dim, vocab_size=vocab, name="emb")
        lstm = nn.lstmemory(emb, hid_dim, name="sent_lstm")
        sent = nn.last_seq(lstm, name="sent_last")
        doc = nn.fc([sent, doc_mem], hid_dim, act="tanh", name="doc_fc")
        return [doc, doc]

    docs = nn.recurrent_group(sentence_step, [words],
                              [nn.Memory("doc", hid_dim)], name="doc_group")
    last = nn.last_seq(docs, name="doc_last")
    prob = nn.fc(last, 2, act="softmax", name="prob")
    label = nn.data("label", size=1, dtype="int32")
    return nn.classification_cost(prob, label, name="cost"), prob


def nested_samples(samples, max_sentences, sentence_len):
    """Flat (ids, label) samples cut into documents of at most
    ``max_sentences`` sentences of at most ``sentence_len`` tokens:
    -> [([[ids], ...], label), ...]."""
    out = []
    for ids, label in samples:
        sents = [list(ids[i:i + sentence_len])
                 for i in range(0, len(ids), sentence_len)]
        out.append((sents[:max_sentences], label))
    return out


def flat_rnn_inputs(rng, B, To, Ti, D, empty_frame=False):
    """Seeded nested values [B, To, Ti, D] with outer and sub-sequence
    lengths (padded token slots zero), and the same tokens packed flat
    [B, T, D] with their lengths: -> (vals, outer_len, sub_lengths, flat,
    flat_len).  ``empty_frame`` gives every row an empty sub-sequence at
    the last outer step."""
    outer = rng.randint(max(1, To - 2), To + 1, B).astype(np.int32)
    outer[0] = To
    sub = np.zeros((B, To), np.int32)
    for b in range(B):
        sub[b, :outer[b]] = rng.randint(1, Ti + 1, outer[b])
    if empty_frame:
        sub[:, To - 1] = 0
        outer[:] = To
    vals = rng.randn(B, To, Ti, D).astype(np.float32)
    for b in range(B):
        for j in range(To):
            vals[b, j, sub[b, j]:] = 0.0
    flat_len = sub.sum(1).astype(np.int32)
    flat = np.zeros((B, max(int(flat_len.max()), 1), D), np.float32)
    for b in range(B):
        t = 0
        for j in range(outer[b]):
            n = sub[b, j]
            flat[b, t:t + n] = vals[b, j, :n]
            t += n
    return vals, outer, sub, flat, flat_len
