"""The semantic-role-labeling nets of ``demo/semantic_role_labeling/
train.py:23-89`` (``srl_net``, the small bidirectional-GRU tagger, and
``db_lstm_net``, the reference's db_lstm), written once for either
package's layer DSL: ``tests/test_torch_text.py`` builds them with both,
``tests/test_torch_cuda.py`` with the port's on the card and on the CPU,
and ``chip_smoke.py`` with the port's at the demo's widths.  Imports
neither jax nor torch."""

#: the nine slots of ``conll05_features`` in row order
SRL_SLOTS = ("word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
             "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data",
             "target")


def srl_net(nn, vocab, n_labels, emb_dim, hid_dim):
    """The small bidirectional-GRU tagger -> (cost, decoded)."""
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    pred = nn.data("predicate", size=vocab, dtype="int32")
    w_emb = nn.embedding(words, emb_dim, vocab_size=vocab, name="w_emb")
    p_emb = nn.embedding(pred, emb_dim, vocab_size=vocab, name="p_emb")
    p_exp = nn.expand(p_emb, words, name="p_exp")
    merged = nn.concat([w_emb, p_exp], name="merged")
    h = nn.bidirectional_rnn(merged, hid_dim, cell="gru", name="enc")
    feat = nn.fc(h, n_labels, act="linear", name="feat")
    labels = nn.data("labels", size=n_labels, is_seq=True, dtype="int32")
    cost = nn.crf_cost(feat, labels, name="cost")
    decoded = nn.crf_decoding(feat, name="decoded")
    return cost, decoded


def db_lstm_net(nn, word_dict_len, label_dict_len, *, pred_len=None,
                mark_dict_len=2, word_dim=32, mark_dim=5, hidden_dim=128,
                depth=8):
    """The reference's db_lstm: eight embedded slots (a shared ``emb``
    table for the six word slots), ``hidden0`` a mixed layer of eight
    full-matrix projections, then ``depth`` LSTMs (relu cell, sigmoid
    state; hidden ``hidden_dim // 4``) alternating direction with direct
    mixed edges, a CRF cost and its Viterbi decode sharing the cost's
    weights -> (cost, decoded)."""
    pred_len = pred_len or word_dict_len
    word = nn.data("word_data", size=word_dict_len, is_seq=True,
                   dtype="int32")
    ctx_slots = [nn.data(f"ctx_{s}_data", size=word_dict_len, is_seq=True,
                         dtype="int32")
                 for s in ("n2", "n1", "0", "p1", "p2")]
    predicate = nn.data("verb_data", size=pred_len, is_seq=True,
                        dtype="int32")
    mark = nn.data("mark_data", size=mark_dict_len, is_seq=True,
                   dtype="int32")
    target = nn.data("target", size=label_dict_len, is_seq=True,
                     dtype="int32")

    emb_para = nn.ParamAttr(name="emb")
    emb_layers = [nn.embedding(x, word_dim, param_attr=emb_para)
                  for x in [word] + ctx_slots]
    emb_layers.append(nn.embedding(predicate, word_dim, name="vemb"))
    emb_layers.append(nn.embedding(mark, mark_dim, name="mark_emb"))

    hidden_0 = nn.mixed(
        hidden_dim,
        input=[nn.full_matrix_projection(e) for e in emb_layers],
        bias_attr=True, name="hidden0")
    lstm_0 = nn.lstmemory(hidden_0, projected_input=True, act="relu",
                          gate_act="sigmoid", state_act="sigmoid",
                          name="lstm0")

    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = nn.mixed(
            hidden_dim,
            input=[nn.full_matrix_projection(input_tmp[0]),
                   nn.full_matrix_projection(input_tmp[1])],
            bias_attr=True, name=f"hidden{i}")
        lstm = nn.lstmemory(mix_hidden, projected_input=True, act="relu",
                            gate_act="sigmoid", state_act="sigmoid",
                            reverse=(i % 2 == 1), name=f"lstm{i}")
        input_tmp = [mix_hidden, lstm]

    feature_out = nn.mixed(
        label_dict_len,
        input=[nn.full_matrix_projection(input_tmp[0]),
               nn.full_matrix_projection(input_tmp[1])],
        bias_attr=True, name="output")
    cost = nn.crf_cost(feature_out, target, name="cost")
    decoded = nn.crf_decoding(feature_out, name="crf_dec_l",
                              share_with="cost")
    return cost, decoded
