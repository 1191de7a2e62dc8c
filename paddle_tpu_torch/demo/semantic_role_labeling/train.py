"""Semantic role labeling — the port's copy of
``demo/semantic_role_labeling/train.py``.

The default network is the reference's db_lstm
(demo/semantic_role_labeling/db_lstm.py:42-215): 8 input features (word,
5 predicate-context words, predicate, mark), one 'emb' table shared by the
six word slots, hidden0 = mixed of 8 full-matrix projections, then a
depth-8 stack of alternating-direction LSTMs (relu cell act, sigmoid state
act) with direct mixed edges, and a CRF cost + viterbi decode.
``--simple`` takes the small bidirectional-GRU tagger.

    python -m paddle_tpu_torch.demo.semantic_role_labeling.train [--device cpu]
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.trainer import SGDTrainer, events


def srl_net(vocab, n_labels, emb_dim, hid_dim):
    """Small bidirectional-GRU tagger (smoke shape)."""
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    pred = nn.data("predicate", size=vocab, dtype="int32")
    w_emb = nn.embedding(words, emb_dim, vocab_size=vocab, name="w_emb")
    p_emb = nn.embedding(pred, emb_dim, vocab_size=vocab, name="p_emb")
    p_exp = nn.expand(p_emb, words, name="p_exp")  # broadcast over timesteps
    merged = nn.concat([w_emb, p_exp], name="merged")
    h = nn.bidirectional_rnn(merged, hid_dim, cell="gru", name="enc")
    feat = nn.fc(h, n_labels, act="linear", name="feat")
    labels = nn.data("labels", size=n_labels, is_seq=True, dtype="int32")
    cost = nn.crf_cost(feat, labels, name="cost")
    decoded = nn.crf_decoding(feat, name="decoded")
    return cost, decoded


def db_lstm_net(word_dict_len, label_dict_len, *, pred_len=None,
                mark_dict_len=2, word_dim=32, mark_dim=5, hidden_dim=128,
                depth=8):
    """The reference db_lstm (db_lstm.py:42-215).  ``hidden_dim`` is the
    mixed/pre-projection width; LSTM hidden = hidden_dim//4, the reference's
    implicit lstmemory rule."""
    pred_len = pred_len or word_dict_len
    word = nn.data("word_data", size=word_dict_len, is_seq=True, dtype="int32")
    ctx_slots = [nn.data(f"ctx_{s}_data", size=word_dict_len, is_seq=True,
                         dtype="int32")
                 for s in ("n2", "n1", "0", "p1", "p2")]
    predicate = nn.data("verb_data", size=pred_len, is_seq=True, dtype="int32")
    mark = nn.data("mark_data", size=mark_dict_len, is_seq=True, dtype="int32")
    target = nn.data("target", size=label_dict_len, is_seq=True, dtype="int32")

    emb_para = nn.ParamAttr(name="emb")  # shared by the six word slots
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
                              share_with="cost")  # shared 'crfw' params
    return cost, decoded


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=800)
    ap.add_argument("--labels", type=int, default=19)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--hidden-dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--simple", action="store_true",
                    help="small bidirectional-GRU tagger instead of db_lstm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    if args.simple:
        cost, decoded = srl_net(args.vocab, args.labels, emb_dim=32,
                                hid_dim=32)
        feeder = data.DataFeeder(
            {"words": "ids_seq", "predicate": "int", "labels": "ids_seq"},
            max_len=48)

        def clamp(r):
            words, pred, labels = r
            return words, pred, [min(l, args.labels - 1) for l in labels]

        reader = data.batch(
            data.map_readers(clamp, data.datasets.conll05(
                "train", vocab_size=args.vocab, n_labels=args.labels,
                n=args.n)),
            args.batch_size)
    else:
        cost, decoded = db_lstm_net(args.vocab, args.labels,
                                    hidden_dim=args.hidden_dim,
                                    depth=args.depth)
        feeder = data.DataFeeder(
            {"word_data": "ids_seq", "ctx_n2_data": "ids_seq",
             "ctx_n1_data": "ids_seq", "ctx_0_data": "ids_seq",
             "ctx_p1_data": "ids_seq", "ctx_p2_data": "ids_seq",
             "verb_data": "ids_seq", "mark_data": "ids_seq",
             "target": "ids_seq"}, max_len=48)
        reader = data.batch(
            data.datasets.conll05_features(
                "train", vocab_size=args.vocab, n_labels=args.labels,
                n=args.n),
            args.batch_size)
    trainer = SGDTrainer(cost, Adam(learning_rate=2e-3), seed=0,
                         device=args.device)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 4 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
