"""Text-classification quick start — the port's copy of
``demo/quick_start/train.py``: all seven reference configs (bag-of-words
LR, sparse LR, CNN, stacked LSTM, bidi-lstm, db-lstm, resnet-lstm —
reference demo/quick_start/trainer_config.*.py).

    python -m paddle_tpu_torch.demo.quick_start.train --config lr [--device cpu]
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.models as models
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.trainer import SGDTrainer, events

VOCAB = 1000


def bow_net(vocab):
    """Bag-of-words logistic regression (trainer_config.lr.py analog)."""
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, 64, vocab_size=vocab)
    bow = nn.pooling(emb, pooling_type="sum")
    out = nn.fc(bow, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    return nn.classification_cost(input=out, label=lbl), out


def sparse_lr_net(vocab):
    """LR straight over a sparse_binary_vector bag-of-words input — the
    reference's actual trainer_config.lr.py shape (fc over sparse input,
    no embedding): the fc computes by row gather (hl_sparse analog)."""
    words = nn.data("words", size=vocab, sparse="binary")
    out = nn.fc(words, 2, act="softmax", name="out",
                param_attr=nn.ParamAttr(name="lr_w", sparse_grad=True))
    lbl = nn.data("label", size=2, dtype="int32")
    return nn.classification_cost(input=out, label=lbl), out


def bidi_lstm_net(vocab, emb_dim=128, hid_dim=128):
    """trainer_config.bidi-lstm.py: emb -> bidirectional_lstm -> dropout 0.5
    -> softmax."""
    import paddle_tpu_torch.v2.networks as networks

    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, emb_dim, vocab_size=vocab)
    bi = networks.bidirectional_lstm(emb, hid_dim, name="bi_lstm")
    pooled = nn.pooling(bi, pooling_type="max")
    drop = nn.dropout(pooled, 0.5)
    out = nn.fc(drop, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    return nn.classification_cost(input=out, label=lbl), out


def db_lstm_text_net(vocab, emb_dim=128, hid_dim=128, depth=8):
    """trainer_config.db-lstm.py: emb -> mixed -> depth-8 alternating
    lstmemory stack with fc direct edges -> max pool -> softmax.  The
    lstmemory layers consume the 4H pre-projection (reference convention):
    hidden width hid_dim, LSTM width hid_dim//4."""
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, emb_dim, vocab_size=vocab)
    hidden_0 = nn.mixed(hid_dim, input=[nn.full_matrix_projection(emb)],
                        name="hidden0")
    lstm_0 = nn.lstmemory(hidden_0, projected_input=True, name="lstm0")
    input_layers = [hidden_0, lstm_0]
    lstm = lstm_0
    for i in range(1, depth):
        fc = nn.fc(input_layers, hid_dim, name=f"fc{i}")
        lstm = nn.lstmemory(fc, projected_input=True, reverse=(i % 2) == 1,
                            name=f"lstm{i}")
        input_layers = [fc, lstm]
    pooled = nn.pooling(lstm, pooling_type="max")
    out = nn.fc(pooled, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    return nn.classification_cost(input=out, label=lbl), out


def resnet_lstm_net(vocab, emb_dim=128, hid_dim=128, depth=3):
    """trainer_config.resnet-lstm.py: residual LSTM stack — each layer's
    input is addto(previous input, previous hidden state)."""
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, emb_dim, vocab_size=vocab)
    prev_input, prev_hidden = emb, nn.lstmemory(emb, hid_dim, name="lstm0")
    for i in range(depth):
        current = nn.addto([prev_input, prev_hidden], name=f"res{i}")
        hidden = nn.lstmemory(current, hid_dim, name=f"lstm{i + 1}")
        prev_input, prev_hidden = current, hidden
    pooled = nn.pooling(prev_hidden, pooling_type="max")
    out = nn.fc(pooled, 2, act="softmax", name="out")
    lbl = nn.data("label", size=2, dtype="int32")
    return nn.classification_cost(input=out, label=lbl), out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config",
                    choices=["lr", "lr_sparse", "cnn", "lstm", "bidi-lstm",
                             "db-lstm", "resnet-lstm"],
                    default="lr")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--hid-dim", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    if args.config == "lr":
        cost, _ = bow_net(VOCAB)
    elif args.config == "lr_sparse":
        cost, _ = sparse_lr_net(VOCAB)
    elif args.config == "cnn":
        cost, _ = models.convolution_net(VOCAB, emb_dim=32, hid_dim=32)
    elif args.config == "bidi-lstm":
        cost, _ = bidi_lstm_net(VOCAB, emb_dim=args.hid_dim,
                                hid_dim=args.hid_dim)
    elif args.config == "db-lstm":
        cost, _ = db_lstm_text_net(VOCAB, emb_dim=args.hid_dim,
                                   hid_dim=args.hid_dim)
    elif args.config == "resnet-lstm":
        cost, _ = resnet_lstm_net(VOCAB, emb_dim=args.hid_dim,
                                  hid_dim=args.hid_dim)
    else:
        cost, _ = models.stacked_lstm_net(VOCAB, emb_dim=32, hid_dim=32,
                                          stacked_num=3)
    trainer = SGDTrainer(cost, Adam(learning_rate=2e-3), seed=0,
                         device=args.device)
    words_kind = "sparse_ids" if args.config == "lr_sparse" else "ids_seq"
    feeder = data.DataFeeder({"words": words_kind, "label": "int"}, max_len=96)
    reader = data.batch(
        data.datasets.imdb("train", vocab_size=VOCAB, n=args.n), args.batch_size)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 5 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
