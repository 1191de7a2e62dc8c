"""Sequence tagging (chunking) — the port's copy of
``demo/sequence_tagging/train.py`` (reference
demo/sequence_tagging/linear_crf.py: sliding-window context features ->
linear CRF).

    python -m paddle_tpu_torch.demo.sequence_tagging.train [--device cpu]
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.trainer import SGDTrainer, events


def linear_crf_net(vocab, n_labels, emb_dim, context_len):
    words = nn.data("words", size=0, is_seq=True, dtype="int32")
    emb = nn.embedding(words, emb_dim, vocab_size=vocab, name="emb")
    ctx = nn.context_projection(emb, context_len=context_len, name="ctx")
    feat = nn.fc(ctx, n_labels, act="linear", name="feat")
    labels = nn.data("labels", size=n_labels, is_seq=True, dtype="int32")
    cost = nn.crf_cost(feat, labels, name="cost")
    return cost, nn.crf_decoding(feat, name="decoded")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=500)
    ap.add_argument("--labels", type=int, default=9, help="BIO chunk labels")
    ap.add_argument("--context-len", type=int, default=5)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    cost, decoded = linear_crf_net(args.vocab, args.labels, emb_dim=32,
                                   context_len=args.context_len)
    trainer = SGDTrainer(cost, Adam(learning_rate=2e-3), seed=0,
                         device=args.device)
    feeder = data.DataFeeder({"words": "ids_seq", "labels": "ids_seq"},
                             max_len=48)

    def to_chunk(r):
        words, _, labels = r
        return words, [l % args.labels for l in labels]

    reader = data.batch(
        data.map_readers(to_chunk, data.datasets.conll05(
            "train", vocab_size=args.vocab, n=args.n)), args.batch_size)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 4 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
