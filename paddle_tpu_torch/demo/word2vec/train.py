"""N-gram word embeddings — the port's copy of ``demo/word2vec/train.py``
(imikolov n-gram LM with a hierarchical-sigmoid output, reference
demo/word2vec/train_v2.py).

    python -m paddle_tpu_torch.demo.word2vec.train [--device cpu]
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import AdaGrad
from paddle_tpu_torch.trainer import SGDTrainer, events


def ngram_net(vocab, emb_dim, hid_dim, ngram, output: str):
    ctx_layers = []
    emb_attr = nn.ParamAttr(name="word_emb")
    for i in range(ngram - 1):
        w = nn.data(f"w{i}", size=vocab, dtype="int32")
        ctx_layers.append(nn.embedding(w, emb_dim, param_attr=emb_attr))
    merged = nn.concat(ctx_layers, name="context")
    h = nn.fc(merged, hid_dim, act="tanh", name="hidden")
    nxt = nn.data("next_word", size=vocab, dtype="int32")
    if output == "hsigmoid":
        cost = nn.hsigmoid_cost(h, nxt, num_classes=vocab, name="cost")
    else:
        out = nn.fc(h, vocab, act="softmax", name="out")
        cost = nn.classification_cost(input=out, label=nxt, name="cost")
    return cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--emb-dim", type=int, default=32)
    ap.add_argument("--hid-dim", type=int, default=64)
    ap.add_argument("--ngram", type=int, default=5)
    ap.add_argument("--output", choices=["hsigmoid", "softmax"],
                    default="hsigmoid")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    cost = ngram_net(args.vocab, args.emb_dim, args.hid_dim, args.ngram,
                     args.output)
    trainer = SGDTrainer(cost, AdaGrad(learning_rate=0.1), seed=0,
                         device=args.device)
    spec = {f"w{i}": "int" for i in range(args.ngram - 1)}
    spec["next_word"] = "int"
    feeder = data.DataFeeder(spec)
    reader = data.batch(
        data.datasets.imikolov("train", vocab_size=args.vocab,
                               ngram=args.ngram, n=args.n), args.batch_size)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 4 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
