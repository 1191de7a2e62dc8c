"""IMDB sentiment stacked LSTM — the port's copy of
``demo/sentiment/train.py`` (reference demo/sentiment/trainer_config.py,
stacked bidirectional LSTM).

    python -m paddle_tpu_torch.demo.sentiment.train [--device cpu]
"""

import argparse

import numpy as np

import paddle_tpu_torch.data as data
import paddle_tpu_torch.models as models
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.evaluators import ClassificationError
from paddle_tpu_torch.param.optimizers import Adam
from paddle_tpu_torch.trainer import SGDTrainer, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--emb-dim", type=int, default=64)
    ap.add_argument("--hid-dim", type=int, default=64)
    ap.add_argument("--stacked-num", type=int, default=3)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    cost, logits = models.stacked_lstm_net(
        args.vocab, emb_dim=args.emb_dim, hid_dim=args.hid_dim,
        stacked_num=args.stacked_num)
    trainer = SGDTrainer(cost, Adam(learning_rate=2e-3),
                         extra_outputs=[logits], seed=0,
                         device=args.device)
    feeder = data.DataFeeder({"words": "ids_seq", "label": "int"}, max_len=128)
    reader = data.shuffle(data.batch(
        data.datasets.sentiment("train", vocab_size=args.vocab, n=args.n),
        args.batch_size), 8)
    test_reader = data.batch(
        data.datasets.sentiment("test", vocab_size=args.vocab, n=args.n // 4),
        args.batch_size)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 5 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")
        if isinstance(ev, events.EndPass):
            e = ClassificationError()
            e.start()
            for rows in test_reader():
                feed = feeder(rows)
                out = trainer.infer([logits], feed)
                e.eval_batch(logits=out[logits.name],
                             labels=np.asarray(feed["label"]))
            print(f"== pass {ev.pass_id} test error {e.result():.3f} ==")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
