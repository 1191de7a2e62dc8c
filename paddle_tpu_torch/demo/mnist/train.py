"""MNIST LeNet-5 — the port's copy of ``demo/mnist/train.py`` (LeNet on
MNIST, demo/mnist/mnist_provider.py + vgg_16_mnist.py style configs).

    python -m paddle_tpu_torch.demo.mnist.train [--device cpu]
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
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--n", type=int, default=1024, help="synthetic samples")
    ap.add_argument("--save-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    cost, logits = models.lenet5()
    trainer = SGDTrainer(cost, Adam(learning_rate=1e-3),
                         extra_outputs=[logits], seed=0, device=args.device)
    feeder = data.DataFeeder({"pixel": "dense", "label": "int"})
    train_reader = data.shuffle(
        data.batch(data.datasets.mnist("train", n=args.n), args.batch_size), 10)
    test_reader = data.batch(data.datasets.mnist("test", n=args.n // 4),
                             args.batch_size)

    def test_error() -> float:
        evaluator = ClassificationError()
        evaluator.start()
        for rows in test_reader():
            feed = feeder(rows)
            out = trainer.infer([logits], feed)
            evaluator.eval_batch(logits=out[logits.name],
                                 labels=np.asarray(feed["label"]))
        return evaluator.result()

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 10 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")
        if isinstance(ev, events.EndPass):
            print(f"== pass {ev.pass_id} test error {test_error():.3f} ==")
            if args.save_dir:
                trainer.save(args.save_dir, ev.pass_id)

    trainer.train(train_reader, num_passes=args.passes,
                  event_handler=on_event, feeder=feeder)


if __name__ == "__main__":
    main()
