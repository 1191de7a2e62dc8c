"""Linear regression introduction — the port's copy of
``demo/introduction/train.py`` (reference:
demo/introduction/trainer_config.py — one fc with named w/b regressing
y = 2x + 0.3; dataprovider.py emits the synthetic pairs).

    python -m paddle_tpu_torch.demo.introduction.train [--device cpu]
"""

import argparse

import numpy as np

import paddle_tpu_torch.data as data
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Momentum
from paddle_tpu_torch.trainer import SGDTrainer, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=12)
    ap.add_argument("--n", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    x = nn.data("x", size=1)
    y = nn.data("y", size=1)
    y_predict = nn.fc(x, 1, act="linear",
                      param_attr=nn.ParamAttr(name="w"),
                      bias_attr=nn.ParamAttr(name="b"), name="y_predict")
    cost = nn.mse_cost(y_predict, y, name="cost")

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(args.n):
            xv = rng.uniform(-1, 1)
            yield [xv], [2.0 * xv + 0.3]

    trainer = SGDTrainer(cost, Momentum(learning_rate=0.2), seed=0,
                         device=args.device)
    feeder = data.DataFeeder({"x": "dense", "y": "dense"})

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id == 0 \
                and ev.pass_id % 10 == 0:
            print(f"pass {ev.pass_id} cost {ev.cost:.5f}")

    trainer.train(data.batch(reader, args.batch_size),
                  num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)
    w = trainer.params["w"].reshape(-1)[0].item()
    b = trainer.params["b"].reshape(-1)[0].item()
    print(f"learned w={w:.3f} b={b:.3f} (target w=2.0 b=0.3)")


if __name__ == "__main__":
    main()
