"""Traffic speed forecasting — the port's copy of
``demo/traffic_prediction/train.py`` (reference:
demo/traffic_prediction/trainer_config.py): from 24 history terms of a
road link, forecast the congestion class (4 levels) at each of the next 24
five-minute horizons as a multi-task net — one shared-weight embedding fc
feeding 24 softmax heads, trained jointly on 24 classification costs (the
reference's outputs([cost_5min, ...])).

    python -m paddle_tpu_torch.demo.traffic_prediction.train [--device cpu]
"""

import argparse

import numpy as np

import paddle_tpu_torch.data as data
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import RMSProp
from paddle_tpu_torch.trainer import SGDTrainer, events

TERM_NUM = 24
FORECASTING_NUM = 24
EMB_SIZE = 16
N_LEVELS = 4  # congestion classes


def traffic_net(forecasting_num=FORECASTING_NUM):
    link_encode = nn.data("link_encode", size=TERM_NUM)
    costs, heads = [], []
    # each horizon's tower shares the link embedding weight (the
    # reference's ParamAttr(name='_link_vec.w'))
    link_param = nn.ParamAttr(name="_link_vec.w")
    for i in range(forecasting_num):
        link_vec = nn.fc(link_encode, EMB_SIZE, param_attr=link_param,
                         name=f"link_vec_{i}")
        score = nn.fc(link_vec, N_LEVELS, act="softmax", name=f"score_{i}")
        label = nn.data(f"label_{(i + 1) * 5}min", size=N_LEVELS,
                        dtype="int32")
        costs.append(nn.classification_cost(
            input=score, label=label, name=f"cost_{(i + 1) * 5}min"))
        heads.append(score)
    return costs, heads


def synth_reader(n, forecasting_num=FORECASTING_NUM):
    """History = noisy sinusoid per link; future class = quantized
    continuation, so every horizon is genuinely predictable."""

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(n):
            phase = rng.uniform(0, 2 * np.pi)
            freq = rng.uniform(0.1, 0.3)
            t = np.arange(TERM_NUM + forecasting_num)
            speed = np.sin(freq * t + phase) + rng.randn(len(t)) * 0.05
            hist = speed[:TERM_NUM].astype(np.float32)
            fut = speed[TERM_NUM:]
            labels = np.clip(((fut + 1) / 2 * N_LEVELS).astype(int), 0,
                             N_LEVELS - 1)
            yield (hist, *[int(l) for l in labels])

    return reader


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--horizons", type=int, default=FORECASTING_NUM)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    costs, _ = traffic_net(args.horizons)
    trainer = SGDTrainer(costs, RMSProp(learning_rate=1e-3), seed=0,
                         device=args.device)
    types = {"link_encode": "dense"}
    for i in range(args.horizons):
        types[f"label_{(i + 1) * 5}min"] = "int"
    feeder = data.DataFeeder(types)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 4 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} "
                  f"cost {ev.cost:.4f}")

    trainer.train(data.batch(synth_reader(args.n, args.horizons),
                             args.batch_size),
                  num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
