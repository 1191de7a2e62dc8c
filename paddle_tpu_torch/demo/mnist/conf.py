"""Command-line config of the mnist demo — the port's copy of
``demo/mnist/conf.py``:

    python -m paddle_tpu_torch --job=train \
        --config=paddle_tpu_torch/demo/mnist/conf.py [--device=cpu]

the trainer-config analog of the reference's demo/mnist configs driven by
paddle_trainer (TrainerMain.cpp:32-65).  ``MNIST_N`` and ``MNIST_BATCH``
size the synthetic stream."""

import os

import paddle_tpu_torch.data as data
import paddle_tpu_torch.models as models
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Adam

N = int(os.environ.get("MNIST_N", "512"))
BATCH = int(os.environ.get("MNIST_BATCH", "64"))


def get_config():
    nn.reset_naming()
    cost, logits = models.lenet5()
    return {
        "cost": cost,
        "optimizer": Adam(learning_rate=1e-3),
        "reader": data.shuffle(
            data.batch(data.datasets.mnist("train", n=N), BATCH), 10),
        # drop_last=False: the test split's ragged tail batch is evaluated
        # too
        "test_reader": data.batch(data.datasets.mnist("test", n=N // 4), BATCH,
                                  drop_last=False),
        "feeder": data.DataFeeder({"pixel": "dense", "label": "int"}),
    }
