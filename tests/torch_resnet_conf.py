"""Command-line config of the port for ``resnet_cifar``:

    python -m paddle_tpu_torch --job=train --config=tests/torch_resnet_conf.py

The pattern of ``demo/image_classification``, built with the port's
modules.  By default it is ``bench.py``'s resnet20_b256 row: ResNet-20 on
32x32x3 images, 10 classes, batches of 256 from the synthetic cifar10
stream, Momentum at 0.1.  The ``TORCH_RESNET_<NAME>`` environment
variables shrink it (``DEPTH``, ``BATCH``, ``N`` samples a pass,
``TEST_N``), as the CPU tests do.  A helper, not a test file.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import paddle_tpu_torch.data as data  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
from paddle_tpu_torch.models import resnet_cifar  # noqa: E402
from paddle_tpu_torch.param import Momentum  # noqa: E402


def _env(name: str, default: int) -> int:
    return int(os.environ.get(f"TORCH_RESNET_{name}", default))


DEPTH, BATCH = _env("DEPTH", 20), _env("BATCH", 256)
N, TEST_N = _env("N", 256 * 20), _env("TEST_N", 256 * 2)


def get_config():
    nn.reset_naming()
    cost, _ = resnet_cifar(depth=DEPTH)
    return {
        "cost": cost,
        "optimizer": Momentum(learning_rate=0.1),
        "reader": data.batch(data.datasets.cifar10("train", n=N), BATCH),
        "test_reader": data.batch(data.datasets.cifar10("test", n=TEST_N),
                                  BATCH),
        "feeder": data.DataFeeder({"pixel": "dense", "label": "int"}),
    }
