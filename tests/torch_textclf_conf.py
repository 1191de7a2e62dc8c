"""Command-line config of the port for ``lstm_benchmark_net``:

    python -m paddle_tpu_torch --job=train --config=tests/torch_textclf_conf.py

The pattern of ``demo/mnist/conf.py``, built with the port's modules.  By
default it is ``bench.py``'s lstm_b64h256 row: vocab 30000, embedding 128,
2 LSTM layers of 256, batches of 64 from the synthetic imdb stream, padded
to T = 100, Adam at 1e-3.  The ``TORCH_TEXTCLF_<NAME>`` environment
variables shrink it (``VOCAB``, ``EMB``, ``HID``, ``BATCH``, ``T``, ``N``
samples a pass, ``TEST_N``), as the CPU tests do.  A helper, not a test
file.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import paddle_tpu_torch.data as data  # noqa: E402
import paddle_tpu_torch.nn as nn  # noqa: E402
from paddle_tpu_torch.models import lstm_benchmark_net  # noqa: E402
from paddle_tpu_torch.param import Adam  # noqa: E402


def _env(name: str, default: int) -> int:
    return int(os.environ.get(f"TORCH_TEXTCLF_{name}", default))


VOCAB, EMB, HID = _env("VOCAB", 30000), _env("EMB", 128), _env("HID", 256)
BATCH, T = _env("BATCH", 64), _env("T", 100)
N, TEST_N = _env("N", 64 * 20), _env("TEST_N", 64 * 2)


def get_config():
    nn.reset_naming()
    cost, _ = lstm_benchmark_net(VOCAB, emb_dim=EMB, hid_dim=HID,
                                 num_layers=2)
    return {
        "cost": cost,
        "optimizer": Adam(learning_rate=1e-3),
        "reader": data.batch(
            data.datasets.imdb("train", vocab_size=VOCAB, n=N), BATCH),
        "test_reader": data.batch(
            data.datasets.imdb("test", vocab_size=VOCAB, n=TEST_N), BATCH),
        "feeder": data.DataFeeder({"words": "ids_seq", "label": "int"},
                                  buckets=(T,), max_len=T),
    }
