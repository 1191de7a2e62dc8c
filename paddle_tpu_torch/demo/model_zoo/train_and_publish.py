"""Model-zoo publish flow — the port's copy of
``demo/model_zoo/train_and_publish.py`` (reference demo/model_zoo/resnet:
classify.py builds an ImageClassifier from a published train_conf +
model_dir and runs --job=classify / --job=extract).

The zoo artifact is a deploy bundle (config proto + trained parameters in
one file, ``config/deploy.py::merge_model``, the MergeModel analog): this
script trains a small CIFAR ResNet and publishes the bundle;
``classify.py`` consumes it with no model code.

    python -m paddle_tpu_torch.demo.model_zoo.train_and_publish \
        --out zoo.ptz [--device cpu]

Not ported here: ``--aot-out`` and ``--aot-hlo-out`` (the reference's
StableHLO and C-host exports, ROADMAP.md Queue 1 item 10) raise a
``ConfigError`` naming the item before anything is trained.
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.config import merge_model
from paddle_tpu_torch.demo.model_zoo import DEFAULT_BUNDLE
from paddle_tpu_torch.models import resnet_cifar
from paddle_tpu_torch.param.optimizers import Momentum
from paddle_tpu_torch.trainer import SGDTrainer, events
from paddle_tpu_torch.utils.error import not_ported


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--out", default=DEFAULT_BUNDLE)
    ap.add_argument("--aot-out", default="",
                    help="not ported: the reference's AOT artifact")
    ap.add_argument("--aot-hlo-out", default="",
                    help="not ported: the reference's C-host bundle")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for flag, given in (("--aot-out", args.aot_out),
                        ("--aot-hlo-out", args.aot_hlo_out)):
        if given:
            raise not_ported(f"model_zoo {flag}", 10)

    nn.reset_naming()
    cost, logits = resnet_cifar(depth=args.depth)
    trainer = SGDTrainer(cost, Momentum(learning_rate=0.05), seed=0,
                         device=args.device)
    feeder = data.DataFeeder({"pixel": "dense", "label": "int"})

    reader = data.batch(data.datasets.cifar10("train", n=args.n),
                        args.batch_size)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 4 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)
    merge_model(args.out, trainer.topology, trainer.params, trainer.state,
                name="zoo_resnet_cifar",
                meta={"task": "cifar10", "depth": args.depth,
                      "feature_layer": "gap"})  # pre-logits global avg pool
    print("published", args.out)


if __name__ == "__main__":
    main()
