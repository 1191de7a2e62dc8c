"""CIFAR-10 image classification — the port's copy of
``demo/image_classification/train.py`` (VGG / ResNet configs, reference
demo/image_classification/vgg_16_cifar.py).

    python -m paddle_tpu_torch.demo.image_classification.train [--device cpu]
"""

import argparse

import paddle_tpu_torch.data as data
import paddle_tpu_torch.models as models
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.param.optimizers import Momentum
from paddle_tpu_torch.trainer import SGDTrainer, events


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["resnet", "vgg", "alexnet", "googlenet"],
                    default="resnet")
    ap.add_argument("--depth", type=int, default=20, help="resnet depth (6n+2)")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    nn.reset_naming()
    if args.model == "resnet":
        cost, logits = models.resnet_cifar(depth=args.depth)
    elif args.model == "alexnet":
        # the published-benchmark net at CIFAR scale (32px inputs upscale
        # poorly through the 11x11/4 stem, so demo at 67px synthetic)
        cost, logits = models.alexnet(num_classes=10, height=67, width=67)
    elif args.model == "googlenet":
        cost, logits = models.googlenet(num_classes=10)
    else:
        cost, logits = models.vgg_cifar()
    opt = Momentum(learning_rate=args.lr, momentum=0.9)
    opt.learning_rate_schedule = "poly"
    trainer = SGDTrainer(cost, opt, seed=0, device=args.device)
    feeder = data.DataFeeder({"pixel": "dense", "label": "int"})
    hw = {"alexnet": 67, "googlenet": 224}.get(args.model)
    if hw:
        # ImageNet-shape nets: synthetic data at the net's native resolution
        import numpy as np

        def imagenet_shape_reader():
            rng = np.random.RandomState(0)
            for _ in range(args.n):
                label = rng.randint(0, 10)
                img = rng.rand(hw, hw, 3).astype(np.float32) * 0.2
                img[:, :, label % 3] += 0.3 + 0.05 * label
                yield img, label

        base = imagenet_shape_reader
    else:
        base = data.datasets.cifar10("train", n=args.n)
    reader = data.shuffle(data.batch(base, args.batch_size), 8)

    def on_event(ev):
        if isinstance(ev, events.EndIteration) and ev.batch_id % 5 == 0:
            print(f"pass {ev.pass_id} batch {ev.batch_id} cost {ev.cost:.4f}")

    trainer.train(reader, num_passes=args.passes, event_handler=on_event,
                  feeder=feeder)


if __name__ == "__main__":
    main()
