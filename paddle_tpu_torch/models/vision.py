"""Vision models — counterpart of ``paddle_tpu/models/vision.py``, built
from the port's layer DSL with the reference's layer names, so its
parameter dict carries across (``params_from_jax``).

- LeNet-5: demo/mnist;
- the CIFAR-quick "SmallNet": benchmark/paddle/image/smallnet_mnist_cifar.py;
- ResNet for CIFAR-10: demo/image_classification/api_v2_resnet.py;
- VGG for CIFAR-10: demo/image_classification/api_v2_vgg.py.

NHWC feeds throughout: ``pixel`` [B, H, W, C] floats and ``label`` [B, 1]
ints.  Each builder returns (cost, logits).
"""

from __future__ import annotations

from typing import Tuple

import paddle_tpu_torch.nn as nn

__all__ = ["lenet5", "smallnet", "resnet_cifar", "vgg_cifar"]


def lenet5(num_classes: int = 10) -> Tuple[nn.LayerOutput, nn.LayerOutput]:
    """LeNet-5 for 28x28x1."""
    img = nn.data("pixel", size=1, height=28, width=28)
    label = nn.data("label", size=1, dtype="int32")
    c1 = nn.img_conv(img, filter_size=5, num_filters=20, padding="VALID",
                     act="relu")
    p1 = nn.img_pool(c1, pool_size=2)
    c2 = nn.img_conv(p1, filter_size=5, num_filters=50, padding="VALID",
                     act="relu")
    p2 = nn.img_pool(c2, pool_size=2)
    f1 = nn.fc(p2, 500, act="relu")
    logits = nn.fc(f1, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


def smallnet(num_classes: int = 10, *, size: int = 32, channels: int = 3):
    """The benchmark's SmallNet (CIFAR-quick): 3 x (conv5, pool3 s2) + fc."""
    img = nn.data("pixel", size=channels, height=size, width=size)
    label = nn.data("label", size=1, dtype="int32")
    h = img
    for i, nf in enumerate((32, 32, 64)):
        h = nn.img_conv(h, filter_size=5, num_filters=nf, padding="SAME",
                        act="relu", name=f"conv{i}")
        h = nn.img_pool(h, pool_size=3, stride=2, padding="SAME",
                        name=f"pool{i}")
    f1 = nn.fc(h, 64, act="relu")
    logits = nn.fc(f1, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


def _conv_bn(ipt, nf, *, stride=1, act="relu", name=""):
    c = nn.img_conv(ipt, filter_size=3, num_filters=nf, stride=stride,
                    padding="SAME", act="linear", bias_attr=False,
                    name=f"{name}_conv")
    return nn.batch_norm(c, act=act, name=f"{name}_bn")


def _shortcut(ipt, nf, stride, name):
    if stride != 1 or ipt.size != nf:
        return nn.img_conv(ipt, filter_size=1, num_filters=nf, stride=stride,
                           padding="SAME", act="linear", bias_attr=False,
                           name=f"{name}_sc")
    return ipt


def _basic_block(ipt, nf, stride, name):
    b1 = _conv_bn(ipt, nf, stride=stride, act="relu", name=f"{name}_a")
    b2 = _conv_bn(b1, nf, stride=1, act="linear", name=f"{name}_b")
    sc = _shortcut(ipt, nf, stride, name)
    return nn.addto([b2, sc], act="relu", name=f"{name}_add")


def resnet_cifar(depth: int = 20, num_classes: int = 10):
    """ResNet-(6n+2) for CIFAR-10 (32x32x3): a conv-BN stem, three stages
    of n basic blocks (16, 32, 64 filters; the first block of stages 2 and
    3 strides 2, with a 1x1 conv shortcut), an 8x8 average pool, fc."""
    if (depth - 2) % 6:
        raise ValueError(f"resnet_cifar depth must be 6n+2, got {depth}")
    n = (depth - 2) // 6
    img = nn.data("pixel", size=3, height=32, width=32)
    label = nn.data("label", size=1, dtype="int32")
    h = _conv_bn(img, 16, name="stem")
    for gi, nf in enumerate((16, 32, 64)):
        for bi in range(n):
            stride = 2 if (gi > 0 and bi == 0) else 1
            h = _basic_block(h, nf, stride, name=f"g{gi}b{bi}")
    pool = nn.img_pool(h, pool_size=8, pool_type="avg", name="gap")
    logits = nn.fc(pool, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


def vgg_cifar(num_classes: int = 10):
    """VGG-16-style CIFAR net: five groups of BN'd 3x3 convs (64x2, 128x2,
    256x3, 512x3, 512x3), each closed by a 2x2 pool, then fc512, dropout,
    fc512, dropout, fc."""
    img = nn.data("pixel", size=3, height=32, width=32)
    label = nn.data("label", size=1, dtype="int32")
    h = img
    for gi, (nf, reps) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3),
                                     (512, 3))):
        for ri in range(reps):
            h = nn.img_conv(h, filter_size=3, num_filters=nf, padding="SAME",
                            act="linear", bias_attr=False,
                            name=f"vgg{gi}_{ri}")
            h = nn.batch_norm(h, act="relu", name=f"vgg{gi}_{ri}_bn")
        h = nn.img_pool(h, pool_size=2, name=f"vggpool{gi}")
    d1 = nn.dropout(h_flat_fc(h, 512, "fc1"), 0.5, name="drop1")
    d2 = nn.dropout(nn.fc(d1, 512, act="relu", name="fc2"), 0.5,
                    name="drop2")
    logits = nn.fc(d2, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


def h_flat_fc(h, size, name):
    return nn.fc(h, size, act="relu", name=name)
