"""AlexNet and GoogLeNet v1 — counterpart of
``paddle_tpu/models/image_bench.py``, the reference's published image
benchmarks (benchmark/paddle/image/alexnet.py: 227x227, conv11 s4 p1 ->
LRN -> pool3 s2 -> conv5 p2 (256) -> LRN -> pool -> 3 x conv3 -> pool ->
fc4096 x 2 with dropout 0.5 -> 1000 classes; benchmark/paddle/image/
googlenet.py: the GoogLeNet v1 stage table without the auxiliary heads).

NHWC convs with explicit integer padding; inception branches are
concatenated on the channel axis; the stride-2 pools use SAME padding,
which lands GoogLeNet's 112/56/28/14/7 stage table on a 7x7 map for the
final average pool.  Layer names, and with them parameter names, are the
reference's: the auto-generated ``__conv_N__`` names key checkpoints, so
the order in which convs are created is kept exactly.
"""

from __future__ import annotations

import paddle_tpu_torch.nn as nn

__all__ = ["alexnet", "googlenet"]


def alexnet(*, num_classes: int = 1000, height: int = 227, width: int = 227):
    """Returns (cost, logits).  Feed: pixel [B, H, W, 3] + label [B, 1]."""
    img = nn.data("pixel", size=3, height=height, width=width)
    label = nn.data("label", size=1, dtype="int32")

    net = nn.img_conv(img, filter_size=11, num_filters=96, stride=4,
                      padding=1)
    net = nn.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = nn.img_pool(net, pool_size=3, stride=2)

    net = nn.img_conv(net, filter_size=5, num_filters=256, stride=1,
                      padding=2)
    net = nn.img_cmrnorm(net, size=5, scale=0.0001, power=0.75)
    net = nn.img_pool(net, pool_size=3, stride=2)

    net = nn.img_conv(net, filter_size=3, num_filters=384, stride=1,
                      padding=1)
    net = nn.img_conv(net, filter_size=3, num_filters=384, stride=1,
                      padding=1)
    net = nn.img_conv(net, filter_size=3, num_filters=256, stride=1,
                      padding=1)
    net = nn.img_pool(net, pool_size=3, stride=2)

    net = nn.fc(net, 4096, act="relu")
    net = nn.dropout(net, 0.5)
    net = nn.fc(net, 4096, act="relu")
    net = nn.dropout(net, 0.5)
    logits = nn.fc(net, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits


def _inception(x, f1, f3r, f3, f5r, f5, proj, *, fused_reduce=False):
    """Inception v1 module.  ``fused_reduce`` merges the three 1x1 convs
    that read ``x`` (the b1 branch and the 3x3/5x5 reducers) into one conv
    of f1+f3r+f5r filters followed by channel slices: the same function
    (the merged kernel is the concat of the three) in one product."""
    if fused_reduce:
        red = nn.img_conv(x, filter_size=1, num_filters=f1 + f3r + f5r,
                          padding=0)
        b1 = nn.slice_channels(red, 0, f1)
        b3 = nn.img_conv(nn.slice_channels(red, f1, f1 + f3r),
                         filter_size=3, num_filters=f3, padding=1)
        b5 = nn.img_conv(nn.slice_channels(red, f1 + f3r, f1 + f3r + f5r),
                         filter_size=5, num_filters=f5, padding=2)
    else:
        # conv creation order (b1, r3, b3, r5, b5, bp) keys the
        # auto-generated parameter names, and with them checkpoints
        b1 = nn.img_conv(x, filter_size=1, num_filters=f1, padding=0)
        b3 = nn.img_conv(nn.img_conv(x, filter_size=1, num_filters=f3r,
                                     padding=0),
                         filter_size=3, num_filters=f3, padding=1)
        b5 = nn.img_conv(nn.img_conv(x, filter_size=1, num_filters=f5r,
                                     padding=0),
                         filter_size=5, num_filters=f5, padding=2)
    bp = nn.img_conv(nn.img_pool(x, pool_size=3, stride=1, padding=1),
                     filter_size=1, num_filters=proj, padding=0)
    return nn.concat([b1, b3, b5, bp])


def googlenet(*, num_classes: int = 1000, height: int = 224,
              width: int = 224, fused_reduce: bool = False):
    """GoogLeNet v1 without the auxiliary heads.  Returns (cost, logits).
    Feed: pixel [B, H, W, 3] + label [B, 1]."""
    img = nn.data("pixel", size=3, height=height, width=width)
    label = nn.data("label", size=1, dtype="int32")

    # the stem's relus run after their stride-2 max pools (the same
    # function, on a 4x smaller map; see img_pool's act=)
    net = nn.img_conv(img, filter_size=7, num_filters=64, stride=2,
                      padding=3, act="linear")
    net = nn.img_pool(net, pool_size=3, stride=2, padding="SAME",
                      act="relu")  # 56
    net = nn.img_conv(net, filter_size=1, num_filters=64, padding=0)
    net = nn.img_conv(net, filter_size=3, num_filters=192, padding=1,
                      act="linear")
    net = nn.img_pool(net, pool_size=3, stride=2, padding="SAME",
                      act="relu")  # 28

    fr = fused_reduce
    net = _inception(net, 64, 96, 128, 16, 32, 32, fused_reduce=fr)  # 3a
    net = _inception(net, 128, 128, 192, 32, 96, 64, fused_reduce=fr)  # 3b
    net = nn.img_pool(net, pool_size=3, stride=2, padding="SAME")  # 14

    net = _inception(net, 192, 96, 208, 16, 48, 64, fused_reduce=fr)  # 4a
    net = _inception(net, 160, 112, 224, 24, 64, 64, fused_reduce=fr)  # 4b
    net = _inception(net, 128, 128, 256, 24, 64, 64, fused_reduce=fr)  # 4c
    net = _inception(net, 112, 144, 288, 32, 64, 64, fused_reduce=fr)  # 4d
    net = _inception(net, 256, 160, 320, 32, 128, 128,
                     fused_reduce=fr)  # 4e -> 832
    net = nn.img_pool(net, pool_size=3, stride=2, padding="SAME")  # 7

    net = _inception(net, 256, 160, 320, 32, 128, 128,
                     fused_reduce=fr)  # 5a
    net = _inception(net, 384, 192, 384, 48, 128, 128,
                     fused_reduce=fr)  # 5b -> 1024
    net = nn.img_pool(net, pool_size=7, stride=7, pool_type="avg")

    logits = nn.fc(net, num_classes, act="linear", name="logits")
    cost = nn.classification_cost(logits, label, name="cost")
    return cost, logits
