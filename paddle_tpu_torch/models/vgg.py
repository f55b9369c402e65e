# ported from paddle_tpu/models/vgg.py
"""VGG-16 (reference: benchmark/fluid/models/vgg.py — conv groups with BN +
dropout, two FC heads). Built on fluid.nets.img_conv_group like the
reference."""

from __future__ import annotations

from .. import layers, nets


def vgg16(img, label, class_num: int = 1000):
    """img [N, 3, H, W], label [N, 1] int64 → (avg_loss, logits)."""

    def group(x, num, groups):
        return nets.img_conv_group(
            x, conv_num_filter=[num] * groups, pool_size=2, pool_stride=2,
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=0.0)

    c = group(img, 64, 2)
    c = group(c, 128, 2)
    c = group(c, 256, 3)
    c = group(c, 512, 3)
    c = group(c, 512, 3)

    d = layers.dropout(c, dropout_prob=0.5)
    fc1 = layers.fc(d, size=512, act=None)
    bn = layers.batch_norm(fc1, act="relu")
    d2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(d2, size=512, act=None)
    logits = layers.fc(fc2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return loss, logits
