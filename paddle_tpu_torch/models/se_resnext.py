# ported from paddle_tpu/models/se_resnext.py
"""SE-ResNeXt (reference: benchmark/fluid/models/se_resnext.py — ResNeXt
bottlenecks with cardinality-grouped 3x3 convs + squeeze-and-excitation
channel gating)."""

from __future__ import annotations

from .. import layers


def _conv_bn(x, num_filters, filter_size, stride=1, groups=1, act="relu"):
    conv = layers.conv2d(x, num_filters=num_filters, filter_size=filter_size,
                         stride=stride, padding=(filter_size - 1) // 2,
                         groups=groups, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _squeeze_excitation(x, num_channels, reduction_ratio=16):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=max(num_channels // reduction_ratio, 1),
                        act="relu")
    excitation = layers.fc(squeeze, size=num_channels, act="sigmoid")
    # scale channels: [N, C] → [N, C, 1, 1] broadcast over H, W
    from ..layers import tensor as tensor_layers

    exc = tensor_layers.reshape(excitation, shape=[0, num_channels, 1, 1])
    return layers.elementwise_mul(x, exc)


def _shortcut(x, ch_out, stride):
    if x.shape[1] != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, act=None)
    return x


def _bottleneck(x, num_filters, stride, cardinality=32, reduction_ratio=16):
    conv0 = _conv_bn(x, num_filters, 1)
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride, groups=cardinality)
    conv2 = _conv_bn(conv1, num_filters * 2, 1, act=None)
    scaled = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(x, num_filters * 2, stride)
    return layers.relu(layers.elementwise_add(short, scaled))


def se_resnext(img, label, class_num: int = 1000, layers_cfg=(3, 4, 6, 3),
               cardinality: int = 32, base_filters=(128, 256, 512, 1024)):
    """SE-ResNeXt-50 by default; (avg_loss, logits)."""
    x = _conv_bn(img, 64, 7, stride=2)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for block, n in enumerate(layers_cfg):
        for i in range(n):
            # reference passes num_filters=[128,256,512,1024] straight into
            # the bottleneck (conv2 doubles it → stage outputs 256..2048)
            x = _bottleneck(x, base_filters[block],
                            stride=2 if i == 0 and block > 0 else 1,
                            cardinality=cardinality)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    logits = layers.fc(drop, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return loss, logits
