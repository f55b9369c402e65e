# ported from paddle_tpu/models/resnet.py
"""ResNet family (reference: benchmark/fluid/models/resnet.py and
benchmark/fluid/models/se_resnext.py).

Built from the framework's conv2d/batch_norm/pool2d layers. In the port
each layer's op runs eagerly on the card: the convolutions on cuDNN, batch
norm as torch reductions, the loss through K2a/K2b.
"""

from __future__ import annotations

from .. import layers

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1, act=None,
                  data_format="NCHW"):
    conv = layers.conv2d(
        input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        bias_attr=False,
        data_format=data_format,
    )
    return layers.batch_norm(conv, act=act, data_layout=data_format)


def _shortcut(input, ch_out, stride, data_format="NCHW"):
    ch_in = input.shape[-1] if data_format == "NHWC" else input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, data_format=data_format)
    return input


def basic_block(input, num_filters, stride, data_format="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, act="relu",
                          data_format=data_format)
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1, data_format=data_format)
    short = _shortcut(input, num_filters, stride, data_format)
    return layers.elementwise_add(short, conv1, act="relu")


def bottleneck_block(input, num_filters, stride, data_format="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          data_format=data_format)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu",
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1, data_format=data_format)
    short = _shortcut(input, num_filters * 4, stride, data_format)
    return layers.elementwise_add(short, conv2, act="relu")


def resnet(img, label, depth=50, class_num=1000, dataset="imagenet",
           data_format="NCHW"):
    """reference: resnet.py resnet_imagenet/resnet_cifar10.

    data_format="NHWC" transposes the (NCHW) input once and runs the whole
    network channels-last; the filters stay OIHW in both layouts.
    """
    block_kind, counts = _DEPTH_CFG[depth]
    block_fn = bottleneck_block if block_kind == "bottleneck" else basic_block

    if data_format == "NHWC" and img.shape[1] in (1, 3, 4):
        img = layers.transpose(img, [0, 2, 3, 1])

    if dataset == "imagenet":
        conv = conv_bn_layer(img, 64, 7, stride=2, act="relu",
                             data_format=data_format)
        conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                             data_format=data_format)
    else:  # cifar10: 3x3 stem, no maxpool
        conv = conv_bn_layer(img, 64, 3, stride=1, act="relu",
                             data_format=data_format)

    for stage, count in enumerate(counts):
        num_filters = 64 * (2 ** stage)
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            conv = block_fn(conv, num_filters, stride, data_format=data_format)

    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True,
                         data_format=data_format)
    logits = layers.fc(pool, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc


def resnet50(img, label, class_num=1000, data_format="NCHW"):
    return resnet(img, label, depth=50, class_num=class_num,
                  data_format=data_format)


def resnet_cifar10(img, label, depth=18, class_num=10):
    return resnet(img, label, depth=depth, class_num=class_num, dataset="cifar10")
