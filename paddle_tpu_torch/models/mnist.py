# ported from paddle_tpu/models/mnist.py
"""MNIST models (reference: benchmark/fluid/models/mnist.py and
tests/book/test_recognize_digits.py)."""

from __future__ import annotations

from .. import layers


def mlp(img, label, hidden_sizes=(200, 200), class_num=10):
    """The book MLP: two tanh-free relu hidden layers + softmax head."""
    h = img
    for size in hidden_sizes:
        h = layers.fc(h, size=size, act="relu")
    logits = layers.fc(h, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc


def lenet5(img, label, class_num=10):
    """conv-pool-conv-pool-fc (reference mnist.py cnn_model)."""
    conv1 = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=50, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    logits = layers.fc(pool2, size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc
