# ported from paddle_tpu/dataset/mnist.py
"""MNIST-shaped dataset (reference: python/paddle/dataset/mnist.py).

Synthetic (zero-egress): 784-dim float32 in [-1, 1]-ish, int label 0-9 —
identical reader contract to the reference's download-backed version.
"""

from .synthetic import class_clusters

TRAIN_SIZE = 8192
TEST_SIZE = 1024


def train():
    return class_clusters(TRAIN_SIZE, 784, 10, seed=1)


def test():
    return class_clusters(TEST_SIZE, 784, 10, seed=2)
