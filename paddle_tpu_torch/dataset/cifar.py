# ported from paddle_tpu/dataset/cifar.py
"""CIFAR-shaped dataset (reference: python/paddle/dataset/cifar.py).

Synthetic (zero-egress): 3x32x32 float32 images, int label — same reader
contract as the reference.
"""

from .synthetic import class_clusters

TRAIN_SIZE = 4096
TEST_SIZE = 512


def train10():
    return class_clusters(TRAIN_SIZE, 3 * 32 * 32, 10, seed=3, flatten=False,
                          image_shape=(3, 32, 32))


def test10():
    return class_clusters(TEST_SIZE, 3 * 32 * 32, 10, seed=4, flatten=False,
                          image_shape=(3, 32, 32))


def train100():
    return class_clusters(TRAIN_SIZE, 3 * 32 * 32, 100, seed=5, flatten=False,
                          image_shape=(3, 32, 32))


def test100():
    return class_clusters(TEST_SIZE, 3 * 32 * 32, 100, seed=6, flatten=False,
                          image_shape=(3, 32, 32))
