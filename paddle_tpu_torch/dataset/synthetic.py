# ported from paddle_tpu/dataset/synthetic.py
"""Synthetic dataset substrate.

The reference datasets (python/paddle/dataset/: mnist, cifar, uci_housing, …)
download real archives at import time. This environment is zero-egress, so
each dataset is a deterministic synthetic generator with the SAME reader
interface (``train()``/``test()`` returning example iterators with identical
shapes/dtypes/ranges). Swap in real loaders by pointing the loaders at local
files; the reader contract is unchanged.
"""

from __future__ import annotations

import numpy as np


def class_clusters(n, dim, classes, seed, noise=0.25, flatten=True, image_shape=None):
    """Separable class-conditional Gaussian clusters, deterministically."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, dim).astype("float32") * 2.0

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            y = int(r.randint(classes))
            x = centers[y] + r.randn(dim).astype("float32") * noise
            if image_shape is not None and not flatten:
                x = x.reshape(image_shape)
            yield x.astype("float32"), y

    return reader


def linear_regression(n, dim, seed, noise=0.1):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim).astype("float32")
    b = float(rng.randn())

    def reader():
        r = np.random.RandomState(seed + 1)
        for _ in range(n):
            x = r.randn(dim).astype("float32")
            y = float(x @ w + b + r.randn() * noise)
            yield x, np.asarray([y], dtype="float32")

    return reader
