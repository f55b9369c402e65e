# ported from paddle_tpu/dataset/uci_housing.py
"""UCI-housing-shaped regression dataset (reference:
python/paddle/dataset/uci_housing.py). Synthetic (zero-egress): 13 features,
scalar target — same reader contract (the fit_a_line book workload)."""

from .synthetic import linear_regression

TRAIN_SIZE = 404
TEST_SIZE = 102


def train():
    return linear_regression(TRAIN_SIZE, 13, seed=7)


def test():
    return linear_regression(TEST_SIZE, 13, seed=8)
