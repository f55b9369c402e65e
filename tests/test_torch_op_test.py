"""The port's per-op harness (``paddle_tpu_torch/testing/op_test.py``)
against the JAX package's (``paddle_tpu/testing/op_test.py``), on the CPU
(``place=CPUPlace()``; the smoke's ``op_harness`` leg runs the same calls
on the card):

* ``run_op`` gives the JAX harness's outputs on the same inputs (1e-6),
  for dense ops, a multi-input slot, a test-mode op and the quantize ops;
* ``check_output`` passes on the numpy reference and fails on a wrong one,
  in both harnesses alike;
* ``check_grad`` (``torch.autograd`` against central differences in
  float64) passes where the JAX harness's does and catches a gradient
  that the op does not have;
* the class-style ``OpTest`` runs both checks.
"""

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX package's ops)
import paddle_tpu_torch as fluid
from paddle_tpu.testing import op_test as jop
from paddle_tpu_torch.testing import op_test as top
from paddle_tpu_torch.testing import OpTest

CPU = fluid.CPUPlace()


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


CASES = {
    "elementwise_add": ({"X": randn(3, 4), "Y": randn(4, seed=1)}, {},
                        ["Out"]),
    "mul": ({"X": randn(3, 5, seed=2), "Y": randn(5, 2, seed=3)}, {},
            ["Out"]),
    "softmax": ({"X": randn(4, 6, seed=4)}, {}, ["Out"]),
    "tanh": ({"X": randn(2, 7, seed=5)}, {}, ["Out"]),
    "reduce_sum": ({"X": randn(3, 4, 5, seed=6)}, {"dim": [1]}, ["Out"]),
    "sum": ({"X": [("a", randn(3, 3, seed=7)), ("b", randn(3, 3, seed=8))]},
            {}, ["Out"]),
    "dropout": ({"X": randn(4, 4, seed=9)},
                {"dropout_prob": 0.3, "is_test": True}, ["Out"]),
    "fake_quantize_abs_max": ({"X": randn(4, 5, seed=10)},
                              {"bit_length": 8}, ["Out", "OutScale"]),
    "fake_dequantize_max_abs": ({"X": np.round(randn(4, 5, seed=11) * 50),
                                 "Scale": np.asarray([2.0], np.float32)},
                                {"max_range": 127.0}, ["Out"]),
    "fake_quantize_moving_average_abs_max": (
        {"X": randn(3, 4, seed=12), "InScale": np.asarray([1.0], "float32"),
         "InAccum": np.asarray([1.5], "float32"),
         "InState": np.asarray([1.2], "float32")},
        {"moving_rate": 0.9}, ["Out", "OutScale", "OutAccum", "OutState"]),
}


@pytest.mark.parametrize("op_type", sorted(CASES))
def test_run_op_equals_the_jax_harness(op_type):
    inputs, attrs, outs = CASES[op_type]
    got = top.run_op(op_type, inputs, outs, attrs, place=CPU)
    want = jop.run_op(op_type, inputs, outs, attrs)
    for slot in outs:
        assert isinstance(got[slot], torch.Tensor)
        assert got[slot].device.type == "cpu"
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=1e-6, atol=1e-6, err_msg=slot)
    # check_output passes on the JAX harness's outputs in both harnesses
    expected = {s: np.asarray(want[s]) for s in outs}
    top.check_output(op_type, inputs, expected, attrs, place=CPU)
    jop.check_output(op_type, inputs, expected, attrs)


def test_check_output_fails_on_a_wrong_reference():
    x = randn(3, 4)
    for check, kw in ((top.check_output, {"place": CPU}),
                      (jop.check_output, {})):
        with pytest.raises(AssertionError, match="'relu' output slot 'Out'"):
            check("relu", {"X": x}, {"Out": x}, **kw)


@pytest.mark.parametrize("op_type,inputs,check", [
    ("tanh", {"X": randn(3, 4, seed=13)}, ["X"]),
    ("mul", {"X": randn(3, 5, seed=14), "Y": randn(5, 2, seed=15)},
     ["X", "Y"]),
    ("softmax", {"X": randn(2, 5, seed=16)}, ["X"]),
    ("fake_dequantize_max_abs", {"X": randn(3, 3, seed=17),
                                 "Scale": np.asarray([2.0], np.float32)},
     ["X"]),
])
def test_check_grad_passes_where_the_jax_harness_does(op_type, inputs,
                                                      check):
    attrs = {"max_range": 127.0} if op_type.startswith("fake") else {}
    top.check_grad(op_type, inputs, check, "Out", attrs, place=CPU)
    jop.check_grad(op_type, inputs, check, "Out", attrs)


def test_check_grad_catches_a_gradient_the_op_lacks():
    # the STE passes r / scale to X: finite differences see the steps of
    # the int grid (zero almost everywhere), so the check must fail
    with pytest.raises(AssertionError, match="max relative error"):
        top.check_grad("fake_quantize_abs_max", {"X": randn(2, 3, seed=18)},
                       ["X"], "Out", {"bit_length": 8}, place=CPU)


class TestScale(OpTest):
    op_type = "scale"
    inputs = {"X": randn(4, 3, seed=19)}
    attrs = {"scale": 2.5, "bias": 0.5}
    outputs = {"Out": randn(4, 3, seed=19) * 2.5 + 0.5}

    def test_output(self):
        self.check_output(place=CPU)

    def test_grad(self):
        self.check_grad(["X"], place=CPU)
