"""The conv slice's ops, port registry against JAX registry.

Each case runs one op of ``paddle_tpu_torch``'s registry and the same op
of ``paddle_tpu``'s on the same ``RandomState`` inputs through the harness
of ``test_torch_train_ops.py``: every output compared, and for the
differentiable ops the port's ``torch.autograd.grad`` against ``jax.vjp``
under the same random cotangent. float32 to 1e-5 (the same math in
another summation order); integer outputs exactly.

* conv2d: NCHW and NHWC, stride 2, padding, dilation 2, groups 2,
  depthwise;
* pool2d: max with padding and with ties (the gradient goes to the first
  of the tied elements on both sides), avg with ``exclusive`` true and
  false, global, adaptive with ragged windows (10 → 7), padding beyond
  half a window, and ``ceil_mode=True`` pooled in floor mode as the
  reference pools it;
* batch_norm: training outputs Y, MeanOut, VarianceOut (Fluid's momentum
  on the old value, the biased variance), SavedMean, SavedVariance and the
  X/Scale/Bias vjp, NCHW and NHWC, ``is_test``, ``use_global_stats``, and
  a bf16 input with float32 statistics (2e-2, bf16 rounding: the
  statistics themselves are float32 sums and held to 1e-5);
* top_k with ties (lower index first), accuracy with k = 1 and 5;
* momentum with and without Nesterov; a sparse gradient raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_ops import (R, _np, _op, check_op_matches_jax, f32,
                                  jax_run, port_run)
from paddle_tpu.core.registry import registered_ops as jax_registered_ops
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.sparse import SparseGrad
from paddle_tpu_torch.executor import TraceContext

TOL = 1e-5


def bn_inputs(seed, c, x):
    rng = R(seed)
    return dict(X=x, Scale=rng.randn(c).astype(np.float32),
                Bias=rng.randn(c).astype(np.float32),
                Mean=rng.randn(c).astype(np.float32) * 0.1,
                Variance=(rng.rand(c) + 0.5).astype(np.float32))


BN_OUTS = {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
           "SavedVariance": 1}


def relu_ties(seed, *shape):
    """A post-ReLU activation: about half the elements are exactly 0, so
    most 2x2 and 3x3 windows of a dark patch tie at 0 or hold one max."""
    x = np.maximum(f32(R(seed), *shape), 0.0)
    x[..., :4, :4] = 0.0  # a plane of ties
    return x


# (id, op type, inputs, attrs, {out slot: count}, inputs to differentiate,
#  the output slot differentiated)
CASES = [
    ("conv_nchw", "conv2d",
     dict(Input=f32(R(0), 2, 4, 9, 9), Filter=f32(R(1), 6, 4, 3, 3)),
     dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1], groups=1),
     {"Output": 1}, ["Input", "Filter"], "Output"),
    ("conv_stride2_pad", "conv2d",
     dict(Input=f32(R(2), 2, 3, 11, 10), Filter=f32(R(3), 5, 3, 7, 7)),
     dict(strides=[2, 2], paddings=[3, 3], dilations=[1, 1], groups=1),
     {"Output": 1}, ["Input", "Filter"], "Output"),
    ("conv_dilation2", "conv2d",
     dict(Input=f32(R(4), 2, 4, 12, 12), Filter=f32(R(5), 4, 4, 3, 3)),
     dict(strides=[1, 2], paddings=[2, 1], dilations=[2, 2], groups=1),
     {"Output": 1}, ["Input", "Filter"], "Output"),
    ("conv_groups2", "conv2d",
     dict(Input=f32(R(6), 2, 4, 8, 8), Filter=f32(R(7), 6, 2, 3, 3)),
     dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1], groups=2),
     {"Output": 1}, ["Input", "Filter"], "Output"),
    ("conv_nhwc", "conv2d",
     dict(Input=f32(R(8), 2, 9, 9, 4), Filter=f32(R(9), 6, 4, 3, 3)),
     dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1], groups=1,
          data_format="NHWC"),
     {"Output": 1}, ["Input", "Filter"], "Output"),
    ("depthwise_conv2d", "depthwise_conv2d",
     dict(Input=f32(R(10), 2, 4, 8, 8), Filter=f32(R(11), 4, 1, 3, 3)),
     dict(strides=[1, 1], paddings=[1, 1], dilations=[1, 1], groups=4),
     {"Output": 1}, ["Input", "Filter"], "Output"),
    ("max_pool_pad", "pool2d", dict(X=f32(R(12), 2, 3, 9, 9)),
     dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
          paddings=[1, 1]), {"Out": 1}, ["X"], "Out"),
    ("max_pool_ties", "pool2d", dict(X=relu_ties(13, 2, 3, 8, 8)),
     dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
          paddings=[1, 1]), {"Out": 1}, ["X"], "Out"),
    ("max_pool_ties_2x2", "pool2d", dict(X=relu_ties(14, 2, 3, 8, 8)),
     dict(pooling_type="max", ksize=[2, 2], strides=[2, 2],
          paddings=[0, 0]), {"Out": 1}, ["X"], "Out"),
    ("max_pool_nhwc", "pool2d", dict(X=f32(R(15), 2, 9, 9, 3)),
     dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
          data_format="NHWC"), {"Out": 1}, ["X"], "Out"),
    ("avg_pool_exclusive", "pool2d", dict(X=f32(R(16), 2, 3, 7, 7)),
     dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
          exclusive=True), {"Out": 1}, ["X"], "Out"),
    ("avg_pool_inclusive", "pool2d", dict(X=f32(R(17), 2, 3, 7, 7)),
     dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2], paddings=[1, 1],
          exclusive=False), {"Out": 1}, ["X"], "Out"),
    ("avg_pool_wide_pad", "pool2d", dict(X=f32(R(18), 2, 3, 7, 7)),
     dict(pooling_type="avg", ksize=[2, 2], strides=[1, 1], paddings=[2, 2],
          exclusive=True), {"Out": 1}, ["X"], "Out"),
    ("max_pool_wide_pad", "pool2d", dict(X=f32(R(19), 2, 3, 7, 7)),
     dict(pooling_type="max", ksize=[2, 2], strides=[2, 2], paddings=[2, 2]),
     {"Out": 1}, ["X"], "Out"),
    ("avg_pool_global", "pool2d", dict(X=f32(R(20), 2, 5, 7, 7)),
     dict(pooling_type="avg", ksize=[1, 1], global_pooling=True),
     {"Out": 1}, ["X"], "Out"),
    ("max_pool_global_nhwc", "pool2d", dict(X=f32(R(21), 2, 7, 7, 5)),
     dict(pooling_type="max", ksize=[1, 1], global_pooling=True,
          data_format="NHWC"), {"Out": 1}, ["X"], "Out"),
    ("avg_pool_adaptive_ragged", "pool2d", dict(X=f32(R(22), 2, 3, 10, 10)),
     dict(pooling_type="avg", ksize=[7, 7], adaptive=True), {"Out": 1},
     ["X"], "Out"),
    ("max_pool_adaptive_ragged", "pool2d", dict(X=f32(R(23), 2, 3, 10, 9)),
     dict(pooling_type="max", ksize=[7, 4], adaptive=True), {"Out": 1},
     ["X"], "Out"),
    ("avg_pool_adaptive_divisible", "pool2d", dict(X=f32(R(24), 2, 3, 8, 8)),
     dict(pooling_type="avg", ksize=[2, 4], adaptive=True), {"Out": 1},
     ["X"], "Out"),
    ("max_pool_ceil_mode_floors", "pool2d", dict(X=f32(R(25), 2, 3, 8, 8)),
     dict(pooling_type="max", ksize=[3, 3], strides=[2, 2], paddings=[0, 0],
          ceil_mode=True), {"Out": 1}, ["X"], "Out"),
    ("bn_train_nchw", "batch_norm",
     bn_inputs(26, 4, f32(R(27), 3, 4, 5, 5) * 2 + 1),
     dict(momentum=0.9, epsilon=1e-5, data_layout="NCHW"), BN_OUTS,
     ["X", "Scale", "Bias"], "Y"),
    ("bn_train_nhwc", "batch_norm",
     bn_inputs(28, 4, f32(R(29), 3, 5, 5, 4) * 2 - 1),
     dict(momentum=0.8, epsilon=1e-3, data_layout="NHWC"), BN_OUTS,
     ["X", "Scale", "Bias"], "Y"),
    ("bn_train_2d", "batch_norm", bn_inputs(30, 6, f32(R(31), 8, 6)),
     dict(momentum=0.9, epsilon=1e-5, data_layout="NCHW"), BN_OUTS,
     ["X", "Scale", "Bias"], "Y"),
    ("bn_is_test", "batch_norm",
     bn_inputs(32, 4, f32(R(33), 3, 4, 5, 5)),
     dict(momentum=0.9, epsilon=1e-5, is_test=True),
     {"Y": 1, "MeanOut": 1, "VarianceOut": 1}, ["X", "Scale", "Bias"], "Y"),
    ("bn_use_global_stats", "batch_norm",
     bn_inputs(34, 4, f32(R(35), 3, 5, 5, 4)),
     dict(momentum=0.9, epsilon=1e-5, use_global_stats=True,
          data_layout="NHWC"),
     {"Y": 1, "MeanOut": 1, "VarianceOut": 1}, ["X", "Scale", "Bias"], "Y"),
    ("momentum", "momentum",
     dict(Param=f32(R(36), 3, 4), Grad=f32(R(37), 3, 4),
          Velocity=f32(R(38), 3, 4), LearningRate=np.array([0.1], np.float32)),
     dict(mu=0.9, use_nesterov=False), {"ParamOut": 1, "VelocityOut": 1},
     [], None),
    ("momentum_nesterov", "momentum",
     dict(Param=f32(R(39), 5), Grad=f32(R(40), 5), Velocity=f32(R(41), 5),
          LearningRate=np.array([0.05], np.float32)),
     dict(mu=0.95, use_nesterov=True), {"ParamOut": 1, "VelocityOut": 1},
     [], None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    check_op_matches_jax(case, TOL)


def test_bn_running_statistics_follow_fluid():
    """MeanOut = 0.9·Mean + 0.1·batch mean and VarianceOut from the biased
    batch variance, the opposite of ``F.batch_norm``'s running update."""
    x = f32(R(42), 6, 3, 4, 4) * 3 + 2
    ins = bn_inputs(43, 3, x)
    got = port_run("batch_norm", ins, BN_OUTS, dict(momentum=0.9))
    bmean = x.mean(axis=(0, 2, 3))
    bvar = x.var(axis=(0, 2, 3))  # biased
    np.testing.assert_allclose(_np(got["MeanOut"][0]),
                               0.9 * ins["Mean"] + 0.1 * bmean, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(got["VarianceOut"][0]),
                               0.9 * ins["Variance"] + 0.1 * bvar, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(got["SavedVariance"][0]), bvar, rtol=TOL)


def test_bn_statistics_carry_no_gradient():
    """The running and saved statistics are plain tensors even when X,
    Scale and Bias require grad: the executor writes them to the scope."""
    ins = bn_inputs(44, 4, f32(R(45), 3, 4, 5, 5))
    ins = {k: torch.tensor(v, requires_grad=k in ("X", "Scale", "Bias"))
           for k, v in ins.items()}
    got = port_run("batch_norm", ins, BN_OUTS, {})
    assert got["Y"][0].requires_grad
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert not got[slot][0].requires_grad, slot


def test_bn_bf16_input_float32_statistics():
    """A bf16 activation with float32 scale, bias and running statistics,
    as under AMP (the moving statistics are scope state, kept float32):
    statistics summed in float32 off the bf16 values to 1e-5, Y and its
    vjp in bf16 to 2e-2."""
    x = f32(R(46), 4, 3, 6, 6) * 2 + 1
    ins = bn_inputs(47, 3, x)
    jins = dict(ins, X=jnp.asarray(x, jnp.bfloat16))
    tins = dict(ins, X=torch.tensor(x).to(torch.bfloat16))
    want = jax_run("batch_norm", jins, BN_OUTS, {})
    got = port_run("batch_norm", tins, BN_OUTS, {})
    for slot in BN_OUTS:
        w, g = np.asarray(want[slot][0], np.float32), _np(got[slot][0])
        tol = 2e-2 if slot == "Y" else TOL
        assert got[slot][0].dtype == (torch.bfloat16 if slot == "Y"
                                      else torch.float32), slot
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=slot)
    ct = f32(R(48), *x.shape)

    def jf(xx, s, b):
        return jax_run("batch_norm", dict(jins, X=xx, Scale=s, Bias=b),
                       BN_OUTS, {})["Y"][0]

    _, vjp = jax.vjp(jf, jins["X"], jnp.asarray(ins["Scale"]),
                     jnp.asarray(ins["Bias"]))
    jgrads = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = [tins["X"].requires_grad_(True),
              torch.tensor(ins["Scale"], requires_grad=True),
              torch.tensor(ins["Bias"], requires_grad=True)]
    y = port_run("batch_norm", dict(tins, X=leaves[0], Scale=leaves[1],
                                    Bias=leaves[2]), BN_OUTS, {})["Y"][0]
    tgrads = torch.autograd.grad(y, leaves, torch.tensor(ct).bfloat16())
    for name, jg, tg in zip("XSB", jgrads, tgrads):
        np.testing.assert_allclose(_np(tg), np.asarray(jg, np.float32),
                                   rtol=2e-2, atol=2e-2, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_orders_ties_as_the_reference(dtype):
    """Equal values come lower index first, as ``jax.lax.top_k`` orders
    them; rows of bf16 probabilities tie often."""
    x = np.array([[1, 3, 3, 0, 3, 2, 3, 1],
                  [5, 5, 5, 5, 5, 5, 5, 5],
                  [0, 0, 1, 0, 1, 2, 0, 2]], np.float32)
    x = np.concatenate([x, np.round(R(49).rand(13, 8) * 4) / 4])
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    for k in (1, 3, 5, 8):
        want = jax_run("top_k", {"X": jx}, {"Out": 1, "Indices": 1},
                       {"k": k})
        got = port_run("top_k", {"X": tx}, {"Out": 1, "Indices": 1},
                       {"k": k})
        np.testing.assert_array_equal(_np(got["Indices"][0]),
                                      np.asarray(want["Indices"][0]))
        np.testing.assert_array_equal(
            _np(got["Out"][0]), np.asarray(want["Out"][0], np.float32))
        assert got["Indices"][0].dtype == torch.int32
    assert _np(got["Indices"][0])[0].tolist() == [1, 2, 4, 6, 5, 0, 7, 3]


@pytest.mark.parametrize("k", [1, 5])
def test_accuracy_matches_jax(k):
    """top_k of softmax rows then accuracy: Accuracy float32, Correct and
    Total int32, as the JAX package's ops give them."""
    rng = R(50 + k)
    probs = rng.rand(32, 10).astype(np.float32)
    label = rng.randint(0, 10, (32, 1)).astype(np.int64)
    outs = {"Accuracy": 1, "Correct": 1, "Total": 1}
    res = []
    for run in (jax_run, port_run):
        idx = run("top_k", {"X": probs}, {"Out": 1, "Indices": 1},
                  {"k": k})["Indices"][0]
        res.append(run("accuracy", {"Indices": idx, "Label": label}, outs,
                       {}))
    want, got = res
    for slot in outs:
        w, g = np.asarray(want[slot][0]), got[slot][0]
        assert g.dtype == (torch.float32 if slot == "Accuracy"
                           else torch.int32), slot
        np.testing.assert_array_equal(_np(g), w, err_msg=slot)
    assert 0 < float(_np(got["Accuracy"][0])) < 1


def test_momentum_sparse_gradient_raises():
    """``momentum`` takes an ``is_sparse`` table's gradient through its
    rows-only branch (the rows it names move, in place, the others keep
    their values and velocity); ``lars_momentum``, dense only in the JAX
    package too, still raises on it, naming the op."""
    op = _op(tfw, "momentum", ["Param", "Grad", "Velocity", "LearningRate"],
             {"ParamOut": 1, "VelocityOut": 1}, dict(mu=0.9))
    env = {"Param@in": torch.zeros(10, 3), "Velocity@in": torch.zeros(10, 3),
           "Grad@in": SparseGrad(torch.tensor([1, 4, 1]), torch.ones(3, 3)),
           "LearningRate@in": torch.tensor([0.1])}
    trace = TraceContext(tfw.Program(), False, torch.device("cpu"), 0)
    treg.get_op_impl("momentum")(treg.OpContext(op, env, trace))
    p, v = env["ParamOut@0"], env["VelocityOut@0"]
    assert p is env["Param@in"] and v is env["Velocity@in"]
    want_v = torch.zeros(10, 3)
    want_v[1], want_v[4] = 2.0, 1.0
    assert torch.equal(v, want_v)
    assert torch.allclose(p, -0.1 * want_v)
    lars = _op(tfw, "lars_momentum",
               ["Param", "Grad", "Velocity", "LearningRate"],
               {"ParamOut": 1, "VelocityOut": 1}, dict(mu=0.9))
    with pytest.raises(NotImplementedError, match="lars_momentum"):
        treg.get_op_impl("lars_momentum")(treg.OpContext(lars, env, trace))


def test_registry_holds_the_conv_slice_ops():
    """The ops ResNet-50, LeNet-5 and the MLP add, each registered in both
    packages."""
    ops = {"conv2d", "depthwise_conv2d", "pool2d", "batch_norm", "momentum",
           "top_k", "accuracy"}
    assert ops <= set(treg.registered_ops())
    assert ops <= set(jax_registered_ops())
