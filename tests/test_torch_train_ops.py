"""Every op of the training slice, port registry against JAX registry.

Each case runs one op of ``paddle_tpu_torch``'s registry and the same op
of ``paddle_tpu``'s on the same numpy inputs (``RandomState``), compares
every output, and for the differentiable ops compares the port's
``torch.autograd.grad`` with ``jax.vjp`` under the same random cotangent.
float32 to 1e-5 (the same math in another summation order); integer and
shape-only outputs exactly.

The random ops draw from torch generators in the port and from threefry
keys in the JAX package, so they are compared by distribution (range,
mean, standard deviation) and dropout by its keep rate, its scaling and its
``is_test`` identity, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu_torch  # noqa: F401  (registers the port's ops)
from paddle_tpu.core import framework as jfw
from paddle_tpu.core import registry as jreg
from paddle_tpu.testing.op_test import _Trace as JaxTrace
from paddle_tpu_torch.core import framework as tfw
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.executor import TraceContext

TOL = 1e-5


def _op(fw, op_type, inputs, outs, attrs):
    op = fw.Operator(fw.Program().global_block, op_type, attrs=dict(attrs))
    op.inputs = {s: [s + "@in"] for s in inputs}
    op.outputs = {s: ["%s@%d" % (s, i) for i in range(k)]
                  for s, k in outs.items()}
    return op


def jax_run(op_type, inputs, outs, attrs, is_test=False):
    """{slot: [outputs]} of the JAX op; ``inputs`` values may be tracers."""
    op = _op(jfw, op_type, inputs, outs, attrs)
    env = {s + "@in": jnp.asarray(a) for s, a in inputs.items()}
    jreg.get_op_impl(op_type)(jreg.OpContext(op, env, JaxTrace(is_test)))
    return {s: [env.get(n) for n in names] for s, names in op.outputs.items()}


def port_run(op_type, inputs, outs, attrs, is_test=False, step=0):
    """{slot: [outputs]} of the port's op; ``inputs`` values are tensors or
    numpy arrays."""
    op = _op(tfw, op_type, inputs, outs, attrs)
    env = {s + "@in": a if isinstance(a, torch.Tensor) else torch.tensor(a)
           for s, a in inputs.items()}
    trace = TraceContext(tfw.Program(), is_test, torch.device("cpu"), step)
    treg.get_op_impl(op_type)(treg.OpContext(op, env, trace))
    return {s: [env.get(n) for n in names] for s, names in op.outputs.items()}


def R(seed):
    return np.random.RandomState(seed)


def f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _seg(rng, b, s):
    seg = np.ones((b, s), np.int32)
    seg[:, s // 2 + 1:] = 2
    return seg


# (id, op type, inputs, attrs, {out slot: count}, inputs to differentiate,
#  the output slot differentiated)
CASES = [
    ("mul", "mul", dict(X=f32(R(0), 2, 3, 4), Y=f32(R(1), 4, 5)),
     dict(x_num_col_dims=2, y_num_col_dims=1), {"Out": 1}, ["X", "Y"], "Out"),
    ("mul_flatten", "mul", dict(X=f32(R(2), 2, 3, 4), Y=f32(R(3), 12, 5)),
     dict(x_num_col_dims=1, y_num_col_dims=1), {"Out": 1}, ["X", "Y"], "Out"),
    ("elementwise_add_axis1", "elementwise_add",
     dict(X=f32(R(4), 2, 3, 4), Y=f32(R(5), 3, 4)), dict(axis=1),
     {"Out": 1}, ["X", "Y"], "Out"),
    ("elementwise_mul", "elementwise_mul",
     dict(X=f32(R(6), 2, 3, 1), Y=f32(R(7), 2, 3, 1)), dict(axis=-1),
     {"Out": 1}, ["X", "Y"], "Out"),
    ("elementwise_div", "elementwise_div",
     dict(X=f32(R(8), 3, 4), Y=np.abs(f32(R(9), 3, 4)) + 0.5), dict(axis=-1),
     {"Out": 1}, ["X", "Y"], "Out"),
    ("scale", "scale", dict(X=f32(R(10), 3, 4)), dict(scale=2.5, bias=-1.0),
     {"Out": 1}, ["X"], "Out"),
    ("cast", "cast", dict(X=f32(R(11), 3, 4) * 3),
     dict(in_dtype="float32", out_dtype="int32"), {"Out": 1}, [], None),
    ("relu", "relu", dict(X=f32(R(12), 3, 4)), {}, {"Out": 1}, ["X"], "Out"),
    ("reduce_sum", "reduce_sum", dict(X=f32(R(13), 2, 3, 4)),
     dict(dim=[1], keep_dim=False), {"Out": 1}, ["X"], "Out"),
    ("reduce_sum_all", "reduce_sum", dict(X=f32(R(14), 2, 3, 4)),
     dict(dim=[0], keep_dim=False, reduce_all=True), {"Out": 1}, ["X"], "Out"),
    ("mean", "mean", dict(X=f32(R(15), 3, 4)), {}, {"Out": 1}, ["X"], "Out"),
    ("reshape2", "reshape2", dict(X=f32(R(16), 2, 3, 4)),
     dict(shape=[0, -1, 2]), {"Out": 1, "XShape": 1}, ["X"], "Out"),
    ("transpose2", "transpose2", dict(X=f32(R(17), 2, 3, 4)),
     dict(axis=[0, 2, 1]), {"Out": 1, "XShape": 1}, ["X"], "Out"),
    ("split_sections", "split", dict(X=f32(R(18), 2, 6, 4)),
     dict(sections=[1, 2, 3], axis=1), {"Out": 3}, ["X"], "Out"),
    ("split_num", "split", dict(X=f32(R(19), 2, 6, 4)),
     dict(num=3, axis=1), {"Out": 3}, ["X"], "Out"),
    ("unsqueeze", "unsqueeze", dict(X=f32(R(20), 2, 3)), dict(axes=[1, 2]),
     {"Out": 1}, ["X"], "Out"),
    ("layer_norm", "layer_norm",
     dict(X=f32(R(21), 2, 3, 8) * 2 + 1, Scale=f32(R(22), 8),
          Bias=f32(R(23), 8)),
     dict(begin_norm_axis=2, epsilon=1e-5),
     {"Y": 1, "Mean": 1, "Variance": 1}, ["X", "Scale", "Bias"], "Y"),
    ("lookup_table", "lookup_table",
     dict(W=f32(R(24), 10, 4),
          Ids=np.array([[[1], [3], [-1]], [[9], [3], [0]]], np.int64)),
     dict(padding_idx=-1, is_sparse=False), {"Out": 1}, ["W"], "Out"),
    ("lookup_table_padding", "lookup_table",
     dict(W=f32(R(25), 10, 4),
          Ids=np.array([[[1], [3], [5]], [[9], [3], [0]]], np.int64)),
     dict(padding_idx=3, is_sparse=False), {"Out": 1}, ["W"], "Out"),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
     dict(Logits=f32(R(26), 2, 3, 20) * 2,
          Label=np.array([[[4], [-100], [19]], [[0], [7], [7]]], np.int64)),
     dict(soft_label=False, ignore_index=-100, label_smoothing=0.1),
     {"Loss": 1}, ["Logits"], "Loss"),
    ("sdpa_segments", "scaled_dot_product_attention",
     dict(Q=f32(R(27), 2, 2, 5, 4), K=f32(R(28), 2, 2, 5, 4),
          V=f32(R(29), 2, 2, 5, 4), SegmentIdsQ=_seg(R(0), 2, 5),
          SegmentIdsKV=_seg(R(0), 2, 5)),
     dict(causal=False, sm_scale=0.5, dropout_rate=0.0, is_test=False),
     {"Out": 1}, ["Q", "K", "V"], "Out"),
    ("sdpa_causal_segments", "scaled_dot_product_attention",
     dict(Q=f32(R(30), 2, 2, 5, 4), K=f32(R(31), 2, 2, 5, 4),
          V=f32(R(32), 2, 2, 5, 4), SegmentIdsQ=_seg(R(0), 2, 5),
          SegmentIdsKV=_seg(R(0), 2, 5)),
     dict(causal=True, sm_scale=0.5, dropout_rate=0.0, is_test=False),
     {"Out": 1}, ["Q", "K", "V"], "Out"),
    ("sdpa_bias", "scaled_dot_product_attention",
     dict(Q=f32(R(33), 2, 2, 5, 4), K=f32(R(34), 2, 2, 6, 4),
          V=f32(R(35), 2, 2, 6, 4), Bias=f32(R(36), 2, 2, 5, 6)),
     dict(causal=False, sm_scale=0.5, dropout_rate=0.0, is_test=False),
     {"Out": 1}, ["Q", "K", "V", "Bias"], "Out"),
    ("adam", "adam",
     dict(Param=f32(R(37), 3, 4), Grad=f32(R(38), 3, 4),
          Moment1=f32(R(39), 3, 4) * 0.1,
          Moment2=np.abs(f32(R(40), 3, 4)) * 0.01,
          Beta1Pow=np.array([0.9 ** 3], np.float32),
          Beta2Pow=np.array([0.999 ** 3], np.float32),
          LearningRate=np.array([1e-3], np.float32)),
     dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
     {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1}, [], None),
    ("fill_constant", "fill_constant", {},
     dict(shape=[2, 3], dtype="float32", value=1.5), {"Out": 1}, [], None),
    ("fill_constant_int64", "fill_constant", {},
     dict(shape=[4], dtype="int64", value=7.0), {"Out": 1}, [], None),
    ("assign_value", "assign_value", {},
     dict(shape=[2, 3], dtype="float32",
          values=f32(R(41), 6).tolist()), {"Out": 1}, [], None),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)


def two_class(rng, n):
    """[n, 2] class probabilities, as DeepFM's softmax head gives them."""
    p = rng.rand(n).astype(np.float32)
    return np.stack([1 - p, p], 1)


# the ops DeepFM adds, held to 1e-6: each is one torch call against one
# jnp call, so the two should round alike
CTR_CASES = [
    ("square", "square", dict(X=f32(R(60), 3, 5)), {}, {"Out": 1}, ["X"],
     "Out"),
    ("elementwise_sub", "elementwise_sub",
     dict(X=f32(R(61), 4, 6), Y=f32(R(62), 4, 6)), dict(axis=-1),
     {"Out": 1}, ["X", "Y"], "Out"),
    ("elementwise_sub_axis1", "elementwise_sub",
     dict(X=f32(R(63), 2, 3, 4), Y=f32(R(64), 3)), dict(axis=1),
     {"Out": 1}, ["X", "Y"], "Out"),
    ("softmax", "softmax", dict(X=f32(R(65), 6, 2) * 3), dict(axis=-1),
     {"Out": 1}, ["X"], "Out"),
    ("softmax_axis1", "softmax", dict(X=f32(R(66), 2, 5, 3)), dict(axis=1),
     {"Out": 1}, ["X"], "Out"),
    ("fill_zeros_like", "fill_zeros_like", dict(X=f32(R(67), 3, 4)), {},
     {"Out": 1}, [], None),
    ("sgd", "sgd",
     dict(Param=f32(R(68), 5, 3), Grad=f32(R(69), 5, 3),
          LearningRate=np.array([0.05], np.float32)), {},
     {"ParamOut": 1}, [], None),
    ("auc", "auc",
     dict(Predict=two_class(R(70), 64),
          Label=R(71).randint(0, 2, (64, 1)).astype(np.int64),
          StatPos=R(72).randint(0, 3, (1, 33)).astype(np.float32),
          StatNeg=R(73).randint(0, 3, (1, 33)).astype(np.float32)),
     dict(curve="ROC", num_thresholds=32),
     {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}, [], None),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    check_op_matches_jax(case, TOL)


@pytest.mark.parametrize("case", CTR_CASES, ids=[c[0] for c in CTR_CASES])
def test_ctr_op_matches_jax(case):
    check_op_matches_jax(case, 1e-6)


def test_concat_matches_jax():
    xs = [f32(R(74 + i), 2, k, 3) for i, k in enumerate((1, 4, 2))]
    ct = f32(R(77), 2, 7, 3)
    outs = []
    for fw, reg, env_of, trace in (
            (jfw, jreg, jnp.asarray, JaxTrace(False)),
            (tfw, treg, lambda a: torch.tensor(a, requires_grad=True),
             TraceContext(tfw.Program(), False, torch.device("cpu"), 0))):
        op = fw.Operator(fw.Program().global_block, "concat",
                         attrs={"axis": 1})
        op.inputs = {"X": ["x%d" % i for i in range(3)]}
        op.outputs = {"Out": ["out"]}
        env = {"x%d" % i: env_of(x) for i, x in enumerate(xs)}
        reg.get_op_impl("concat")(reg.OpContext(op, env, trace))
        outs.append((env, env["out"]))
    (_, want), (tenv, got) = outs
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    grads = torch.autograd.grad(got, [tenv["x%d" % i] for i in range(3)],
                                torch.tensor(ct))
    for g, (a, b) in zip(grads, ((0, 1), (1, 5), (5, 7))):
        np.testing.assert_array_equal(g.numpy(), ct[:, a:b])


def check_op_matches_jax(case, tol):
    _, op_type, inputs, attrs, outs, wrt, gslot = case
    want = jax_run(op_type, inputs, outs, attrs)
    got = port_run(op_type, inputs, outs, attrs)
    for slot in outs:
        for w, g in zip(want[slot], got[slot]):
            w, g = np.asarray(w), _np(g)
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=slot)
            else:
                np.testing.assert_array_equal(g, w, err_msg=slot)
    if not wrt:
        return
    ct = np.asarray(R(99).randn(*np.shape(want[gslot][0])), np.float32)

    def jf(*xs):
        ins = dict(inputs)
        ins.update(zip(wrt, xs))
        return jax_run(op_type, ins, outs, attrs)[gslot][0]

    _, vjp = jax.vjp(jf, *[jnp.asarray(inputs[s]) for s in wrt])
    jgrads = vjp(jnp.asarray(ct))
    leaves = {s: torch.tensor(inputs[s], requires_grad=True) for s in wrt}
    ins = dict(inputs)
    ins.update(leaves)
    out = port_run(op_type, ins, outs, attrs)[gslot][0]
    tgrads = torch.autograd.grad(out, [leaves[s] for s in wrt],
                                 torch.as_tensor(ct))
    for s, jg, tg in zip(wrt, jgrads, tgrads):
        np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=tol,
                                   atol=tol, err_msg="d%s" % s)


@pytest.mark.parametrize("op_type,attrs,check", [
    ("uniform_random", dict(shape=[200, 300], dtype="float32", min=-0.5,
                            max=1.5), "uniform"),
    ("gaussian_random", dict(shape=[200, 300], dtype="float32", mean=0.25,
                             std=2.0), "gaussian"),
    ("truncated_gaussian_random", dict(shape=[200, 300], dtype="float32",
                                       mean=0.25, std=2.0), "truncated"),
])
def test_random_op_distribution_matches_jax(op_type, attrs, check):
    want = np.asarray(jax_run(op_type, {}, {"Out": 1}, attrs)["Out"][0])
    got = port_run(op_type, {}, {"Out": 1}, attrs)["Out"][0]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    again = port_run(op_type, {}, {"Out": 1}, attrs)["Out"][0].numpy()
    np.testing.assert_array_equal(got, again)  # same seed, same draw
    other = port_run(op_type, {}, {"Out": 1}, attrs, step=1)["Out"][0]
    assert not np.array_equal(got, other.numpy())  # next step, new draw
    if check == "uniform":
        assert got.min() >= -0.5 and got.max() < 1.5
        assert want.min() >= -0.5 and want.max() < 1.5
    if check == "truncated":
        # mean ± 2 std, and the std of a standard normal cut at ±2
        for x in (got, want):
            assert x.min() >= 0.25 - 4.0 and x.max() <= 0.25 + 4.0
            assert x.min() < 0.25 - 3.9 and x.max() > 0.25 + 3.9
        assert abs(got.std() - 2.0 * 0.87962566) < 0.02
    # 60,000 draws: the means agree to a few standard errors
    assert abs(got.mean() - want.mean()) < 0.03
    assert abs(got.std() - want.std()) < 0.03


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_matches_jax_semantics(impl):
    x = np.abs(f32(R(50), 100, 1000)) + 0.1
    attrs = dict(dropout_prob=0.1, dropout_implementation=impl, seed=0)
    outs = {"Out": 1, "Mask": 1}
    # is_test: identity (upscale) or x*(1-p) (downgrade), both packages
    want = np.asarray(jax_run("dropout", {"X": x}, outs, attrs,
                              is_test=True)["Out"][0])
    got = port_run("dropout", {"X": x}, outs, attrs, is_test=True)["Out"][0]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if impl == "upscale_in_train":
        np.testing.assert_array_equal(got.numpy(), x)
    # p = 0: identity in training too
    p0 = dict(attrs, dropout_prob=0.0)
    got0 = port_run("dropout", {"X": x}, outs, p0)["Out"][0]
    np.testing.assert_array_equal(got0.numpy(), x)
    # p = 0.1: keep rate 0.9 within 1 % of 100,000 draws (JAX's too), and
    # the kept values scaled as the JAX op scales them
    scale = 1.0 / 0.9 if impl == "upscale_in_train" else 1.0
    for res in (port_run("dropout", {"X": x}, outs, attrs),
                jax_run("dropout", {"X": x}, outs, attrs)):
        out, mask = _np(res["Out"][0]), _np(res["Mask"][0])
        keep = mask.astype(bool)
        assert abs(keep.mean() - 0.9) < 0.01
        np.testing.assert_array_equal(out[~keep], 0.0)
        np.testing.assert_allclose(out[keep], (x * np.float32(scale))[keep],
                                   rtol=TOL)


def test_attention_dropout_keep_rate():
    q = f32(R(51), 4, 4, 64, 8)
    ins = dict(Q=q, K=f32(R(52), 4, 4, 64, 8), V=np.ones((4, 4, 64, 8),
                                                         np.float32))
    attrs = dict(causal=False, sm_scale=0.3, dropout_rate=0.1,
                 is_test=False)
    out = port_run("scaled_dot_product_attention", ins, {"Out": 1},
                   attrs)["Out"][0].numpy()
    # with V all ones, each output row is the sum of its kept probabilities
    # times 1/(1-p): 1 in expectation, never the plain softmax's exact 1
    assert abs(out.mean() - 1.0) < 0.01 and not np.allclose(out, 1.0)
    test = port_run("scaled_dot_product_attention", ins, {"Out": 1},
                    dict(attrs, is_test=True))["Out"][0].numpy()
    want = np.asarray(jax_run("scaled_dot_product_attention", ins,
                              {"Out": 1}, dict(attrs, is_test=True))["Out"][0])
    np.testing.assert_allclose(test, want, rtol=TOL, atol=TOL)
