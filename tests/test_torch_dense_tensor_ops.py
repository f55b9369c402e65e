"""The port's dense tensor ops match the JAX package's.

Each op of ``paddle_tpu/ops/tensor_ops.py`` that needs no LoD, tensor
array or sub-block runs through both registries on the same
``RandomState`` inputs, forward and backward (``check_op`` of
``test_torch_dense_reduce_math``): float outputs to 1e-6, gradients to
1e-5, integer and bool outputs exactly with their dtype (int32, as the
JAX package gives them), ``argsort`` with ties exactly. ``scatter``
keeps the last of a repeated id, as XLA does, and its gradient goes to
that one. The random ops (``*_batch_size_like``, ``randint``) are held
by shape, dtype, range, moments within 4 sigma and repeatability from
one seed. ``load`` reads what ``io.save_vars`` writes in either package;
``assign``, ``fill_constant_batch_size_like``, ``range``, ``linspace``,
``reverse``, ``crop`` and ``load`` also run as the layers build them,
through ``Executor.run`` of both packages.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import registry as treg
from test_torch_dense_reduce_math import (BF16, ELEMENTWISE, check_op,
                                          randn)

SHAPE = (4, 6, 5)
IMG = (2, 8, 6, 6)


def ids(n, hi, seed=0, shape=None):
    return np.random.RandomState(seed).randint(0, hi, shape or (n,)) \
        .astype(np.int64)


CASES = {
    # name: (op type, attrs, inputs (a thunk), outputs)
    "flatten": ("flatten", {"axis": 2}, lambda: {"X": randn(*SHAPE)},
                {"Out": 1}),
    "flatten_axis0": ("flatten", {"axis": 0}, lambda: {"X": randn(*SHAPE)},
                      {"Out": 1}),
    "flatten2": ("flatten2", {"axis": 1}, lambda: {"X": randn(*SHAPE)},
                 {"Out": 1, "XShape": 1}),
    "stack": ("stack", {"axis": 1}, lambda: {"X": [randn(4, 5, seed=i)
                                                   for i in range(3)]},
              {"Y": 1}),
    "stack_neg": ("stack", {"axis": -1}, lambda: {"X": [
        randn(4, 5, seed=i) for i in range(2)]}, {"Y": 1}),
    "unstack": ("unstack", {"axis": 1}, lambda: {"X": randn(4, 3, 5)},
                {"Y": 3}),
    "strided_slice": ("strided_slice", {
        "axes": [0, 2], "starts": [1, 0], "ends": [4, 5], "strides": [2, 2]},
        lambda: {"Input": randn(*SHAPE)}, {"Out": 1}),
    "strided_slice_negative": ("strided_slice", {
        "axes": [1, 2], "starts": [-1, 4], "ends": [0, -6],
        "strides": [-2, -1]}, lambda: {"Input": randn(*SHAPE)}, {"Out": 1}),
    "strided_slice_clamped": ("strided_slice", {
        "axes": [1], "starts": [-100], "ends": [100], "strides": [3]},
        lambda: {"Input": randn(*SHAPE)}, {"Out": 1}),
    "gather_nd": ("gather_nd", {}, lambda: {
        "X": randn(*SHAPE), "Index": np.stack(
            [ids(7, 4, 1), ids(7, 6, 2)], -1)}, {"Out": 1}),
    "gather_nd_full": ("gather_nd", {}, lambda: {
        "X": randn(*SHAPE), "Index": np.stack(
            [ids(3, 4, 1), ids(3, 6, 2), ids(3, 5, 3)], -1).reshape(
                3, 1, 3)}, {"Out": 1}),
    "scatter_overwrite": ("scatter", {"overwrite": True}, lambda: {
        "X": randn(8, 5), "Ids": np.array([3, 0, 6], np.int64),
        "Updates": randn(3, 5, seed=1)}, {"Out": 1}),
    "scatter_add_repeats": ("scatter", {"overwrite": False}, lambda: {
        "X": randn(8, 5), "Ids": np.array([3, 0, 3, 6, 3], np.int64),
        "Updates": randn(5, 5, seed=1)}, {"Out": 1}),
    "expand": ("expand", {"expand_times": [2, 1, 3]},
               lambda: {"X": randn(*SHAPE)}, {"Out": 1}),
    "expand_as": ("expand_as", {}, lambda: {
        "X": randn(4, 1, 5), "target_tensor": randn(4, 6, 10)}, {"Out": 1}),
    "tile": ("tile", {"repeat_times": [3, 2]},
             lambda: {"X": randn(*SHAPE)}, {"Out": 1}),
    "pad": ("pad", {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5},
            lambda: {"X": randn(*SHAPE)}, {"Out": 1}),
    "pad2d_constant": ("pad2d", {"paddings": [1, 2, 0, 3],
                                 "mode": "constant", "pad_value": -1.0},
                       lambda: {"X": randn(*IMG)}, {"Out": 1}),
    "pad2d_reflect": ("pad2d", {"paddings": [1, 2, 3, 0], "mode": "reflect"},
                      lambda: {"X": randn(*IMG)}, {"Out": 1}),
    "pad2d_edge": ("pad2d", {"paddings": [2, 0, 1, 3], "mode": "edge"},
                   lambda: {"X": randn(*IMG)}, {"Out": 1}),
    "pad_constant_like": ("pad_constant_like", {"pad_value": 2.0}, lambda: {
        "X": randn(5, 7, 4), "Y": randn(3, 7, 2, seed=1)}, {"Out": 1}),
    "crop": ("crop", {"offsets": [1, 2, 0], "shape": [2, 3, 5]},
             lambda: {"X": randn(*SHAPE)}, {"Out": 1}),
    "reverse": ("reverse", {"axis": [0, 2]}, lambda: {"X": randn(*SHAPE)},
                {"Out": 1}),
    "one_hot": ("one_hot", {"depth": 9},
                lambda: {"X": ids(12, 9, shape=(3, 4, 1))}, {"Out": 1}),
    "one_hot_out_of_range": ("one_hot", {"depth": 5}, lambda: {
        "X": np.array([[0], [4], [5], [-1], [2]], np.int64)}, {"Out": 1}),
    "one_hot_2d": ("one_hot", {"depth": 7},
                   lambda: {"X": ids(12, 7, shape=(3, 4))}, {"Out": 1}),
    "shape": ("shape", {}, lambda: {"Input": randn(*SHAPE)}, {"Out": 1}),
    "argsort": ("argsort", {"axis": 1}, lambda: {"X": randn(*SHAPE)},
                {"Out": 1, "Indices": 1}),
    "argsort_ties": ("argsort", {"axis": -1}, lambda: {
        "X": np.random.RandomState(5).randint(0, 3, SHAPE).astype(
            np.float32)}, {"Out": 1, "Indices": 1}),
    "arg_max": ("arg_max", {"axis": 1}, lambda: {"X": randn(*SHAPE)},
                {"Out": 1}),
    "arg_max_ties": ("arg_max", {"axis": -1}, lambda: {
        "X": np.random.RandomState(6).randint(0, 2, SHAPE).astype(
            np.float32)}, {"Out": 1}),
    "arg_min": ("arg_min", {"axis": 0}, lambda: {"X": randn(*SHAPE)},
                {"Out": 1}),
    "arg_min_ties": ("arg_min", {"axis": 2}, lambda: {
        "X": np.random.RandomState(7).randint(0, 2, SHAPE).astype(
            np.float32)}, {"Out": 1}),
    "multiplex": ("multiplex", {}, lambda: {
        "X": [randn(6, 5, seed=i) for i in range(3)],
        "Ids": ids(6, 3, shape=(6, 1))}, {"Out": 1}),
    "is_empty": ("is_empty", {}, lambda: {"X": randn(*SHAPE)}, {"Out": 1}),
    "is_empty_true": ("is_empty", {}, lambda: {"X": randn(0, 5)},
                      {"Out": 1}),
    "assign": ("assign", {}, lambda: {"X": randn(*SHAPE)}, {"Out": 1}),
    "shuffle_channel": ("shuffle_channel", {"group": 4},
                        lambda: {"X": randn(*IMG)}, {"Out": 1}),
    "label_smooth": ("label_smooth", {"epsilon": 0.1}, lambda: {
        "X": np.eye(9, dtype=np.float32)[ids(12, 9)]}, {"Out": 1}),
    "label_smooth_prior": ("label_smooth", {"epsilon": 0.2}, lambda: {
        "X": np.eye(9, dtype=np.float32)[ids(12, 9)],
        "PriorDist": np.random.RandomState(1).dirichlet(
            np.ones(9)).astype(np.float32)}, {"Out": 1}),
    "pixel_shuffle": ("pixel_shuffle", {"upscale_factor": 2},
                      lambda: {"X": randn(*IMG)}, {"Out": 1}),
    "space_to_depth": ("space_to_depth", {"blocksize": 3},
                       lambda: {"X": randn(*IMG)}, {"Out": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_op_matches_jax(case):
    op_type, attrs, inputs, outs = CASES[case]
    check_op(op_type, attrs, inputs(), outs)


@pytest.mark.parametrize("case", ("label_smooth", "one_hot"))
def test_bf16_matches_jax(case):
    op_type, attrs, inputs, outs = CASES[case]
    inp = inputs()
    if op_type == "label_smooth":
        inp = {"X": inp["X"].astype(jnp.bfloat16)}
    got, _ = check_op(op_type, attrs, inp, outs, tol=BF16, grad_tol=BF16)
    if op_type == "label_smooth":
        # the constants round to bf16 first, as JAX's weak scalars do: the
        # smoothed labels are the same bits
        _, want = check_op(op_type, attrs, inp, outs, tol=(0, 0),
                           grad_tol=BF16)


def test_scatter_overwrite_keeps_the_last_repeat_and_its_gradient():
    x = randn(8, 5)
    idx = np.array([3, 0, 3, 6, 3, 0], np.int64)
    upd = randn(6, 5, seed=1)
    got, want = check_op("scatter", {"overwrite": True},
                         {"X": x, "Ids": idx, "Updates": upd}, {"Out": 1})
    out = got["Out"].detach().numpy()
    np.testing.assert_array_equal(out[3], upd[4])
    np.testing.assert_array_equal(out[0], upd[5])
    np.testing.assert_array_equal(out[6], upd[3])
    np.testing.assert_array_equal(out[1], x[1])


def test_scatter_negative_ids_wrap():
    check_op("scatter", {"overwrite": True}, {
        "X": randn(8, 5), "Ids": np.array([-1, 2, -8], np.int64),
        "Updates": randn(3, 5, seed=1)}, {"Out": 1})


def test_pad2d_nhwc_pads_h_and_w():
    """``data_format`` NHWC pads dims 1 and 2 (Fluid's rule; the JAX
    package's op pads dims 2 and 3 whatever the layout): held to the JAX
    package's NCHW op on the transposed input."""
    x = randn(*IMG)
    for mode in ("constant", "reflect", "edge"):
        attrs = {"paddings": [1, 2, 2, 1], "mode": mode, "pad_value": 3.0}
        _, want = check_op("pad2d", attrs, {"X": x}, {"Out": 1})
        env = {"X": torch.tensor(x.transpose(0, 2, 3, 1))}
        op = types.SimpleNamespace(
            type="pad2d", attrs=dict(attrs, data_format="NHWC"), block=None,
            inputs={"X": ["X"]}, outputs={"Out": ["Out"]})
        treg.get_op_impl("pad2d")(treg.OpContext(op, env, None))
        np.testing.assert_array_equal(env["Out"].numpy(), np.asarray(
            want["Out"]).transpose(0, 2, 3, 1))


# -- the random ops -----------------------------------------------------------


def run_random(op_type, attrs, inputs, seed, step=0):
    from paddle_tpu_torch.executor import TraceContext

    program = types.SimpleNamespace(random_seed=seed)
    op = types.SimpleNamespace(type=op_type, attrs=dict(attrs), block=None,
                               inputs={k: [k] for k in inputs},
                               outputs={"Out": ["Out"]})
    env = {k: torch.tensor(v) for k, v in inputs.items()}
    trace = TraceContext(program, False, torch.device("cpu"), step)
    treg.get_op_impl(op_type)(treg.OpContext(op, env, trace))
    return env["Out"]


BATCH_LIKE = {"shape": [-1, 300], "input_dim_idx": 1, "output_dim_idx": 0}


@pytest.mark.parametrize("op_type", ("uniform_random_batch_size_like",
                                     "gaussian_random_batch_size_like",
                                     "randint"))
def test_random_op_shape_range_moments_and_seed(op_type):
    inputs = {"Input": randn(3, 200)}
    if op_type == "uniform_random_batch_size_like":
        attrs, lo, hi = dict(BATCH_LIKE, min=-2.0, max=4.0), -2.0, 4.0
        mean, std = 1.0, 6.0 / 12 ** 0.5
    elif op_type == "gaussian_random_batch_size_like":
        attrs, lo, hi = dict(BATCH_LIKE, mean=1.5, std=0.5), -np.inf, np.inf
        mean, std = 1.5, 0.5
    else:
        attrs, lo, hi = {"shape": [200, 300], "low": -3, "high": 7}, -3, 6
        mean, std = 1.5, (10 ** 2 - 1) ** 0.5 / 12 ** 0.5
        inputs = {}
    out = run_random(op_type, attrs, inputs, seed=11)
    assert tuple(out.shape) == (200, 300)
    assert out.dtype == (torch.int32 if op_type == "randint"
                         else torch.float32)
    v = out.double().numpy()
    assert v.min() >= lo and v.max() <= hi
    n = v.size
    assert abs(v.mean() - mean) < 4 * std / n ** 0.5
    # the sample variance's standard error is about std^2 sqrt(2/n)
    assert abs(v.var() - std ** 2) < 4 * std ** 2 * (2 / n) ** 0.5 * 1.5
    if op_type == "randint":
        assert set(np.unique(v).astype(int)) == set(range(-3, 7))
    again = run_random(op_type, attrs, inputs, seed=11)
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    other = run_random(op_type, attrs, inputs, seed=12)
    assert not torch.equal(other, out)


def test_random_batch_size_like_matches_jax_shape():
    from paddle_tpu.core import registry as jreg

    for op_type in ("uniform_random_batch_size_like",
                    "gaussian_random_batch_size_like"):
        x = randn(3, 7)
        op = types.SimpleNamespace(
            type=op_type, attrs=dict(BATCH_LIKE, shape=[-1, 4, 2]),
            block=None, inputs={"Input": ["Input"]},
            outputs={"Out": ["Out"]})
        import jax

        env = {"Input": jnp.asarray(x)}
        trace = types.SimpleNamespace(rng=lambda: jax.random.PRNGKey(0))
        ctx = jreg.OpContext(op, env, trace)
        ctx.rng = lambda: jax.random.PRNGKey(0)
        jreg.get_op_impl(op_type)(ctx)
        got = run_random(op_type, dict(BATCH_LIKE, shape=[-1, 4, 2]),
                         {"Input": x}, seed=3)
        assert tuple(got.shape) == env["Out"].shape == (7, 4, 2)
        assert str(got.dtype) == "torch." + str(env["Out"].dtype)


# -- through the layers and the executors of both packages --------------------


def run_both(build, feed=None):
    """Builds ``build(fluid)`` -> fetch vars in each package and runs the
    startup and main programs on the CPU; returns (port, JAX) fetches."""
    out = []
    for fluid in (tfluid, jfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        if fluid is tfluid:
            exe.run(startup, scope=scope)
            out.append([np.asarray(v) for v in exe.run(
                main, feed=feed or {}, fetch_list=fetch, scope=scope)])
        else:
            with fluid.scope_guard(scope):
                exe.run(startup)
                out.append([np.asarray(v) for v in exe.run(
                    main, feed=feed or {}, fetch_list=fetch)])
    return out


def test_tensor_layers_run_in_both_packages():
    x = randn(4, 6)

    def build(fluid):
        layers = fluid.layers
        d = layers.data("x", shape=[6])
        a = layers.assign(d)
        f = layers.fill_constant_batch_size_like(d, [-1, 3], "float32", 2.5)
        r = layers.range(0.0, 7.0, 1.5, "float32")
        ls = layers.linspace(-1.0, 2.0, 7, "float32")
        rev = layers.reverse(d, [1])
        c = layers.crop(d, shape=[2, 4], offsets=[1, 1])
        cs = layers.cumsum(d, axis=1, exclusive=True)
        fin = layers.isfinite(d)
        return [a, f, r, ls, rev, c, cs, fin]

    got, want = run_both(build, {"x": x})
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt", ("npy", "npz"))
def test_load_reads_save_vars_files(tmp_path, fmt):
    value = randn(3, 5)
    name = "w_loaded"
    if fmt == "npy":
        path = os.path.join(tmp_path, name + ".npy")
        np.save(path, value)
    else:
        path = os.path.join(tmp_path, "all.npz")
        np.savez(path, **{name: value, "other": value * 2})

    def build(fluid):
        block = fluid.default_main_program().global_block
        out = block.create_var(name=name, shape=[3, 5], dtype="float32")
        fluid.layers.load(out, path)
        return [out]

    got, want = run_both(build)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], value)


def test_load_reads_the_file_once():
    import tempfile

    value = randn(2, 3)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "v.npy")
        np.save(path, value)
        block = tfluid.Program().global_block
        block.create_var(name="v", shape=[2, 3], dtype="float16")
        op = types.SimpleNamespace(
            type="load", attrs={"file_path": path, "load_as_fp16": True},
            block=block, inputs={}, outputs={"Out": ["v"]})
        trace = types.SimpleNamespace(device=torch.device("cpu"))
        env = {}
        treg.get_op_impl("load")(treg.OpContext(op, env, trace))
        first = env["v"]
        np.save(path, value * 3)
        treg.get_op_impl("load")(treg.OpContext(op, env, trace))
        assert env["v"] is first and first.dtype == torch.float16


@pytest.mark.parametrize("fill", ("load", "numpy_initializer"))
def test_startup_constant_is_a_fresh_parameter_each_run(tmp_path, fill):
    """A parameter that a startup program fills from a kept constant
    (``load``'s file, ``NumpyArrayInitializer``'s ``assign_value``) is a
    tensor of its own: a rows-only Momentum step writes it in place, and
    running the startup program again into a new scope gives the file's
    values again, in another tensor."""
    value = randn(6, 4)
    path = os.path.join(tmp_path, "emb.npy")
    np.save(path, value)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        init = (tfluid.initializer.NumpyArrayInitializer(value)
                if fill == "numpy_initializer" else None)
        i = tfluid.layers.data("i", shape=[1], dtype="int64")
        e = tfluid.layers.embedding(i, size=[6, 4], is_sparse=True,
                                    param_attr=tfluid.ParamAttr(
                                        name="emb", initializer=init))
        loss = tfluid.layers.reduce_sum(e)
        tfluid.optimizer.Momentum(0.5, 0.9).minimize(loss)
    if fill == "load":
        with tfluid.program_guard(startup):
            tfluid.layers.load(startup.global_block.var("emb"), path)
    exe = tfluid.Executor(tfluid.CPUPlace())
    first = tfluid.Scope()
    exe.run(startup, scope=first)
    exe.run(main, feed={"i": np.array([[1], [3], [1]], np.int64)},
            fetch_list=[loss], scope=first)
    trained = first.as_numpy("emb")
    assert not np.array_equal(trained[[1, 3]], value[[1, 3]])
    np.testing.assert_array_equal(trained[[0, 2, 4, 5]], value[[0, 2, 4, 5]])
    second = tfluid.Scope()
    exe.run(startup, scope=second)
    assert second.find_var("emb") is not first.find_var("emb")
    np.testing.assert_array_equal(second.as_numpy("emb"), value)
    np.testing.assert_array_equal(first.as_numpy("emb"), trained)
