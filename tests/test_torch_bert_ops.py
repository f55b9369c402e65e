"""The ops BERT adds to the port match the JAX package's.

``gather``, ``slice``, ``squeeze``/``squeeze2`` and ``tanh`` are built
into one small program by each package and run through each
``Executor`` on the CPU on the same numpy inputs; every output (and
``squeeze2``'s ``XShape``) must match the JAX package's to 1e-6, shapes
included. Then the gradients: a [rows, d] parameter passes through
``gather`` at an index that repeats a row (the bench draws masked
positions per row with ``randint``, so BERT's MLM gather repeats), and
through BERT's pooler chain (``slice`` → ``squeeze`` → ``tanh``), one SGD
step at lr 1 each; the parameter after the step must match the JAX
package's and the numpy gradient (repeated rows summed) to 1e-6.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

X = np.random.RandomState(0).randn(4, 1, 6, 3).astype("float32")

# (axes, starts, ends) of each slice of X
SLICES = [
    ([2], [1], [4]),          # plain
    ([2], [-4], [-1]),        # negative start and end
    ([2], [-100], [100]),     # out of range: clamps to the whole dim
    ([2, 0], [4, 1], [2, 3]),  # start past end: an empty slice
    ([0, 3], [1, -2], [3, 5]),
]
# axes of each squeeze of X: dim 0 is 4 and dim 2 is 6, so each is passed
# over; [] drops every dim of 1
SQUEEZES = [[1], [0, 1], [], [-3], [2]]


def build(fluid, idx_shape):
    main, startup = fluid.Program(), fluid.Program()
    outs = {}
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=list(X.shape),
                              append_batch_size=False)
        flat = fluid.layers.data("flat", shape=[24, 3],
                                 append_batch_size=False)
        idx = fluid.layers.data("idx", shape=idx_shape, dtype="int64",
                                append_batch_size=False)
        outs["gather"] = fluid.layers.gather(flat, idx)
        for i, (axes, starts, ends) in enumerate(SLICES):
            outs["slice%d" % i] = fluid.layers.slice(x, axes, starts, ends)
        for i, axes in enumerate(SQUEEZES):
            outs["squeeze%d" % i] = fluid.layers.squeeze(x, axes)
        blk = main.global_block
        out = blk.create_var(name="sq2_out", dtype="float32")
        xshape = blk.create_var(name="sq2_xshape", dtype="float32")
        blk.append_op("squeeze2", inputs={"X": x},
                      outputs={"Out": out, "XShape": xshape},
                      attrs={"axes": [1]})
        outs["squeeze2"], outs["squeeze2_xshape"] = out, xshape
        outs["tanh"] = fluid.layers.tanh(x)
    return main, outs


IDX = np.array([[3], [0], [3], [-1], [11], [3]], "int64")


def run(fluid, exe, scope_cls):
    main, outs = build(fluid, list(IDX.shape))
    feed = {"x": X, "flat": X.reshape(24, 3), "idx": IDX}
    names = sorted(outs)
    vals = exe.run(main, feed=feed, fetch_list=[outs[n] for n in names],
                   scope=scope_cls())
    shapes = {n: outs[n].shape for n in names}
    return dict(zip(names, vals)), shapes


def test_forward_matches_jax():
    want, want_shapes = run(jfluid, jfluid.Executor(jfluid.CPUPlace()),
                            jfluid.Scope)
    got, got_shapes = run(tfluid, tfluid.Executor(tfluid.CPUPlace()),
                          tfluid.Scope)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # the ops' shape inference sizes each output as the JAX package's does
    assert got_shapes == want_shapes
    assert got["squeeze2"].shape == (4, 6, 3)
    assert got["squeeze2_xshape"].shape == (0,) + X.shape
    assert got["squeeze1"].shape == (4, 6, 3)   # axis 0 (dim 4) passed over
    assert got["slice3"].shape == (2, 1, 0, 3)
    np.testing.assert_array_equal(got["gather"],
                                  X.reshape(24, 3)[IDX.reshape(-1)])


def grad_program(fluid, case):
    """A [rows, d] parameter through ``case``'s ops into sum(out * g), with
    SGD(1.0): one step leaves param - dL/dparam."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        g = fluid.layers.data("g", shape=[-1, 3], append_batch_size=False)
        param = fluid.layers.create_parameter([12, 3], "float32",
                                              name="param")
        if case == "gather":
            idx = fluid.layers.data("idx", shape=[6, 1], dtype="int64",
                                    append_batch_size=False)
            out = fluid.layers.gather(param, idx)
        else:  # BERT's pooler chain on a [batch, seq, d] view
            seq = fluid.layers.reshape(param, [4, 3, 3])
            first = fluid.layers.slice(seq, axes=[1], starts=[0], ends=[1])
            out = fluid.layers.tanh(fluid.layers.squeeze(first, axes=[1]))
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, g))
        fluid.optimizer.SGD(1.0).minimize(loss)
    return main, startup


@pytest.mark.parametrize("case", ["gather", "pooler"])
def test_gradient_matches_jax_and_numpy(case):
    rng = np.random.RandomState(1)
    w0 = rng.randn(12, 3).astype("float32")
    rows = 6 if case == "gather" else 4
    feed = {"g": rng.randn(rows, 3).astype("float32")}
    if case == "gather":
        feed["idx"] = IDX
    want_grad = np.zeros_like(w0)
    if case == "gather":
        np.add.at(want_grad, IDX.reshape(-1), feed["g"])
        assert len(set(IDX.reshape(-1) % 12)) < len(IDX)  # a repeated row
    else:
        first = w0.reshape(4, 3, 3)[:, 0]
        want_grad.reshape(4, 3, 3)[:, 0] = feed["g"] * (1 - np.tanh(first) ** 2)

    jm, js = grad_program(jfluid, case)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        arrays["param"] = w0
        jscope.set_var("param", w0)
        exe.run(jm, feed=feed)
        want = np.asarray(jscope.find_var("param"))

    tm, _ = grad_program(tfluid, case)
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    tfluid.Executor(tfluid.CPUPlace()).run(tm, feed=feed, scope=tscope)
    got = tscope.as_numpy("param")
    np.testing.assert_allclose(want, w0 - want_grad, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
