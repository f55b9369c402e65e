"""The port's tensor-array ops match the JAX package's.

One program a case, built by both packages and run on the CPU: the six
ops (``create_array``, ``write_to_array``, ``read_from_array``,
``lod_array_length``, ``array_to_tensor``, ``tensor_array_to_tensor``)
through their layers, every fetch equal to the JAX package's in value,
shape and dtype. Held in particular:

* the capacity's edges: a write at the capacity and past it is dropped
  and the count saturates; a read past the count returns the zeros of an
  unwritten slot, a read past the capacity clamps to the last slot, a
  negative index counts from the end; the count after every write;
* the dtypes the JAX ops give whatever the layer declares: the length and
  ``OutIndex`` int32, a row written into a buffer of another dtype cast
  to it (the JAX package holds int64 data as int32);
* ``array_to_tensor`` taken before a later write does not see it (the
  port writes in place where no gradient needs the old buffer);
* an array read inside a training step: the gradients of the rows
  written, as in the JAX package;
* reading a created but never-written array raises in both packages.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def run(fluid, build, feed, steps=1, start=None):
    """``steps`` runs of the program ``build`` makes; returns the fetched
    rows and the state they started from (the startup's, or ``start``)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    if start is None:
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
    else:
        scope = fluid.io.state_from_numpy(main, start, fluid.Scope(),
                                          fluid.CPUPlace())
    state = {n: np.asarray(v) for n, v in scope.vars.items()}
    rows = []
    with fluid.scope_guard(scope):
        for _ in range(steps):
            rows.append([np.asarray(v) for v in exe.run(
                main, feed=feed, fetch_list=fetch)])
    return rows, state


def same_dtype(got, want):
    """The JAX package runs without 64-bit types: what the port holds as
    int64 it holds as int32."""
    return got == want or (want == np.int32 and got == np.int64)


def both(build, feed, steps=1):
    want, start = run(jfluid, build, feed, steps)
    got, _ = run(tfluid, build, feed, steps, start=start)
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert same_dtype(g.dtype, w.dtype) and g.shape == w.shape, \
                (g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    return got


def idx(fluid, i):
    return fluid.layers.fill_constant([1], "int64", i)


def build_edges(fluid):
    L = fluid.layers
    x = L.data("x", [2, 3], append_batch_size=False)
    fetch = []
    arr = L.array_write(x, idx(fluid, 0), capacity=4)
    fetch.append(L.array_length(arr))
    arr = L.array_write(x * 2.0, idx(fluid, 2), array=arr)
    fetch.append(L.array_length(arr))
    arr = L.array_write(x * 3.0, idx(fluid, 4), array=arr)  # at capacity
    fetch.append(L.array_length(arr))
    arr = L.array_write(x * 4.0, idx(fluid, 9), array=arr)  # past it
    fetch.append(L.array_length(arr))
    arr = L.array_write(x * 5.0, idx(fluid, -1), array=arr)  # the last slot
    fetch.append(L.array_length(arr))
    for i in (0, 1, 2, 3, 7, -1, -2):
        fetch.append(L.array_read(arr, idx(fluid, i)))
    stacked, count = L.array_to_tensor(arr)
    fetch += [stacked, count]
    for axis in (0, 1, -1):
        fetch += list(L.tensor_array_to_tensor(arr, axis=axis))
    return fetch


def test_write_read_length_and_the_capacity_edges():
    x = np.random.RandomState(0).randn(2, 3).astype("float32")
    got = both(build_edges, {"x": x})[0]
    lengths = [int(v[0]) for v in got[:5]]
    assert lengths == [1, 3, 4, 4, 4]  # saturated at the capacity
    assert all(v.dtype == np.int32 for v in got[:5])
    reads = got[5:12]
    for r, want in zip(reads, (x, 0 * x, 2 * x, 5 * x, 5 * x, 5 * x,
                               2 * x)):
        np.testing.assert_allclose(r, want, rtol=1e-6)
    stacked, count = got[12:14]
    assert stacked.shape == (4, 2, 3) and count.dtype == np.int32
    np.testing.assert_allclose(stacked, [x, 0 * x, 2 * x, 5 * x], rtol=1e-6)
    cat0, idx0, cat1, idx1, catm, idxm = got[14:20]
    assert cat0.shape == (8, 3) and cat1.shape == (2, 12) == catm.shape
    assert list(idx0) == [2] * 4 and list(idx1) == [3] * 4
    assert idx0.dtype == np.int32


def build_partial(fluid):
    """Two of a capacity of 5 written: the unwritten slots' OutIndex is 0,
    and their rows zeros."""
    L = fluid.layers
    x = L.data("x", [3], append_batch_size=False)
    arr = L.array_write(x, idx(fluid, 0), capacity=5)
    arr = L.array_write(x + 1.0, idx(fluid, 1), array=arr)
    return list(L.tensor_array_to_tensor(arr, axis=0)) + [
        L.array_length(arr), L.array_read(arr, idx(fluid, 4))]


def test_tensor_array_to_tensor_masks_unwritten_slots():
    x = np.arange(3, dtype=np.float32)
    out, out_idx, n, r = both(build_partial, {"x": x})[0]
    assert list(out_idx) == [3, 3, 0, 0, 0] and int(n[0]) == 2
    assert not out[6:].any() and not r.any()


def build_dtypes(fluid):
    """An int32 row into an int64 buffer is cast to it."""
    L = fluid.layers
    ids = L.data("ids", [2, 3], dtype="int64", append_batch_size=False)
    small = L.cast(ids, "int32")
    arr = L.array_write(ids, idx(fluid, 0), capacity=3)
    arr = L.array_write(small, idx(fluid, 1), array=arr)
    stacked, count = L.array_to_tensor(arr)
    return [stacked, count, L.array_read(arr, idx(fluid, 1)),
            L.array_length(arr)]


def test_dtypes_follow_the_jax_ops():
    ids = np.arange(6, dtype=np.int64).reshape(2, 3)
    stacked, count, r, n = both(build_dtypes, {"ids": ids})[0]
    assert stacked.dtype == np.int64 == r.dtype
    assert count.dtype == np.int32 == n.dtype


def build_snapshot(fluid):
    """``array_to_tensor`` before a later write keeps what it saw."""
    L = fluid.layers
    x = L.data("x", [2], append_batch_size=False)
    arr = L.array_write(x, idx(fluid, 0), capacity=2)
    before, _ = L.array_to_tensor(arr)
    arr = L.array_write(x * 7.0, idx(fluid, 1), array=arr)
    after, _ = L.array_to_tensor(arr)
    return [before, after]


def test_array_to_tensor_is_a_snapshot():
    x = np.array([1.0, 2.0], np.float32)
    before, after = both(build_snapshot, {"x": x})[0]
    np.testing.assert_array_equal(before, [x, 0 * x])
    np.testing.assert_array_equal(after, [x, 7 * x])


def build_train(fluid):
    """Rows written from a parameter's fc, read back into the loss: the
    gradient reaches the fc through the buffer."""
    L = fluid.layers
    x = L.data("x", [3, 4], append_batch_size=False)
    h = L.fc(x, size=4)
    arr = L.array_write(h, idx(fluid, 0), capacity=3)
    arr = L.array_write(L.tanh(h), idx(fluid, 1), array=arr)
    arr = L.array_write(h * 3.0, idx(fluid, 5), array=arr)  # dropped
    r0 = L.array_read(arr, idx(fluid, 0))
    r1 = L.array_read(arr, idx(fluid, 1))
    stacked, _ = L.array_to_tensor(arr)
    cat, _ = L.tensor_array_to_tensor(arr, axis=0)
    loss = L.elementwise_add(
        L.elementwise_add(L.mean(r0 * r1), L.mean(stacked)),
        L.mean(cat * cat))
    fluid.optimizer.SGD(0.5).minimize(loss)
    return [loss, "fc_0.w_0@GRAD", "fc_0.b_0@GRAD"]


def test_gradients_through_the_array_match_the_jax_package():
    x = np.random.RandomState(1).randn(3, 4).astype("float32")
    rows = both(build_train, {"x": x}, steps=3)
    assert float(rows[-1][0]) < float(rows[0][0])
    assert np.abs(rows[0][1]).sum() > 0


def build_unwritten(fluid):
    L = fluid.layers
    arr = L.create_array("float32")
    return [L.array_read(arr, idx(fluid, 0))]


def test_reading_an_unwritten_array_raises_in_both():
    for fluid in (jfluid, tfluid):
        with pytest.raises(RuntimeError, match="read_from_array"):
            run(fluid, build_unwritten, {})
