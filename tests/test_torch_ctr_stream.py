"""DeepFM streamed from MultiSlot shards, on the port and the JAX package.

``bench.py``'s ``bench_deepfm_stream`` chain at ``test_torch_deepfm.py``'s
size (V = 1000, 8 fields, embedding 4, deep layers (16, 16), batch 32,
Adam(1e-3), ``is_sparse``): ``write_ctr_shards`` → ``CTRMultiSlotReader``
→ its ``prefetch(4)`` → ``DevicePrefetcher(capacity=2)`` (the CPU here) →
``run_steps(fetch_every=4)``, from the JAX startup's weights
(``io.state_from_numpy``). The shards hold 8 full batches and a partial
one, so a second captured step resolves at the end. The losses agree with
the JAX package's same chain to 1e-5 relative, the state to rtol 1e-4 and
atol 1e-6 (``test_torch_deepfm.py``'s tolerances), and the stream equals a
list of the reader's batches on the port bit for bit.

``AsyncExecutor(thread_num=1)`` trains the same model from a
``DataFeedDesc`` of three slots (``ids`` sparse, 8 a line, ``dense``,
``label``) as the JAX package's does, and ``merge_selected_rows`` /
``get_tensor_from_selected_rows`` give the JAX ops' outputs on a
gradient with duplicate ids.
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import data as jdata
from paddle_tpu.flags import set_flag
from paddle_tpu.models import deepfm as jdfm
from paddle_tpu.reader import DevicePrefetcher as JPrefetcher
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch.models import deepfm as tdfm
from paddle_tpu_torch.reader import DevicePrefetcher

V, FIELDS, EMB, LAYERS, B, DENSE = 1000, 8, 4, (16, 16), 32, 13
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _scatter_path():
    set_flag("sparse_update_kernel", "off")
    yield
    set_flag("sparse_update_kernel", "auto")


def build(fluid, dfm):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", shape=[FIELDS], dtype="int64")
        dense = fluid.layers.data("dense", shape=[DENSE])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        _, loss, auc = dfm.deepfm(ids, dense, label, sparse_feature_dim=V,
                                  embedding_size=EMB, num_fields=FIELDS,
                                  layer_sizes=LAYERS, is_sparse=True)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss, auc


def jax_start(js):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    return scope, {n: np.asarray(v) for n, v in scope.vars.items()}


def reader(mod, paths):
    return mod.CTRMultiSlotReader(paths, batch_size=B, num_fields=FIELDS,
                                  dense_dim=DENSE, vocab=V, epochs=1,
                                  drop_remainder=False)


def assert_state(tm, jscope, tscope):
    for n in sorted(v.name for v in tm.list_vars() if v.persistable):
        np.testing.assert_allclose(tscope.as_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def test_streamed_deepfm_matches_jax(tmp_path):
    paths = tdata.write_ctr_shards(str(tmp_path), 8 * B + 12, n_shards=3,
                                   num_fields=FIELDS, dense_dim=DENSE,
                                   vocab=V)
    jm, js, jloss, jauc = build(jfluid, jdfm)
    jscope, arrays = jax_start(js)
    with jfluid.scope_guard(jscope):
        feeds = JPrefetcher(reader(jdata, paths).prefetch(4), capacity=2)
        want = jfluid.Executor(jfluid.CPUPlace()).run_steps(
            jm, feeds, fetch_list=[jloss, jauc], fetch_every=4)

    tm, _, tloss, tauc = build(tfluid, tdfm)
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(), CPU)
    exe = tfluid.Executor(CPU)
    rd = reader(tdata, paths)
    pf = DevicePrefetcher(rd.prefetch(4), capacity=2, device="cpu")
    got = exe.run_steps(tm, pf, fetch_list=[tloss, tauc], fetch_every=4,
                        scope=tscope)
    assert pf._stop.is_set()  # run_steps started it, and stopped it
    assert len(got) == len(want) == 9 and rd.records_read == 8 * B + 12
    assert sorted(cap.sig[0][1] for cap in exe._captured.values()) == \
        [(12, 13), (B, 13)]
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=1e-5)
    np.testing.assert_allclose([float(g[1]) for g in got],
                               [float(w[1]) for w in want], rtol=1e-6)
    assert_state(tm, jscope, tscope)

    # the stream equals a list of the same batches, bit for bit
    lscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(), CPU)
    listed = tfluid.Executor(CPU).run_steps(
        tm, list(reader(tdata, paths)), fetch_list=[tloss, tauc],
        fetch_every=4, scope=lscope)
    assert [float(r[0]) for r in listed] == [float(g[0]) for g in got]


def async_files(tmp_path, files=2, lines=2 * B):
    rng = np.random.RandomState(0)
    out = []
    for i in range(files):
        p = str(tmp_path / ("part-%d" % i))
        with open(p, "w") as f:
            for _ in range(lines):
                ids = rng.randint(0, V, FIELDS)
                dense = rng.rand(DENSE)
                f.write("%d %s %d %s 1 %d\n" % (
                    FIELDS, " ".join(map(str, ids)), DENSE,
                    " ".join("%.6f" % v for v in dense), rng.randint(0, 2)))
        out.append(p)
    proto = str(tmp_path / "feed.proto")
    with open(proto, "w") as f:
        f.write('name: "MultiSlotDataFeed"\nbatch_size: %d\n'
                'multi_slot_desc {\n'
                '  slots { name: "ids" type: "uint64" is_dense: false '
                'is_used: true }\n'
                '  slots { name: "dense" type: "float" is_dense: true '
                'is_used: true dense_dim: %d }\n'
                '  slots { name: "label" type: "uint64" is_dense: true '
                'is_used: true }\n}\n' % (B, DENSE))
    return out, proto


def test_async_executor_matches_jax(tmp_path):
    files, proto = async_files(tmp_path)
    jm, js, jloss, _ = build(jfluid, jdfm)
    jscope, arrays = jax_start(js)
    with jfluid.scope_guard(jscope):
        want = jfluid.AsyncExecutor(jfluid.CPUPlace()).run(
            jm, jfluid.DataFeedDesc(proto), files, thread_num=1,
            fetch=[jloss.name])
    tm, _, tloss, _ = build(tfluid, tdfm)
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(), CPU)
    with tfluid.scope_guard(tscope):
        got = tfluid.AsyncExecutor(CPU).run(
            tm, tfluid.DataFeedDesc(proto), files, thread_num=1,
            fetch=tloss.name)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose([float(np.asarray(g[0])) for g in got],
                               [float(np.asarray(w[0])) for w in want],
                               rtol=1e-5)
    assert_state(tm, jscope, tscope)


def test_async_executor_errors_and_place(tmp_path):
    files, proto = async_files(tmp_path, files=1, lines=4)
    with open(files[0], "a") as f:
        f.write("3 1 2\n")
    tm, startup, tloss, _ = build(tfluid, tdfm)
    scope = tfluid.Scope()
    tfluid.Executor(CPU).run(startup, scope=scope)
    with tfluid.scope_guard(scope), \
            pytest.raises(ValueError, match="declares 3 values"):
        tfluid.AsyncExecutor(CPU).run(tm, tfluid.DataFeedDesc(proto), files,
                                      thread_num=2, fetch=[tloss])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tfluid.AsyncExecutor()


def selected_rows(mod_registry, sparse, ids, rows):
    env = {"X": sparse.SparseGrad(ids, rows)}
    trace = types.SimpleNamespace(is_test=False, device=torch.device("cpu"),
                                  program=None)
    for op_type, src, dst in (("merge_selected_rows", "X", "M"),
                              ("get_tensor_from_selected_rows", "M", "T")):
        op = types.SimpleNamespace(type=op_type, attrs={}, block=None,
                                   inputs={"X": [src]},
                                   outputs={"Out": [dst]})
        mod_registry.get_op_impl(op_type)(mod_registry.OpContext(op, env,
                                                                 trace))
    return np.asarray(env["M"].ids), np.asarray(env["T"])


def test_selected_rows_ops_match_jax():
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core import sparse as jsparse
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core import sparse as tsparse

    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, 200).astype(np.int64)  # many duplicates
    rows = rng.randn(200, EMB).astype(np.float32)
    want_ids, want = selected_rows(jreg, jsparse, jnp.asarray(ids),
                                   jnp.asarray(rows))
    got_ids, got = selected_rows(treg, tsparse, torch.from_numpy(ids),
                                 torch.from_numpy(rows))
    np.testing.assert_array_equal(got_ids, want_ids.astype(np.int64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    n = len(np.unique(ids))
    assert (got_ids[n:] == 2**31 - 1).all() and (got[n:] == 0).all()
    for op_type in ("merge_selected_rows", "get_tensor_from_selected_rows"):
        op = types.SimpleNamespace(type=op_type, attrs={}, block=None,
                                   inputs={"X": ["X"]},
                                   outputs={"Out": ["O"]})
        with pytest.raises(TypeError, match="SelectedRows"):
            treg.get_op_impl(op_type)(treg.OpContext(
                op, {"X": torch.zeros(3)}, None))


def test_selected_rows_layers_run_in_a_program():
    """The front ends build and the ops run on an ``is_sparse`` table's
    rows-only gradient after the optimizer step."""
    main, startup, loss, _ = build(tfluid, tdfm)
    with tfluid.program_guard(main, startup):
        g = main.global_block.var("sparse_emb@GRAD")
        merged = tfluid.layers.merge_selected_rows(g)
        dense = tfluid.layers.get_tensor_from_selected_rows(merged)
        raw = tfluid.layers.get_tensor_from_selected_rows(g)
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 20, (B, FIELDS)).astype("int64"),
            "dense": rng.rand(B, DENSE).astype("float32"),
            "label": rng.randint(0, 2, (B, 1)).astype("int64")}
    d, r = exe.run(main, feed=feed, fetch_list=[dense, raw], scope=scope)
    assert r.shape == (B * FIELDS, EMB) and d.shape == r.shape
    np.testing.assert_allclose(d.sum(0), r.sum(0), rtol=1e-5, atol=1e-6)
