"""The port trains the Transformer as the JAX package does.

The 2-layer Transformer of ``test_torch_program.py`` (dropout 0, label
smoothing 0.1) is built by both packages; the JAX startup program
initialises the weights, which ``io.state_from_numpy`` carries into the
port's scope (torch cannot redraw JAX's threefry). Four Adam steps on one
fixed batch through each ``Executor.run``:

* the losses agree to 1e-5 relative (float32, another summation order);
* the parameters agree to 1e-3 absolute after 4 steps: Adam's first steps
  move a weight by about +-lr (1e-2 here), so a gradient near 0 that rounds
  to the other sign costs one step's width, not more.

With dropout 0.1 the port's masks are its own (torch generators, not
threefry): the loss must stay finite and fall over 10 steps.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtfm
from paddle_tpu_torch.models import transformer as ttfm
from test_torch_program import SMALL, build_transformer

B = 4


def feed_batch(seed=0):
    """The fixed batch of ``bench.py``'s Transformer bench, at test size."""
    rng = np.random.RandomState(seed)
    s, v = SMALL["seq"], SMALL["vocab"]
    return {
        "src": rng.randint(2, v, (B, s)).astype("int64"),
        "trg": rng.randint(2, v, (B, s)).astype("int64"),
        "lbl": rng.randint(2, v, (B, s, 1)).astype("int64"),
        "smask": np.ones((B, s), "float32"),
        "tmask": np.ones((B, s), "float32"),
    }


def test_losses_and_params_match_jax_over_4_adam_steps():
    feed = feed_batch()
    jm, js, jloss = build_transformer(jfluid, jtfm, **SMALL)
    tm, _, tloss = build_transformer(tfluid, ttfm, **SMALL)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(js)
        arrays = {n: np.asarray(v) for n, v in jscope.vars.items()}
        want = [float(jexe.run(jm, feed=feed, fetch_list=[jloss])[0])
                for _ in range(4)]
    tscope = tfluid.io.state_from_numpy(tm, arrays, tfluid.Scope(),
                                        tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(texe.run(tm, feed=feed, fetch_list=[tloss],
                          scope=tscope)[0]) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    params = [p.name for p in tm.all_parameters()]
    assert len(params) == 60
    for n in params:
        np.testing.assert_allclose(tscope.as_numpy(n),
                                   np.asarray(jscope.find_var(n)),
                                   atol=1e-3, err_msg=n)


def test_dropout_training_runs_from_the_ports_startup():
    tm, ts, tloss = build_transformer(tfluid, ttfm, dropout=0.1, **SMALL)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    assert len(scope.vars) == len([v for v in tm.list_vars()
                                   if v.persistable])
    feed = feed_batch(1)
    losses = [float(exe.run(tm, feed=feed, fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(10)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    # test mode turns every dropout off: two runs of a test clone agree
    test_prog = tm.clone(for_test=True)
    a = exe.run(test_prog, feed=feed, fetch_list=[tloss], scope=scope)[0]
    b = exe.run(test_prog, feed=feed, fetch_list=[tloss], scope=scope)[0]
    np.testing.assert_array_equal(a, b)


def test_state_from_numpy_checks_names_and_shapes():
    tm, ts, _ = build_transformer(tfluid, ttfm, **SMALL)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    arrays = {n: scope.as_numpy(n) for n in scope.vars}
    name = sorted(arrays)[0]
    with pytest.raises(KeyError, match=name):
        tfluid.io.state_from_numpy(
            tm, {n: a for n, a in arrays.items() if n != name},
            tfluid.Scope(), tfluid.CPUPlace())
    bad = dict(arrays)
    bad[name] = np.zeros((3,) + arrays[name].shape, arrays[name].dtype)
    with pytest.raises(ValueError, match="shape"):
        tfluid.io.state_from_numpy(tm, bad, tfluid.Scope(), tfluid.CPUPlace())


def test_executor_rejects_other_feed_fetch_var_names():
    exe = tfluid.Executor(tfluid.CPUPlace())
    for kw in ({"feed_var_name": "my_feed"}, {"fetch_var_name": "my_fetch"}):
        with pytest.raises(ValueError, match="feed_var_name"):
            exe.run(tfluid.Program(), **kw)


def test_executor_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfluid.io.state_from_numpy(tfluid.Program(), {})
