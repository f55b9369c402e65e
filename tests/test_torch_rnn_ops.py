"""The port's recurrent ops match the JAX package's.

``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``, ``lstm``,
``gru_unit``, ``lstm_unit`` and the aliases ``gru`` and ``lstmp`` run
through each package's registered implementation on the same
``RandomState`` inputs (B = 4, T = 6, H = 5; lengths 6, 1, 0, 3), forward
and backward against one random cotangent, to 1e-5, over ``is_reverse``,
the peepholes, ``origin_mode``, H0/C0 given or not, with and without a
``Length``, and the ``relu``/``sigmoid`` activations of the SRL model.
(``dynamic_rnn``, the ninth op of the family, has its own file.)

``lstm``'s inter-layer dropout draws from each package's own generator,
so it is held to the JAX package at ``dropout_prob`` 0 and by its
statistics here: the keep rate, a fresh mask a layer, the same masks
when a step is run again, and no dropout in test mode.
"""

import types

import numpy as np
import pytest
import torch

from test_torch_sequence_ops import LENGTHS, check_seq, randn

B, T, H = 4, 6, 5


def lstm_inputs(peepholes, h0c0, with_length, d=4 * H, seed=0):
    rng = np.random.RandomState(seed)
    inputs = {"Input": rng.randn(B, T, d).astype(np.float32),
              "Weight": (rng.randn(H, 4 * H) * 0.5).astype(np.float32),
              "Bias": rng.randn(1, (7 if peepholes else 4) * H)
              .astype(np.float32)}
    if h0c0:
        inputs["H0"] = rng.randn(B, H).astype(np.float32)
        inputs["C0"] = rng.randn(B, H).astype(np.float32)
    if with_length:
        inputs["Length"] = LENGTHS
    return inputs


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("h0c0", [True, False])
@pytest.mark.parametrize("peepholes", [True, False])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_lstm(is_reverse, peepholes, h0c0, with_length):
    check_seq("dynamic_lstm", {"use_peepholes": peepholes,
                               "is_reverse": is_reverse},
              lstm_inputs(peepholes, h0c0, with_length),
              {"Hidden": 1, "Cell": 1})


@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_lstm_srl_activations(is_reverse):
    """``candidate_activation="relu"``, ``cell_activation="sigmoid"``
    (``semantic_roles.db_lstm``)."""
    check_seq("dynamic_lstm", {"use_peepholes": True,
                               "is_reverse": is_reverse,
                               "gate_activation": "sigmoid",
                               "cell_activation": "sigmoid",
                               "candidate_activation": "relu"},
              lstm_inputs(True, False, True), {"Hidden": 1, "Cell": 1})


@pytest.mark.parametrize("acts", [("hard_sigmoid", "softsign", "identity"),
                                  ("sigmoid", "relu", "tanh")])
def test_dynamic_lstm_other_activations(acts):
    check_seq("dynamic_lstm", {"use_peepholes": False,
                               "gate_activation": acts[0],
                               "cell_activation": acts[1],
                               "candidate_activation": acts[2]},
              lstm_inputs(False, True, True), {"Hidden": 1, "Cell": 1})


@pytest.mark.parametrize("op_type", ["dynamic_lstmp", "lstmp"])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_lstmp(op_type, is_reverse):
    rng = np.random.RandomState(1)
    p = 3
    inputs = {"Input": rng.randn(B, T, 4 * H).astype(np.float32),
              "Weight": (rng.randn(p, 4 * H) * 0.5).astype(np.float32),
              "ProjWeight": (rng.randn(H, p) * 0.5).astype(np.float32),
              "Bias": rng.randn(1, 4 * H).astype(np.float32),
              "Length": LENGTHS}
    check_seq(op_type, {"is_reverse": is_reverse,
                        "proj_activation": "tanh"}, inputs,
              {"Projection": 1, "Cell": 1})


def gru_inputs(h0, with_length, seed=2):
    rng = np.random.RandomState(seed)
    inputs = {"Input": rng.randn(B, T, 3 * H).astype(np.float32),
              "Weight": (rng.randn(H, 3 * H) * 0.5).astype(np.float32),
              "Bias": rng.randn(1, 3 * H).astype(np.float32)}
    if h0:
        inputs["H0"] = rng.randn(B, H).astype(np.float32)
    if with_length:
        inputs["Length"] = LENGTHS
    return inputs


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("h0", [True, False])
@pytest.mark.parametrize("origin_mode", [False, True])
@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_gru(is_reverse, origin_mode, h0, with_length):
    check_seq("dynamic_gru", {"is_reverse": is_reverse,
                              "origin_mode": origin_mode},
              gru_inputs(h0, with_length), {"Hidden": 1})


def test_gru_alias_and_activations():
    check_seq("gru", {"gate_activation": "hard_sigmoid",
                      "candidate_activation": "relu"},
              gru_inputs(True, True), {"Hidden": 1})


@pytest.mark.parametrize("origin_mode", [False, True])
def test_gru_unit(origin_mode):
    rng = np.random.RandomState(3)
    check_seq("gru_unit", {"origin_mode": origin_mode},
              {"Input": rng.randn(B, 3 * H).astype(np.float32),
               "HiddenPrev": rng.randn(B, H).astype(np.float32),
               "Weight": (rng.randn(H, 3 * H) * 0.5).astype(np.float32),
               "Bias": rng.randn(1, 3 * H).astype(np.float32)},
              {"Hidden": 1})


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit(forget_bias):
    check_seq("lstm_unit", {"forget_bias": forget_bias},
              {"X": randn(B, 4 * H), "C_prev": randn(B, H, seed=1)},
              {"H": 1, "C": 1})


def cudnn_lstm_inputs(layers, dirs, init, with_length, d_in=3, seed=4):
    rng = np.random.RandomState(seed)
    wx, wh, bs = [], [], []
    for layer in range(layers):
        d = d_in if layer == 0 else H * dirs
        for _ in range(dirs):
            wx.append((rng.randn(d, 4 * H) * 0.5).astype(np.float32))
            wh.append((rng.randn(H, 4 * H) * 0.5).astype(np.float32))
            bs.append(rng.randn(4 * H).astype(np.float32))
    inputs = {"Input": rng.randn(B, T, d_in).astype(np.float32),
              "WeightX": wx, "WeightH": wh, "Bias": bs}
    if init:
        inputs["InitH"] = rng.randn(layers * dirs, B, H).astype(np.float32)
        inputs["InitC"] = rng.randn(layers * dirs, B, H).astype(np.float32)
    if with_length:
        inputs["Length"] = LENGTHS
    return inputs


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("layers,bidirec", [(1, False), (2, False),
                                            (2, True)])
def test_lstm(layers, bidirec, init, with_length):
    check_seq("lstm", {"num_layers": layers, "is_bidirec": bidirec,
                       "dropout_prob": 0.0},
              cudnn_lstm_inputs(layers, 2 if bidirec else 1, init,
                                with_length),
              {"Out": 1, "LastH": 1, "LastC": 1})


def run_lstm_op(inputs, attrs, is_test, step=0):
    """The port's ``lstm`` op through a training trace whose generator is
    seeded as the executor seeds it; returns its Out."""
    from paddle_tpu_torch.core.framework import Program
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.executor import TraceContext
    from test_torch_dense_reduce_math import _flat, _torch, fake_op

    outs = {"Out": 1, "LastH": 1, "LastC": 1}
    env = {n: _torch(v) for n, v in _flat(inputs).items()}
    trace = TraceContext(Program(), is_test, torch.device("cpu"), step)
    get_op_impl("lstm")(OpContext(fake_op("lstm", attrs, inputs, outs), env,
                                  trace))
    return env["Out"]


def test_lstm_dropout_by_its_statistics():
    """Between layers a mask keeps 1 - p of the units; the two
    inter-layer masks differ; test mode drops nothing; a step's masks are
    seeded by (seed, step, op), so a rerun of the step draws them again."""
    p = 0.3
    inputs = cudnn_lstm_inputs(3, 1, False, False)
    inputs["Input"] = np.random.RandomState(9).randn(64, 32, 3).astype(
        np.float32)
    attrs = {"num_layers": 3, "is_bidirec": False, "dropout_prob": p}
    calls = []

    def spy(shape, prob, gen, device):
        keep = torch.rand(shape, generator=gen, device=device) >= prob
        calls.append(keep)
        return keep

    from paddle_tpu_torch.ops import rnn_ops

    orig = rnn_ops.keep_mask
    rnn_ops.keep_mask = spy
    try:
        run_lstm_op(inputs, attrs, is_test=False)
        assert len(calls) == 2  # one mask between each pair of layers
        for keep in calls:
            assert abs(float(keep.float().mean()) - (1 - p)) < 0.01
        assert not torch.equal(calls[0], calls[1])
        calls.clear()
        run_lstm_op(inputs, attrs, is_test=True)
        assert not calls
    finally:
        rnn_ops.keep_mask = orig
    # in test mode the op is the JAX package's at dropout 0
    want = run_lstm_op(inputs, dict(attrs, dropout_prob=0.0), is_test=False)
    got = run_lstm_op(inputs, attrs, is_test=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = cudnn_lstm_inputs(2, 1, False, False)
    a = run_lstm_op(one, {"num_layers": 2, "dropout_prob": p}, False, step=1)
    b = run_lstm_op(one, {"num_layers": 2, "dropout_prob": p}, False, step=1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = run_lstm_op(one, {"num_layers": 2, "dropout_prob": p}, False, step=2)
    assert not torch.equal(a, c)


def test_lstm_dropout_zero_draws_nothing():
    ns = types.SimpleNamespace(n=0)
    from paddle_tpu_torch.ops import rnn_ops

    orig = rnn_ops.keep_mask

    def spy(*a):
        ns.n += 1
        return orig(*a)

    rnn_ops.keep_mask = spy
    try:
        run_lstm_op(cudnn_lstm_inputs(2, 1, False, True),
                    {"num_layers": 2, "dropout_prob": 0.0}, False)
    finally:
        rnn_ops.keep_mask = orig
    assert ns.n == 0
