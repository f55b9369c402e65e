"""The sequence and recurrent ops and DynamicRNN on the card.

Each recurrent op (``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``,
``lstm``, ``gru_unit``, ``lstm_unit``), the CRF pair and a few sequence
ops run on the card against the same call on the CPU, forward and
backward (1e-5 norm-wise in float32, integer outputs identical), and
under ``torch.cuda.set_sync_debug_mode("error")``: none reads a device
value on the host, so a captured step can hold them. A DynamicRNN
program with a dropout inside its block trains on the card as on the CPU,
and its captured steps (``run_steps``: a CUDA graph) equal its eager steps
bit for bit, masks included. Every test carries the ``cuda`` marker and
skips without a GPU. The file imports neither ``jax`` nor
``paddle_tpu``:

    python -m pytest tests/test_torch_sequence_cuda.py -m cuda --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.registry import OpContext, get_op_impl

pytestmark = pytest.mark.cuda

B, T, H = 16, 40, 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def to_env(inputs, dev):
    """({slot: [names]}, {name: tensor on dev}); the float ones are
    leaves that require grad."""
    names, env = {}, {}
    for slot, v in inputs.items():
        vs = v if isinstance(v, list) else [v]
        names[slot] = ["%s%d" % (slot, i) for i in range(len(vs))]
        for n, a in zip(names[slot], vs):
            t = torch.as_tensor(a).to(dev)
            env[n] = t.requires_grad_(True) if t.is_floating_point() else t
    return names, env


def run_op(op_type, attrs, inputs, outs, dev, cots=None):
    """The registered op on ``inputs`` ({slot: array or [arrays]}) on
    ``dev``, or on a ``to_env`` pair already there; returns ({out:
    tensor}, {input: grad}) with the gradients of the float inputs against
    the cotangents of the float outputs: seeded ones copied from the host,
    or with ``cots="ones"`` made on the device."""
    names, env = to_env(inputs, dev) if isinstance(inputs, dict) \
        else inputs
    env = dict(env)
    op = types.SimpleNamespace(type=op_type, attrs=dict(attrs), block=None,
                               inputs=names, outputs={s: [s] for s in outs})
    trace = types.SimpleNamespace(is_test=False, device=dev, program=None)
    leaves = {n: t for n, t in env.items() if t.requires_grad}
    get_op_impl(op_type)(OpContext(op, env, trace))
    got = {s: env[s] for s in outs if s in env}
    fl = [s for s, t in got.items() if t.is_floating_point()
          and t.requires_grad]
    if cots == "ones":
        cot = [torch.ones_like(got[s]) for s in fl]
    else:
        rng = np.random.RandomState(1)
        cot = [torch.as_tensor(rng.randn(*got[s].shape).astype(np.float32))
               .to(dev) for s in fl]
    gs = torch.autograd.grad([got[s] for s in fl], list(leaves.values()),
                             cot, allow_unused=True) if fl else []
    return got, {n: g for n, g in zip(leaves, gs) if g is not None}


def norm_err(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def lengths():
    return np.random.RandomState(5).randint(0, T + 1, B).astype(np.int64)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


CASES = {
    "dynamic_lstm": ({"use_peepholes": True, "is_reverse": True},
                     {"Input": rnd(B, T, 4 * H), "Weight":
                      rnd(H, 4 * H, seed=1, scale=0.2),
                      "Bias": rnd(1, 7 * H, seed=2), "Length": lengths()},
                     ["Hidden", "Cell"]),
    "dynamic_lstm_srl": ({"use_peepholes": True,
                          "candidate_activation": "relu",
                          "cell_activation": "sigmoid"},
                         {"Input": rnd(B, T, 4 * H), "Weight":
                          rnd(H, 4 * H, seed=1, scale=0.2),
                          "Bias": rnd(1, 7 * H, seed=2),
                          "H0": rnd(B, H, seed=3), "C0": rnd(B, H, seed=4),
                          "Length": lengths()}, ["Hidden", "Cell"]),
    "dynamic_lstmp": ({"is_reverse": False},
                      {"Input": rnd(B, T, 4 * H), "Weight":
                       rnd(8, 4 * H, seed=1, scale=0.2),
                       "ProjWeight": rnd(H, 8, seed=3, scale=0.2),
                       "Bias": rnd(1, 4 * H, seed=2), "Length": lengths()},
                      ["Projection", "Cell"]),
    "dynamic_gru": ({"is_reverse": True, "origin_mode": True},
                    {"Input": rnd(B, T, 3 * H), "Weight":
                     rnd(H, 3 * H, seed=1, scale=0.2),
                     "Bias": rnd(1, 3 * H, seed=2), "H0": rnd(B, H, seed=3),
                     "Length": lengths()}, ["Hidden"]),
    "lstm": ({"num_layers": 2, "is_bidirec": True, "dropout_prob": 0.0},
             {"Input": rnd(B, T, 8),
              "WeightX": [rnd(8, 4 * H, seed=1, scale=0.2),
                          rnd(8, 4 * H, seed=2, scale=0.2),
                          rnd(2 * H, 4 * H, seed=3, scale=0.2),
                          rnd(2 * H, 4 * H, seed=4, scale=0.2)],
              "WeightH": [rnd(H, 4 * H, seed=5 + i, scale=0.2)
                          for i in range(4)],
              "Bias": [rnd(4 * H, seed=9 + i) for i in range(4)],
              "Length": lengths()}, ["Out", "LastH", "LastC"]),
    "gru_unit": ({}, {"Input": rnd(B, 3 * H), "HiddenPrev": rnd(B, H, seed=1),
                      "Weight": rnd(H, 3 * H, seed=2, scale=0.2),
                      "Bias": rnd(1, 3 * H, seed=3)}, ["Hidden"]),
    "lstm_unit": ({"forget_bias": 1.0},
                  {"X": rnd(B, 4 * H), "C_prev": rnd(B, H, seed=1)},
                  ["H", "C"]),
    "linear_chain_crf": ({}, {"Emission": rnd(B, T, 12),
                              "Transition": rnd(14, 12, seed=1, scale=0.3),
                              "Label": np.random.RandomState(2).randint(
                                  0, 12, (B, T)), "Length": lengths()},
                         ["LogLikelihood"]),
    "crf_decoding": ({}, {"Emission": rnd(B, T, 12),
                          "Transition": rnd(14, 12, seed=1, scale=0.3),
                          "Length": lengths()}, ["ViterbiPath"]),
    "sequence_pool": ({"pooltype": "max"}, {"X": rnd(B, T, H),
                                            "Length": lengths()}, ["Out"]),
    "sequence_conv": ({"contextLength": 3, "contextStart": -1},
                      {"X": rnd(B, T, H), "Filter": rnd(3 * H, 8, seed=1),
                       "Length": lengths()}, ["Out"]),
    "sequence_mask": ({"maxlen": T, "out_dtype": "float32"},
                      {"X": lengths()}, ["Y"]),
}


def _op_type(case):
    return "dynamic_lstm" if case.startswith("dynamic_lstm_") else case


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_equals_cpu(cuda, case):
    attrs, inputs, outs = CASES[case]
    got, g_grads = run_op(_op_type(case), attrs, inputs, outs, cuda)
    want, w_grads = run_op(_op_type(case), attrs, inputs, outs,
                           torch.device("cpu"))
    for s in outs:
        assert got[s].device.type == "cuda"
        if want[s].is_floating_point():
            assert norm_err(got[s], want[s]) <= 1e-5, (s, norm_err(
                got[s], want[s]))
        else:
            assert torch.equal(got[s].cpu(), want[s]), s
    assert set(g_grads) == set(w_grads)
    for n in w_grads:
        assert norm_err(g_grads[n], w_grads[n]) <= 1e-5, n


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_host_sync_forward_or_backward(cuda, case):
    attrs, inputs, outs = CASES[case]
    on_card = to_env(inputs, cuda)
    run_op(_op_type(case), attrs, on_card, outs, cuda, "ones")  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_op(_op_type(case), attrs, on_card, outs, cuda, "ones")
    finally:
        torch.cuda.set_sync_debug_mode(0)


TD, D, S = 12, 6, 4


def build_drnn(dropout):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", shape=[TD, D])
        length = fluid.layers.data("length", shape=[], dtype="int64")
        s = fluid.layers.data("s", shape=[S])
        drnn = fluid.layers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, length=length)
            st = drnn.static_input(s)
            prev = drnn.memory(shape=[H], value=0.0)
            h = fluid.layers.fc([x_t, prev, st], size=H, act="tanh")
            h = fluid.layers.dropout(h, dropout_prob=dropout,
                                     dropout_implementation="upscale_in_train")
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, out))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss, out


def drnn_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, TD, D).astype(np.float32),
            "length": rng.randint(1, TD + 1, B).astype(np.int64),
            "s": rng.randn(B, S).astype(np.float32)}


def start_state(main, startup):
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)
    return {n: init.as_numpy(n) for n in init.vars}


def test_dynamic_rnn_card_equals_cpu(cuda):
    main, startup, loss, _ = build_drnn(0.0)
    arrays = start_state(main, startup)
    losses = {}
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), place)
        exe = fluid.Executor(place)
        main._tpu_step_counter = 0
        losses[str(place)] = [float(exe.run(main, feed=drnn_feed(),
                                            fetch_list=[loss],
                                            scope=scope)[0])
                              for _ in range(4)]
    cpu, card = losses.values()
    assert card[-1] < card[0]
    np.testing.assert_allclose(card, cpu, rtol=1e-5)


def test_dynamic_rnn_captured_equals_eager_with_dropout(cuda):
    main, startup, loss, out = build_drnn(0.3)
    arrays = start_state(main, startup)
    dev = fluid.CUDAPlace(0)
    exe = fluid.Executor(dev)
    feeds = [drnn_feed(i) for i in range(5)]
    s_e = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), dev)
    main._tpu_step_counter = 0
    eager = [[np.asarray(v) for v in exe.run(main, feed=f,
                                             fetch_list=[loss, out],
                                             scope=s_e)] for f in feeds]
    s_c = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), dev)
    main._tpu_step_counter = 0
    exe_c = fluid.Executor(dev)
    rows = exe_c.run_steps(main, feeds, fetch_list=[loss, out], scope=s_c)
    from paddle_tpu_torch.monitor import metrics

    assert metrics.CAPTURES.value >= 1
    for e, c in zip(eager, rows):
        np.testing.assert_array_equal(np.asarray(c[0]), e[0])
        np.testing.assert_array_equal(np.asarray(c[1]), e[1])  # the masks
    for n in arrays:
        assert torch.equal(s_c.find_var(n), s_e.find_var(n)), n
    exe_c.close()
    # the masks differ between timesteps and steps
    drop = eager[0][1][0] == 0.0
    assert 0.1 < drop.mean() < 0.5
    assert not np.array_equal(eager[0][1] == 0.0, eager[1][1] == 0.0)


def test_dynamic_rnn_eager_step_syncs_nothing(cuda):
    main, startup, loss, _ = build_drnn(0.3)
    arrays = start_state(main, startup)
    dev = fluid.CUDAPlace(0)
    scope = fluid.io.state_from_numpy(main, arrays, fluid.Scope(), dev)
    exe = fluid.Executor(dev)
    feed = {k: torch.as_tensor(v, device=cuda)
            for k, v in drnn_feed().items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                return_numpy=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
