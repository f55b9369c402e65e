"""Detection and dygraph on the card.

* ``imperative.jit_train`` captures a conv + batch norm + fc step as one
  CUDA graph: losses, parameters and running statistics bit-equal to the
  same eager Momentum steps, ``captured`` True;
* under ``jit_train`` dropout's replays draw the masks the same eager
  steps draw;
* ``imperative.jit`` captures a forward, equal to the eager one;
* ``guard()`` with no place puts the tensors on the card;
* ``multiclass_nms`` with ``nms_eta`` < 1 and ``generate_proposals``
  captured in a CUDA graph equal their eager runs and the CPU's;
* ``roi_align``'s and ``yolov3_loss``'s backwards give the same bits on
  two runs.

Every test carries the ``cuda`` marker and skips without a GPU. The file
imports neither ``jax`` nor ``paddle_tpu``:

    python -m pytest tests/test_torch_detection_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu_torch as fluid
from paddle_tpu_torch import imperative
from paddle_tpu_torch.imperative import F, to_variable

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = prev


class _ConvBN(imperative.Layer):
    def __init__(self, name_scope):
        super().__init__(name_scope)
        self._conv = imperative.Conv2D(self.full_name(), 4, 8, 3)
        self._bn = imperative.BatchNorm(self.full_name(), 8, act="relu")
        self._fc = imperative.FC(self.full_name(), 3)

    def forward(self, x):
        return self._fc(self._bn(self._conv(x)))


def _run(xb, yb, state, compiled, steps=4):
    with imperative.guard(seed=3):
        net = _ConvBN("cbn")
        net(to_variable(xb[:2]))
        net.set_state(state)
        opt = fluid.optimizer.Momentum(0.05, 0.9)

        def loss_fn(img, lbl):
            return F.mean(F.softmax_with_cross_entropy(net(img), lbl))

        losses = []
        step = imperative.jit_train(loss_fn, net, opt) if compiled else None
        for _ in range(steps):
            if step is not None:
                losses.append(step(xb, yb).value.clone())
            else:
                loss = loss_fn(to_variable(xb), to_variable(yb))
                loss.backward()
                opt.minimize(loss)
                net.clear_gradients()
                losses.append(loss.value.detach().clone())
        st = {k: v.value.detach().clone() for k, v in net.state_dict().items()}
        return torch.stack(losses), st, getattr(step, "captured", None)


def test_jit_train_is_one_graph_equal_to_eager(cuda):
    rng = np.random.RandomState(0)
    xb = rng.randn(16, 4, 6, 6).astype("float32")
    yb = rng.randint(0, 3, (16, 1)).astype("int64")
    with imperative.guard(seed=1):
        net = _ConvBN("cbn")
        net(to_variable(xb[:2]))
        assert net._conv.weight.value.is_cuda
        state = {k: v.numpy() for k, v in net.state_dict().items()}
    le, se, _ = _run(xb, yb, state, False)
    lj, sj, captured = _run(xb, yb, state, True)
    assert captured is True
    assert torch.equal(le, lj)
    assert se.keys() == sj.keys()
    assert all(torch.equal(se[k], sj[k]) for k in se)


class _DropMLP(imperative.Layer):
    def __init__(self, name_scope):
        super().__init__(name_scope)
        self._fc1 = imperative.FC(self.full_name(), 32, act="relu")
        self._fc2 = imperative.FC(self.full_name(), 3)

    def forward(self, x):
        return self._fc2(F.dropout(self._fc1(x), dropout_prob=0.5))


def test_jit_train_dropout_replays_draw_what_eager_draws(cuda):
    """Dropout draws from the tracer's generator, which ``jit_train``
    registers with its graph: every replay draws the mask the same eager
    step draws, and the masks move on from step to step."""
    rng = np.random.RandomState(4)
    xb = rng.randn(16, 8).astype("float32")
    yb = rng.randint(0, 3, (16, 1)).astype("int64")
    with imperative.guard(seed=1):
        net = _DropMLP("drop")
        net(to_variable(xb[:2]))
        state = {k: v.numpy() for k, v in net.state_dict().items()}

    def run(compiled, steps=6):
        with imperative.guard(seed=9):
            net = _DropMLP("drop")
            net(to_variable(xb[:2]))
            net.set_state(state)
            opt = fluid.optimizer.SGD(0.0)

            def loss_fn(img, lbl):
                return F.mean(F.softmax_with_cross_entropy(net(img), lbl))

            step = imperative.jit_train(loss_fn, net, opt) if compiled \
                else None
            losses = []
            for _ in range(steps):
                if step is not None:
                    losses.append(step(xb, yb).value.clone())
                else:
                    loss = loss_fn(to_variable(xb), to_variable(yb))
                    loss.backward()
                    opt.minimize(loss)
                    net.clear_gradients()
                    losses.append(loss.value.detach().clone())
            return torch.stack(losses), getattr(step, "captured", None)

    le, _ = run(False)
    lj, captured = run(True)
    assert captured is True
    assert torch.equal(le, lj)
    # lr 0 keeps the weights, so only the masks move the loss
    assert len(set(le.tolist())) == len(le)


def test_jit_captures_the_forward(cuda):
    with imperative.guard(seed=3):
        net = _ConvBN("cbn")
        net.eval()
        x = to_variable(np.random.RandomState(1).randn(4, 4, 6, 6)
                        .astype("float32"))
        want = net(x).numpy()
        fast = imperative.jit(net)
        got = fast(x)
        assert fast.captured is True
        np.testing.assert_array_equal(got.numpy(), want)


def _forward(op, attrs, inputs, outs, dev):
    """The port's registered ``op`` on ``inputs`` (tensors on ``dev``)
    with a trace on ``dev``, no gradient: its outputs in ``outs`` order."""
    from types import SimpleNamespace

    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    env = dict(inputs)
    op_ = SimpleNamespace(type=op, attrs=dict(attrs), block=None,
                          inputs={k: [k] for k in inputs},
                          outputs={s: [s] for s in outs})
    get_op_impl(op)(OpContext(op_, env, SimpleNamespace(
        is_test=False, device=dev, program=None)))
    return tuple(env[s] for s in outs)


def test_nms_and_proposals_captured_equal_eager_and_cpu(cuda):
    cases = {c[0]: c for c in chip_smoke.detection_harness_cases()}
    for op in ("multiclass_nms", "generate_proposals"):
        _, inputs, attrs, outs = cases[op]
        names = sorted(inputs)
        cpu_in = [torch.as_tensor(inputs[k]) for k in names]

        def fn(*ts):
            return _forward(op, attrs, dict(zip(names, ts)), outs, cuda)

        card = [t.to(cuda) for t in cpu_in]
        eager = fn(*card)
        graph, captured, _ = chip_smoke.graph_of(fn, card)
        graph.replay()
        torch.cuda.synchronize()
        cpu = _forward(op, attrs, dict(zip(names, cpu_in)), outs,
                       torch.device("cpu"))
        for e, c, w in zip(eager, captured, cpu):
            assert torch.equal(e, c)
            np.testing.assert_allclose(e.cpu().numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_roi_and_yolo_backwards_repeat_their_bits(cuda):
    cases = {c[0]: c for c in chip_smoke.detection_harness_cases()}
    for op in ("roi_align", "roi_perspective_transform", "yolov3_loss"):
        _, inputs, attrs, outs = cases[op]
        grads = []
        for _ in range(2):
            _, g = chip_smoke.registered_op(
                op, attrs, {k: torch.as_tensor(v) for k, v in inputs.items()},
                {s: 1 for s in outs}, cuda)
            grads.append(g["X"])
        assert torch.equal(grads[0], grads[1])
