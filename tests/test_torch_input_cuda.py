"""The input pipeline on the card.

``DevicePrefetcher()`` copies each feed to the card on its own stream from
a ring of pinned buffers; the consumer's stream waits for the copy, so
every batch arrives with the bytes it left the host with, also when the
ring's buffers are refilled while earlier batches are still held and when
a feed's shape changes from batch to batch. A
``run_steps`` fed by a live prefetcher captures its step and replays it
(the capture holds the prefetcher's CUDA work off), with losses equal to
the same batches given as a list. A ``py_reader`` with
``use_double_buffer`` prefetches to the card by default. Every test
carries the ``cuda`` marker and skips without a GPU. The file imports
neither ``jax`` nor ``paddle_tpu``:

    python -m pytest tests/test_torch_input_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.monitor import metrics
from paddle_tpu_torch.reader import DevicePrefetcher
from paddle_tpu_torch.reader.prefetcher import RING_SLOTS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", torch.cuda.current_device())


def feeds(n, seed=0, rows=256):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(rows, 16).astype("float32"),
             "y": rng.randint(0, 4, (rows, 1)).astype("int64")}
            for _ in range(n)]


def test_prefetcher_delivers_every_batch_byte_for_byte(cuda):
    src = feeds(4 * RING_SLOTS + 1)
    got = list(DevicePrefetcher(iter(src), capacity=2))
    assert len(got) == len(src)
    for g, s in zip(got, src):
        for k in s:
            assert g[k].device == cuda and g[k].dtype == \
                torch.from_numpy(s[k]).dtype
            assert g[k].cpu().numpy().tobytes() == s[k].tobytes()


def test_prefetcher_keeps_feeds_whose_shape_changes(cuda):
    """A feed whose shape changes batch to batch (a padded sparse slot)
    reuses the ring's buffers, grown when a batch needs more bytes."""
    rng = np.random.RandomState(1)
    src = [{"ids": rng.randint(0, 9, (8, n)).astype("int64"),
            "mask": rng.rand(n) > 0.5} for n in (3, 7, 2, 7, 11, 1, 0, 5)]
    pf = DevicePrefetcher(iter(src), capacity=3)
    got = list(pf)
    for g, s in zip(got, src):
        for k in s:
            assert g[k].cpu().numpy().tobytes() == s[k].tobytes()
            assert tuple(g[k].shape) == s[k].shape


def test_prefetcher_reraises_and_stops_on_the_card(cuda):
    def bad():
        yield feeds(1)[0]
        raise OSError("shard unreadable")

    it = iter(DevicePrefetcher(bad()))
    next(it)
    with pytest.raises(OSError, match="shard unreadable"):
        next(it)
    with DevicePrefetcher(iter(feeds(20)), capacity=1) as pf:
        next(iter(pf))
    assert not pf._thread.is_alive()


def mlp(fluid_, via_reader=False):
    main, startup = fluid_.Program(), fluid_.Program()
    with fluid_.program_guard(main, startup), fluid_.unique_name.guard():
        reader = None
        if via_reader:
            reader = fluid_.layers.py_reader(
                capacity=4, shapes=[[-1, 16], [-1, 1]],
                dtypes=["float32", "int64"])
            x, y = fluid_.layers.read_file(reader)
        else:
            x = fluid_.layers.data("x", shape=[16])
            y = fluid_.layers.data("y", shape=[1], dtype="int64")
        h = fluid_.layers.fc(x, 64, act="relu")
        loss = fluid_.layers.mean(fluid_.layers.softmax_with_cross_entropy(
            fluid_.layers.fc(h, 4), y))
        fluid_.optimizer.SGD(0.1).minimize(loss)
    return main, startup, reader, loss


def clone(scope):
    out = fluid.Scope()
    for k, v in scope.vars.items():
        out.set_var(k, v.clone())
    return out


def test_run_steps_captures_with_a_live_prefetcher(cuda):
    main, startup, _, loss = mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    start = clone(scope)
    src = feeds(12)
    caps0, reps0 = metrics.CAPTURES.value, metrics.REPLAYS.value
    got = exe.run_steps(main, DevicePrefetcher(iter(src), capacity=2),
                        fetch_list=[loss], fetch_every=4, scope=scope)
    assert (metrics.CAPTURES.value - caps0, metrics.REPLAYS.value - reps0) \
        == (1, 10)
    exe2 = fluid.Executor()
    want = exe2.run_steps(main, src, fetch_list=[loss], fetch_every=4,
                          scope=start)
    assert [float(r[0]) for r in got] == [float(r[0]) for r in want]
    exe.close()
    exe2.close()


def test_py_reader_prefetches_to_the_card(cuda):
    main, startup, reader, loss = mlp(fluid, via_reader=True)
    src = feeds(5)
    reader.decorate_tensor_provider(lambda: ((f["x"], f["y"]) for f in src))
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    start = clone(scope)
    reader.start()
    assert reader._prefetcher.device == cuda
    got = []
    with pytest.raises(fluid.EOFException):
        while True:
            got.append(float(exe.run(main, fetch_list=[loss],
                                     scope=scope)[0]))
    reader.reset()
    x, y = reader.var_names
    want = [float(exe.run(main, feed={x: f["x"], y: f["y"]},
                          fetch_list=[loss], scope=start)[0]) for f in src]
    assert got == want
