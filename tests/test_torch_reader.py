"""The port's readers, DataFeeder, datasets and DevicePrefetcher.

Every reader decorator, ``DataFeeder`` (ragged examples padded, masks,
the label column reshaped to [N, 1]) and every ``dataset`` reader gives
what the JAX package's gives on the same seeded input. The
``DevicePrefetcher`` keeps the JAX package's contract on the CPU
(``device="cpu"``): order, the worker's traceback in the consumer,
``stop()`` unblocking a worker on a full queue, re-iteration after
exhaustion, the context manager; ``DevicePrefetcher()`` means the card and
raises without one.
"""

import itertools
import threading
import traceback

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import reader as jreader
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.reader import DevicePrefetcher


def source(n=23, seed=0):
    def r():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield (i, rng.randn(3).astype("float32"))
    return r


def same(a, b):
    """Equal nested structures of ints, floats, tuples, lists, arrays."""
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b and type(a) is type(b)


def decorated(mod, name):
    src = source()
    other = source(seed=1)
    return {
        "map_readers": lambda: mod.map_readers(
            lambda x, y: (x[0] + y[0], x[1] * y[1]), src, other),
        "shuffle": lambda: mod.shuffle(src, 5, seed=3),
        "shuffle_whole": lambda: mod.shuffle(src, 100, seed=7),
        "chain": lambda: mod.chain(src, mod.firstn(other, 4)),
        "compose": lambda: mod.compose(src, other),
        "compose_unaligned": lambda: mod.compose(
            src, mod.firstn(other, 5), check_alignment=False),
        "batch": lambda: mod.batch(src, 4),
        "batch_drop_last": lambda: mod.batch(src, 4, drop_last=True),
        "buffered": lambda: mod.buffered(src, 3),
        "firstn": lambda: mod.firstn(src, 7),
        "cache": lambda: mod.cache(src),
        "xmap_ordered": lambda: mod.xmap_readers(
            lambda e: (e[0] * 2, e[1] + 1), src, 3, 4, order=True),
    }[name]()


@pytest.mark.parametrize("name", [
    "map_readers", "shuffle", "shuffle_whole", "chain", "compose",
    "compose_unaligned", "batch", "batch_drop_last", "buffered", "firstn",
    "cache", "xmap_ordered"])
def test_decorator_matches_jax(name):
    want = list(decorated(jreader, name)())
    got = list(decorated(treader, name)())
    assert same(got, want)
    assert same(list(decorated(treader, name)()), got)  # a second pass


def test_xmap_unordered_is_a_permutation():
    def xr(mod):
        return mod.xmap_readers(lambda e: e[0] * 2, source(), 4, 2)

    assert sorted(xr(treader)()) == sorted(xr(jreader)()) \
        == [2 * i for i in range(23)]


def test_compose_checks_alignment():
    r = treader.compose(source(), treader.firstn(source(), 5))
    with pytest.raises(RuntimeError, match="different lengths"):
        list(r())


def test_cache_reads_its_source_once():
    calls = []

    def src():
        calls.append(1)
        return iter(range(5))

    c = treader.cache(src)
    assert list(c()) == list(c()) == list(range(5)) and len(calls) == 1


def feeder_vars(fluid):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        words = fluid.layers.data("words", shape=[1], dtype="int64",
                                  lod_level=1)
        img = fluid.layers.data("img", shape=[4])
        label = fluid.layers.data("label", shape=[1], dtype="int64")
    return [words, img, label]


def feeder_rows(ragged=True):
    rng = np.random.RandomState(0)
    rows = []
    for i in range(6):
        n = 1 + i % 4 if ragged else 3
        rows.append((rng.randint(0, 50, n).tolist(),
                     rng.randn(4).astype("float32"), int(rng.randint(10))))
    return rows


@pytest.mark.parametrize("pad,masks,ragged", [
    (True, True, True), (True, False, True), (False, False, False)])
def test_data_feeder_matches_jax(pad, masks, ragged):
    rows = feeder_rows(ragged)
    want = jfluid.DataFeeder(feeder_vars(jfluid), jfluid.CPUPlace(),
                             pad_sequences=pad, emit_masks=masks).feed(rows)
    got = tfluid.DataFeeder(feeder_vars(tfluid), tfluid.CPUPlace(),
                            pad_sequences=pad, emit_masks=masks).feed(rows)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and np.array_equal(got[k], want[k]), k
    assert got["label"].shape == (6, 1)
    assert ("words_mask" in got) == (pad and masks)


def test_data_feeder_errors():
    feeder = tfluid.DataFeeder(feeder_vars(tfluid))
    with pytest.raises(ValueError, match="pad_sequences=True"):
        feeder.feed(feeder_rows())
    with pytest.raises(ValueError, match="empty minibatch"):
        feeder.feed([])


DATASETS = {
    "mnist.train": lambda d: d.mnist.train(),
    "mnist.test": lambda d: d.mnist.test(),
    "cifar.train10": lambda d: d.cifar.train10(),
    "cifar.test100": lambda d: d.cifar.test100(),
    "uci_housing.train": lambda d: d.uci_housing.train(),
    "imdb.train": lambda d: d.imdb.train(),
    "imikolov.train": lambda d: d.imikolov.train(n=5),
    "conll05.test": lambda d: d.conll05.test(),
    "wmt16.train": lambda d: d.wmt16.train(),
    "movielens.test": lambda d: d.movielens.test(),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_reader_matches_jax(name):
    want = list(itertools.islice(DATASETS[name](jfluid.dataset)(), 40))
    got = list(itertools.islice(DATASETS[name](tfluid.dataset)(), 40))
    assert len(got) == 40 and same(got, want)


def test_dataset_sizes_and_dicts():
    assert sum(1 for _ in tfluid.dataset.mnist.train()()) == 8192
    assert sum(1 for _ in tfluid.dataset.uci_housing.test()()) == 102
    assert tfluid.dataset.imdb.word_dict() == jfluid.dataset.imdb.word_dict()
    assert tfluid.dataset.conll05.get_dict() == \
        jfluid.dataset.conll05.get_dict()
    assert tfluid.dataset.movielens.max_movie_id() == \
        jfluid.dataset.movielens.max_movie_id()


def feeds(n=7):
    return [{"x": np.full((2, 3), i, "float32"), "y": np.arange(i, i + 2)}
            for i in range(n)]


def test_prefetcher_keeps_order_on_the_cpu():
    got = list(DevicePrefetcher(iter(feeds()), capacity=2, device="cpu"))
    assert len(got) == 7
    for i, f in enumerate(got):
        assert isinstance(f["x"], torch.Tensor) and f["x"].device.type \
            == "cpu"
        assert torch.equal(f["x"], torch.full((2, 3), float(i)))
        assert f["y"].tolist() == [i, i + 1]


def test_prefetcher_hands_over_copies():
    src = feeds(2)
    got = list(DevicePrefetcher(iter(src), device="cpu"))
    src[0]["x"][...] = -1
    assert float(got[0]["x"][0, 0]) == 0.0


def test_prefetcher_reraises_with_the_worker_traceback():
    def bad():
        yield feeds(1)[0]
        raise OSError("shard unreadable")

    pf = DevicePrefetcher(bad(), device="cpu")
    it = iter(pf)
    next(it)
    with pytest.raises(OSError, match="shard unreadable") as info:
        next(it)
    frames = "".join(traceback.format_tb(info.value.__traceback__))
    assert "in bad" in frames


def test_prefetcher_stop_unblocks_a_worker_on_a_full_queue():
    produced = []

    def endless():
        for i in itertools.count():
            produced.append(i)
            yield {"x": np.zeros(2)}

    pf = DevicePrefetcher(endless(), capacity=1, device="cpu").start()
    for _ in range(500):  # one batch queued, the next one held: blocked
        if len(produced) >= 2 and pf._q.full():
            break
        threading.Event().wait(0.01)
    assert pf._q.full()
    pf.stop()
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        pf.start()


def test_prefetcher_stop_ends_a_running_iteration():
    pf = DevicePrefetcher(iter(feeds(50)), capacity=2, device="cpu")
    it = iter(pf)
    next(it)
    pf.stop()
    assert list(it) == []


def test_prefetcher_reiteration_terminates():
    pf = DevicePrefetcher(iter(feeds(3)), device="cpu")
    assert len(list(pf)) == 3
    assert list(pf) == []


def test_prefetcher_context_manager_stops_it():
    with DevicePrefetcher(iter(feeds(50)), capacity=2, device="cpu") as pf:
        first = next(iter(pf))
    assert float(first["x"][0, 0]) == 0.0
    assert pf._stop.is_set() and not pf._thread.is_alive()


def test_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher(iter(feeds()))


def test_prefetcher_instruments_exist():
    from paddle_tpu_torch.monitor import metrics

    names = set(metrics.snapshot())
    assert {"prefetcher/queue_depth", "prefetcher/h2d_ms",
            "prefetcher/wait_time_ms", "prefetcher/copy_ms"} <= names
    before = metrics.histogram("prefetcher/wait_time_ms").count
    list(DevicePrefetcher(iter(feeds(4)), device="cpu"))
    if metrics.enabled():
        assert metrics.histogram("prefetcher/wait_time_ms").count \
            == before + 5


def test_prefetchers_under_thread_stress_keep_each_stream_whole():
    """More prefetchers and consumers than cores, with a short switch
    interval: every consumer gets its own source's batches, in order."""
    import os
    import sys

    n = 2 * (os.cpu_count() or 4) + 2
    got = {}

    def consume(i):
        src = ({"x": np.full(3, 1000 * i + j)} for j in range(40))
        got[i] = [int(f["x"][0]) for f in
                  DevicePrefetcher(src, capacity=1, device="cpu")]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == {i: [1000 * i + j for j in range(40)] for i in range(n)}
