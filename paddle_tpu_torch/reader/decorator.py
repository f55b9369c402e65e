# ported from paddle_tpu/reader/decorator.py
"""Reader decorators (reference: python/paddle/reader/decorator.py).

A reader is a zero-arg callable returning an iterator of examples. Decorators
compose readers — batching, shuffling, buffering, parallel mapping — exactly
the reference's API.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import threading
from typing import Callable, Iterable, List

__all__ = ["map_readers", "shuffle", "chain", "compose", "batch", "buffered",
           "firstn", "cache", "xmap_readers"]


def map_readers(func: Callable, *readers):
    def reader():
        iters = [r() for r in readers]
        for items in zip(*iters):
            yield func(*items)

    return reader


def shuffle(reader, buf_size: int, seed=None):
    def shuffled():
        rnd = _random.Random(seed)
        buf: List = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                rnd.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rnd.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, check_alignment: bool = True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        iters = [r() for r in readers]
        if check_alignment:
            for items in zip(*iters):
                yield sum((make_tuple(i) for i in items), ())
            for it in iters:
                try:
                    next(it)
                    raise RuntimeError("composed readers have different lengths")
                except StopIteration:
                    pass
        else:
            for items in itertools.zip_longest(*iters):
                yield sum((make_tuple(i) for i in items if i is not None), ())

    return reader


def batch(reader, batch_size: int, drop_last: bool = False):
    def batched():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


def buffered(reader, size: int):
    """Background-thread read-ahead (reference: decorator.py buffered)."""

    class _End:
        pass

    def buffered_reader():
        q: queue.Queue = queue.Queue(maxsize=size)

        def worker():
            try:
                for e in reader():
                    q.put(e)
            finally:
                q.put(_End)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return buffered_reader


def firstn(reader, n: int):
    def reader_n():
        return itertools.islice(reader(), n)

    return reader_n


def cache(reader):
    all_data = []
    filled = []

    def cached():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)

    return cached


def xmap_readers(mapper, reader, process_num: int, buffer_size: int, order: bool = False):
    """Parallel map over a reader with worker threads (reference:
    decorator.py xmap_readers)."""

    end = object()

    def xreader():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)

        def feeder():
            for i, e in enumerate(reader()):
                in_q.put((i, e))
            for _ in range(process_num):
                in_q.put(end)

        def worker():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, e = item
                out_q.put((i, mapper(e)))

        threading.Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=worker, daemon=True).start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                i, v = item
                pending[i] = v
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]

    return xreader
