# ported from paddle_tpu/layers/io.py
"""IO layers: data declaration (reference: python/paddle/fluid/layers/io.py).

``data`` declares a feed variable with a leading batch dim of -1 (dynamic),
matching Fluid (``io.py data, append_batch_size=True``). ``py_reader`` /
``double_buffer`` bind a host pipeline (:mod:`..reader.py_reader`, with the
side-stream :class:`..reader.DevicePrefetcher`) that the Executor drains at
step boundaries, since the graph itself doesn't own IO.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core import unique_name
from ..core.framework import default_main_program
from ..reader import decorator as _decorator
from ..reader.py_reader import PyReader

__all__ = ["data", "py_reader", "create_py_reader_by_data", "read_file",
           "double_buffer", "shuffle", "batch", "load"]


def data(name: str, shape: Sequence[int], dtype="float32", append_batch_size: bool = True,
         lod_level: int = 0, stop_gradient: bool = True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block
    var = block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        is_data=True,
        stop_gradient=stop_gradient,
    )
    var.lod_level = lod_level
    return var


def py_reader(capacity: int, shapes: Sequence[Sequence[int]], dtypes: Sequence,
              lod_levels: Optional[Sequence[int]] = None, name: Optional[str] = None,
              use_double_buffer: bool = True):
    """Async graph input (reference: python/paddle/fluid/layers/io.py:636).

    Creates one data variable per (shape, dtype) and binds a PyReader whose
    queue the Executor drains each step — see reader/py_reader.py (host
    thread + device prefetch replace the C++ blocking-queue `read` op).

        reader = fluid.layers.py_reader(64, [[-1,784],[-1,1]], ['float32','int64'])
        img, label = fluid.layers.read_file(reader)
        ...
        reader.decorate_paddle_reader(train_reader)
        reader.start()
        try:
            while True: exe.run(fetch_list=[loss])
        except fluid.core.EOFException:
            reader.reset()
    """
    base = name or unique_name.generate("py_reader")
    prog = default_main_program()
    block = prog.global_block
    vars_ = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        var = block.create_var(
            name="%s_slot_%d" % (base, i),
            shape=list(shape),
            dtype=dtype,
            is_data=True,
            stop_gradient=True,
        )
        var.lod_level = (lod_levels[i] if lod_levels else 0)
        vars_.append(var)
    reader = PyReader(vars_, capacity, use_double_buffer=use_double_buffer, name=base)
    prog._py_readers.append(reader)
    return reader


def create_py_reader_by_data(capacity: int, feed_list, name: Optional[str] = None,
                             use_double_buffer: bool = True):
    """Bind a PyReader to existing data variables (reference: io.py
    create_py_reader_by_data)."""
    prog = default_main_program()
    reader = PyReader(list(feed_list), capacity, use_double_buffer=use_double_buffer,
                      name=name or unique_name.generate("py_reader"))
    prog._py_readers.append(reader)
    return reader


def read_file(reader):
    """The data variables fed by a py_reader (reference: io.py read_file)."""
    vars_ = reader.data_vars
    return vars_[0] if len(vars_) == 1 else list(vars_)


def double_buffer(reader, place=None, name=None):
    """Compat shim: py_reader(use_double_buffer=True) already device-prefetches
    (reader/prefetcher.py); returns the reader unchanged."""
    return reader


def shuffle(reader, buffer_size):
    """reference: layers/io.py shuffle (create_shuffle_reader op). The
    file-reader op stack is replaced by host-side reader decorators
    (SURVEY §2 reader infra): this delegates to
    ``reader.shuffle`` for Python readers."""
    if callable(reader):
        return _decorator.shuffle(reader, buffer_size)
    raise TypeError(
        "layers.shuffle expects a Python reader callable; the reference's "
        "graph reader Variables (open_files) are replaced by py_reader + "
        "reader decorators in this package")


def batch(reader, batch_size):
    """reference: layers/io.py batch (create_batch_reader op); delegates to
    ``reader.batch`` for Python readers."""
    if callable(reader):
        return _decorator.batch(reader, batch_size)
    raise TypeError(
        "layers.batch expects a Python reader callable; the reference's "
        "graph reader Variables (open_files) are replaced by py_reader + "
        "reader decorators in this package")


def load(out, file_path, load_as_fp16=None):
    """Load a saved variable into ``out`` (reference: layers/io.py load →
    operators/load_op.cc); reads the .npy written by io.save_vars."""
    from .layer_helper import LayerHelper

    helper = LayerHelper("load")
    helper.append_op("load", inputs={}, outputs={"Out": out},
                     attrs={"file_path": file_path,
                            "load_as_fp16": bool(load_as_fp16 or False)})
    return out

