# ported from paddle_tpu/layers/io.py
"""IO layers: data declaration (reference: python/paddle/fluid/layers/io.py).

``data`` declares a feed variable with a leading batch dim of -1 (dynamic),
matching Fluid (``io.py data, append_batch_size=True``). The readers of the
JAX package (py_reader, double_buffer, the reader decorators) are not
ported yet.
"""

from __future__ import annotations

from typing import Sequence

from ..core.framework import default_main_program

__all__ = ["data", "load"]


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


def load(out, file_path, load_as_fp16=None):
    """Load a saved variable into ``out`` (reference: layers/io.py load →
    operators/load_op.cc); reads the .npy written by io.save_vars."""
    from .layer_helper import LayerHelper

    helper = LayerHelper("load")
    helper.append_op("load", inputs={}, outputs={"Out": out},
                     attrs={"file_path": file_path,
                            "load_as_fp16": bool(load_as_fp16 or False)})
    return out

