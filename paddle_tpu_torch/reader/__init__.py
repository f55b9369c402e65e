# ported from paddle_tpu/reader/__init__.py
"""Host readers: the reference's reader decorators, the side-stream
:class:`DevicePrefetcher` and the ``py_reader`` queue."""

from .decorator import (  # noqa: F401
    batch,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    shuffle,
    xmap_readers,
)
from .prefetcher import DevicePrefetcher  # noqa: F401
from .py_reader import EOFException, PyReader  # noqa: F401
