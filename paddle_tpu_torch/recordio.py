# ported from paddle_tpu/recordio.py
"""RecordIO Python API over the native C++ library
(reference: recordio/ + python recordio_writer.py + reader ops'
create_recordio_file_reader).

The library is the port's own copy of the JAX package's source
(``native/recordio.cc``), built with ``g++`` into ``paddle_tpu_torch/build/``
at first use (:mod:`.native`). The files are the JAX package's byte for
byte: chunks of up to 1024 records or 1 MiB, each the magic ``PTRC``, the
record count, the payload length, the payload's CRC-32 and the table of
record lengths, then the records. Either package reads the other's files.
"""

from __future__ import annotations

import ctypes
from typing import Iterator

from .native import build_and_load

__all__ = ["Writer", "Scanner", "write_records", "read_records",
           "recordio_reader", "RecordIOCorruptError"]


class RecordIOCorruptError(RuntimeError):
    pass


def _lib():
    lib = build_and_load("recordio")
    lib.ptrio_writer_open.restype = ctypes.c_void_p
    lib.ptrio_writer_open.argtypes = [ctypes.c_char_p]
    lib.ptrio_writer_write.restype = ctypes.c_int
    lib.ptrio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.ptrio_writer_close.restype = ctypes.c_int
    lib.ptrio_writer_close.argtypes = [ctypes.c_void_p]
    lib.ptrio_scanner_open.restype = ctypes.c_void_p
    lib.ptrio_scanner_open.argtypes = [ctypes.c_char_p]
    lib.ptrio_scanner_next.restype = ctypes.c_void_p
    lib.ptrio_scanner_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.ptrio_scanner_close.argtypes = [ctypes.c_void_p]
    return lib


class Writer:
    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.ptrio_writer_open(path.encode())
        if not self._h:
            raise IOError("cannot open %r for writing" % path)

    def write(self, data: bytes):
        if self._lib.ptrio_writer_write(self._h, data, len(data)) != 0:
            raise IOError("recordio write failed")

    def close(self):
        if self._h:
            if self._lib.ptrio_writer_close(self._h) != 0:
                raise IOError("recordio close/flush failed")
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Scanner:
    def __init__(self, path: str):
        self._lib = _lib()
        self._h = self._lib.ptrio_scanner_open(path.encode())
        if not self._h:
            raise IOError("cannot open %r for reading" % path)

    def __iter__(self) -> Iterator[bytes]:
        length = ctypes.c_uint64()
        while True:
            p = self._lib.ptrio_scanner_next(self._h, ctypes.byref(length))
            if not p:
                if length.value == 0xFFFFFFFFFFFFFFFF:
                    raise RecordIOCorruptError("recordio chunk CRC/framing error")
                return
            yield ctypes.string_at(p, length.value)

    def close(self):
        if self._h:
            self._lib.ptrio_scanner_close(self._h)
            self._h = None


def write_records(path: str, examples, serializer=None):
    """Write records. By default records must already be ``bytes`` (the
    reference recordio stores raw byte records); pass
    ``serializer=pickle.dumps`` to store arbitrary objects."""
    if serializer is None:
        serializer = _require_bytes
    with Writer(path) as w:
        n = 0
        for e in examples:
            w.write(serializer(e))
            n += 1
    return n


def _require_bytes(e):
    if not isinstance(e, (bytes, bytearray)):
        raise TypeError(
            "recordio stores bytes; got %s — pass serializer=pickle.dumps "
            "to store arbitrary objects" % type(e).__name__)
    return bytes(e)


def read_records(path: str, deserializer=None):
    """Yield records as raw ``bytes`` by default. Deserializing with pickle
    executes arbitrary code from the file, so it is strictly opt-in
    (``deserializer=pickle.loads``) for files you trust."""
    s = Scanner(path)
    try:
        for rec in s:
            yield deserializer(rec) if deserializer is not None else rec
    finally:
        s.close()


def recordio_reader(path: str, deserializer=None):
    """A reader() factory over a recordio file — plugs into the decorator
    pipeline (batch/shuffle/...) like the reference's recordio reader op.
    Yields raw bytes unless an explicit ``deserializer`` is given (see
    ``read_records`` for the pickle trust caveat)."""

    def reader():
        return read_records(path, deserializer)

    return reader
