"""The port's RecordIO (``paddle_tpu_torch/recordio.py`` over its own copy
of ``native/recordio.cc``, built into ``paddle_tpu_torch/build/``) against
the JAX package's:

* round trips of raw byte records over many chunks, and pickled examples
  through ``recordio_reader`` → ``reader.batch`` (pickle opt-in);
* a flipped payload bit and a tampered length table raise
  ``RecordIOCorruptError``;
* for the same records the files are byte-identical to the JAX writer's,
  and each package reads the other's files;
* the library is built from the port's source into the port's build
  directory, never beside the source, and the source names its origin.
"""

import os
import pickle
import struct

import numpy as np
import pytest

from paddle_tpu import recordio as jrecordio
from paddle_tpu_torch import native, recordio
from paddle_tpu_torch import reader as R

RECORDS = ([b"hello", b"", b"x" * 100000, bytes(range(256))]
           + [("example-%d" % i).encode() for i in range(5000)]
           + [bytes(np.random.RandomState(3).randint(0, 256, 4000)
                    .astype(np.uint8)) for _ in range(400)])


def test_round_trip_over_many_chunks(tmp_path):
    path = str(tmp_path / "many.rio")
    with recordio.Writer(path) as w:
        for r in RECORDS:
            w.write(r)
    assert list(recordio.Scanner(path)) == RECORDS
    # > 1 MiB and > 1024 records: several chunks
    data = open(path, "rb").read()
    assert data.count(b"CRTP") >= 5  # 'PTRC' little-endian magic per chunk


def test_pickled_examples_through_the_reader_pipeline(tmp_path):
    path = str(tmp_path / "examples.rio")
    rng = np.random.RandomState(0)
    examples = [(rng.randn(4).astype("float32"), int(i % 3))
                for i in range(100)]
    with pytest.raises(TypeError):
        recordio.write_records(path, examples)  # pickle is opt-in
    assert recordio.write_records(path, examples, serializer=pickle.dumps) == 100
    batches = list(R.batch(recordio.recordio_reader(
        path, deserializer=pickle.loads), 32)())
    assert [len(b) for b in batches] == [32, 32, 32, 4]
    np.testing.assert_array_equal(batches[0][0][0], examples[0][0])
    assert list(recordio.read_records(path))[0] == pickle.dumps(examples[0])


def _written(tmp_path, name):
    path = str(tmp_path / name)
    with recordio.Writer(path) as w:
        for i in range(10):
            w.write(b"payload-%d" % i)
    return path


def test_a_flipped_payload_bit_is_detected(tmp_path):
    path = _written(tmp_path, "corrupt.rio")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(recordio.RecordIOCorruptError):
        list(recordio.Scanner(path))


def test_a_tampered_length_table_is_detected(tmp_path):
    path = _written(tmp_path, "tamper.rio")
    data = bytearray(open(path, "rb").read())
    # magic(4) n(4) plen(8) crc(4) lens(4*n) payload: inflate lens[0]
    (l0,) = struct.unpack_from("<I", data, 20)
    struct.pack_into("<I", data, 20, l0 + 1000)
    open(path, "wb").write(bytes(data))
    with pytest.raises(recordio.RecordIOCorruptError):
        list(recordio.Scanner(path))


def test_files_are_the_jax_packages_byte_for_byte(tmp_path):
    ours, theirs = str(tmp_path / "port.rio"), str(tmp_path / "jax.rio")
    assert recordio.write_records(ours, RECORDS) == len(RECORDS)
    assert jrecordio.write_records(theirs, RECORDS) == len(RECORDS)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert list(recordio.read_records(theirs)) == RECORDS
    assert list(jrecordio.read_records(ours)) == RECORDS


def test_the_library_is_built_from_the_ports_source(tmp_path):
    recordio.write_records(str(tmp_path / "a.rio"), [b"x"])
    lib = native.build_and_load("recordio")
    path = native._lib_path(native.SRC_DIR / "recordio.cc")
    assert lib._name == str(path) and path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "build" and \
        native.BUILD_DIR.parent.name == "paddle_tpu_torch"
    src = (native.SRC_DIR / "recordio.cc").read_text()
    assert src.splitlines()[0] == \
        "// ported from paddle_tpu/native/recordio.cc"
    assert not os.path.exists(native.SRC_DIR / "librecordio.so")
