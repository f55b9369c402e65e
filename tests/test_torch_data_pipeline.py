"""The port's checkpointable readers against the JAX package's.

On the same files: ``write_ctr_shards`` writes byte-identical shards;
``CheckpointableReader``, its ``prefetch`` wrapper, ``MultiSlotTextReader``
and ``CTRMultiSlotReader`` give equal batches and an equal ``state_dict``
(as JSON) after every batch; a reader restored from a state resumes
exactly once; the quarantine JSONL lines are equal; the corrupt-rate bound
raises ``DataCorruptionError``; the ``data/*`` counters move alike;
``MultiSlotTextReader``'s feeds equal ``AsyncExecutor``'s batching of the
same lines; ``DataFeedDesc`` parses and prints a proto as the JAX
package's does.
"""

import json
import os

import numpy as np
import pytest

from paddle_tpu import data as jdata
from paddle_tpu.async_executor import _batch_to_feed as jbatch
from paddle_tpu.async_executor import _parse_multislot_line as jparse
from paddle_tpu.data_feed_desc import DataFeedDesc as JDesc
from paddle_tpu.monitor import metrics as jmetrics
from paddle_tpu_torch import data as tdata
from paddle_tpu_torch.async_executor import _batch_to_feed as tbatch
from paddle_tpu_torch.async_executor import _parse_multislot_line as tparse
from paddle_tpu_torch.data_feed_desc import DataFeedDesc as TDesc
from paddle_tpu_torch.monitor import metrics as tmetrics


def same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("n,shards,fields,dense,vocab,seed", [
    (100, 2, 26, 13, 1000, 0), (37, 3, 5, 3, 50, 7), (10, 4, 1, 1, 2, 3)])
def test_write_ctr_shards_byte_identical(tmp_path, n, shards, fields, dense,
                                         vocab, seed):
    kw = dict(n_shards=shards, num_fields=fields, dense_dim=dense,
              vocab=vocab, seed=seed)
    jp = jdata.write_ctr_shards(str(tmp_path / "j"), n, **kw)
    tp = tdata.write_ctr_shards(str(tmp_path / "t"), n, **kw)
    assert [os.path.basename(p) for p in jp] == \
        [os.path.basename(p) for p in tp]
    for a, b in zip(jp, tp):
        assert open(a, "rb").read() == open(b, "rb").read()


def ctr_readers(paths, **kw):
    kw = dict(dict(batch_size=8, num_fields=4, dense_dim=3, vocab=50,
                   epochs=2, drop_remainder=False), **kw)
    return jdata.CTRMultiSlotReader(paths, **kw), \
        tdata.CTRMultiSlotReader(paths, **kw)


def test_ctr_reader_batches_and_state_at_every_position(tmp_path):
    paths = tdata.write_ctr_shards(str(tmp_path), 30, n_shards=2,
                                   num_fields=4, dense_dim=3, vocab=50)
    jr, tr = ctr_readers(paths)
    assert json.dumps(jr.state_dict()) == json.dumps(tr.state_dict())
    n = 0
    for a, b in zip(jr, tr):
        same_batch(b, a)
        assert json.dumps(tr.state_dict()) == json.dumps(jr.state_dict())
        assert tr.last_batch_ids() == jr.last_batch_ids()
        n += 1
    assert n == 8  # 2 epochs of 30 records at 8: 3 full and a partial
    assert tr.records_read == 60 and tr.state_dict()["epoch"] == 2
    with pytest.raises(StopIteration):
        next(tr)


@pytest.mark.parametrize("stop_after", [0, 1, 3, 5])
def test_resume_is_exactly_once(tmp_path, stop_after):
    paths = tdata.write_ctr_shards(str(tmp_path), 30, n_shards=3,
                                   num_fields=4, dense_dim=3, vocab=50)
    whole = list(ctr_readers(paths)[1])
    first = ctr_readers(paths)[1].prefetch(3)
    head = [next(first) for _ in range(stop_after)]
    state = json.loads(json.dumps(first.state_dict()))
    first.stop()
    jr, tr = ctr_readers(paths)
    jr.load_state_dict(state)
    tr.load_state_dict(state)
    tail = list(tr)
    assert len(head) + len(tail) == len(whole)
    for a, b in zip(head + tail, whole):
        same_batch(a, b)
    for a, b in zip(tail, jr):
        same_batch(a, b)
    assert tr.state_dict() == jr.state_dict()


def test_prefetch_state_is_the_consumers(tmp_path):
    paths = tdata.write_ctr_shards(str(tmp_path), 32, n_shards=2,
                                   num_fields=4, dense_dim=3, vocab=50)
    jp = ctr_readers(paths, epochs=1)[0].prefetch(2)
    tp = ctr_readers(paths, epochs=1)[1].prefetch(2)
    for _ in range(3):
        same_batch(next(tp), next(jp))
        assert tp.state_dict() == jp.state_dict()
        assert tp.last_batch_ids() == jp.last_batch_ids()
    ids = ["ctr_00001.txt#0", "ctr_00001.txt#3"]
    jp.quarantine(ids, "window")
    tp.quarantine(ids, "window")
    same_batch(next(tp), next(jp))
    assert tp.quarantined_ids() == jp.quarantined_ids() == sorted(ids)
    assert tp.state_dict() == jp.state_dict()
    jp.stop()
    tp.stop()


def plant(paths, tmp_path, bad):
    """Copies of the shards with lines replaced: {(shard, line): text}."""
    out = []
    for i, p in enumerate(paths):
        lines = open(p).read().split("\n")
        for (s, ln), text in bad.items():
            if s == i:
                lines[ln] = text
        q = str(tmp_path / os.path.basename(p))
        open(q, "w").write("\n".join(lines))
        out.append(q)
    return out


def test_quarantine_lines_and_counters_equal(tmp_path):
    paths = tdata.write_ctr_shards(str(tmp_path / "clean"), 40, n_shards=2,
                                   num_fields=4, dense_dim=3, vocab=50)
    good = open(paths[0]).readline().split()
    out_of_range = list(good)
    out_of_range[1 + 1 + 1 + 3 + 1] = "50"
    two_ids = list(good)
    two_ids[1 + 1 + 1 + 3] = "2"
    two_ids.insert(1 + 1 + 1 + 3 + 2, "7")
    bad = plant(paths, tmp_path, {
        (0, 2): " ".join(out_of_range), (0, 5): "not a record",
        (1, 1): " ".join(two_ids), (1, 4): "1 0 2 0.5 0.5"})
    qj, qt = str(tmp_path / "qj.jsonl"), str(tmp_path / "qt.jsonl")
    names = ["data/records_read", "data/records_corrupt",
             "data/records_quarantined", "data/batches", "data/bytes_read",
             "data/epochs_completed", "data/records_skipped"]
    before = ({n: jmetrics.counter(n).value for n in names},
              {n: tmetrics.counter(n).value for n in names})
    jr, tr = ctr_readers(bad, quarantine_path=None, max_corrupt_rate=0.5,
                         corrupt_check_min=1)
    jr.quarantine_path, tr.quarantine_path = qj, qt
    ja, ta = list(jr), list(tr)
    assert len(ta) == len(ja) == 9  # 72 records at 8
    for a, b in zip(ja, ta):
        same_batch(b, a)
    assert open(qt).read() == open(qj).read()
    assert [json.loads(x)["id"] for x in open(qt)] == [
        "ctr_00000.txt#2", "ctr_00000.txt#5", "ctr_00001.txt#1",
        "ctr_00001.txt#4"]
    assert tr.records_corrupt == 4 and tr.records_read == 72
    # the second epoch skips what the first quarantined
    assert tr.state_dict()["records_skipped"] == 4
    moved = ({n: jmetrics.counter(n).value - before[0][n] for n in names},
             {n: tmetrics.counter(n).value - before[1][n] for n in names})
    if jmetrics.enabled() and tmetrics.enabled():
        assert moved[1] == moved[0]
        assert moved[1]["data/records_corrupt"] == 4


def test_corrupt_rate_bound_raises(tmp_path):
    p = str(tmp_path / "mostly_bad_0.txt")
    good = tdata.write_ctr_shards(str(tmp_path / "g"), 1, n_shards=1,
                                  num_fields=4, dense_dim=3, vocab=50)
    line = open(good[0]).read().strip()
    with open(p, "w") as f:
        for i in range(20):
            f.write(("garbage" if i % 2 else line) + "\n")
    for mod in (jdata, tdata):
        r = mod.CTRMultiSlotReader([p], batch_size=2, num_fields=4,
                                   dense_dim=3, vocab=50,
                                   max_corrupt_rate=0.1, corrupt_check_min=4)
        with pytest.raises(mod.DataCorruptionError, match="exceeds the"):
            list(r)


def test_generic_reader_schema_and_errors(tmp_path):
    p = str(tmp_path / "rec_0.txt")
    with open(p, "w") as f:
        for i in range(10):
            f.write("%d %d\n" % (i, i * i) if i != 4 else "x y\n")

    def parse(line):
        a, b = line.split()
        return {"a": np.asarray([int(a)], np.int64),
                "b": np.asarray([float(b)], np.float32)}

    def readers(mod):
        schema = [mod.FieldSpec("a", (1,), np.int64),
                  mod.FieldSpec("b", (None,), np.float32)]
        return mod.CheckpointableReader([p], parse, 3, schema=schema,
                                        max_corrupt_rate=0.5,
                                        corrupt_check_min=1)

    jr, tr = readers(jdata), readers(tdata)
    ja, ta = list(jr), list(tr)
    assert len(ta) == len(ja) == 3
    for a, b in zip(ja, ta):
        same_batch(b, a)
    assert tr.state_dict() == jr.state_dict()
    assert tr.quarantined_ids() == ["rec_0.txt#4"]
    with pytest.raises(ValueError, match="at least one shard"):
        tdata.CheckpointableReader([], parse, 2)
    with pytest.raises(ValueError, match="basenames must be unique"):
        tdata.CheckpointableReader([p, p], parse, 2)
    with pytest.raises(ValueError, match="version"):
        tr.load_state_dict({"version": 99})


def test_multislot_reader_equals_async_batching(tmp_path):
    paths = tdata.write_ctr_shards(str(tmp_path), 12, n_shards=1,
                                   num_fields=5, dense_dim=3, vocab=100)
    slots = tdata.ctr_slots(num_fields=5, dense_dim=3)
    got = list(tdata.MultiSlotTextReader(paths, slots, batch_size=4,
                                         epochs=1))
    want = list(jdata.MultiSlotTextReader(
        paths, jdata.ctr_slots(num_fields=5, dense_dim=3), batch_size=4,
        epochs=1))
    lines = [tparse(x.strip(), slots) for x in open(paths[0])]
    ref = [tbatch(lines[i:i + 4], slots) for i in range(0, 12, 4)]
    jlines = [jparse(x.strip(), slots) for x in open(paths[0])]
    jref = [jbatch(jlines[i:i + 4], slots) for i in range(0, 12, 4)]
    assert len(got) == len(want) == len(ref) == 3
    for g, w, r, jr in zip(got, want, ref, jref):
        same_batch(g, w)
        same_batch(g, r)
        same_batch(r, jr)


def test_variable_length_slots_pad_with_lengths(tmp_path):
    p = str(tmp_path / "var_0.txt")
    with open(p, "w") as f:
        f.write("3 1 2 3 1 0.5 1 1\n2 4 5 1 0.25 1 0\n1 9 1 0.125 1 1\n")
    slots = [tdata.slot("ids"), tdata.slot("x", type="float",
                                           is_dense=True),
             tdata.slot("label", is_dense=True)]
    jslots = [jdata.slot("ids"), jdata.slot("x", type="float",
                                            is_dense=True),
              jdata.slot("label", is_dense=True)]
    got = list(tdata.MultiSlotTextReader([p], slots, batch_size=3))
    want = list(jdata.MultiSlotTextReader([p], jslots, batch_size=3))
    same_batch(got[0], want[0])
    assert got[0]["ids"].tolist() == [[1, 2, 3], [4, 5, 0], [9, 0, 0]]
    assert got[0]["ids_length"].tolist() == [3, 2, 1]
    with pytest.raises(ValueError, match="ended early"):
        tparse("1 5", slots)
    with pytest.raises(ValueError, match="declares 3 values"):
        tparse("3 1 2", slots)


PROTO = """name: "MultiSlotDataFeed"
batch_size: 32
multi_slot_desc {
  slots {
    name: "ids"
    type: "uint64"
    is_dense: false
    is_used: true
  }
  slots { name: "dense" type: "float" is_dense: true is_used: true dense_dim: 13 }
  slots {
    name: "label"
    type: "uint64"
    is_dense: true
    is_used: false
  }
}
"""


def test_data_feed_desc_matches_jax(tmp_path):
    p = str(tmp_path / "feed.proto")
    open(p, "w").write(PROTO)
    jd, td = JDesc(p), TDesc(p)
    assert td.name == jd.name and td.batch_size == jd.batch_size == 32
    assert [vars(s) for s in td.slots] == [vars(s) for s in jd.slots]
    assert td.slots[1].dense_dim == 13
    for d in (jd, td):
        d.set_batch_size(128)
        d.set_dense_slots(["ids"])
        d.set_use_slots(["ids", "label"])
    assert td.desc() == jd.desc()
    assert [(s.is_dense, s.is_used) for s in td.slots] == \
        [(True, True), (True, False), (True, True)]
