"""The port's prefix cache against the JAX package's: the host-side index
(keys, longest match, LRU, refusals, flush) behaves the same; a hit's
stream equals the cold stream and the JAX engine's, greedy and sampled;
a failed request never donates; and pages exported by either package's
engine import into the other's, so the hit they serve is the same.
"""

import numpy as np
import pytest

from paddle_tpu.fleet import prefix_cache as jpc
from paddle_tpu.serving import metrics as jsm
from paddle_tpu_torch.fleet import metrics as tfm
from paddle_tpu_torch.fleet import prefix_cache as tpc
from paddle_tpu_torch.monitor import metrics as tmx
from paddle_tpu_torch.reliability import FaultPlan, faults
from paddle_tpu_torch.serving import metrics as tsm
from torch_serving_util import SMALL, engine, jserving, tserving

SYS = list(range(1, 18))  # 17 tokens: 2 full pages of 8 cacheable


def prefix_engine(pkg, pages=8, **kw):
    return engine(pkg, slots=2, num_pages=32, prefix_cache_pages=pages,
                  prompt_buckets=(8, 16, 32), **kw)


def test_prefix_key_and_index_equal_jax():
    for toks in ([1, 2, 3], list(range(40, 72)), np.arange(5)):
        assert tpc.prefix_key(toks) == jpc.prefix_key(toks)
    for mod in (tpc, jpc):
        c = mod.PrefixCache(page_budget=8, page_size=4)
        assert [c.cacheable_len(n) for n in (16, 17, 8, 3)] == [12, 16, 4, 0]
        base = list(range(100, 112))
        assert c.insert(base[:4], [0]) == (True, [])
        assert c.insert(base[:8], [1, 2]) == (True, [])
        assert c.lookup(base + [9]).tokens == tuple(base[:8])
        assert c.lookup(base[:6]).tokens == tuple(base[:4])
        assert c.lookup([7] * 12) is None
        assert c.insert(base[:4], [3]) == (False, [])
        assert c.insert([1, 2, 3], [4]) == (False, [])
        assert c.insert(list(range(40)), list(range(10))) == (False, [])
        assert c.get(base[:8]).pages == [1, 2] and c.get([5]) is None
        assert c.evict(base[:4]) == [0] and c.pages_held == 2
        assert sorted(c.flush()) == [1, 2] and len(c) == 0


def test_lru_eviction_and_counters():
    tmx.enable()
    h0, e0 = tfm.PREFIX_HITS.value, tfm.PREFIX_EVICTIONS.value
    c = tpc.PrefixCache(page_budget=2, page_size=4)
    c.insert([1, 2, 3, 4], [10])
    c.insert([5, 6, 7, 8], [11])
    assert c.lookup([1, 2, 3, 4, 9]) is not None
    assert c.insert([9, 10, 11, 12], [12]) == (True, [11])
    assert tfm.PREFIX_HITS.value == h0 + 1
    assert tfm.PREFIX_EVICTIONS.value == e0 + 1
    with pytest.raises(ValueError):
        tpc.PrefixCache(0, 4)


def hit_run(pkg, kw):
    """A cold request, then the same system prompt with other suffixes:
    (streams, prefills, hits)."""
    eng = prefix_engine(pkg)
    reqs = [eng.submit(SYS + [30], 5, **kw(0))]
    eng.run()
    for i, tail in enumerate(([30], [31, 32, 33], [40] * 9), 1):
        reqs.append(eng.submit(SYS + tail, 6, **kw(i)))
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    assert eng.page_accounting_ok()
    h = eng.health()
    eng.drain(10.0)
    assert eng.pool.num_used == 0
    return [list(r.tokens_out) for r in reqs], h["prefills"], h["resumes"]


def cold_run(pkg, kw):
    eng = engine(pkg, slots=2, num_pages=32, prompt_buckets=(8, 16, 32))
    reqs = [eng.submit(SYS + t, m, **kw(i)) for i, (t, m) in enumerate(
        (([30], 5), ([30], 6), ([31, 32, 33], 6), ([40] * 9, 6)))]
    eng.run()
    return [list(r.tokens_out) for r in reqs]


KWS = {"greedy": lambda i: {},
       "sampled": lambda i: dict(temperature=0.9, top_k=(0, 7)[i % 2],
                                 seed=11 + i)}


@pytest.mark.parametrize("kind", sorted(KWS))
def test_hit_streams_equal_cold_and_jax(kind):
    kw = KWS[kind]
    toks, prefills, resumes = hit_run(tserving, kw)
    assert resumes == 3 and prefills == 1
    assert toks == cold_run(tserving, kw)
    jtoks, jprefills, jresumes = hit_run(jserving, kw)
    assert toks == jtoks and (prefills, resumes) == (jprefills, jresumes)


def test_failed_request_never_donates():
    tmx.enable()
    eng = prefix_engine(tserving)
    pk0 = tfm.PREFIX_POISONED_SKIPPED.value
    with FaultPlan([faults.FaultSpec("serving.decode", "fatal", at=1)]):
        bad = eng.submit(SYS, 5)
        eng.run(max_steps=50)
    assert bad.state == "failed"
    assert tfm.PREFIX_POISONED_SKIPPED.value > pk0
    assert len(eng.prefix_cache) == 0
    assert eng.page_accounting_ok() and eng.pool.num_used == 0
    good = eng.submit(SYS, 3, seed=5)
    eng.run()
    assert good.state == "finished" and eng.health()["resumes"] == 0
    assert eng.prefix_cache.pages_held == 2 and eng.pool.num_used == 2
    eng.drain(10.0)
    assert eng.pool.num_used == 0


def donor(pkg):
    eng = prefix_engine(pkg)
    eng.submit(SYS + [30], 4)
    eng.run()
    return eng


@pytest.mark.parametrize("src,dst", [(jserving, tserving),
                                     (tserving, jserving),
                                     (tserving, tserving)])
def test_pages_cross_between_packages(src, dst):
    """A prefix prefilled by one engine, exported, ingested by another:
    the receiver serves the prompt as a hit with the donor's stream, and
    re-exports the very bytes it took in."""
    a = donor(src)
    meta, blobs = a.export_prefix_pages(SYS[:16])
    assert meta["n_pages"] == 2 and meta["kv_dtype"] == "float32"
    assert meta["layout"] == "paged"
    b = prefix_engine(dst)
    assert not b.ingest_prefix_pages(SYS[:12], meta, blobs)
    assert not b.ingest_prefix_pages(SYS[:8], dict(meta, n_head=4), blobs)
    assert b.page_accounting_ok() and b.pool.num_used == 0
    assert b.ingest_prefix_pages(SYS[:16], meta, blobs)
    assert b.ingest_prefix_pages(SYS[:16], meta, blobs)  # held: no-op
    meta_b, blobs_b = b.export_prefix_pages(SYS[:16])
    assert meta_b == meta and blobs_b == blobs
    want = a.submit(SYS + [31, 32], 6, temperature=0.7, seed=3)
    a.run()
    got = b.submit(SYS + [31, 32], 6, temperature=0.7, seed=3)
    b.run()
    assert got.tokens_out == want.tokens_out
    assert b.health()["resumes"] == 1 and b.health()["prefills"] == 0
    assert b.evict_prefix(SYS[:16]) == 2 and b.evict_prefix(SYS[:16]) == 0
    assert b.page_accounting_ok() and b.pool.num_used == 0


def test_request_prefix_export_and_layout_refusals():
    eng = prefix_engine(tserving)
    r = eng.submit(SYS + [7, 8], 6)
    eng.step()
    toks, meta, blobs = eng.export_request_prefix(r)
    assert toks == SYS[:16] and meta["n_pages"] == 2
    shp = (SMALL["n_layer"], 16, SMALL["n_head"],
           SMALL["d_model"] // SMALL["n_head"])
    k = np.frombuffer(blobs[0], np.float32).reshape(shp)
    assert np.isfinite(k).all() and np.abs(k).sum() > 0
    eng.run()
    flat = engine(tserving, paged=False)
    assert flat.export_prefix_pages(SYS[:16]) is None
    with pytest.raises(ValueError):
        flat.cache_ops.export_pages(flat._cache, [0])
    assert not flat.ingest_prefix_pages(SYS[:16], meta, blobs)


def test_hits_skip_prefills_counted_as_jax():
    """PREFILL_COUNT counts cold prefills only, in both packages."""
    from paddle_tpu.monitor import metrics as jmx

    jmx.enable()
    tmx.enable()
    j0, t0 = jsm.PREFILL_COUNT.value, tsm.PREFILL_COUNT.value
    hit_run(jserving, KWS["greedy"])
    hit_run(tserving, KWS["greedy"])
    assert tsm.PREFILL_COUNT.value - t0 == jsm.PREFILL_COUNT.value - j0 == 1
