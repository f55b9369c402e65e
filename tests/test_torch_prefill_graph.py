"""The serving engine's prefill and prefix-hit resume as one dispatch a
prompt bucket, on the CPU.

On the card each prompt bucket's prefill (``model.prefill``, the prompt's
KV written through its page-table row, the first token sampled at the
last prompt position) is one CUDA graph, and so is each bucket's resume;
on the CPU the same ``CapturedDispatch`` bodies run on their static
inputs. Held here, at test width:

* greedy and seeded-sampled streams over prompts of three buckets equal
  the JAX engine's and the ``cuda_graphs=False`` engine's (the
  contiguous layout sampled), with one dispatch a bucket used;
* each request's first logits row (the dispatch's static buffer) is
  copied out, equal to the JAX engine's;
* ``warmup()`` makes every bucket's prefill and resume dispatch on an
  idle engine and leaves the streams and the page accounting as they
  were;
* a prefix-hit resume padded to its bucket (remainders of 1, 3 and 9
  tokens: buckets 8, 8 and 16) gives the cold prefill's stream and the
  JAX engine's hit stream.
"""

import numpy as np
import pytest

from torch_serving_util import (SMALL, engine, jserving, make_stream,
                                tserving)

BUCKETS = (8, 16, 32)
SYS = list(range(1, 18))  # 17 tokens: 2 full pages of 8 cacheable
KWS = {"greedy": lambda i: {},
       "sampled": lambda i: dict(temperature=(0.7, 1.3)[i % 2],
                                 top_k=(0, 9)[i % 2], seed=300 + i)}


def stream():
    """Prompts of 3 to 30 tokens: every bucket of ``BUCKETS``."""
    out = make_stream(4, seed=4, max_prompt=30, max_new=5)
    return out + [([5] * 3, 4), ([9] * 30, 3)]


def serve(pkg, kind, warm=False, **kw):
    """(streams, first logits rows, engine) of ``stream()``."""
    eng = engine(pkg, slots=2, num_pages=32, prompt_buckets=BUCKETS,
                 collect_logits=True, **kw)
    if warm:
        eng.warmup()
    reqs = [eng.submit(p, m, **KWS[kind](i))
            for i, (p, m) in enumerate(stream())]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    assert eng.page_accounting_ok()
    firsts = [np.asarray(eng.captured_logits(r)[0]) for r in reqs]
    return [list(r.tokens_out) for r in reqs], firsts, eng


@pytest.mark.parametrize("kind,paged", (("greedy", True), ("sampled", True),
                                        ("sampled", False)))
def test_prefill_dispatch_streams_equal_jax_and_eager(kind, paged):
    toks, firsts, eng = serve(tserving, kind, paged=paged)
    used = sorted(k for k in eng.graph_info() if k.startswith("prefill/"))
    assert used == ["prefill/%d/sampled" % b for b in sorted(BUCKETS,
                                                             key=str)]
    assert eng.stats()["prefills"] == len(stream())
    eager, eager_firsts, _ = serve(tserving, kind, paged=paged,
                                   cuda_graphs=False)
    jtoks, jfirsts, _ = serve(jserving, kind, paged=paged)
    assert toks == eager == jtoks
    for got, ref, want in zip(firsts, eager_firsts, jfirsts):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # each row its own copy, not the dispatch's static buffer
    assert len({f.tobytes() for f in firsts}) == len(firsts)


def test_warmup_makes_every_bucket_and_changes_nothing():
    toks, _, eng = serve(tserving, "sampled", warm=True,
                         prefix_cache_pages=8)
    info = eng.graph_info()
    for kind in ("prefill", "resume"):
        for b in BUCKETS:
            assert "%s/%d/sampled" % (kind, b) in info
    cold, _, _ = serve(tserving, "sampled", prefix_cache_pages=8)
    assert toks == cold
    eng.drain(10.0)
    assert eng.pool.num_used == 0


def hit_streams(pkg, kind):
    """A cold request, then the same system prompt with remainders of 1, 3
    and 9 tokens, each a prefix hit: (streams, prefills, resumes, the
    engine)."""
    eng = engine(pkg, slots=2, num_pages=32, prefix_cache_pages=8,
                 prompt_buckets=BUCKETS)
    reqs = [eng.submit(SYS + [30], 5, **KWS[kind](0))]
    eng.run()
    for i, tail in enumerate(([30], [31, 32, 33], [40] * 9), 1):
        reqs.append(eng.submit(SYS + tail, 6, **KWS[kind](i)))
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    h = eng.health()
    return [list(r.tokens_out) for r in reqs], h["prefills"], \
        h["resumes"], eng


@pytest.mark.parametrize("kind", sorted(KWS))
def test_padded_resume_equals_the_cold_stream(kind):
    toks, prefills, resumes, eng = hit_streams(tserving, kind)
    assert (prefills, resumes) == (1, 3)
    resumed = sorted(k for k in eng.graph_info() if k.startswith("resume/"))
    assert resumed == ["resume/16/sampled", "resume/8/sampled"]
    cold = engine(tserving, slots=2, num_pages=32, prompt_buckets=BUCKETS)
    reqs = [cold.submit(SYS + t, m, **KWS[kind](i)) for i, (t, m) in
            enumerate((([30], 5), ([30], 6), ([31, 32, 33], 6),
                       ([40] * 9, 6)))]
    cold.run()
    assert toks == [list(r.tokens_out) for r in reqs]
    assert toks == hit_streams(jserving, kind)[0]
    assert all(0 <= t < SMALL["vocab_size"] for s in toks for t in s)


@pytest.mark.parametrize("enabled", [True, False])
def test_a_capture_pauses_the_cyclic_collector(enabled):
    """Every capture runs under ``serving.captured.gc_paused``: a dead CUDA
    graph freed by the collector during another capture invalidates it on
    the card, so the collector is off inside and as it was after."""
    import gc

    from paddle_tpu_torch.serving.captured import gc_paused

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(ValueError), gc_paused():
            raise ValueError("a failed capture")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
