"""Seeded sampled decoding of the port against the JAX package.

The sampler (``serving.engine._sample_tokens``) on random [B, V] logits
with mixed temperature, top-k, seed and position picks the JAX package's
tokens, and its temperature-0 rows are bit-equal to ``argmax``. The engine
serves sampled requests with the JAX engine's streams, paged (continuous
and static waves) and contiguous, at ``decode_fuse`` 1 and 4; greedy and
sampled requests share a batch without the greedy ones moving.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving.engine import _sample_tokens as jax_sample
from paddle_tpu_torch.serving.engine import _sample_tokens
from torch_serving_util import (jserving, make_stream, models, serve,
                                tserving)

MODES = {"paged-continuous": dict(paged=True, continuous=True),
         "paged-static": dict(paged=True, continuous=False),
         "contiguous": dict(paged=False)}


def sampler_inputs(b, v, seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, v) * 2).astype(np.float32)
    temp = rng.choice([0.0, 0.3, 0.8, 1.0, 1.7], b).astype(np.float32)
    top_k = rng.choice([0, 1, 3, 40, v + 5], b).astype(np.int32)
    seeds = rng.randint(0, 2 ** 31 - 1, b).astype(np.int32)
    pos = rng.randint(0, 1024, b).astype(np.int32)
    temp[:2] = [0.0, 1.0]
    return logits, temp, top_k, seeds, pos


@pytest.mark.parametrize("b,v,seed", [(16, 64, 0), (16, 64, 1),
                                      (64, 257, 2), (8, 50257, 3)])
def test_sampler_tokens_equal_jax(b, v, seed):
    args = sampler_inputs(b, v, seed)
    want = np.asarray(jax_sample(*(jnp.asarray(a) for a in args)))
    got = _sample_tokens(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    logits, temp = args[0], args[1]
    greedy = temp == 0
    assert greedy.any()
    assert (got.numpy()[greedy] == logits[greedy].argmax(-1)).all()


def test_sampler_keeps_top_k_and_varies_with_seed():
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(1, 64).astype(np.float32))
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    drawn = set()
    for s in range(200):
        tok = _sample_tokens(logits, torch.tensor([1.5]), torch.tensor([3]),
                             torch.tensor([s], dtype=torch.int32),
                             torch.tensor([7], dtype=torch.int32))
        drawn.add(int(tok[0]))
    assert drawn == top3


def jax_stream(mode, fuse, kw):
    return serve(jserving, make_stream(8), submit_kw=kw, decode_fuse=fuse,
                 **MODES[mode])[0]


_JAX = {}


def sampled_kw(i):
    return dict(temperature=(0.7, 1.0, 1.3)[i % 3], top_k=(0, 5, 40)[i % 3],
                seed=1000 + i)


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_sampled_streams_identical_to_jax(mode, fuse):
    key = (mode, fuse)
    if key not in _JAX:
        _JAX[key] = jax_stream(mode, fuse, sampled_kw)
    toks, _, ok = serve(tserving, make_stream(8), submit_kw=sampled_kw,
                        decode_fuse=fuse, **MODES[mode])
    assert toks == _JAX[key] and ok


def test_sampled_stream_does_not_depend_on_fuse():
    f1 = serve(tserving, make_stream(8), submit_kw=sampled_kw)[0]
    f4 = serve(tserving, make_stream(8), submit_kw=sampled_kw,
               decode_fuse=4)[0]
    greedy = serve(tserving, make_stream(8))[0]
    assert f1 == f4 and f1 != greedy


def test_temperature_zero_is_greedy_bit_for_bit():
    greedy, lg, _ = serve(tserving, make_stream(6), collect=True)
    t0, lt, _ = serve(tserving, make_stream(6), collect=True,
                      submit_kw=lambda i: dict(temperature=0.0, top_k=5,
                                               seed=123))
    assert t0 == greedy
    for a, b in zip(lg, lt):
        assert np.array_equal(a, b)


def test_mixed_greedy_and_sampled_batch():
    """Per-request sampling parameters ride slot state: one batch serves
    greedy and sampled requests side by side, the greedy ones equal a
    greedy-only run, and the whole batch equals the JAX engine's."""
    stream = make_stream(8, seed=3)

    def kw(i):
        return sampled_kw(i) if i % 2 else {}

    mixed = serve(tserving, stream, submit_kw=kw, decode_fuse=4)[0]
    pure = serve(tserving, stream[0::2], decode_fuse=4)[0]
    assert mixed[0::2] == pure
    assert mixed == serve(jserving, stream, submit_kw=kw, decode_fuse=4)[0]


def test_sampled_top_k_never_leaves_the_top_k():
    k = 3
    _, tm = models()
    eng = tserving.ServingEngine(tm, tserving.ServingConfig(
        slots=2, page_size=8, max_seq=64, prompt_buckets=(16,),
        collect_logits=True), device="cpu")
    stream = make_stream(2, seed=9)
    reqs = [eng.submit(p, 8, temperature=1.5, top_k=k, seed=7 + i)
            for i, (p, _) in enumerate(stream)]
    eng.run()
    checked = 0
    for r in reqs:
        rows = eng.captured_logits(r)
        assert len(rows) == len(r.tokens_out)
        for tok, row in zip(r.tokens_out, rows):
            assert tok in np.argsort(row)[-k:]
            checked += 1
    assert checked == 16
