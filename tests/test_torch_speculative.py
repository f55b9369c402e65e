"""Speculative decoding of the port against the JAX package, after
tests/test_speculative.py: the n-gram drafter proposes the JAX drafter's
tokens, ``residual_sample`` is the same function, ``verify_forward``'s
logits agree to 1e-5, greedy and sampled speculative streams are
bit-identical to plain decode and to the JAX engine's, and every
retirement path (finished, deadline, decode failure, drain) gives every
page back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import decoder_lm as jdl
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch.models import decoder_lm as tdl
from paddle_tpu_torch.reliability import FaultPlan, faults
from paddle_tpu_torch.serving import kv_cache as tkv
from paddle_tpu_torch.serving import metrics as tsm
from paddle_tpu_torch.serving import speculative as tspec
from torch_serving_util import (SMALL, engine, jserving, models,
                                rep_prompts, serve, tserving)


def histories(n=40, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        motif = list(rng.randint(0, 8, rng.randint(1, 5)))
        h = motif * int(rng.randint(1, 4)) + list(rng.randint(0, 8, 3))
        out.append([int(t) for t in h])
    return out


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (2, 2), (4, 2)])
def test_ngram_proposals_equal_jax(max_n, min_n):
    j = jspec.NGramDrafter(max_n=max_n, min_n=min_n)
    t = tspec.make_drafter("ngram", max_n=max_n, min_n=min_n)
    assert t.kind == "ngram"
    for h in histories() + [[], [7], [1, 2, 3, 4, 5, 6]]:
        for k in (0, 1, 3, 8):
            assert t.propose(h, k) == j.propose(h, k), (h, k)


def test_drafter_factory_and_knob_grammar():
    with pytest.raises(ValueError):
        tspec.make_drafter("oracle")
    with pytest.raises(ValueError):
        tspec.NGramDrafter(max_n=1, min_n=2)
    for v in (None, 0, 3, 99, "off", "auto", " 4 ", "none"):
        assert tspec.parse_speculation(v) == jspec.parse_speculation(v)
    with pytest.raises(ValueError):
        tspec.parse_speculation(-1)
    assert tspec.verify_window_args(5, 4, 2) == \
        jspec.verify_window_args(5, 4, 2)


def test_residual_sample_equals_jax():
    rng = np.random.RandomState(3)
    for _ in range(200):
        p = rng.dirichlet(np.ones(16))
        q = rng.dirichlet(np.ones(16))
        d, ua, ur = int(rng.randint(16)), rng.rand(), rng.rand()
        assert tspec.residual_sample(p, q, d, ua, ur) == \
            jspec.residual_sample(p, q, d, ua, ur)


@pytest.mark.parametrize("paged", [True, False])
def test_verify_forward_logits_match_jax(paged):
    """One verify window over a prefilled cache: the same logits (1e-5)
    and the same K/V rows written, in both layouts."""
    jm, tm = models()
    b, w, ps, max_ctx = 3, 4, 8, 64
    rng = np.random.RandomState(1)
    lens = np.array([5, 17, 30], np.int32)
    active = np.array([True, True, False])
    mask = np.ones((b, w), bool)
    mask[1, 2:] = False
    toks = rng.randint(0, SMALL["vocab_size"], (b, w)).astype(np.int32)
    ctx = rng.randn(2, b, max_ctx, SMALL["n_head"], 16).astype(np.float32)
    pages = np.arange(b * max_ctx // ps).reshape(b, -1)[:, ::-1].copy()
    if paged:
        jops = jkv.PagedKVCache(2, 2, 16, b, max_ctx, ps, b * max_ctx // ps)
        tops = tkv.PagedKVCache(2, 2, 16, b, max_ctx, ps, b * max_ctx // ps,
                                device="cpu")
    else:
        jops = jkv.ContiguousKVCache(2, 2, 16, b, max_ctx)
        tops = tkv.ContiguousKVCache(2, 2, 16, b, max_ctx, device="cpu")
    jstate, tstate = jops.init_state(), tops.init_state()
    for layer in range(2):
        for s in range(b):
            n = int(lens[s])
            kv = (ctx[layer, s, :n], ctx[1 - layer, s, :n])
            if paged:
                dest = jops.prompt_dest(pages[s])
                jstate["pt"] = jstate["pt"].at[s].set(jnp.asarray(dest))
                tstate["pt"][s] = torch.as_tensor(dest)
            else:
                dest = jops.prompt_dest(s)
            jstate = jops.write_prompt(jstate, layer, jnp.asarray(kv[0]),
                                       jnp.asarray(kv[1]),
                                       jnp.asarray(dest), n)
            tops.write_prompt(tstate, layer, torch.as_tensor(kv[0]),
                              torch.as_tensor(kv[1]),
                              torch.as_tensor(dest), n)
    jl, jstate = jdl.verify_forward(
        jm.params, jm.cfg, jstate, jops, jnp.asarray(toks),
        jnp.asarray(lens), jnp.asarray(active), jnp.asarray(mask))
    tl, tstate = tdl.verify_forward(
        tm.params, tm.cfg, tstate, tops, torch.as_tensor(toks),
        torch.as_tensor(lens), torch.as_tensor(active),
        torch.as_tensor(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    # the rows the window wrote agree; the sink row of the port is extra
    for name in ("k", "v"):
        want = np.asarray(jstate[name])
        got = tstate[name].numpy()
        got = got[:, :-1] if paged else got[:, :, :-1]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def spec_count(name):
    return {"accepted": tsm.SPEC_ACCEPTED, "proposed": tsm.SPEC_PROPOSED,
            "dispatches": tsm.DECODE_DISPATCHES}[name].value


def rep_stream(n=5, m=12):
    return [(p, m) for p in rep_prompts(n)]


_JAX = {}


def jax_spec(name, kw, **cfg):
    if name not in _JAX:
        _JAX[name] = serve(jserving, rep_stream(), submit_kw=kw,
                           collect=True, **cfg)[:2]
    return _JAX[name]


@pytest.mark.parametrize("fuse", [1, 4])
def test_greedy_speculative_bit_identical_to_plain_and_jax(fuse):
    from paddle_tpu_torch.monitor import metrics as mx

    mx.enable()
    a0, p0 = spec_count("accepted"), spec_count("proposed")
    spec, lspec, ok = serve(tserving, rep_stream(), speculation=4,
                            decode_fuse=fuse, collect=True)
    accepted = spec_count("accepted") - a0
    assert accepted > 0 and spec_count("proposed") - p0 >= accepted
    plain, lplain, _ = serve(tserving, rep_stream(), decode_fuse=fuse,
                             collect=True)
    assert ok and spec == plain
    for a, b in zip(lspec, lplain):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    jtoks, jlog = jax_spec("greedy", None, speculation=4)
    assert spec == jtoks
    for a, b in zip(lspec, jlog):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("temp,top_k", [(0.8, 0), (1.2, 5)])
def test_sampled_speculative_bit_identical_to_plain_and_jax(temp, top_k):
    def kw(i):
        return dict(temperature=temp, top_k=top_k, seed=17 + i)

    spec = serve(tserving, rep_stream(), submit_kw=kw, speculation=4)[0]
    plain = serve(tserving, rep_stream(), submit_kw=kw)[0]
    assert spec == plain
    assert spec == jax_spec("sampled-%s-%d" % (temp, top_k), kw,
                            speculation=4)[0]


def test_speculation_saves_dispatches():
    from paddle_tpu_torch.monitor import metrics as mx

    mx.enable()
    d0 = spec_count("dispatches")
    serve(tserving, rep_stream(4, 14), speculation=4)
    d1 = spec_count("dispatches")
    serve(tserving, rep_stream(4, 14))
    d2 = spec_count("dispatches")
    assert d1 - d0 < d2 - d1


def test_mixed_speculation_per_request():
    prompts = rep_prompts(4)
    eng = engine(tserving)
    reqs = [eng.submit(p, 10, speculation=(4 if i % 2 == 0 else 0))
            for i, p in enumerate(prompts)]
    eng.run()
    assert eng.pool.num_used == 0 and eng.page_accounting_ok()
    assert [r.tokens_out for r in reqs] == \
        serve(tserving, [(p, 10) for p in prompts])[0]


def assert_balanced(eng, label):
    assert eng.pool.num_used == 0, "%s leaked pages" % label
    assert eng.page_accounting_ok(), label


def test_spec_page_accounting_every_retirement_path():
    prompts = rep_prompts(3)
    eng = engine(tserving)
    for p in prompts:
        eng.submit(p, 8, speculation=4)
    eng.run()
    assert_balanced(eng, "finished")

    eng_t = engine(tserving)
    r_dead = eng_t.submit(prompts[0], 32, deadline_s=0.0, speculation=4)
    r_live = eng_t.submit(prompts[1], 4, speculation=4)
    eng_t.run(max_steps=100)
    assert r_dead.state == "timeout" and r_live.state == "finished"
    assert_balanced(eng_t, "timeout")

    eng_f = engine(tserving, decode_retries=0)
    with FaultPlan([faults.FaultSpec("serving.decode", "fatal", at=1)]):
        r_a = eng_f.submit(prompts[0], 6, speculation=4)
        r_b = eng_f.submit(prompts[1], 6, speculation=4)
        eng_f.run(max_steps=100)
    assert r_a.state == "failed" and not r_a.pages
    assert r_b.state in ("failed", "finished")
    assert_balanced(eng_f, "decode-failure")
    r_after = eng_f.submit(prompts[2], 4, speculation=4)
    eng_f.run(max_steps=100)
    assert r_after.state == "finished"
    assert_balanced(eng_f, "post-failure")

    eng_d = engine(tserving)
    for p in prompts:
        eng_d.submit(p, 30, speculation=4)
    eng_d.step()
    eng_d.drain(timeout_s=0.0)
    assert_balanced(eng_d, "drain")


def test_speculation_info_and_stats_surface():
    eng = engine(tserving, speculation=3)
    assert eng.speculation_info() == (3, "ngram", "explicit")
    st = eng.stats()
    assert (st["speculation"], st["spec_drafter"],
            st["speculation_source"]) == (3, "ngram", "explicit")
    assert engine(tserving).speculation_info() == (0, "off", "off")
    auto = tserving.ServingConfig(speculation="auto")
    assert (auto.speculation, auto.speculation_source) == (4, "default")
    jauto = jserving.ServingConfig(speculation="auto")
    assert jauto.speculation == auto.speculation
    with pytest.raises(ValueError):
        engine(tserving).submit([1, 2, 3], 4, speculation=-2)
