"""Helpers shared by the serving tests of the PyTorch port: the JAX
package's small decoder and the port's copy of its weights, engine
configs of both packages, and a function that serves a stream and returns
each request's tokens."""

import jax
import numpy as np

from paddle_tpu import serving as jserving
from paddle_tpu.models import decoder_lm as jdl
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import decoder_lm as tdl

SMALL = dict(vocab_size=64, n_layer=2, d_model=32, n_head=2, max_seq=64)
_MODELS = {}


def models(seed=0):
    """(JAX DecoderLM, the port's DecoderLM on the CPU) on one set of
    weights, built once a process."""
    if seed not in _MODELS:
        jm = jdl.DecoderLM(jdl.DecoderConfig(**SMALL), seed=seed)
        tcfg = tdl.DecoderConfig(**SMALL)
        tree = jax.tree_util.tree_map(np.asarray, jm.params)
        tm = tdl.DecoderLM(tcfg, params=tdl.params_from_jax(tree, tcfg, "cpu"),
                           device="cpu")
        _MODELS[seed] = (jm, tm)
    return _MODELS[seed]


def config(pkg, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prompt_buckets", (16,))
    return pkg.ServingConfig(**kw)


def engine(pkg, seed=0, **kw):
    """A serving engine of ``pkg`` (``jserving`` or ``tserving``) on the
    shared weights; the port's runs on the CPU."""
    jm, tm = models(seed)
    if pkg is jserving:
        return jserving.ServingEngine(jm, config(jserving, **kw))
    return tserving.ServingEngine(tm, config(tserving, **kw), device="cpu")


def make_stream(n, seed=0, max_prompt=16, max_new=8):
    rng = np.random.RandomState(seed)
    return [(list(rng.randint(0, SMALL["vocab_size"],
                              int(rng.randint(3, max_prompt + 1)))),
             int(rng.randint(2, max_new + 1))) for _ in range(n)]


def rep_prompts(n=4, motif=3, reps=4, seed=0):
    """Repetitive prompts (a short motif repeated): the n-gram drafter's
    best case, so acceptance is not vacuous."""
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, SMALL["vocab_size"], motif)) * reps
            for _ in range(n)]


def serve(pkg, stream, submit_kw=None, seed=0, collect=False, **kw):
    """Serve ``stream`` ([(prompt, max_new)]) on a fresh engine;
    ``submit_kw(i)`` gives request i's extra submit arguments. Returns
    (tokens per request, logits per request or None, engine stats, page
    accounting held)."""
    eng = engine(pkg, seed=seed, collect_logits=collect, **kw)
    reqs = [eng.submit(p, m, **(submit_kw(i) if submit_kw else {}))
            for i, (p, m) in enumerate(stream)]
    eng.run()
    assert all(r.state == "finished" for r in reqs)
    toks = [list(r.tokens_out) for r in reqs]
    logits = ([np.stack([np.asarray(x) for x in eng.captured_logits(r)])
               for r in reqs] if collect else None)
    ok = eng.page_accounting_ok()
    eng.close()
    return toks, logits, ok
