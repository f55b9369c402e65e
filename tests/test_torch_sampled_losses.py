"""The port's sampled heads compute the JAX package's formulas.

``nce`` (uniform negatives), ``hierarchical_sigmoid`` (SimpleCode bit
paths) and ``sample_logits`` (log-uniform negatives, the accidental-hit
mask, the log-probability correction) run through both registries on the
same ``RandomState`` inputs. The two packages' generators differ, so the
port draws its samples from a seeded generator and the JAX op is handed
the same draw (``jax.random.randint`` / ``uniform`` patched to return it):
every output, and the gradient of the float outputs against one random
cotangent, to 1e-5; integer outputs identical, dtypes included. The
draws themselves are checked for their bounds and repeat from the seed.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dense_reduce_math import _np, check_op, run_jax, run_port

TOL = (1e-5, 1e-5)


class SeededTrace:
    """A trace whose op draws from one generator seeded from ``seed``."""

    def __init__(self, seed, is_test=False):
        self.gen = torch.Generator().manual_seed(seed)
        self.is_test = is_test
        self.device, self.program = torch.device("cpu"), None

    def op_rng(self, ctx):
        return self.gen


def port_run(op_type, attrs, inputs, outs, diff, cots, seed, is_test=False):
    return run_port(op_type, attrs, inputs, outs, diff, cots or {},
                    SeededTrace(seed, is_test))


def compare(got, got_g, want, want_g):
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        assert str(g.dtype).replace("torch.", "") == str(np.asarray(w).dtype), n
        if np.issubdtype(np.asarray(w).dtype, np.floating):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=TOL[0],
                                       atol=TOL[1], err_msg=n)
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=n)
    for n, w in want_g.items():
        np.testing.assert_allclose(_np(got_g[n]), np.asarray(w), rtol=TOL[0],
                                   atol=TOL[1], err_msg="grad " + n)


def held_to_jax(monkeypatch, op_type, attrs, inputs, outs, diff, draw,
                seed=7, is_test=False):
    """Runs the port with a seeded draw, hands the JAX op that draw
    (``draw(port outputs)`` patches ``jax.random``), runs it with
    random cotangents, reruns the port from the same seed with those
    cotangents and compares."""
    first, _ = port_run(op_type, attrs, inputs, outs, [], None, seed,
                        is_test)
    draw(monkeypatch, first)
    with jax_rng():
        want, want_g, cots = run_jax(op_type, attrs, inputs, outs, diff)
    got, got_g = port_run(op_type, attrs, inputs, outs, diff, cots, seed,
                          is_test)
    for n in first:
        assert torch.equal(first[n].detach(), got[n].detach()), n
    compare(got, got_g, want, want_g)
    return got


@contextlib.contextmanager
def jax_rng():
    """The JAX package's ops draw from a fixed key (the fake op has no
    trace to key them)."""
    from paddle_tpu.core import registry as jreg

    orig = jreg.OpContext.rng
    jreg.OpContext.rng = lambda self: jax.random.PRNGKey(0)
    try:
        yield
    finally:
        jreg.OpContext.rng = orig


def nce_inputs(b=6, d=5, c=13, nt=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"Input": rng.randn(b, d).astype(np.float32),
            "Weight": rng.randn(c, d).astype(np.float32) * 0.5,
            "Bias": rng.randn(c).astype(np.float32) * 0.1,
            "Label": rng.randint(0, c, (b, nt)).astype(np.int64)}


NCE_OUTS = {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1}


def patch_randint(nt):
    def draw(monkeypatch, first):
        neg = jnp.asarray(first["SampleLabels"].numpy()[:, nt:])
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: neg.astype(jnp.int32))
    return draw


@pytest.mark.parametrize("nt,k", ((1, 5), (2, 3)))
def test_nce_matches_jax_on_the_port_draw(monkeypatch, nt, k):
    inputs = nce_inputs(nt=nt)
    attrs = {"num_neg_samples": k, "num_total_classes": 13}
    got = held_to_jax(monkeypatch, "nce", attrs, inputs, NCE_OUTS,
                      ["Input", "Weight", "Bias"], patch_randint(nt))
    samples = got["SampleLabels"].numpy()
    np.testing.assert_array_equal(samples[:, :nt], inputs["Label"])
    assert samples.min() >= 0 and samples.max() < 13


def test_nce_without_bias_and_in_test_mode(monkeypatch):
    inputs = nce_inputs()
    del inputs["Bias"]
    attrs = {"num_neg_samples": 4, "num_total_classes": 13}
    held_to_jax(monkeypatch, "nce", attrs, inputs, NCE_OUTS,
                ["Input", "Weight"], patch_randint(1))
    # is_test: class 0s, no draw, as in the JAX package
    got, _ = port_run("nce", dict(attrs, is_test=True), inputs, NCE_OUTS,
                      [], None, seed=1)
    assert (got["SampleLabels"].numpy()[:, 1:] == 0).all()
    with jax_rng():
        check_op("nce", dict(attrs, is_test=True), inputs, NCE_OUTS,
                 tol=TOL, grad_tol=TOL)


def test_nce_draw_is_uniform_and_seeded():
    inputs = nce_inputs(b=2000, c=13)
    attrs = {"num_neg_samples": 10, "num_total_classes": 13}
    a, _ = port_run("nce", attrs, inputs, NCE_OUTS, [], None, seed=3)
    b, _ = port_run("nce", attrs, inputs, NCE_OUTS, [], None, seed=3)
    assert torch.equal(a["SampleLabels"], b["SampleLabels"])
    neg = a["SampleLabels"].numpy()[:, 1:].ravel()
    counts = np.bincount(neg, minlength=13)
    # 20,000 draws over 13 classes: each within 5 sigma of 1538
    assert counts.min() > 1538 - 5 * 37 and counts.max() < 1538 + 5 * 37


@pytest.mark.parametrize("c", (2, 7, 16, 33))
@pytest.mark.parametrize("bias", (True, False))
def test_hsigmoid_matches_jax(c, bias):
    rng = np.random.RandomState(c)
    inputs = {"X": rng.randn(9, 6).astype(np.float32),
              "W": rng.randn(c - 1, 6).astype(np.float32) * 0.5,
              "Label": rng.randint(0, c, (9, 1)).astype(np.int64)}
    if bias:
        inputs["Bias"] = rng.randn(c - 1).astype(np.float32) * 0.1
    check_op("hierarchical_sigmoid", {"num_classes": c}, inputs,
             {"Out": 1, "PreOut": 1}, tol=TOL, grad_tol=TOL,
             diff=[n for n in ("X", "W", "Bias") if n in inputs])


SL_OUTS = {"Samples": 1, "Probabilities": 1, "SampledLogits": 1,
           "SampledLabels": 1}


def patch_uniform(nt, c):
    """A uniform draw from which the JAX op's inverse CDF gives the port's
    negatives: exp(u log(c + 1)) - 1 = neg + 0.5."""
    def draw(monkeypatch, first):
        neg = first["Samples"].numpy()[:, nt:].astype(np.float64)
        u = np.log(neg + 1.5) / np.log(c + 1.0)
        monkeypatch.setattr(jax.random, "uniform",
                            lambda *a, **k: jnp.asarray(u, jnp.float32))
    return draw


@pytest.mark.parametrize("nt,s,hits", ((1, 8, True), (2, 6, True),
                                        (1, 8, False)))
def test_sample_logits_matches_jax_on_the_port_draw(monkeypatch, nt, s,
                                                    hits):
    rng = np.random.RandomState(nt + s)
    c = 20
    inputs = {"Logits": rng.randn(7, c).astype(np.float32),
              "Labels": rng.randint(0, 4, (7, nt)).astype(np.int64)}
    attrs = {"num_samples": s, "remove_accidental_hits": hits}
    got = held_to_jax(monkeypatch, "sample_logits", attrs, inputs, SL_OUTS,
                      ["Logits"], patch_uniform(nt, c))
    samples = got["Samples"].numpy()
    assert samples.min() >= 0 and samples.max() < c


def test_sample_logits_customized_samples_match_jax():
    rng = np.random.RandomState(9)
    samples = np.concatenate([rng.randint(0, 10, (5, 1)),
                              rng.randint(0, 10, (5, 4))], axis=1)
    inputs = {"Logits": rng.randn(5, 10).astype(np.float32),
              "Labels": samples[:, :1].astype(np.int64),
              "CustomizedSamples": samples.astype(np.int64),
              "CustomizedProbabilities": rng.rand(5, 5).astype(np.float32)}
    check_op("sample_logits", {"num_samples": 4}, inputs, SL_OUTS, tol=TOL,
             grad_tol=TOL, diff=["Logits"])


def test_sample_logits_draw_is_log_uniform():
    c = 50
    inputs = {"Logits": np.zeros((4000, c), np.float32),
              "Labels": np.zeros((4000, 1), np.int64)}
    got, _ = port_run("sample_logits", {"num_samples": 5}, inputs, SL_OUTS,
                      [], None, seed=5)
    neg = got["Samples"].numpy()[:, 1:].ravel()
    freq = np.bincount(neg, minlength=c) / neg.size
    want = np.log((np.arange(c) + 2.0) / (np.arange(c) + 1.0)) \
        / np.log(c + 1.0)
    # the Zipfian law, each class within 5 sigma of its share
    sigma = np.sqrt(want * (1 - want) / neg.size)
    assert (np.abs(freq - want) < 5 * sigma + 1e-4).all()
