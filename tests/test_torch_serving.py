"""The port's ServingEngine against the JAX package's, on the same weights.

Greedy token streams must be IDENTICAL, and every emitted token's logits
agree to 1e-5 (float32, the same math summed in another order), in the
paged layout with continuous batching and with static waves and in the
contiguous layout, at ``decode_fuse`` 1 and 4. Also: page accounting,
backpressure under a half-size pool, the rules that keep the port on the
card unless asked for the CPU, and the rule that the port imports neither
``jax`` nor ``paddle_tpu``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import decoder_lm as jdl
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import decoder_lm as tdl
from paddle_tpu_torch.serving import metrics as tsm

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=64, n_layer=2, d_model=32, n_head=2, max_seq=64)
MODES = {"paged-continuous": dict(paged=True, continuous=True),
         "paged-static": dict(paged=True, continuous=False),
         "contiguous": dict(paged=False)}


@pytest.fixture(scope="module")
def models():
    jm = jdl.DecoderLM(jdl.DecoderConfig(**SMALL), seed=0)
    tcfg = tdl.DecoderConfig(**SMALL)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    tm = tdl.DecoderLM(tcfg, params=tdl.params_from_jax(tree, tcfg, "cpu"),
                       device="cpu")
    return jm, tm


def make_stream(n, seed=0, max_prompt=16, max_new=8):
    rng = np.random.RandomState(seed)
    return [(list(rng.randint(0, SMALL["vocab_size"],
                              int(rng.randint(3, max_prompt + 1)))),
             int(rng.randint(2, max_new + 1))) for _ in range(n)]


def config(pkg, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prompt_buckets", (16,))
    return pkg.ServingConfig(collect_logits=True, **kw)


def drive(eng, stream):
    reqs = [eng.submit(p, m) for p, m in stream]
    done = eng.run()
    assert len(done) == len(reqs)
    assert all(r.state == "finished" for r in reqs)
    return reqs


_JAX_RUNS = {}  # (mode, fuse) -> [(tokens, logits)] per request


def jax_run(jm, mode, fuse):
    """The JAX engine's streams and logits on the 8-request stream."""
    key = (mode, fuse)
    if key not in _JAX_RUNS:
        eng = jserving.ServingEngine(
            jm, config(jserving, decode_fuse=fuse, **MODES[mode]))
        reqs = drive(eng, make_stream(8))
        _JAX_RUNS[key] = [(r.tokens_out, eng.captured_logits(r))
                          for r in reqs]
        eng.close()
    return _JAX_RUNS[key]


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_streams_identical_to_jax(models, mode, fuse):
    jm, tm = models
    want = jax_run(jm, mode, fuse)
    eng = tserving.ServingEngine(
        tm, config(tserving, decode_fuse=fuse, **MODES[mode]), device="cpu")
    reqs = drive(eng, make_stream(8))
    for r, (toks, logits) in zip(reqs, want):
        assert r.tokens_out == toks
        np.testing.assert_allclose(np.stack(eng.captured_logits(r)),
                                   np.stack(logits), rtol=1e-5, atol=1e-5)
    assert eng.page_accounting_ok()
    st = eng.stats()
    assert st["layout"] == ("paged" if MODES[mode]["paged"] else "contiguous")
    assert st["decode_kernel"] == "gather"  # the CPU runs the plain version
    assert st["decode_steps"] % fuse == 0 and st["prefills"] == 8
    if MODES[mode]["paged"]:
        assert st["pages_in_use"] == 0


def test_eos_stops_streams_identically(models):
    """With ``eos_id`` set to the most frequent token of the plain run, the
    streams stop at it in both packages and stay identical."""
    jm, tm = models
    toks = [t for r, _ in jax_run(jm, "paged-continuous", 1) for t in r[1:]]
    eos = int(np.bincount(toks).argmax())
    jeng = jserving.ServingEngine(jm, config(jserving, eos_id=eos))
    want = [r.tokens_out for r in drive(jeng, make_stream(8))]
    jeng.close()
    teng = tserving.ServingEngine(tm, config(tserving, eos_id=eos),
                                  device="cpu")
    got = [r.tokens_out for r in drive(teng, make_stream(8))]
    assert got == want
    assert any(t[-1] == eos and len(t) < m
               for t, (_, m) in zip(got, make_stream(8)))


def test_admission_backpressures_under_half_pool(models):
    _, tm = models
    full = 4 * 64 // 8
    eng = tserving.ServingEngine(
        tm, config(tserving, num_pages=full // 2), device="cpu")
    blocked0 = tsm.ADMISSION_BLOCKED.value
    stream = make_stream(12, seed=1, max_prompt=16, max_new=40)
    reqs = [eng.submit(p, m) for p, m in stream]
    while not eng.scheduler.idle():
        eng.step()
        assert eng.page_accounting_ok()
        assert eng.pool.num_used <= full // 2
    assert tsm.ADMISSION_BLOCKED.value > blocked0
    # scheduling moved, the streams did not: same as a full pool
    ref = tserving.ServingEngine(tm, config(tserving), device="cpu")
    for a, b in zip(reqs, drive(ref, stream)):
        assert a.tokens_out == b.tokens_out
    with pytest.raises(ValueError):  # can never fit the pool
        eng.submit([1] * 8, 8 * (full // 2))


def test_sampled_decoding_is_not_ported_yet(models):
    _, tm = models
    eng = tserving.ServingEngine(tm, config(tserving), device="cpu")
    with pytest.raises(NotImplementedError, match="threefry"):
        eng.submit([1, 2, 3], 4, temperature=0.5)
    assert eng.scheduler.queue_depth == 0


def test_entry_points_raise_without_a_gpu(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.ServingEngine(tm, config(tserving))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdl.DecoderLM(tdl.DecoderConfig(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdl.init_params(tdl.DecoderConfig(**SMALL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.PagedKVCache(2, 2, 16, 4, 64, 8, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.ContiguousKVCache(2, 2, 16, 4, 64)
    cfg = tserving.ServingConfig(decode_fuse="auto")
    assert (cfg.decode_fuse, cfg.decode_fuse_source) == (1, "default")


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models.decoder_lm, "
            "paddle_tpu_torch.ops.kernels.paged_attention, "
            "paddle_tpu_torch.executor, paddle_tpu_torch.layers, "
            "paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.ops.kernels.softmax_xent, "
            "paddle_tpu_torch.amp, "
            "paddle_tpu_torch.ops.kernels.flash_attention, "
            "paddle_tpu_torch.core.sparse, "
            "paddle_tpu_torch.ops.kernels.sparse_adam, "
            "paddle_tpu_torch.models.deepfm; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_name_no_jax_import():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"paddle_tpu_torch/amp.py",
            "paddle_tpu_torch/ops/kernels/flash_attention.py",
            "paddle_tpu_torch/ops/kernels/sparse_adam.py",
            "paddle_tpu_torch/models/deepfm.py"} <= names
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), (f, mod)
