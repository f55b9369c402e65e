# ported from paddle_tpu/passes/pipeline.py
"""Default optimization pipeline + the Executor's entry point.

``PADDLE_TPU_OPT_LEVEL`` (default 1) gates everything:

* ``0`` — no default passes; programs run exactly as built.
* ``1`` — constant folding, CSE, fused-kernel pattern rewrites
  (softmax+cross_entropy, unfused attention -> flash), conv+bn weight
  folding (inference programs), then dead-op/dead-var elimination.
* ``2`` — level 1 applied to a fixpoint (a second round picks up chains
  the first round's rewrites exposed).

Individual passes can be switched off with ``PADDLE_TPU_PASS_<NAME>=0``
(e.g. ``PADDLE_TPU_PASS_COMMON_SUBEXPRESSION_ELIMINATION=0``). These are
the JAX package's variables, so one environment drives both packages.

The Executor calls :func:`maybe_optimize` in ``run`` and ``run_steps``
*before* it resolves a plan or a captured step, so the optimized program is
the one the plans, the captured steps and the Predictor key on. Results
are memoized on the source Program keyed by (version, fetch set, opt
level, gate set) with the deriving scope held by weakref — a cache-hit run
never re-enters a pass, and the source program itself is NEVER mutated
(passes run on a clone).
"""

from __future__ import annotations

import contextlib
import os
import time
import weakref
from typing import Iterable, Optional

from ..core.pass_framework import PassBuilder, get_pass
from ..monitor import metrics as _mx
from . import analysis as A

__all__ = [
    "DEFAULT_PASS_NAMES", "opt_level", "pass_enabled", "default_pipeline",
    "optimize_program", "maybe_optimize", "pass_gate_overrides",
]

# Order matters: folding exposes CSE opportunities, both feed the pattern
# matchers cleaner graphs, and DCE last sweeps every leftover intermediate.
DEFAULT_PASS_NAMES = (
    "constant_folding",
    "common_subexpression_elimination",
    "softmax_xent_fuse_pass",
    "flash_attention_rewrite",
    "conv_bn_fuse_pass",
    "dead_code_elimination",
)

# Passes that DELETE the defining op of a value that is still computed
# (folded chains, merged duplicates, rewritten compositions). They may only
# run when the fetch set is KNOWN — at build time any named intermediate
# could still be fetched later, and removing its def would turn a formerly
# working `fetch_list=[name]` into a KeyError. conv_bn + DCE are fetch-safe
# in conservative mode (DCE keeps everything transitively feeding a leaf).
_NEEDS_FETCH_INFO = frozenset({
    "constant_folding",
    "common_subexpression_elimination",
    "softmax_xent_fuse_pass",
    "flash_attention_rewrite",
})

_m_runs = _mx.PASS_RUNS
_m_time = _mx.PASS_TIME_MS
_m_before = _mx.PASS_OPS_BEFORE
_m_after = _mx.PASS_OPS_AFTER


def opt_level() -> int:
    """Current ``PADDLE_TPU_OPT_LEVEL`` (read per call so tests and REPLs
    can flip it without restarting), clamped to 0..2."""
    raw = os.environ.get("PADDLE_TPU_OPT_LEVEL", "1").strip()
    try:
        lvl = int(raw)
    except ValueError:
        lvl = 1
    return max(0, min(2, lvl))


def pass_enabled(name: str) -> bool:
    raw = os.environ.get("PADDLE_TPU_PASS_" + name.upper(), "1")
    return raw.strip().lower() not in ("0", "false", "no", "off")


@contextlib.contextmanager
def pass_gate_overrides(disabled: Iterable[str]):
    """Temporarily force ``PADDLE_TPU_PASS_<NAME>=0`` for each name in
    ``disabled`` (restoring prior values on exit). :func:`maybe_optimize`
    keys its memo on the active gate set, so flipping gates here yields a
    freshly optimized clone instead of a stale cache hit (the JAX
    package's autotuner measures candidate gate sets through it)."""
    saved = {}
    try:
        for name in disabled:
            key = "PADDLE_TPU_PASS_" + str(name).upper()
            saved[key] = os.environ.get(key)
            os.environ[key] = "0"
        yield
    finally:
        for key, prev in saved.items():
            if prev is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = prev


def default_pipeline(scope=None, fetch_names: Optional[Iterable[str]] = None,
                     protected: Optional[set] = None,
                     level: Optional[int] = None) -> PassBuilder:
    """The default PassBuilder for ``level`` (current env level when None).
    ``conv_bn_fuse_pass`` joins only when a scope is available (it folds
    parameter *values*)."""
    lvl = opt_level() if level is None else level
    builder = PassBuilder()
    if lvl <= 0:
        return builder
    for name in DEFAULT_PASS_NAMES:
        if not pass_enabled(name):
            continue
        if fetch_names is None and name in _NEEDS_FETCH_INFO:
            continue  # def-removing passes wait for real fetch targets
        if name == "conv_bn_fuse_pass":
            if scope is None:
                continue
            from .. import transpiler  # noqa: F401 — registers the pass
        p = get_pass(name)
        if scope is not None:
            p.set_attr("scope", scope)
        if fetch_names is not None:
            p.set_attr("fetch_names", tuple(fetch_names))
        if protected:
            p.set_attr("protected", set(protected))
        builder.append_pass(p)
    return builder


def _mirror_pass_metrics(builder: PassBuilder) -> None:
    if not _mx._enabled:
        return
    for p in builder.all_passes():
        name = p.name or type(p).__name__
        removed = p.attr("ops_removed")
        if removed:
            _mx.counter("passes/%s/ops_removed" % name).inc(removed)
        rewrites = p.attr("rewrites_matched")
        if rewrites:
            _mx.counter("passes/%s/rewrites_matched" % name).inc(rewrites)
        fused = p.attr("fused_count")
        if fused:
            _mx.counter("passes/%s/rewrites_matched" % name).inc(fused)


def optimize_program(program, fetch_names: Optional[Iterable[str]] = None,
                     scope=None, level: Optional[int] = None):
    """Clone ``program``, stamp RNG slots, run the default pipeline, return
    the optimized clone (the source is left untouched). A second
    application to the result is a no-op by construction (stamps and
    rewrites are idempotent)."""
    lvl = opt_level() if level is None else level
    if lvl <= 0 or not program.global_block.ops:
        return program

    t0 = time.perf_counter()
    work = program.clone()
    A.stamp_rng_slots(work)
    # freeze each op's source position (the JAX package's attribution
    # identity) BEFORE any pass deletes/moves ops — as the RNG slots
    A.stamp_op_slots(work)

    protected = A.protected_names(work, fetch_names or ())
    builder = default_pipeline(scope=scope, fetch_names=fetch_names,
                               protected=protected, level=lvl)
    n_before = len(work.global_block.ops)
    rounds = 2 if lvl >= 2 else 1
    for _ in range(rounds):
        work = builder.apply_all(work)
        _mirror_pass_metrics(builder)
    if _mx._enabled:
        _m_runs.inc()
        _m_before.set(n_before)
        _m_after.set(len(work.global_block.ops))
        _m_time.observe((time.perf_counter() - t0) * 1e3)
    return work


def maybe_optimize(program, fetch_names=None, scope=None):
    """Memoized :func:`optimize_program` — the Executor's per-run entry.

    The cache lives ON the source program (version-keyed, like the
    dispatch-plan table) so it dies with it and a version bump invalidates
    it; re-running a pass on a cache hit is a bug this function exists to
    prevent. The scope is part of the identity of a clone that folded
    VALUES from it (conv+bn) — held by weakref, so a dead scope's entry can
    never be served to an unrelated new scope that reused its id, and dead
    entries are pruned as they are seen. A clone that read no scope value
    serves every scope (unlike the JAX package, which re-optimizes when
    the scope changes): the port's captured legs alternate an eager scope
    and a captured copy of it, and a fresh clone at every switch would
    re-plan and re-capture the step each time."""
    lvl = opt_level()
    if lvl <= 0:
        return program
    if getattr(program, "_opt_product", False):
        return program  # already a pipeline output; never re-optimize
    # flipping a PADDLE_TPU_PASS_* gate mid-process must not be masked by a
    # memo hit — the active gate set is part of the identity
    gates = tuple(n for n in DEFAULT_PASS_NAMES if not pass_enabled(n))
    key = (tuple(fetch_names or ()), lvl, gates)
    entry = getattr(program, "_opt_cache", None)
    if entry is None or entry[0] != program._version:
        entry = (program._version, {})
        program._opt_cache = entry
    cache = entry[1]
    hit = cache.get(key)
    if hit is not None:
        scope_ref, cached = hit
        live = scope_ref() if scope_ref is not None else None
        if not getattr(cached, "_fold_sources", None):
            return cached
        if ((scope_ref is None and scope is None) or live is scope) \
                and _fold_sources_fresh(cached, scope):
            return cached
        del cache[key]  # dead/foreign scope or value-stale fold
    opt = optimize_program(program, fetch_names=fetch_names, scope=scope,
                           level=lvl)
    if opt is not program:
        opt._opt_product = True
    cache[key] = (weakref.ref(scope) if scope is not None else None, opt)
    return opt


def _fold_sources_fresh(cached, scope):
    """Value-folding passes (conv+bn) bake SCOPE VALUES into the optimized
    clone; the clone records which objects it read (``_fold_sources``). A
    checkpoint load — or a train step updating the weights — replaces those
    scope entries with new objects, which this identity check catches, so
    the memo never serves a fold derived from superseded values (even for
    clones like ``clone(for_test=True)`` programs that a version bump on
    the train program cannot reach)."""
    sources = getattr(cached, "_fold_sources", None)
    if not sources:
        return True
    if scope is None:
        return False
    return all(scope.find_var(name) is obj for name, obj in sources.items())
