# ported from paddle_tpu/reliability/faults.py
"""Deterministic fault injection for crash drills (the chaos layer).

A :class:`FaultPlan` arms named **injection sites** — chokepoints that
already exist in the hot paths (``executor.dispatch``, ``executor.compile``,
``serving.decode``, ``io.save_checkpoint``, ``page_pool.alloc``) — with
typed faults fired at deterministic visit counts, so a drill reproduces the
same failure at the same step every run (seedable when probabilistic
entries are used). Sites poll the plan with :func:`poll`; with no plan
installed and ``PADDLE_TPU_FAULT_PLAN`` unset the whole subsystem costs one
module-global ``None`` check per chokepoint.

Plan grammar (``PADDLE_TPU_FAULT_PLAN`` or :meth:`FaultPlan.parse`)::

    plan    := entry (';' entry)*
    entry   := site '@' N '=' kind [ ':' times [ ':' ms ] ]

``site@N=kind`` fires ``kind`` on the Nth visit to ``site`` (1-based), for
``times`` consecutive visits (default 1); ``ms`` parameterizes ``latency``.
Example::

    PADDLE_TPU_FAULT_PLAN='serving.decode@3=transient:2;executor.dispatch@5=preempt'

Fault kinds:

``preempt``
    delivers SIGTERM to the current process (the preemption-notice shape a
    cloud scheduler sends); the JAX package's supervisor turns it into
    checkpoint-and-exit (not ported yet).
``transient``
    raises :class:`TransientFault` (classified transient — retryable).
``resource``
    raises :class:`InjectedResourceExhausted` (``RESOURCE_EXHAUSTED``, the
    allocator-failure shape; classified fatal — retrying an OOM repeats it).
``fatal``
    raises :class:`InjectedFault` (classified fatal).
``nan``
    no raise; handed back to the site (the executor dispatch site, which
    poisons a feed with it, is not ported yet: its sites come with the
    executor's fault handling).
``latency``
    sleeps ``ms`` milliseconds at the site (deadline/timeout drills).
``exhausted``
    the ``page_pool.alloc`` site raises ``PagePoolExhausted`` (the serving
    backpressure drill) and ``serving.decode`` raises it as an
    exhaustion-shaped dispatch failure (batch eviction); sites without a
    pool ignore it — arm ``resource`` there instead.

:func:`classify` is the one retry-policy oracle the supervisor and the
serving engine share: an exception is ``"preemption"``, ``"transient"``,
``"backpressure"`` or ``"fatal"``.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, Optional, Sequence

from ..monitor import metrics as _mx

__all__ = [
    "FaultPlan", "FaultSpec", "InjectedFault", "TransientFault",
    "InjectedResourceExhausted", "PreemptionRequested",
    "SITES", "KINDS", "install", "clear", "current_plan", "poll",
    "fire", "act", "classify",
]

SITES = ("executor.dispatch", "executor.compile", "serving.decode",
         "io.save_checkpoint", "page_pool.alloc")
KINDS = ("preempt", "transient", "resource", "fatal", "nan", "latency",
         "exhausted")

_m_injected = _mx.counter(
    "reliability/faults_injected",
    help="faults fired by the active FaultPlan, all sites")
class InjectedFault(RuntimeError):
    """A deliberately injected failure (chaos drills). ``classify`` treats
    the base class as fatal; subclasses refine."""


class TransientFault(InjectedFault):
    """Injected failure of the kind that retry-with-backoff should absorb
    (flaky dispatch, dropped RPC, transient runtime hiccup)."""


class InjectedResourceExhausted(InjectedFault):
    """Injected RESOURCE_EXHAUSTED — the allocator-failure shape. Fatal to
    a retry loop (the same step will OOM again)."""


class PreemptionRequested(BaseException):
    """Raised by the supervisor's signal handler path when preemption must
    interrupt host-side work. ``BaseException`` so a broad ``except
    Exception`` retry loop can never swallow a preemption notice."""


class FaultSpec:
    """One armed site: fire ``kind`` on visits [at, at+times) (1-based)."""

    __slots__ = ("site", "kind", "at", "times", "ms", "p")

    def __init__(self, site: str, kind: str, at: int = 1, times: int = 1,
                 ms: float = 0.0, p: Optional[float] = None):
        if site not in SITES:
            raise ValueError("unknown fault site %r (sites: %s)"
                             % (site, ", ".join(SITES)))
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (kinds: %s)"
                             % (kind, ", ".join(KINDS)))
        if at < 1 or times < 1:
            raise ValueError("at/times are 1-based positive counts")
        self.site = site
        self.kind = kind
        self.at = int(at)
        self.times = int(times)
        self.ms = float(ms)
        # Probabilistic arming (programmatic only — the env grammar is
        # deterministic by design): fire with probability p per visit,
        # drawn from the plan's seeded RNG so a drill replays identically
        # for the same seed.
        self.p = p

    def __repr__(self):
        return ("FaultSpec(%s@%d=%s:%d%s)"
                % (self.site, self.at, self.kind, self.times,
                   ":%gms" % self.ms if self.ms else ""))


_ENTRY_RE = re.compile(
    r"^(?P<site>[\w.]+)@(?P<at>\d+)=(?P<kind>\w+)"
    r"(?::(?P<times>\d+))?(?::(?P<ms>\d+(?:\.\d+)?))?$")


class FaultPlan:
    """A deterministic, seedable schedule of faults. Thread-safe visit
    counting so serving/executor threads share one plan."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._hits: Dict[str, int] = {}
        self._fired = 0
        self._lock = threading.Lock()
        self._rng = None  # built lazily, only for probabilistic entries

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = []
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY_RE.match(raw)
            if m is None:
                raise ValueError(
                    "bad fault-plan entry %r (grammar: site@N=kind[:times"
                    "[:ms]])" % raw)
            specs.append(FaultSpec(
                m.group("site"), m.group("kind"), at=int(m.group("at")),
                times=int(m.group("times") or 1),
                ms=float(m.group("ms") or 0.0)))
        return cls(specs, seed=seed)

    # -- introspection --------------------------------------------------------
    @property
    def fired(self) -> int:
        return self._fired

    def hits(self, site: str) -> int:
        return self._hits.get(site, 0)

    # -- the site-facing poll -------------------------------------------------
    def poll(self, site: str) -> Optional[FaultSpec]:
        """Count one visit to ``site``; return the armed spec if a fault
        fires on this visit, else None."""
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.p is not None:
                    if self._rng is None:
                        import numpy as np

                        self._rng = np.random.RandomState(self.seed)
                    if float(self._rng.random_sample()) < spec.p:
                        self._fired += 1
                        _m_injected.inc()
                        return spec
                    continue
                if spec.at <= n < spec.at + spec.times:
                    self._fired += 1
                    _m_injected.inc()
                    return spec
        return None

    # -- installation ---------------------------------------------------------
    def __enter__(self):
        install(self)
        return self

    def __exit__(self, *exc):
        clear()
        return False


_plan: Optional[FaultPlan] = None
_env_cache = (None, None)  # (env string, parsed plan)


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide (wins over the env plan)."""
    global _plan
    _plan = plan
    return plan


def clear() -> None:
    global _plan
    _plan = None


def current_plan() -> Optional[FaultPlan]:
    """The installed plan, else the (cached) ``PADDLE_TPU_FAULT_PLAN`` env
    plan, else None. The None fast path is one global load + env read."""
    global _env_cache
    if _plan is not None:
        return _plan
    text = os.environ.get("PADDLE_TPU_FAULT_PLAN")
    if not text:
        return None
    if _env_cache[0] != text:
        _env_cache = (text, FaultPlan.parse(text))
    return _env_cache[1]


def poll(site: str) -> Optional[FaultSpec]:
    """Visit ``site``; returns the firing spec or None. The no-plan fast
    path is the single branch every chokepoint pays."""
    plan = current_plan()
    if plan is None:
        return None
    return plan.poll(site)


def fire(site: str) -> Optional[FaultSpec]:
    """Poll ``site`` and ACT on raise/sleep/signal kinds; returns the spec
    for kinds the call site must handle itself (``nan``, ``exhausted``) or
    None. The uniform chokepoint entry for sites without special kinds."""
    spec = poll(site)
    if spec is None:
        return None
    return act(spec, site)


def act(spec: FaultSpec, site: str) -> Optional[FaultSpec]:
    """Perform ``spec``'s generic action (raise / sleep / SIGTERM); hand
    back specs whose effect is site-specific."""
    if spec.kind == "latency":
        time.sleep(spec.ms / 1e3 if spec.ms else 0.01)
        return None
    if spec.kind == "preempt":
        import signal

        os.kill(os.getpid(), signal.SIGTERM)
        return None
    if spec.kind == "transient":
        raise TransientFault(
            "injected transient fault at %s (visit %d)" % (site, spec.at))
    if spec.kind == "resource":
        raise InjectedResourceExhausted(
            "RESOURCE_EXHAUSTED: injected allocator failure at %s" % site)
    if spec.kind == "fatal":
        raise InjectedFault("injected fatal fault at %s" % site)
    return spec  # nan / exhausted: the call site owns the effect


_TRANSIENT_MSG = re.compile(
    r"UNAVAILABLE|ABORTED|DATA_LOSS|connection reset|socket closed|"
    r"injected transient", re.IGNORECASE)


def classify(exc: BaseException) -> str:
    """Retry-policy oracle: ``"preemption"`` | ``"transient"`` |
    ``"backpressure"`` | ``"fatal"``. Message heuristics cover runtime
    errors that arrive as a bare ``RuntimeError``."""
    if isinstance(exc, (KeyboardInterrupt, PreemptionRequested)):
        return "preemption"
    if isinstance(exc, TransientFault):
        return "transient"
    if isinstance(exc, InjectedFault):  # resource / fatal
        return "fatal"
    try:  # lazy: serving must stay importable without reliability and v.v.
        from ..serving.request import BackpressureError

        if isinstance(exc, BackpressureError):
            return "backpressure"
    except Exception:
        pass
    if _TRANSIENT_MSG.search(str(exc)):
        return "transient"
    return "fatal"
