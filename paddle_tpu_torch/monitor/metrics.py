# ported from paddle_tpu/monitor/metrics.py
"""Process-global metrics registry: counters, gauges, fixed-bucket histograms.

The role Fluid scatters across ``platform/profiler.cc`` event counters,
``memory_usage_calc.py`` and ad-hoc VLOG lines, unified the way modern
serving stacks do it (Prometheus-style instruments). Three design rules:

1. **Near-zero overhead when disabled** — every instrument method starts
   with a single ``if not _enabled: return`` branch (no lock, no
   allocation). ``PADDLE_TPU_METRICS=0`` turns the whole subsystem into
   that branch; the default is ON because enabled-path cost is a lock +
   a float add, invisible next to a device step.
2. **Thread-safe when enabled** — reader/prefetcher worker threads and
   the main step loop write concurrently; each instrument carries its own
   lock so there is no global hot lock.
3. **Names are stable strings** (``"executor/cache_hit"``) — the registry
   is get-or-create, so instrumented modules can be imported in any order
   and tests can look instruments up by name.

Export surfaces: ``snapshot()`` (plain dict), ``to_json()``, ``to_text()``
(one line per instrument), ``to_prometheus()`` (text exposition format a
promtool-style validator parses: sanitized names, cumulative ``_bucket``
counts + ``_sum``/``_count`` per histogram), ``reset()`` (zero values, keep
registrations).
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from typing import Dict, List, Optional, Sequence

from ..log import vlog

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "enabled", "enable", "disable",
    "snapshot", "to_json", "to_text", "to_prometheus", "prometheus_name",
    "reset",
    "DEFAULT_TIME_BUCKETS_MS", "log_buckets", "sorted_percentile",
]


def sorted_percentile(xs: Sequence[float], p: float) -> float:
    """p-th percentile (p in [0, 100]) of an already-sorted sample list —
    the one convention shared by StepLogger and StepProfiler readouts
    (floor-index; exact sample values, no interpolation)."""
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(len(xs) * p / 100.0))]


def _env_enabled() -> bool:
    raw = os.environ.get("PADDLE_TPU_METRICS", "1").strip().lower()
    return raw not in ("0", "false", "no", "off", "")


_enabled: bool = _env_enabled()
_registry: Dict[str, "_Instrument"] = {}
_registry_lock = threading.Lock()

# Buckets for wall-time histograms, in milliseconds: sub-ms host overhead up
# through multi-second compiles, roughly 2.5x steps.
DEFAULT_TIME_BUCKETS_MS: Sequence[float] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def log_buckets(lo: float, hi: float,
                per_decade: int = 3) -> Sequence[float]:
    """Geometric histogram bounds covering ``[lo, hi]`` with
    ``per_decade`` buckets per factor of 10 — the bucket scheme for
    quantities spanning many orders of magnitude (tensor absmax ranges run
    1e-8..1e4; no linear ladder holds that). Bounds are plain floats, so
    the existing Histogram/snapshot/to_prometheus machinery needs no
    special casing. ``hi`` is always included as the last bound."""
    if lo <= 0.0:
        raise ValueError("log_buckets: lo must be > 0, got %r" % (lo,))
    if hi <= lo:
        raise ValueError("log_buckets: need hi > lo, got %r <= %r"
                         % (hi, lo))
    if per_decade < 1:
        raise ValueError("log_buckets: per_decade must be >= 1, got %r"
                         % (per_decade,))
    import math

    steps = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    out: List[float] = [float(lo)]
    for i in range(1, steps):
        # each bound from lo directly (no cumulative drift), snapped to 10
        # significant digits so ``le_%g`` labels stay clean
        nxt = float("%.10g" % (lo * 10.0 ** (i / float(per_decade))))
        if nxt >= hi:
            break
        if nxt > out[-1]:
            out.append(nxt)
    if out[-1] < hi:
        out.append(float(hi))
    return tuple(out)


def enabled() -> bool:
    return _enabled


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = bool(flag)


def disable() -> None:
    enable(False)


class _Instrument:
    kind = "instrument"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count (resets only via registry reset)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Instrument):
    """Last-written value (queue depth, HBM bytes, grad norm, ...)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._value = 0.0
        self._written = False

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(v)
            self._written = True

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n
            self._written = True

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value, "set": self._written}

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._written = False


class Histogram(_Instrument):
    """Fixed-bucket histogram with sum/count/min/max and estimated quantiles.

    Buckets are upper bounds (le); observations past the last bound land in
    the +Inf overflow bucket. Quantile estimation interpolates linearly
    inside the containing bucket — the standard Prometheus
    ``histogram_quantile`` behaviour, good enough for p50/p95 step-time
    readouts without retaining raw samples.
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None,
                 help: str = ""):
        super().__init__(name, help)
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_TIME_BUCKETS_MS)))
        if not bounds:
            raise ValueError("histogram %r needs at least one bucket bound" % name)
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1 = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._overflow_warned = False

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        v = float(v)
        # bisect without importing: bucket count is small and fixed
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile (p in [0, 100]) by linear interpolation
        within the containing bucket; exact-ish at the observed min/max.

        A rank landing in the +Inf overflow bucket CLAMPS to the top
        finite bucket edge (one-time vlog) instead of interpolating
        toward the observed max: the overflow bucket has no upper edge,
        so interpolation there manufactures spuriously precise values a
        single outlier drags arbitrarily high — the same honest-lower-
        bound convention telemetry's interval percentiles use."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = max(1.0, math.ceil(total * min(max(p, 0.0), 100.0) / 100.0))
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if i == len(self.bounds):
                    if not self._overflow_warned:
                        self._overflow_warned = True
                        vlog(1, "histogram %s: p%g rank in +Inf overflow "
                                "bucket — clamping to top edge %g (max "
                                "observed %g); widen the buckets",
                             self.name, p, self.bounds[-1], self._max)
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else max(0.0, min(self._min, self.bounds[0]))
                hi = self.bounds[i]
                if rank <= cum + c:
                    frac = (rank - cum) / c
                    est = lo + (hi - lo) * frac
                    return min(max(est, self._min), self._max)
                cum += c
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
            mn = self._min if n else 0.0
            mx = self._max if n else 0.0
        out = {
            "type": "histogram",
            "count": n,
            "sum": s,
            "min": mn,
            "max": mx,
            "mean": (s / n) if n else 0.0,
            "buckets": {("le_%g" % b): c for b, c in zip(self.bounds, counts)},
        }
        out["buckets"]["le_inf"] = counts[-1]
        if n:
            out["p50"] = self.percentile(50)
            out["p95"] = self.percentile(95)
            out["p99"] = self.percentile(99)
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0
            self._overflow_warned = False
            self._min = math.inf
            self._max = -math.inf


def _get_or_create(name: str, cls, **kwargs) -> _Instrument:
    inst = _registry.get(name)
    if inst is not None:
        if not isinstance(inst, cls):
            raise TypeError("metric %r already registered as %s, requested %s"
                            % (name, inst.kind, cls.kind))
        return inst
    with _registry_lock:
        inst = _registry.get(name)
        if inst is None:
            inst = cls(name, **kwargs)
            _registry[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError("metric %r already registered as %s, requested %s"
                            % (name, inst.kind, cls.kind))
        return inst


def counter(name: str, help: str = "") -> Counter:
    return _get_or_create(name, Counter, help=help)


def gauge(name: str, help: str = "") -> Gauge:
    return _get_or_create(name, Gauge, help=help)


def histogram(name: str, buckets: Optional[Sequence[float]] = None,
              help: str = "") -> Histogram:
    inst = _get_or_create(name, Histogram, buckets=buckets, help=help)
    if buckets is not None:
        want = tuple(sorted(float(b) for b in buckets))
        if want != inst.bounds:
            # silently handing back different bounds would skew every
            # percentile the caller computes against its requested buckets
            raise ValueError(
                "histogram %r already registered with buckets %s; "
                "requested %s" % (name, list(inst.bounds), list(want)))
    return inst


def snapshot() -> Dict[str, dict]:
    """Point-in-time view of every registered instrument, as a plain dict
    (JSON-serializable; the ``metrics`` section of bench JSON)."""
    with _registry_lock:
        items = list(_registry.items())
    return {name: inst.snapshot() for name, inst in sorted(items)}


def to_json(indent: Optional[int] = None) -> str:
    return json.dumps(snapshot(), indent=indent, sort_keys=True)


def to_text() -> str:
    """One line per instrument — the quick ``print`` surface."""
    lines: List[str] = []
    for name, snap in snapshot().items():
        t = snap["type"]
        if t == "histogram":
            lines.append(
                "%-40s hist  count=%d mean=%.3f p50=%.3f p95=%.3f p99=%.3f "
                "min=%.3f max=%.3f"
                % (name, snap["count"], snap["mean"], snap.get("p50", 0.0),
                   snap.get("p95", 0.0), snap.get("p99", 0.0),
                   snap["min"], snap["max"]))
        else:
            lines.append("%-40s %-5s value=%g" % (name, t, snap["value"]))
    return "\n".join(lines)


def prometheus_name(name: str) -> str:
    """Instrument name → a valid Prometheus metric name: ``/`` and ``:``
    (and any other illegal character) become ``_``; a leading digit gains a
    ``_`` prefix. Distinct registry names stay distinct in practice because
    every instrument here uses ``/``-separated word segments."""
    out = re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_num(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return "%d" % int(v)
    return repr(float(v))


def to_prometheus() -> str:
    """Render the registry in the Prometheus text exposition format (0.0.4).

    Counters/gauges are one sample each; histograms emit the standard
    triplet — CUMULATIVE ``<name>_bucket{le="..."}`` counts ending in
    ``le="+Inf"``, plus ``<name>_sum`` and ``<name>_count`` — so the output
    parses under promtool-style validators and ``histogram_quantile``
    works on a scrape of it. Names are sanitized via
    :func:`prometheus_name` (``serving/ttft_ms`` → ``serving_ttft_ms``).
    """
    with _registry_lock:
        items = sorted(_registry.items())
    lines: List[str] = []
    for name, inst in items:
        pname = prometheus_name(name)
        if inst.help:
            lines.append("# HELP %s %s" % (pname, _prom_escape_help(inst.help)))
        if isinstance(inst, Histogram):
            lines.append("# TYPE %s histogram" % pname)
            snap = inst.snapshot()
            cum = 0
            bounds = list(inst.bounds)
            counts = [snap["buckets"]["le_%g" % b] for b in bounds]
            counts.append(snap["buckets"]["le_inf"])
            for b, c in zip(bounds + [math.inf], counts):
                cum += c
                le = "+Inf" if b == math.inf else _prom_num(b)
                lines.append('%s_bucket{le="%s"} %d' % (pname, le, cum))
            lines.append("%s_sum %s" % (pname, _prom_num(snap["sum"])))
            lines.append("%s_count %d" % (pname, snap["count"]))
        elif isinstance(inst, Counter):
            lines.append("# TYPE %s counter" % pname)
            lines.append("%s %s" % (pname, _prom_num(inst.value)))
        else:
            lines.append("# TYPE %s gauge" % pname)
            lines.append("%s %s" % (pname, _prom_num(inst.value)))
    return "\n".join(lines) + ("\n" if lines else "")


def reset() -> None:
    """Zero all values; registrations (and module-held instrument handles)
    stay valid."""
    with _registry_lock:
        items = list(_registry.values())
    for inst in items:
        inst.reset()


# The captured step's instruments (``executor._CapturedStep``): CUDA graphs
# captured, their replays, and the wall time of the last capture. The
# kernels' own launch counters count a capture once, never its replays.
CAPTURES = counter("executor/captures",
                   help="training or eval steps captured into a CUDA graph")
REPLAYS = counter("executor/replays", help="replays of captured steps")
CAPTURE_MS = gauge("executor/capture_ms",
                   help="wall ms of the last capture (the graph's "
                        "synchronize, capture and instantiation)")

# The default pass pipeline's instruments (``passes.pipeline``), under the
# JAX package's names; each pass adds ``passes/<name>/ops_removed`` and
# ``passes/<name>/rewrites_matched`` counters and a ``passes/<name>/time_ms``
# histogram as it first reports.
PASS_RUNS = counter("passes/pipeline/runs",
                    help="default-pipeline applications (one per program "
                         "version x fetch-set, never per step)")
PASS_TIME_MS = histogram("passes/pipeline/time_ms",
                         help="wall time of one full default-pipeline run")
PASS_OPS_BEFORE = gauge("passes/pipeline/op_count_before",
                        help="global-block op count entering the last run")
PASS_OPS_AFTER = gauge("passes/pipeline/op_count_after",
                       help="global-block op count leaving the last run")
