"""Typed metrics registry: counters, gauges, streaming distributions
(a copy of ``neuroimagedisttraining_tpu/obs/metrics.py``, which imports no
JAX).

One registry per run (the runner's ObsSession owns it; a process-global
default serves library callers like ``parallel.collectives`` and
``bench.py``). Three metric types:

* :class:`Counter` — monotone accumulator (``inc``).
* :class:`Gauge` — last-value-wins (``set``), e.g. HBM watermarks.
* :class:`Distribution` — streaming count/sum/min/max plus p50/p99 from
  a bounded deterministic reservoir (no t-digest dependency; at the
  per-round cadence the reservoir IS the full sample until ~512 obs).

Labels: every metric can fork labeled children
(``reg.distribution("agg_ms").labels(impl="sparse")``) behind a bounded
cardinality guard — crossing ``max_label_sets`` raises
:class:`LabelCardinalityError` explicitly (a runaway label like a raw
round index must die loudly, not OOM the registry).

``SectionTimer`` is the accumulating named-section wall timer that
replaces ``utils.profiling.Timer`` (which now shims onto it with a
``DeprecationWarning``); ``Registry.timer`` is the one-shot section
variant whose elapsed time is readable from the returned handle.
"""
from __future__ import annotations

import contextlib
import math
import random
import time
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

__all__ = [
    "Counter", "Distribution", "Gauge", "LabelCardinalityError",
    "MetricsRegistry", "SectionTimer", "get_registry", "mad", "median",
    "set_registry",
]


def median(xs) -> float:
    """Exact median of a non-empty sequence (shared by the analysis
    layer's robust statistics — obs/analyze.py outlier flags and
    obs/regress.py noise bands must not drift apart)."""
    s = sorted(xs)
    n = len(s)
    if not n:
        raise ValueError("median of an empty sequence")
    mid = n // 2
    return float(s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid]))


def mad(xs, center: Optional[float] = None) -> float:
    """Median absolute deviation about ``center`` (default: median)."""
    c = median(xs) if center is None else center
    return median([abs(x - c) for x in xs])


def robust_sigma(xs, center: Optional[float] = None) -> float:
    """``1.4826 * MAD`` — the robust standard-deviation estimator
    every outlier threshold in obs/ derives from (one owner of the
    normal-consistency constant; callers apply their own floors)."""
    return 1.4826 * mad(xs, center)

#: default bound on distinct label-sets per metric family
MAX_LABEL_SETS = 64

#: reservoir size for distribution quantiles (exact until this many obs)
RESERVOIR_SIZE = 512


class LabelCardinalityError(RuntimeError):
    """A metric family exceeded its bounded label cardinality."""


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared label-fanout machinery for the three metric types."""

    kind = "metric"

    def __init__(self, name: str, max_label_sets: int = MAX_LABEL_SETS):
        self.name = name
        self._children: Dict[Tuple[Tuple[str, str], ...], "_Metric"] = {}
        self._max_label_sets = max_label_sets

    def labels(self, **labels: Any) -> "_Metric":
        """The child metric for this label-set (created on first use,
        bounded by the cardinality guard)."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self._max_label_sets:
                raise LabelCardinalityError(
                    f"metric {self.name!r} would exceed "
                    f"{self._max_label_sets} label sets (adding {labels!r})"
                    " — unbounded labels (e.g. a raw round index) must be"
                    " record fields, not labels")
            child = self._child()
            self._children[key] = child
        return child

    def _child(self) -> "_Metric":
        """A fresh same-type metric for one label-set (subclasses with
        extra construction state — Distribution's reservoir size —
        override to propagate it)."""
        return type(self)(self.name, max_label_sets=self._max_label_sets)

    def _value_snapshot(self) -> Any:
        raise NotImplementedError  # pragma: no cover - abstract

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": self.kind,
                               "value": self._value_snapshot()}
        if self._children:
            out["labeled"] = {
                ",".join(f"{k}={v}" for k, v in key): c._value_snapshot()
                for key, c in sorted(self._children.items())}
        return out


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, max_label_sets: int = MAX_LABEL_SETS):
        super().__init__(name, max_label_sets)
        self._value = 0.0

    def inc(self, value: float = 1.0) -> None:
        v = float(value)
        if v < 0:
            raise ValueError(
                f"counter {self.name!r}: negative increment {v} (use a "
                "gauge for values that go down)")
        self._value += v

    @property
    def value(self) -> float:
        return self._value

    def _value_snapshot(self) -> float:
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, max_label_sets: int = MAX_LABEL_SETS):
        super().__init__(name, max_label_sets)
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        return self._value

    def _value_snapshot(self) -> Optional[float]:
        return self._value


class Distribution(_Metric):
    """Streaming distribution: exact count/sum/min/max/last, p50/p99 from
    a deterministic bounded reservoir (seeded per-name, so two runs with
    the same observation stream report the same quantiles)."""

    kind = "distribution"

    def __init__(self, name: str, max_label_sets: int = MAX_LABEL_SETS,
                 reservoir_size: int = RESERVOIR_SIZE):
        super().__init__(name, max_label_sets)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last: Optional[float] = None
        self._reservoir: list = []
        self._reservoir_size = reservoir_size
        # crc32, NOT hash(): str hashing is salted per process
        # (PYTHONHASHSEED), which would break the same-stream ->
        # same-quantiles determinism this class documents
        self._rng = random.Random(zlib.crc32(name.encode()))

    def _child(self) -> "Distribution":
        return Distribution(self.name,
                            max_label_sets=self._max_label_sets,
                            reservoir_size=self._reservoir_size)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.last = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._reservoir) < self._reservoir_size:
            self._reservoir.append(v)
        else:  # Vitter's algorithm R
            j = self._rng.randrange(self.count)
            if j < self._reservoir_size:
                self._reservoir[j] = v

    def quantile(self, q: float) -> Optional[float]:
        if not self._reservoir:
            return None
        s = sorted(self._reservoir)
        idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[idx]

    def _value_snapshot(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count, "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min, "max": self.max, "last": self.last,
            "p50": self.quantile(0.50), "p99": self.quantile(0.99),
        }


class _TimerHandle:
    """Handle returned by ``Registry.timer``: after the ``with`` block,
    ``elapsed`` holds the section's wall seconds (also observed into the
    backing distribution) — callers like ``bench.py`` read their section
    timing from the registry through it."""

    __slots__ = ("elapsed",)

    def __init__(self) -> None:
        self.elapsed: float = 0.0


class MetricsRegistry:
    """Get-or-create metric registry with type checking: asking for the
    same name as a different type raises (silent aliasing would corrupt
    both series)."""

    def __init__(self, max_label_sets: int = MAX_LABEL_SETS):
        self._metrics: Dict[str, _Metric] = {}
        self._max_label_sets = max_label_sets

    def _get(self, name: str, cls) -> Any:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(
                name, max_label_sets=self._max_label_sets)
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def distribution(self, name: str) -> Distribution:
        return self._get(name, Distribution)

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[_TimerHandle]:
        """Time a section into ``distribution(name)`` (seconds); the
        yielded handle exposes ``elapsed`` after the block."""
        h = _TimerHandle()
        t0 = time.perf_counter()
        try:
            yield h
        finally:
            h.elapsed = time.perf_counter() - t0
            self.distribution(name).observe(h.elapsed)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe nested dict of every metric (the ``metrics.json``
        payload)."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        self._metrics.clear()

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)


class SectionTimer:
    """Accumulating wall-clock timer with named sections — the
    registry-backed replacement for ``utils.profiling.Timer`` (same
    ``section``/``summary`` surface; ``summary()`` shape is unchanged so
    existing consumers keep working)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = ""):
        self._registry = registry if registry is not None \
            else MetricsRegistry()
        self._prefix = prefix
        self._names: list = []

    @contextlib.contextmanager
    def section(self, name: str):
        full = self._prefix + name
        if full not in self._names:
            self._names.append(full)
        with self._registry.timer(full):
            yield

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for full in self._names:
            d = self._registry.distribution(full)
            if d.count:
                out[full[len(self._prefix):]] = {
                    "total_s": d.sum, "count": d.count,
                    "mean_s": d.sum / d.count}
        return out


# -- process-global default registry ------------------------------------
# Library callers with no run context (collectives' agg micro-bench,
# bench.py's section timers) record here; the runner's ObsSession uses
# its OWN registry so per-run metrics.json never mixes runs.

_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the process-global default (None installs a fresh one);
    returns the previous registry so tests/callers can restore it."""
    global _default
    prev = _default
    _default = registry if registry is not None else MetricsRegistry()
    return prev
