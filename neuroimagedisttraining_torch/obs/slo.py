"""Online SLO engine: declarative objectives, streaming estimators,
error budgets, and the run-health state machine (a copy of
``neuroimagedisttraining_tpu/obs/slo.py``, which imports no JAX).

Everything diagnostic built so far is post-hoc (``obs/analyze.py`` runs
after the run; ``perf_gate.py`` gates *between* runs). This module
closes the loop **in-run**: a declarative SLO spec is evaluated
incrementally at the ``ObsSession`` record hook with O(1)-memory
streaming estimators, SRE-style error budgets with fast/slow
multi-window burn-rate alerts, and an ``OK -> DEGRADED -> FAILING``
run-health state machine (with hysteresis) whose state is stamped on
every JSONL round line.

Spec DSL (``--slo_spec``, inline ``;``-separated or a file with one
objective per line, ``#`` comments)::

    p99:round_time_s<2.5@w=20        # windowed p99 under 2.5 s
    rate:clients_quarantined<0.1@w=50  # windowed mean under 0.1/round
    ewma:global_acc>0.55@a=0.2       # EWMA drift floor
    slope:mem_device_bytes_in_use<1e6  # leak slope under 1 MB/round

Grammar: ``<kind>:<metric><op><threshold>[@k=v,...]`` with

* ``kind`` — ``p50``/``p90``/``p99``/``p999``... (the digits are the
  decimal fraction, ``p99`` = 0.99; windowed quantile by default,
  ``w=0`` switches to the O(1) P² streaming estimator and ``res=N``
  to the fixed deterministic reservoir over the whole run; ambiguous
  spellings — single-digit ``p5``, percentile-style ``p100`` — are
  refused), ``rate`` (windowed mean), ``ewma`` (exponential moving
  average, ``a=`` alpha), ``slope`` (windowed least-squares slope per
  round);
* ``metric`` — any numeric key of the per-round JSONL record
  (``round_time_s``, ``train_loss``, ``clients_quarantined``,
  ``mem_device_bytes_in_use``, ``comm_agg_share``, ...). The
  federation/serving planes stamp their own keys when ``--xtrace``
  tracing is on, so objectives like ``p95:fed_round_ms<2000``,
  ``p95:fed_wire_ms<50``, ``rate:fed_queue_ms<20``,
  ``p99:serve_adopt_lag_ms<500`` or ``ewma:serve_probe_acc>0.5``
  evaluate live at the aggregator / serving worker;
* ``op`` — ``<``, ``<=``, ``>``, ``>=`` (the condition the run must
  SATISFY; violation = the condition fails);
* params — ``w`` (window, rounds), ``a`` (EWMA alpha), ``budget``
  (error budget: allowed violating-round fraction, default
  :data:`DEFAULT_BUDGET`), ``min`` (samples before judging).

Determinism is the contract: estimators consume only the flushed
record's values (no wall clock, no RNG), so fused and unfused loops,
reruns, and kill+``--resume`` replays (the engine deterministically
rebuilds from the JSONL — :meth:`SloEngine.replay`) produce
bit-identical verdicts, events, and health trajectories. Off
(``--slo_spec`` unset) nothing here is constructed; on, the engine is
a pure readout — the training trajectory stays bit-identical. Like
every obs knob, ``slo_*`` flags never enter run/checkpoint identity.
"""
from __future__ import annotations

import collections
import math
import os
import re
from typing import Any, Deque, Dict, List, Optional, Tuple

from .events import SEVERITY, Event, events_from_record, make_event

__all__ = [
    "DEFAULT_BUDGET", "DEGRADED", "Ewma", "FAILING", "HEALTH_RANK",
    "OK", "Objective", "P2Quantile", "ReservoirQuantile", "SloEngine",
    "WindowedMean", "WindowedQuantile", "WindowedSlope",
    "load_slo_spec", "parse_objective", "parse_slo_spec",
]

# -- run-health states ---------------------------------------------------

OK = "ok"
DEGRADED = "degraded"
FAILING = "failing"

#: numeric rank of each health state (the JSONL/metrics gauge value)
HEALTH_RANK = {OK: 0, DEGRADED: 1, FAILING: 2}

#: default error budget: fraction of evaluated rounds allowed to
#: violate before the objective's budget is exhausted (FAILING)
DEFAULT_BUDGET = 0.1

#: default estimator window (rounds) for windowed kinds
DEFAULT_WINDOW = 20

#: default EWMA smoothing factor
DEFAULT_ALPHA = 0.2

#: multi-window burn-rate alert: fast/slow violation-rate windows and
#: the burn factor — both windows' rates above ``factor * budget``
#: raises BUDGET_BURN (the SRE fast-burn/slow-burn pair, scaled to
#: round cadence)
BURN_FAST_WINDOW = 5
BURN_SLOW_WINDOW = 25
BURN_FACTOR = 6.0

#: rounds a budget must have been evaluated before exhaustion can fire
#: (a single early violation must not instantly fail a long run)
MIN_BUDGET_ROUNDS = 4

#: hysteresis: consecutive breach rounds before OK -> DEGRADED, and
#: consecutive clean rounds before stepping back down one state
DEGRADE_AFTER = 2
RECOVER_AFTER = 3

#: breach rounds stored per objective (count keeps exact total)
_MAX_BREACH_ROUNDS = 128


# -- streaming estimators ------------------------------------------------

def _interp_quantile(values, q: float) -> float:
    """Linear-interpolated quantile of a small sample — the ONE
    spelling of ``np.quantile(..., method='linear')`` shared by the
    windowed estimator and P²'s warmup branch (the property tests pin
    both to numpy; two copies could drift apart)."""
    s = sorted(values)
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


class WindowedQuantile:
    """Exact quantile over the last ``window`` observations (bounded
    deque — O(window) memory, O(1) in run length). Linear
    interpolation matches ``np.quantile(..., method='linear')`` so the
    property tests pin equality, not mere tolerance."""

    def __init__(self, q: float, window: int = DEFAULT_WINDOW):
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile q={q} outside [0, 1]")
        self.q = float(q)
        self._buf: Deque[float] = collections.deque(
            maxlen=max(1, int(window)))
        self.count = 0

    def observe(self, x: float) -> None:
        self._buf.append(float(x))
        self.count += 1

    def value(self) -> Optional[float]:
        if not self._buf:
            return None
        return _interp_quantile(self._buf, self.q)


class P2Quantile:
    """The P² streaming quantile (Jain & Chhabra 1985): five markers,
    O(1) memory regardless of stream length — the ``w=0`` (whole-run)
    estimator. Exact until five observations, then the classic
    piecewise-parabolic marker update. Deterministic: no sampling."""

    def __init__(self, q: float):
        if not (0.0 < q < 1.0):
            raise ValueError(f"P2 quantile q={q} outside (0, 1)")
        self.q = float(q)
        self.count = 0
        self._h: List[float] = []            # marker heights
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]  # marker positions
        q_ = self.q
        self._want = [1.0, 1.0 + 2.0 * q_, 1.0 + 4.0 * q_,
                      3.0 + 2.0 * q_, 5.0]
        self._dwant = [0.0, q_ / 2.0, q_, (1.0 + q_) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if len(self._h) < 5:
            self._h.append(x)
            if len(self._h) == 5:
                self._h.sort()
            return
        h = self._h
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        # adjust interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or \
                    (d <= -1.0 and self._pos[i - 1] - self._pos[i]
                     < -1.0):
                step = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, step)
                if not (h[i - 1] < cand < h[i + 1]):
                    cand = self._linear(i, step)
                h[i] = cand
                self._pos[i] += step

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._h, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
            / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
            / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._h, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    def value(self) -> Optional[float]:
        if self.count == 0:
            return None
        if len(self._h) < 5:
            # exact quantile of what's there (same rule as windowed)
            return _interp_quantile(self._h, self.q)
        return self._h[2]


class ReservoirQuantile:
    """Fixed-reservoir quantile riding ``obs.metrics.Distribution``'s
    deterministic reservoir (crc32-seeded algorithm R): exact while the
    stream fits the reservoir, a deterministic same-stream ->
    same-estimate sample beyond it. The alternative whole-run
    estimator for callers that want the metrics-registry machinery."""

    def __init__(self, q: float, reservoir_size: int = 512,
                 name: str = "slo"):
        from .metrics import Distribution

        self.q = float(q)
        self._dist = Distribution(name, reservoir_size=reservoir_size)

    @property
    def count(self) -> int:
        return self._dist.count

    def observe(self, x: float) -> None:
        self._dist.observe(float(x))

    def value(self) -> Optional[float]:
        return self._dist.quantile(self.q)


class WindowedMean:
    """Mean over the last ``window`` observations (the ``rate`` kind:
    e.g. quarantined clients per round)."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._buf: Deque[float] = collections.deque(
            maxlen=max(1, int(window)))
        self.count = 0

    def observe(self, x: float) -> None:
        self._buf.append(float(x))
        self.count += 1

    def value(self) -> Optional[float]:
        if not self._buf:
            return None
        return sum(self._buf) / len(self._buf)


class Ewma:
    """Exponential moving average, ``v = a*x + (1-a)*v`` seeded by the
    first observation."""

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"ewma alpha={alpha} outside (0, 1]")
        self.alpha = float(alpha)
        self._v: Optional[float] = None
        self.count = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self._v = x if self._v is None else (
            self.alpha * x + (1.0 - self.alpha) * self._v)

    def value(self) -> Optional[float]:
        return self._v


class WindowedSlope:
    """Least-squares slope (metric units per observation) over the
    last ``window`` observations — the streaming twin of the
    analyzer's memory-leak slope."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._buf: Deque[float] = collections.deque(
            maxlen=max(2, int(window)))
        self.count = 0

    def observe(self, x: float) -> None:
        self._buf.append(float(x))
        self.count += 1

    def value(self) -> Optional[float]:
        n = len(self._buf)
        if n < 2:
            return None
        ys = list(self._buf)
        mx = (n - 1) / 2.0
        my = sum(ys) / n
        num = sum((i - mx) * (y - my) for i, y in enumerate(ys))
        den = sum((i - mx) ** 2 for i in range(n))
        return num / den


# -- spec parsing --------------------------------------------------------

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}

_TOKEN_RE = re.compile(
    r"^(?P<kind>[a-z]+\d*):(?P<metric>[A-Za-z0-9_./-]+)"
    r"(?P<op><=|>=|<|>)(?P<thr>[^@]+)(?:@(?P<params>.+))?$")

#: per-kind minimum samples before an objective is judged (overridable
#: with ``min=``); slope needs two points, windowed stats warm at 3
_DEFAULT_MIN_SAMPLES = {"quantile": 3, "rate": 1, "ewma": 1,
                        "slope": 3}


class Objective:
    """One parsed SLO objective (immutable spec half; runtime state
    lives in the engine)."""

    def __init__(self, kind: str, metric: str, op: str,
                 threshold: float, quantile: Optional[float] = None,
                 window: int = DEFAULT_WINDOW,
                 alpha: float = DEFAULT_ALPHA,
                 budget: float = DEFAULT_BUDGET,
                 min_samples: Optional[int] = None, name: str = "",
                 reservoir: int = 0):
        if kind not in ("quantile", "rate", "ewma", "slope"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if op not in _OPS:
            raise ValueError(f"unknown SLO op {op!r}")
        if not (0.0 < budget <= 1.0):
            raise ValueError(
                f"slo budget={budget:g} outside (0, 1] "
                "(the allowed violating-round fraction)")
        # estimator-constructor constraints validated HERE so a bad
        # spec dies at parse time (the derive() contract), not as a
        # raw traceback when the engine builds mid-run-setup
        if not (0.0 < float(alpha) <= 1.0):
            raise ValueError(
                f"slo ewma alpha={alpha:g} outside (0, 1]")
        if int(window) < 0:
            raise ValueError(
                f"slo window w={window} negative (0 = whole-run "
                "streaming estimator)")
        if int(window) == 0 and kind != "quantile":
            # deque(maxlen=max(1, 0)) would silently make a rate a
            # single-round snapshot — refuse instead
            raise ValueError(
                f"slo w=0 (whole-run streaming) is only defined for "
                f"quantile kinds; {kind} objectives need w >= 1")
        if int(reservoir) and kind != "quantile":
            raise ValueError(
                f"slo res= selects the reservoir quantile estimator; "
                f"it does not apply to {kind} objectives")
        if int(reservoir) < 0:
            raise ValueError(f"slo res={reservoir} negative")
        self.kind = kind
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.quantile = quantile
        self.window = int(window)
        self.alpha = float(alpha)
        self.budget = float(budget)
        self.reservoir = int(reservoir)
        self.min_samples = int(
            min_samples if min_samples is not None
            else _DEFAULT_MIN_SAMPLES[kind])
        self.name = name or self.canonical()

    def canonical(self) -> str:
        kind = (f"p{self.quantile:g}".replace("0.", "", 1)
                if self.kind == "quantile" else self.kind)
        return f"{kind}:{self.metric}{self.op}{self.threshold:g}"

    def make_estimator(self):
        if self.kind == "quantile":
            if self.reservoir > 0:
                # whole-run deterministic-sample quantile riding the
                # metrics.Distribution reservoir (res=N)
                return ReservoirQuantile(
                    self.quantile, reservoir_size=self.reservoir,
                    name=self.name)
            if self.window <= 0:
                return P2Quantile(self.quantile)
            return WindowedQuantile(self.quantile, self.window)
        if self.kind == "rate":
            return WindowedMean(self.window)
        if self.kind == "ewma":
            return Ewma(self.alpha)
        return WindowedSlope(self.window)

    def satisfied(self, value: float) -> bool:
        return bool(_OPS[self.op](value, self.threshold))

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "metric": self.metric, "op": self.op,
                "threshold": self.threshold,
                "quantile": self.quantile, "window": self.window,
                "alpha": self.alpha, "budget": self.budget,
                "reservoir": self.reservoir,
                "min_samples": self.min_samples}


def parse_objective(token: str) -> Objective:
    """One DSL token -> :class:`Objective`; raises ValueError with the
    offending token on any malformed piece (a typo'd SLO spec must die
    at parse time, not silently watch nothing)."""
    tok = token.strip()
    m = _TOKEN_RE.match(tok)
    if not m:
        raise ValueError(
            f"slo_spec: malformed objective {tok!r} (want "
            "<kind>:<metric><op><threshold>[@k=v,...], e.g. "
            "p99:round_time_s<2.5@w=20)")
    kind_tok = m.group("kind")
    quantile = None
    if re.fullmatch(r"p\d+", kind_tok):
        digits = kind_tok[1:]
        # the digits ARE the decimal fraction: p99 = 0.99, p999 =
        # 0.999, p05 = 0.05. Two spellings that read differently under
        # percentile conventions are refused instead of silently
        # watching the wrong quantile:
        if len(digits) == 1:
            raise ValueError(
                f"slo_spec: ambiguous quantile kind {kind_tok!r} — "
                f"write p{digits}0 (the 0.{digits} quantile) or "
                f"p0{digits} (the 0.0{digits} quantile)")
        if len(digits) >= 3 and digits[0] == "1" and \
                set(digits[1:]) == {"0"}:
            raise ValueError(
                f"slo_spec: {kind_tok!r} reads as the 100th "
                "percentile (the maximum), which the 0.<digits> rule "
                f"would silently treat as the 0.{digits} quantile — "
                "use p99/p999, or watch the raw metric with a rate "
                "objective")
        quantile = int(digits) / (10 ** len(digits))
        if not (0.0 < quantile < 1.0):
            raise ValueError(
                f"slo_spec: quantile kind {kind_tok!r} outside (0,1)")
        kind = "quantile"
    elif kind_tok in ("rate", "ewma", "slope"):
        kind = kind_tok
    else:
        raise ValueError(
            f"slo_spec: unknown kind {kind_tok!r} in {tok!r} "
            "(know: p<NN> quantiles, rate, ewma, slope)")
    try:
        threshold = float(m.group("thr"))
    except ValueError as e:
        raise ValueError(
            f"slo_spec: bad threshold {m.group('thr')!r} in {tok!r}"
        ) from e
    params: Dict[str, float] = {}
    if m.group("params"):
        for kv in m.group("params").split(","):
            kv = kv.strip()
            if not kv:
                continue
            if "=" not in kv:
                raise ValueError(
                    f"slo_spec: bad param {kv!r} in {tok!r} "
                    "(want k=v)")
            k, v = kv.split("=", 1)
            k = k.strip()
            if k not in ("w", "a", "budget", "min", "res"):
                raise ValueError(
                    f"slo_spec: unknown param {k!r} in {tok!r} "
                    "(know: w, a, budget, min, res)")
            try:
                params[k] = float(v)
            except ValueError as e:
                raise ValueError(
                    f"slo_spec: bad value {v!r} for param {k!r} "
                    f"in {tok!r}") from e
    return Objective(
        kind=kind, metric=m.group("metric"), op=m.group("op"),
        threshold=threshold, quantile=quantile,
        window=int(params.get("w", DEFAULT_WINDOW)),
        alpha=params.get("a", DEFAULT_ALPHA),
        budget=params.get("budget", DEFAULT_BUDGET),
        min_samples=(int(params["min"]) if "min" in params else None),
        reservoir=int(params.get("res", 0)),
        name=tok)


def parse_slo_spec(text: str) -> List[Objective]:
    """Parse a full spec: objectives separated by ``;`` or newlines,
    ``#`` starts a comment. Duplicate objective names are refused (two
    estimators under one name would fight over one budget)."""
    objs: List[Objective] = []
    for raw in str(text).splitlines() or [str(text)]:
        # strip the comment from the PHYSICAL line before the ';'
        # split — a comment may itself contain semicolons
        line = raw.split("#", 1)[0]
        for tok in line.split(";"):
            tok = tok.strip()
            if not tok:
                continue
            objs.append(parse_objective(tok))
    if not objs:
        raise ValueError("slo_spec: no objectives in spec")
    seen = set()
    for o in objs:
        if o.name in seen:
            raise ValueError(
                f"slo_spec: duplicate objective {o.name!r}")
        seen.add(o.name)
    return objs


def load_slo_spec(spec: str) -> List[Objective]:
    """``--slo_spec`` resolution: an existing file path is read (one
    objective per line), anything else parses inline. A path-looking
    spec whose file is MISSING gets a missing-file error, not a
    confusing 'malformed DSL' one (wrong cwd / not-yet-written file
    is the likely mistake there)."""
    if os.path.isfile(spec):
        with open(spec) as f:
            return parse_slo_spec(f.read())
    try:
        return parse_slo_spec(spec)
    except ValueError as e:
        if "/" in spec or os.sep in spec:
            raise ValueError(
                f"slo_spec: {spec!r} is neither an existing spec "
                "file nor valid inline DSL — check the path (specs "
                f"resolve relative to the cwd). Inline parse said: {e}"
            ) from e
        raise


# -- engine --------------------------------------------------------------

class _ObjectiveState:
    """Runtime half of one objective: estimator, budget, burn windows,
    and the violating edge-tracker."""

    def __init__(self, obj: Objective):
        self.obj = obj
        self.estimator = obj.make_estimator()
        self.evaluated = 0
        self.violations = 0
        self.violating = False          # last evaluated verdict
        self.value: Optional[float] = None
        self.burning = False
        self.breach_rounds: List[int] = []
        self._fast: Deque[int] = collections.deque(
            maxlen=BURN_FAST_WINDOW)
        self._slow: Deque[int] = collections.deque(
            maxlen=BURN_SLOW_WINDOW)

    def observe(self, x: float, round_idx: int
                ) -> Tuple[bool, bool, bool]:
        """Feed one sample; returns ``(entered_violation,
        left_violation, entered_burn)`` edge flags."""
        self.estimator.observe(x)
        if self.estimator.count < self.obj.min_samples:
            return (False, False, False)
        v = self.estimator.value()
        if v is None or not math.isfinite(v):
            # a non-finite estimate IS a violation (a NaN p99 cannot
            # certify the objective)
            bad = True
        else:
            bad = not self.obj.satisfied(v)
        self.value = v
        self.evaluated += 1
        self.violations += int(bad)
        self._fast.append(int(bad))
        self._slow.append(int(bad))
        entered = bad and not self.violating
        left = (not bad) and self.violating
        self.violating = bad
        if bad:
            if len(self.breach_rounds) < _MAX_BREACH_ROUNDS:
                self.breach_rounds.append(int(round_idx))
        burn_line = min(1.0, BURN_FACTOR * self.obj.budget)
        burning = (len(self._fast) == self._fast.maxlen
                   and len(self._slow) >= self._fast.maxlen
                   and sum(self._fast) / len(self._fast) >= burn_line
                   and sum(self._slow) / len(self._slow) >= burn_line)
        entered_burn = burning and not self.burning
        self.burning = burning
        return (entered, left, entered_burn)

    @property
    def budget_spend(self) -> float:
        """Error-budget spend fraction: violations over the allowed
        count at the current horizon (>= 1.0 = exhausted)."""
        if not self.evaluated:
            return 0.0
        return self.violations / max(
            self.obj.budget * self.evaluated, 1e-12)

    @property
    def budget_exhausted(self) -> bool:
        return (self.evaluated >= MIN_BUDGET_ROUNDS
                and self.budget_spend > 1.0)

    def summary(self) -> Dict[str, Any]:
        out = self.obj.describe()
        out.update({
            "evaluated": self.evaluated,
            "violations": self.violations,
            "compliance": (1.0 - self.violations / self.evaluated
                           if self.evaluated else None),
            "budget_spend": round(self.budget_spend, 4),
            "budget_exhausted": self.budget_exhausted,
            "violating": self.violating,
            "burning": self.burning,
            "value": self.value,
            "breach_rounds": list(self.breach_rounds),
        })
        return out


class SloEngine:
    """Incremental SLO evaluation over the flushed round records.

    ``observe(record)`` consumes one materialized record and returns
    the round's events (record-derived GUARD/WATCHDOG/DRIFT plus the
    engine's SLO_BREACH/BUDGET_BURN/HEALTH_TRANSITION) — at most one
    event per type per round, the dedupe contract. ``health`` is the
    state machine's current state; the session stamps it on the JSONL
    line it just evaluated.
    """

    def __init__(self, objectives: List[Objective],
                 degrade_after: int = DEGRADE_AFTER,
                 recover_after: int = RECOVER_AFTER):
        if not objectives:
            raise ValueError("SloEngine needs at least one objective")
        self._objs = [_ObjectiveState(o) for o in objectives]
        self.degrade_after = max(1, int(degrade_after))
        self.recover_after = max(1, int(recover_after))
        self._health = OK
        self._breach_streak = 0
        self._clean_streak = 0
        self.rounds_observed = 0
        self.transitions: List[Dict[str, Any]] = []
        self.events_total = 0

    # -- properties ------------------------------------------------------

    @property
    def health(self) -> str:
        return self._health

    @property
    def health_rank(self) -> int:
        return HEALTH_RANK[self._health]

    @property
    def breached(self) -> List[str]:
        """Names of objectives currently in violation."""
        return [s.obj.name for s in self._objs if s.violating]

    @property
    def objectives(self) -> List[Objective]:
        return [s.obj for s in self._objs]

    # -- evaluation ------------------------------------------------------

    def observe(self, record: Dict[str, Any]) -> List[Event]:
        """Evaluate one flushed round record. Only non-negative integer
        rounds are SLO rounds (the final round=-1 record is a protocol
        artifact, not a round)."""
        r = record.get("round")
        if not isinstance(r, (int, float)) or int(r) < 0:
            return []
        r = int(r)
        self.rounds_observed += 1
        events = events_from_record(record)
        newly_breached: List[Dict[str, Any]] = []
        newly_burning: List[Dict[str, Any]] = []
        for st in self._objs:
            v = record.get(st.obj.metric)
            if not isinstance(v, (int, float)):
                continue
            entered, _left, entered_burn = st.observe(float(v), r)
            if entered:
                newly_breached.append({
                    "objective": st.obj.name, "metric": st.obj.metric,
                    "kind": st.obj.kind, "op": st.obj.op,
                    "threshold": st.obj.threshold, "value": st.value,
                    "sample": float(v)})
            if entered_burn:
                newly_burning.append({
                    "objective": st.obj.name,
                    "budget": st.obj.budget,
                    "budget_spend": round(st.budget_spend, 4),
                    "fast_rate": sum(st._fast) / max(1, len(st._fast)),
                    "slow_rate": sum(st._slow) / max(1, len(st._slow)),
                })
        if newly_breached:
            names = ", ".join(b["objective"] for b in newly_breached)
            events.append(make_event(
                "SLO_BREACH", r, f"SLO breach: {names}",
                {"objectives": newly_breached},
                objective=newly_breached[0]["objective"]))
        if newly_burning:
            names = ", ".join(b["objective"] for b in newly_burning)
            events.append(make_event(
                "BUDGET_BURN", r, f"error-budget burn: {names}",
                {"objectives": newly_burning},
                objective=newly_burning[0]["objective"]))
        transition = self._step_health(r)
        if transition is not None:
            events.append(transition)
        self.events_total += len(events)
        return events

    def _step_health(self, round_idx: int) -> Optional[Event]:
        """One state-machine step after this round's evaluations."""
        any_violating = any(s.violating for s in self._objs)
        exhausted = [s.obj.name for s in self._objs
                     if s.budget_exhausted]
        if any_violating:
            self._breach_streak += 1
            self._clean_streak = 0
        else:
            self._clean_streak += 1
            self._breach_streak = 0
        prev = self._health
        new = prev
        reason = ""
        if exhausted:
            new = FAILING
            reason = "budget_exhausted:" + ",".join(exhausted)
        elif any_violating:
            if prev == OK and self._breach_streak >= self.degrade_after:
                new = DEGRADED
                reason = (f"breach_streak={self._breach_streak}"
                          f">={self.degrade_after}")
        elif self._clean_streak >= self.recover_after and \
                HEALTH_RANK[prev] > 0:
            # hysteresis: step DOWN one state per recover_after clean
            # rounds (FAILING -> DEGRADED -> OK)
            new = DEGRADED if prev == FAILING else OK
            reason = (f"clean_streak={self._clean_streak}"
                      f">={self.recover_after}")
            self._clean_streak = 0
        if new == prev:
            return None
        self._health = new
        self.transitions.append(
            {"round": int(round_idx), "from": prev, "to": new,
             "reason": reason})
        sev = {OK: SEVERITY["info"], DEGRADED: SEVERITY["warning"],
               FAILING: SEVERITY["critical"]}[new]
        return make_event(
            "HEALTH_TRANSITION", round_idx,
            f"run health {prev.upper()} -> {new.upper()} ({reason})",
            {"from": prev, "to": new, "reason": reason},
            severity=sev)

    # -- resume / offline replay -----------------------------------------

    def replay(self, records: List[Dict[str, Any]]) -> List[Event]:
        """Deterministically rebuild engine state from an existing
        JSONL stream (deduped keep-last, sorted — the
        ``obs.export.dedupe_rounds`` timeline). Returns every event
        the replay produced; resume callers discard them (the events
        stream already holds the originals), offline replays
        (``obs slo``, the analyzer) consume them."""
        from .export import dedupe_rounds

        out: List[Event] = []
        for rec in dedupe_rounds(records):
            out.extend(self.observe(rec))
        return out

    # -- reporting -------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """End-of-run summary (metrics.json / analyzer payload)."""
        return {
            "health": self._health,
            "health_rank": self.health_rank,
            "rounds_observed": self.rounds_observed,
            "events_total": self.events_total,
            "transitions": list(self.transitions),
            "objectives": {s.obj.name: s.summary()
                           for s in self._objs},
        }
