"""Typed, severity-ranked run events: the bus every in-run alert rides
(a copy of ``neuroimagedisttraining_tpu/obs/events.py``, which imports no
JAX).

PRs 3-6 left the run's "something happened" signals scattered: the
guard's quarantine count is a record field, the watchdog's verdicts are
log lines, drift anomalies are flight-recorder internals, and nothing
in the repo could say "round 12 went DEGRADED" while the run was still
alive. This module is the single typed channel:

* :class:`Event` — one occurrence: ``type`` (one of
  :data:`EVENT_TYPES`), the round it belongs to, a numeric ``severity``
  (:data:`SEVERITY` ranks), a human ``message``, and a JSON-safe
  ``detail`` payload. Events are **deterministic by construction**: no
  wall-clock timestamps, no host state — an event derives purely from
  the flushed round record (and the SLO engine's state, itself a pure
  function of the record stream), so fused and unfused runs, reruns,
  and kill+``--resume`` replays emit bit-identical event sequences.
* :class:`EventBus` — fan-out to pluggable sinks (the per-run
  ``<identity>.events.jsonl`` stream writer, the flight-recorder
  trigger adapter, ``obs tail``'s live renderer, registry counters). A
  sink that raises is logged and skipped: telemetry must never kill
  the run it observes.
* :func:`events_from_record` — the record-derived event family
  (``GUARD`` / ``WATCHDOG`` / ``DRIFT`` / ``BYZANTINE``), shared by
  the SLO engine so
  every event flows through one path. The SLO engine itself adds
  ``SLO_BREACH`` / ``BUDGET_BURN`` / ``HEALTH_TRANSITION``
  (obs/slo.py).

At most ONE event per ``(round, type)`` is emitted (a breach event
lists every newly-breached objective in its detail), so the per-host
events-stream fold (``obs.export.merge_host_events``) can dedupe on
exactly that key.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "EVENT_SCHEMA_VERSION", "EVENT_TYPES", "Event", "EventBus",
    "SEVERITY", "event_key", "events_from_record", "format_event_line",
    "severity_label",
]

#: version stamped on every exported event line
EVENT_SCHEMA_VERSION = 1

#: severity ranks (numeric so events sort/compare; labels for humans)
SEVERITY = {"info": 10, "warning": 20, "error": 30, "critical": 40}

#: event type -> default severity label. HEALTH_TRANSITION's severity
#: follows the state it enters (ok=info, degraded=warning,
#: failing=critical) — the default here is the fallback.
EVENT_TYPES = {
    "GUARD": "warning",            # in-jit quarantine fired this round
    "WATCHDOG": "error",           # rollback-retry / skip verdict
    "DRIFT": "warning",            # non-finite per-client drift
    "BYZANTINE": "error",          # adversarial clients/sites this round
    "SLO_BREACH": "error",         # an SLO objective entered violation
    "BUDGET_BURN": "warning",      # multi-window burn-rate alert
    "HEALTH_TRANSITION": "info",   # run-health state machine moved
    "SITE_DOWN": "critical",       # fleet ledger: peer missed heartbeats
    "SITE_RECOVERED": "info",      # fleet ledger: DOWN peer came back
}

#: record fields whose positive counts mark an adversarial round: the
#: in-process fault-replay counters (stamped by the runner's obs path)
#: plus the fed aggregator's norm-screen flag count — one BYZANTINE
#: event per round lists every nonzero field in its detail.
BYZANTINE_FIELDS = (
    "clients_byzantine", "clients_signflipped", "clients_colluding",
    "clients_labelflipped", "fed_byzantine_flagged",
)


def severity_label(severity: int) -> str:
    """The coarsest label whose rank the severity reaches."""
    best = "info"
    for name, rank in sorted(SEVERITY.items(), key=lambda kv: kv[1]):
        if severity >= rank:
            best = name
    return best


@dataclasses.dataclass
class Event:
    """One typed run event. ``detail`` must stay JSON-safe (the stream
    writer serializes it verbatim); ``objective`` names the primary SLO
    objective for breach-family events (empty elsewhere)."""

    type: str
    round: int
    severity: int
    message: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)
    objective: str = ""

    def __post_init__(self) -> None:
        if self.type not in EVENT_TYPES:
            raise ValueError(
                f"unknown event type {self.type!r} "
                f"(know: {', '.join(sorted(EVENT_TYPES))})")

    def to_record(self) -> Dict[str, Any]:
        """The JSONL line shape (also what sinks and ``obs tail``
        consume). Deliberately timestamp-free: determinism is the
        contract."""
        return {
            "round": int(self.round),
            "event_type": self.type,
            "severity": int(self.severity),
            "severity_label": severity_label(self.severity),
            "objective": self.objective,
            "message": self.message,
            "detail": self.detail,
            "event_schema": EVENT_SCHEMA_VERSION,
        }

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "Event":
        return cls(type=str(rec.get("event_type")),
                   round=int(rec.get("round", -1)),
                   severity=int(rec.get("severity",
                                        SEVERITY["info"])),
                   message=str(rec.get("message", "")),
                   detail=dict(rec.get("detail") or {}),
                   objective=str(rec.get("objective", "")))


def make_event(type: str, round_idx: int, message: str,
               detail: Optional[Dict[str, Any]] = None,
               severity: Optional[int] = None,
               objective: str = "") -> Event:
    if severity is None:
        severity = SEVERITY[EVENT_TYPES[type]]
    return Event(type=type, round=int(round_idx),
                 severity=int(severity), message=message,
                 detail=dict(detail or {}), objective=objective)


def event_key(rec: Dict[str, Any]):
    """The dedupe key of one event record: ``(round, event_type)`` —
    the per-host fold's keep-last unit (one event per type per round
    is the emission contract above)."""
    return (rec.get("round"), rec.get("event_type"))


def events_from_record(record: Dict[str, Any]) -> List[Event]:
    """The record-derived events of one FLUSHED round record, in a
    fixed deterministic order (GUARD, WATCHDOG, DRIFT, BYZANTINE).
    Reads only already-materialized scalars — no device sync, no
    RNG."""
    out: List[Event] = []
    r = record.get("round")
    if not isinstance(r, (int, float)) or int(r) < 0:
        return out
    r = int(r)
    q = record.get("clients_quarantined")
    if isinstance(q, (int, float)) and q > 0:
        out.append(make_event(
            "GUARD", r, f"guard quarantined {q:g} client(s)",
            {"clients_quarantined": float(q)}))
    retried = float(record.get("rounds_retried") or 0)
    skipped = float(record.get("round_skipped") or 0)
    if retried > 0 or skipped > 0:
        verdict = "skip" if skipped > 0 else "retry"
        out.append(make_event(
            "WATCHDOG", r,
            f"watchdog {verdict} (retries {retried:g})",
            {"verdict": verdict, "rounds_retried": retried,
             "round_skipped": skipped}))
    from .numerics import drift_slots

    bad = sorted(j for j, v in drift_slots(record).items()
                 if not math.isfinite(v))
    if bad:
        out.append(make_event(
            "DRIFT", r,
            "non-finite client drift in slot(s) "
            + ",".join(str(j) for j in bad),
            {"slots": bad}))
    byz = {f: float(record.get(f) or 0) for f in BYZANTINE_FIELDS
           if isinstance(record.get(f), (int, float))
           and record.get(f) > 0}
    if byz:
        total = sum(byz.values())
        out.append(make_event(
            "BYZANTINE", r,
            f"{total:g} adversarial contribution(s) this round "
            "(" + ",".join(sorted(byz)) + ")", byz))
    return out


class EventBus:
    """Fan-out of one run's events to pluggable sinks.

    Sinks are callables taking an :class:`Event`; a raising sink is
    logged and skipped (observability must never take the run down).
    The bus also keeps per-type counters for the end-of-run summary.
    """

    def __init__(self) -> None:
        self._sinks: List[Callable[[Event], None]] = []
        self.counts: Dict[str, int] = {}
        self.total = 0

    def subscribe(self, sink: Callable[[Event], None]
                  ) -> Callable[[Event], None]:
        self._sinks.append(sink)
        return sink

    def unsubscribe(self, sink: Callable[[Event], None]) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    def emit(self, event: Event) -> None:
        self.total += 1
        self.counts[event.type] = self.counts.get(event.type, 0) + 1
        for sink in list(self._sinks):
            try:
                sink(event)
            except Exception:
                logger.warning("event sink %r failed on %s",
                               sink, event.type, exc_info=True)


def format_event_line(rec: Dict[str, Any]) -> str:
    """One event record -> one human line (``obs tail --events``)."""
    r = rec.get("round")
    head = ("final " if r == -1 else f"round {r:<4}"
            if isinstance(r, (int, float)) else "?     ")
    parts = [head,
             f"{rec.get('severity_label', 'info').upper():<8}",
             str(rec.get("event_type", "?"))]
    obj = rec.get("objective")
    if obj:
        parts.append(f"[{obj}]")
    msg = rec.get("message")
    if msg:
        parts.append(str(msg))
    return "  ".join(parts)
