"""Anomaly flight recorder: a bounded post-mortem bundle when a round
goes wrong (counterpart of ``neuroimagedisttraining_tpu/obs/recorder.py``).

The guard quarantines a poisoned client and the watchdog rolls back a
diverged round — but by the time a human looks, the evidence (the
per-client numerics of the rounds LEADING UP to the fault) has scrolled
past. The flight recorder keeps a sliding window of the last-K flushed
round records (including the in-round numerics scalars from
``obs/numerics.py``) and, when a trigger trips, freezes it to disk as a
bundle under the run dir:

    <run_dir>/<identity>.flight/r00012-guard_quarantine/
        trigger.json      # reason, round, offending clients/groups,
                          # the triggering record
        window.jsonl      # the last-K rounds of numerics telemetry
        profile/          # optional torch.profiler device trace of the
                          # watchdog RETRY attempt (--flight_profile)

Triggers (``--flight_recorder`` grammar — comma-separated):

* ``guard``     — the round's guard quarantined clients this round
                  (``clients_quarantined > 0`` on the flushed record);
* ``watchdog``  — the round watchdog returned a RETRY or SKIP verdict;
* ``drift>K``   — the round's max per-client drift exceeds the trailing
                  window's median by ``K`` robust sigmas (1.4826·MAD) —
                  the finite-divergence early trigger; a NON-finite
                  drift trips unconditionally;
* ``auto``      — shorthand for ``watchdog,guard``.

Bundles are bounded (``max_bundles`` per run, one per (round, reason));
once the budget is spent further triggers are counted, not captured.
Everything here is opt-in and off the training path: the recorder only
ever reads ALREADY-materialized records at the DeferredRecords flush
point (or the watchdog's already-synced verdict path), so it forces no
device sync and — like every obs knob — never enters run identity.
"""
from __future__ import annotations

import collections
import json
import logging
import math
import os
from typing import Any, Dict, List, Optional

from .numerics import drift_slots as _drift_slots

logger = logging.getLogger(__name__)

__all__ = ["FlightRecorder", "parse_triggers"]

#: trigger.json schema version
BUNDLE_SCHEMA_VERSION = 1

#: minimum finite drift samples before the robust drift threshold fires
_DRIFT_MIN_HISTORY = 5


def parse_triggers(spec: str) -> Dict[str, Any]:
    """``"watchdog,guard,drift>3.5,slo"`` → ``{"watchdog": bool,
    "guard": bool, "slo": bool, "drift_k": float|None}``;
    ``"auto"``/``"1"``/``"on"`` = watchdog+guard. ``slo`` captures a
    bundle on SLO_BREACH / BUDGET_BURN / HEALTH_TRANSITION-to-FAILING
    events from the typed event bus (obs/events.py — the recorder is a
    bus sink via :meth:`FlightRecorder.observe_event`). Raises
    ValueError on unknown tokens so a typo'd flight config dies at
    parse time, not silently at the fault."""
    out: Dict[str, Any] = {"watchdog": False, "guard": False,
                           "slo": False, "drift_k": None}
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok in ("auto", "1", "on"):
            out["watchdog"] = out["guard"] = True
        elif tok in ("watchdog", "guard", "slo"):
            out[tok] = True
        elif tok.startswith("drift>"):
            try:
                out["drift_k"] = float(tok[len("drift>"):])
            except ValueError as e:
                raise ValueError(
                    f"flight_recorder: bad drift threshold {tok!r} "
                    "(want drift>K, K a float, e.g. drift>3.5)") from e
            if not (math.isfinite(out["drift_k"])
                    and out["drift_k"] > 0):
                raise ValueError(
                    f"flight_recorder: drift>K needs a finite K > 0, "
                    f"got {tok!r}")
        else:
            raise ValueError(
                f"flight_recorder: unknown trigger {tok!r} "
                "(know: auto, watchdog, guard, slo, drift>K)")
    if not (out["watchdog"] or out["guard"] or out["slo"]
            or out["drift_k"] is not None):
        raise ValueError(
            "flight_recorder: no triggers in spec "
            "(use e.g. 'auto' or 'guard,slo,drift>3.5')")
    return out


def _json_safe(v: Any) -> Any:
    if hasattr(v, "detach"):  # a tensor of the watchdog's verdict path
        v = v.detach().cpu().numpy()
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
        arr = np.asarray(v)
        if arr.ndim == 0 and arr.dtype.kind in "fiub":
            return arr.item()
        if arr.ndim == 1 and arr.dtype.kind in "fiu":
            return [float(x) for x in arr]
    except Exception:
        pass
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def _sanitize(record: Dict[str, Any]) -> Dict[str, Any]:
    """A JSON-writable copy (device scalars → floats; the watchdog path
    hands the recorder records it has already synced, so this
    materializes nothing new of consequence)."""
    return {k: _json_safe(v) for k, v in record.items()}


class FlightRecorder:
    """Sliding-window post-mortem capture for one run. See module doc."""

    def __init__(self, run_dir: str, identity: str, spec: str = "auto",
                 window: int = 16, max_bundles: int = 5,
                 profile_retry: bool = False, num_clients: int = 0,
                 clients_per_round: int = 0):
        self.triggers = parse_triggers(spec)
        self.dir = os.path.join(run_dir or ".", identity + ".flight")
        self.window = collections.deque(maxlen=max(1, int(window)))
        self.max_bundles = max(1, int(max_bundles))
        self.bundles: List[str] = []
        self.triggers_skipped = 0
        self.profile_retry = bool(profile_retry)
        self.num_clients = int(num_clients)
        self.clients_per_round = int(clients_per_round)
        self._drift_hist: collections.deque = collections.deque(
            maxlen=64)
        self._captured = set()          # (round, reason) dedupe
        self._armed_profile: Optional[int] = None
        self.profile_dir: Optional[str] = None
        self._profiled = False
        self._profiling = False
        self._prof = None
        self._prof_dir = ""

    # -- per-record hook (DeferredRecords flush point) -------------------
    def observe_record(self, record: Dict[str, Any]) -> None:
        """Feed one FLUSHED (materialized) round record: evaluates the
        guard and drift triggers, then appends to the window."""
        rec = _sanitize(record)
        r = rec.get("round")
        if isinstance(r, (int, float)) and int(r) >= 0:
            r = int(r)
            q = rec.get("clients_quarantined")
            if self.triggers["guard"] and isinstance(q, (int, float)) \
                    and q > 0:
                self._capture("guard_quarantine", r, rec,
                              self._offenders(rec))
            self._judge_drift(r, rec)
        self.window.append(rec)

    def _judge_drift(self, r: int, rec: Dict[str, Any]) -> None:
        k = self.triggers["drift_k"]
        if k is None:
            return
        slots = _drift_slots(rec)
        if not slots:
            return
        if any(not math.isfinite(v) for v in slots.values()):
            self._capture("drift_nonfinite", r, rec,
                          self._offenders(rec))
            return
        cur = max(slots.values())
        hist = list(self._drift_hist)
        self._drift_hist.append(cur)
        if len(hist) < _DRIFT_MIN_HISTORY:
            return
        from .metrics import median as _median, robust_sigma

        med = _median(hist)
        sigma = max(robust_sigma(hist, med), 1e-12)
        if cur > med + k * sigma:
            detail = self._offenders(rec)
            detail["drift_sigmas"] = round((cur - med) / sigma, 2)
            self._capture("drift", r, rec, detail)

    # -- event-bus adapter (obs/events.py sink) --------------------------
    def observe_event(self, event) -> None:
        """The SLO engine's trigger adapter: subscribed to the typed
        event bus when the ``slo`` trigger is armed, it freezes a
        bundle on an SLO breach, an error-budget burn, or the health
        state machine entering FAILING. The event's record and detail
        become the trigger payload; the window is the same last-K
        flushed rounds every other trigger captures."""
        if not self.triggers.get("slo"):
            return
        etype = getattr(event, "type", "")
        reason = None
        if etype == "SLO_BREACH":
            reason = "slo_breach"
        elif etype == "BUDGET_BURN":
            reason = "slo_budget_burn"
        elif etype == "HEALTH_TRANSITION" and \
                (getattr(event, "detail", {}) or {}).get("to") == \
                "failing":
            reason = "slo_failing"
        if reason is None:
            return
        detail = dict(getattr(event, "detail", {}) or {})
        if getattr(event, "objective", ""):
            detail.setdefault("objective", event.objective)
        # event records are JSON-safe by construction (no device
        # scalars), so they skip the record sanitizer — _json_safe
        # would stringify the nested detail dict
        self._capture(reason, int(event.round), event.to_record(),
                      detail)

    # -- watchdog hooks --------------------------------------------------
    def note_watchdog(self, round_idx: int, verdict: str,
                      record: Dict[str, Any],
                      retry: Optional[int] = None) -> None:
        """The runner's rollback path: a RETRY/SKIP verdict on this
        attempt of ``round_idx`` (the record never reaches the deferred
        emitter for RETRY, so the capture happens here). ``retry`` is
        the FAILING attempt's cohort nonce — the verdict-path record
        does not carry ``rounds_retried`` yet, and replaying nonce 0
        for a re-drawn cohort would name innocent clients."""
        if not self.triggers["watchdog"]:
            return
        rec = _sanitize(record)
        bdir = self._capture(f"watchdog_{verdict}", int(round_idx),
                             rec, self._offenders(rec, retry=retry))
        # arm the retry-round device trace only when its parent bundle
        # was actually captured — an orphan profile/ dir outside any
        # bundle (budget spent, or watchdog trigger off) would
        # contradict the documented bundle layout
        if bdir and self.profile_retry and verdict == "retry" \
                and not self._profiled:
            self._armed_profile = int(round_idx)

    def take_retry_profile(self, round_idx: int) -> Optional[str]:
        """The device-trace capture dir for this round's retry attempt,
        exactly once per run (None otherwise): ``profile/`` INSIDE the
        round's ``watchdog_retry`` trigger bundle. The runner brackets
        the retry's ``run_round``+verdict with :meth:`start_profile` /
        :meth:`stop_profile` on the returned dir (the export creates it —
        a failed start leaves nothing behind)."""
        if self._armed_profile != int(round_idx) or self._profiled:
            return None
        self._armed_profile = None
        self._profiled = True
        self.profile_dir = os.path.join(
            self.dir, f"r{int(round_idx):05d}-watchdog_retry",
            "profile")
        return self.profile_dir

    def start_profile(self, trace_dir: str) -> bool:
        """Start a ``torch.profiler`` capture (CPU, and CUDA where there is
        a card) that :meth:`stop_profile` exports into ``trace_dir``."""
        try:
            from ..utils.profiling import start_trace

            self._prof = start_trace()
            self._prof_dir = trace_dir
            self._profiling = True
            return True
        except Exception:  # profiler unavailable: capture is best-effort
            logger.warning("flight recorder: device-trace capture "
                           "unavailable", exc_info=True)
            return False

    def stop_profile(self) -> None:
        if not self._profiling:
            return
        self._profiling = False
        try:
            from ..utils.profiling import stop_trace

            stop_trace(self._prof, self._prof_dir)
        except Exception:  # pragma: no cover - profiler teardown quirk
            logger.warning("flight recorder: stop_trace failed",
                           exc_info=True)
        self._prof = None

    # -- capture ---------------------------------------------------------
    def _offenders(self, rec: Dict[str, Any],
                   retry: Optional[int] = None) -> Dict[str, Any]:
        """Offending per-client summary for the trigger detail: the
        non-finite (or max-drift) cohort slots, mapped to global client
        ids via the deterministic participation replay when the cohort
        shape is known. ``retry`` overrides the record's
        ``rounds_retried`` nonce (the watchdog verdict path, where the
        counter has not joined the record yet)."""
        slots = _drift_slots(rec)
        detail: Dict[str, Any] = {}
        if slots:
            bad = sorted(j for j, v in slots.items()
                         if not math.isfinite(v))
            top = (bad or
                   [max(slots, key=lambda j: slots[j])])
            detail["slots"] = top
            detail["slot_drift"] = {str(j): slots[j] for j in top}
            r = rec.get("round")
            if self.num_clients and self.clients_per_round \
                    and isinstance(r, (int, float)) and int(r) >= 0:
                from .health import replay_client_indexes

                if retry is None:
                    retry = int(rec.get("rounds_retried") or 0)
                sel = replay_client_indexes(
                    int(r), self.num_clients, self.clients_per_round,
                    retry=retry)
                detail["clients"] = [int(sel[j]) for j in top
                                     if j < len(sel)]
        groups = sorted(
            k[len("num_maxabs/"):] for k, v in rec.items()
            if k.startswith("num_maxabs/")
            and isinstance(v, (int, float)) and not math.isfinite(v))
        if groups:
            detail["layer_groups"] = groups
        return detail

    def _capture(self, reason: str, round_idx: int,
                 rec: Dict[str, Any],
                 detail: Dict[str, Any]) -> Optional[str]:
        key = (round_idx, reason)
        if key in self._captured:
            return None
        if len(self.bundles) >= self.max_bundles:
            self.triggers_skipped += 1
            self._captured.add(key)
            return None
        self._captured.add(key)
        bdir = os.path.join(self.dir, f"r{round_idx:05d}-{reason}")
        os.makedirs(bdir, exist_ok=True)
        with open(os.path.join(bdir, "trigger.json"), "w") as f:
            json.dump({
                "bundle_schema": BUNDLE_SCHEMA_VERSION,
                "reason": reason, "round": round_idx,
                "detail": detail, "record": rec,
                "window_rounds": [w.get("round") for w in self.window],
            }, f, indent=1, default=str)
        with open(os.path.join(bdir, "window.jsonl"), "w") as f:
            wrote = False
            for w in self.window:
                f.write(json.dumps(w, default=str) + "\n")
                wrote = wrote or w.get("round") == rec.get("round")
            if not wrote:  # the triggering record may predate its flush
                f.write(json.dumps(rec, default=str) + "\n")
        self.bundles.append(bdir)
        logger.warning("flight recorder: captured %s bundle -> %s",
                       reason, bdir)
        return bdir

    def summary(self) -> Dict[str, Any]:
        return {"bundles": list(self.bundles),
                "triggers_skipped": self.triggers_skipped,
                "profile_dir": self.profile_dir}
