"""Per-client / per-site health ledger over a recorded round stream
(counterpart of ``neuroimagedisttraining_tpu/obs/health.py``).

The paper's premise is federated training across ~21 heterogeneous ABCD
acquisition sites, but the per-round JSONL stream records cohort-level
aggregates. This module reconstructs the per-site view OFFLINE from
three sources:

1. **Participation replay** — cohort draws are a pure function of the
   round index (``algorithms.base.sample_client_indexes``, the
   reference's comparability contract), so each round's selected
   clients are recomputable from ``(round, client_num_in_total,
   client_num_per_round)`` alone — no recording needed.
2. **Fault-trace replay** — the port's fault draws are a pure function
   of ``(seed, round, client id)`` (``robust.faults.client_draws``, one
   CPU ``torch.Generator`` a client), and ``robust.faults.
   fault_trace_round`` replays them on the host, so drop / straggle /
   NaN-poison / Byzantine events attribute to exact (round, site) pairs
   offline. The replay is one seam, :data:`FaultTraceFn`: every function
   here that replays faults takes ``fault_trace`` (default the port's
   own), so a stream recorded by another draw source (the JAX package's
   threefry keys) is attributed by that source's replay.
3. **Recorded per-site series** — when the obs stream carries
   ``acc_per_client`` (stamped by the runner on eval rounds with
   ``--obs`` on), each site gets a global-model accuracy trajectory.

The ledger feeds ``obs/analyze.py``'s report and flags degraded sites:
repeated faults, or an accuracy trajectory whose recent half regressed
against its earlier half by more than :data:`DEGRADED_ACC_DROP`. The
runner stamps each round's JSONL line with the clients a fault actually
touched through :func:`make_fault_counts_fn`; the flight recorder maps
cohort slots to client ids through :func:`replay_client_indexes`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

__all__ = ["FaultTraceFn", "build_health_ledger", "make_fault_counts_fn",
           "render_health", "replay_client_indexes"]

#: ``fn(spec, seed, round, client_ids) -> {"dropped", "straggled",
#: "poisoned", "byzantine", "signflipped", "colluding", "labelflipped"}``
#: (bool arrays aligned with ``client_ids``): the one seam through which
#: fault draws reach the offline tier; None means the port's own
#: ``robust.faults.fault_trace_round``
FaultTraceFn = Callable[[Any, int, int, Any], Dict[str, Any]]

#: a site is flagged when its mean accuracy over the most recent half of
#: its trajectory sits this far below the earlier half (absolute)
DEGRADED_ACC_DROP = 0.05

#: minimum recorded eval points before an accuracy trend is judged
MIN_TREND_POINTS = 4

#: a site is flagged when this fraction (or more) of its participations
#: ended in a fault (drop / quarantine-grade poison)
DEGRADED_FAULT_RATE = 0.5


def _round_indices(records: List[Dict[str, Any]]) -> List[int]:
    return sorted({int(r["round"]) for r in records
                   if isinstance(r.get("round"), (int, float))
                   and int(r.get("round", -1)) >= 0})


def _effective_straggled(tr: Dict[str, Any]):
    """Straggle draws that actually took effect in the round program:
    ``make_fault_fn`` lets Byzantine scaling override the straggle
    factor, a colluding client's delta is REPLACED by the shared attack
    direction, NaN poison overrides every delta transform, and a
    dropped client's payload never reaches the server at all. (A
    signflip does NOT mask a straggle — the negation composes with the
    straggle factor, so both draws show in the shipped delta.)"""
    import numpy as np

    return np.logical_and.reduce([
        tr["straggled"],
        np.logical_not(tr["byzantine"]),
        np.logical_not(tr["colluding"]),
        np.logical_not(tr["poisoned"]),
        np.logical_not(tr["dropped"]),
    ])


def _effective_masks(tr: Dict[str, Any]) -> Dict[str, Any]:
    """The per-kind draws that actually shipped an adversarial delta,
    after the injector's override chain (collude > byzantine/signflip >
    straggle; nan poisons everything; drop withholds everything).
    ``labelflipped`` is a DATA-path fault — it survives every delta
    transform except drop/nan (which remove the round's contribution
    entirely)."""
    import numpy as np

    alive = np.logical_not(tr["poisoned"]) \
        & np.logical_not(tr["dropped"])
    not_collude = np.logical_not(tr["colluding"])
    return {
        "byzantine": tr["byzantine"] & alive & not_collude,
        "signflipped": tr["signflipped"] & alive & not_collude,
        "colluding": tr["colluding"] & alive,
        "labelflipped": tr["labelflipped"] & alive,
        "straggled": _effective_straggled(tr),
    }


def replay_client_indexes(round_idx: int, num_clients: int,
                          clients_per_round: int, retry: int = 0):
    """Offline twin of ``algorithms.base.sample_client_indexes``: the
    identical draw (it IS that function), but with the process-global
    numpy RNG state saved and restored around the reseed — the runner
    stamps counts mid-round-loop, and telemetry must not leave RNG
    side effects behind (the bit-identity contract). ``retry`` is the
    accepted attempt's watchdog nonce (``rounds_retried`` on the
    record): a retried round trained a RE-DRAWN cohort, and replaying
    nonce 0 would attribute faults to clients that never ran."""
    import numpy as np

    from ..algorithms.base import sample_client_indexes

    state = np.random.get_state()
    try:
        return sample_client_indexes(
            round_idx, num_clients, clients_per_round, retry=retry)
    finally:
        np.random.set_state(state)


def _trace_fn(fault_trace: Optional[FaultTraceFn]) -> FaultTraceFn:
    if fault_trace is not None:
        return fault_trace
    from ..robust.faults import fault_trace_round

    return fault_trace_round


def make_fault_counts_fn(fault_spec: str, seed: int, num_clients: int,
                         clients_per_round: int,
                         fault_trace: Optional[FaultTraceFn] = None):
    """Per-round fault-count stamper for the runner's obs path: returns
    ``fn(round, retry=0) -> {"clients_straggled",
    "clients_byzantine", "clients_signflipped", "clients_colluding",
    "clients_labelflipped"}`` counted over that round's REPLAYED
    cohort (drop/quarantine counts are measured in-jit by the guard
    and deliberately not replayed here). Returns None when the spec
    injects nothing. ``fault_trace`` is the replay seam
    (:data:`FaultTraceFn`)."""
    from ..robust.faults import parse_fault_spec

    spec = parse_fault_spec(fault_spec)
    if spec is None or not spec.any_active:
        return None
    fault_trace_round = _trace_fn(fault_trace)

    def counts(round_idx: int, retry: int = 0) -> Dict[str, float]:
        sel = replay_client_indexes(
            round_idx, num_clients, clients_per_round, retry=retry)
        tr = fault_trace_round(spec, seed, round_idx, sel)
        eff = _effective_masks(tr)
        return {
            "clients_straggled": float(eff["straggled"].sum()),
            "clients_byzantine": float(eff["byzantine"].sum()),
            "clients_signflipped": float(eff["signflipped"].sum()),
            "clients_colluding": float(eff["colluding"].sum()),
            "clients_labelflipped": float(eff["labelflipped"].sum()),
        }

    return counts


def build_health_ledger(records: List[Dict[str, Any]],
                        config: Optional[Dict[str, Any]] = None,
                        fault_trace: Optional[FaultTraceFn] = None
                        ) -> Dict[str, Any]:
    """The per-site ledger for one run's (deduped) round stream.

    ``config`` is the run's recorded flag namespace (the stat_info JSON
    sidecar's ``config`` block); without it the replay sources are
    unavailable and the ledger degrades to the recorded series only.
    ``fault_trace`` is the fault replay seam (:data:`FaultTraceFn`).
    """
    import numpy as np

    config = config or {}
    rounds = _round_indices(records)
    num_clients = int(config.get("client_num_in_total") or 0)
    clients_per_round = int(config.get("client_num_per_round")
                            or num_clients)
    seed = int(config.get("seed") or 0)
    fault_spec = str(config.get("fault_spec") or "")

    ledger: Dict[str, Any] = {
        "sites": {}, "degraded_sites": [], "rounds_analyzed": len(rounds),
        "num_clients": num_clients, "replay": {
            "participation": bool(num_clients and rounds),
            "faults": False,
        },
    }
    if not num_clients or not rounds:
        return ledger

    # the accepted attempt of a watchdog-retried round trained a
    # RE-DRAWN cohort; its nonce is the record's rounds_retried
    retry_of = {int(r["round"]): int(r.get("rounds_retried") or 0)
                for r in records
                if isinstance(r.get("round"), (int, float))
                and isinstance(r.get("rounds_retried"), (int, float))}

    participated = np.zeros(num_clients, np.int64)
    dropped = np.zeros(num_clients, np.int64)
    poisoned = np.zeros(num_clients, np.int64)
    straggled = np.zeros(num_clients, np.int64)
    byzantine = np.zeros(num_clients, np.int64)
    signflipped = np.zeros(num_clients, np.int64)
    colluding = np.zeros(num_clients, np.int64)
    labelflipped = np.zeros(num_clients, np.int64)
    # in-jit numerics drift (obs/numerics.py, obs_schema v2): per-slot
    # ``num_drift_s<j>`` record keys map to global clients through the
    # SAME participation replay — per-site drift trajectories join the
    # ledger when the stream carries them (v1 streams simply have none)
    rec_of = {int(r["round"]): r for r in records
              if isinstance(r.get("round"), (int, float))
              and int(r["round"]) >= 0}
    drift_points = np.zeros(num_clients, np.int64)
    drift_nonfinite = np.zeros(num_clients, np.int64)
    drift_max = np.zeros(num_clients, np.float64)

    spec = None
    if fault_spec:
        from ..robust.faults import parse_fault_spec

        spec = parse_fault_spec(fault_spec)
        if spec is not None and not spec.any_active:
            spec = None
    ledger["replay"]["faults"] = spec is not None

    import math

    from .numerics import drift_slots

    for r in rounds:
        sel = replay_client_indexes(r, num_clients, clients_per_round,
                                    retry=retry_of.get(r, 0))
        participated[sel] += 1
        if spec is not None:
            tr = _trace_fn(fault_trace)(spec, seed, r, sel)
            eff = _effective_masks(tr)
            dropped[sel] += tr["dropped"]
            poisoned[sel] += tr["poisoned"]
            straggled[sel] += eff["straggled"]
            byzantine[sel] += eff["byzantine"]
            signflipped[sel] += eff["signflipped"]
            colluding[sel] += eff["colluding"]
            labelflipped[sel] += eff["labelflipped"]
        for j, v in drift_slots(rec_of.get(r) or {}).items():
            if j >= len(sel):
                continue
            c = int(sel[j])
            drift_points[c] += 1
            if math.isfinite(v):
                drift_max[c] = max(drift_max[c], float(v))
            else:
                drift_nonfinite[c] += 1

    # recorded per-site accuracy trajectories (eval rounds with obs on)
    acc_traj: Dict[int, List[float]] = {}
    for rec in records:
        per = rec.get("acc_per_client")
        if isinstance(per, (list, tuple)) and len(per) == num_clients:
            for c, v in enumerate(per):
                if isinstance(v, (int, float)):
                    acc_traj.setdefault(c, []).append(float(v))

    for c in range(num_clients):
        traj = acc_traj.get(c, [])
        entry: Dict[str, Any] = {
            "rounds_participated": int(participated[c]),
            "participation_share": (float(participated[c]) / len(rounds)
                                    if rounds else 0.0),
            "dropped": int(dropped[c]),
            "quarantined": int(poisoned[c]),
            "straggled": int(straggled[c]),
            "byzantine": int(byzantine[c]),
            "signflipped": int(signflipped[c]),
            "colluding": int(colluding[c]),
            "labelflipped": int(labelflipped[c]),
            "eval_points": len(traj),
            "last_acc": traj[-1] if traj else None,
            "drift_points": int(drift_points[c]),
            # max over FINITE samples only; None when none exist (an
            # every-round-poisoned site must not read as zero drift)
            "drift_max": (float(drift_max[c])
                          if drift_points[c] > drift_nonfinite[c]
                          else None),
            "drift_nonfinite": int(drift_nonfinite[c]),
        }
        reasons = []
        if drift_nonfinite[c]:
            reasons.append("drift_nonfinite")
        faults = int(dropped[c] + poisoned[c])
        if participated[c] and \
                faults / float(participated[c]) >= DEGRADED_FAULT_RATE:
            reasons.append("fault_rate")
        attacks = int(byzantine[c] + signflipped[c] + colluding[c]
                      + labelflipped[c])
        if participated[c] and \
                attacks / float(participated[c]) >= DEGRADED_FAULT_RATE:
            # an ATTACKING site is degraded by attribution, not by
            # health: the replayed trace names it an adversary
            reasons.append("adversarial")
        if len(traj) >= MIN_TREND_POINTS:
            half = len(traj) // 2
            early = float(np.mean(traj[:half]))
            late = float(np.mean(traj[half:]))
            entry["acc_trend"] = late - early
            if early - late > DEGRADED_ACC_DROP:
                reasons.append("acc_regressing")
        entry["degraded"] = bool(reasons)
        entry["degraded_reasons"] = reasons
        ledger["sites"][str(c)] = entry
        if reasons:
            ledger["degraded_sites"].append(c)
    return ledger


def render_health(ledger: Dict[str, Any]) -> str:
    """Human-readable ledger summary (one line per noteworthy site)."""
    lines = [f"per-site health — {ledger['rounds_analyzed']} rounds, "
             f"{ledger['num_clients']} sites"
             + ("" if ledger["replay"]["faults"]
                else " (no fault replay: fault_spec empty/unavailable)")]
    for c, s in sorted(ledger["sites"].items(), key=lambda kv: int(kv[0])):
        noteworthy = s["degraded"] or s["dropped"] or s["quarantined"] \
            or s["straggled"] or s["byzantine"] \
            or s.get("signflipped") or s.get("colluding") \
            or s.get("labelflipped")
        if not noteworthy:
            continue
        bits = [f"site {c}: participated {s['rounds_participated']}"]
        for k in ("dropped", "quarantined", "straggled", "byzantine",
                  "signflipped", "colluding", "labelflipped"):
            if s[k]:
                bits.append(f"{k} {s[k]}")
        if s["last_acc"] is not None:
            bits.append(f"last_acc {s['last_acc']:.3f}")
        if s["degraded"]:
            bits.append("DEGRADED(" + ",".join(s["degraded_reasons"]) + ")")
        lines.append("  " + ", ".join(bits))
    if len(lines) == 1:
        lines.append("  all sites healthy")
    return "\n".join(lines)
