"""Offline run analyzer: from recorded telemetry to a diagnosis
(counterpart of ``neuroimagedisttraining_tpu/obs/analyze.py``).

Runs record per-round JSONL, ``metrics.json`` and host span traces; this
module turns one run's artifacts into a verdict:

* **per-phase round-time attribution** — host span totals folded into
  phases (``sample`` / ``train_dispatch`` / ``train_flush`` / ``eval``
  / ``finalize`` / ``setup``), the JSONL ``round_time_s`` series as the
  wall-clock denominator, and the un-attributed remainder reported
  honestly as ``device_and_wait`` (the in-graph phases — ``local_train``
  / ``guard`` / ``aggregate`` — run on the card, visible in the
  ``--profile_dir`` ``torch.profiler`` trace through ``obs/devtrace.py``,
  not in host spans);
* **robust outlier / straggler rounds** — median/MAD flags on the
  ``round_time_s`` series (a deviation floor keeps a near-constant
  series from flagging noise), cross-referenced with the deterministic
  fault-trace replay (the port's ``robust.faults.fault_trace_round``
  over the ``torch`` generators its rounds drew from, or any other
  replay given at the ``fault_trace`` seam, ``obs/health.py``) so a
  round whose cohort contained injected stragglers is flagged with the
  exact round index and the ``train`` phase;
* **memory watermark trend** — least-squares slope + monotonicity over
  the per-round ``mem_*`` samples, flagging suspected leaks;
* **fault-recovery summary** and the **per-site health ledger**
  (``obs/health.py``), plus **compile-cost** totals when the run's
  registry recorded them (``obs/compile.py``: the port's kernel builds
  and CUDA-graph captures, ``COMPILE_KINDS``).

Everything is offline and side-effect-free: the analyzer never touches
run identity, and obs-off runs (no JSONL) simply have nothing to
analyze. Output is a versioned machine-readable dict
(:data:`ANALYSIS_SCHEMA_VERSION`, written as ``<identity>.analysis.json``)
plus a human-readable report. CLI:
``python -m neuroimagedisttraining_torch.obs analyze <run_dir>``. The
schema and its keys are the JAX package's: an ``analysis.json`` either
package writes validates in both.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

from . import export as obs_export

__all__ = [
    "ANALYSIS_SCHEMA_VERSION", "analyze_records", "analyze_run_dir",
    "render_report", "render_xtrace", "validate_analysis",
    "write_analysis",
]

#: version of the analysis.json schema this module emits.
#: v2 adds the ``numerics`` section (in-jit training-dynamics telemetry:
#: per-layer-group precursor trends, per-client drift trajectories,
#: fault/rollback attribution) and the combined ``outlier_table``
#: (timing outliers + numeric drift outliers as one ranked table).
#: v3 adds the ``comm`` section (obs/comm.py wire-cost telemetry:
#: modeled bytes per agg_impl and per leaf group, the what-if table at
#: the live mask density, probed agg time/share, measured serialized
#: bytes, and the obs/devtrace.py device-trace attribution when a
#: profile was captured). v4 adds the ``slo`` section (obs/slo.py
#: online-SLO telemetry: the run-health trajectory, per-objective
#: compliance and error-budget spend from a deterministic engine
#: replay, and the breach timeline from the ``<identity>.events.jsonl``
#: stream joined against the fault-trace replay so each breach names
#: the injected rounds and clients behind it). v5 adds the ``xtrace``
#: section (obs/xtrace.py cross-process distributed tracing: per-round
#: critical-path decomposition over the clock-aligned merged trace —
#: dispatch / site train / encode / wire / queue-wait / combine /
#: flush / publish / adopt — with the straggler site named per round
#: from the slowest ``site_round`` lane, cross-checked against the
#: sites' own injected-straggle records, plus the staleness→accuracy
#: join from the serving probe). Older documents (and older
#: ``obs_schema`` round streams) are still accepted — each
#: version's keys are required only of documents at that version or
#: newer.
ANALYSIS_SCHEMA_VERSION = 6

#: host span name -> phase bucket. Container / nested spans are mapped
#: to None and skipped so phase totals never double-count (``round``
#: contains sample+dispatch; ``init_state`` contains ``snip_mask``;
#: ``finalize`` contains ``finetune``). Unknown spans -> other_host.
PHASE_OF_SPAN: Dict[str, Optional[str]] = {
    "sample": "sample",
    "dispatch_round": "train_dispatch",
    "fused_block_dispatch": "train_dispatch",
    "fused_block_flush": "train_flush",
    "eval": "eval",
    "finalize": "finalize",
    "build": "setup",
    "init_state": "setup",
    "round": None,
    "snip_mask": None,
    "finetune": None,
}

#: a round is an outlier when its |round_time_s - median| exceeds this
#: many robust standard deviations (1.4826 * MAD)
OUTLIER_MAD_K = 3.5

#: deviation floor as a fraction of the median: a series of
#: near-identical times (MAD ~ 0) must not flag sub-percent noise
OUTLIER_REL_FLOOR = 0.05

#: minimum rounds before timing outliers are judged at all
MIN_ROUNDS_FOR_OUTLIERS = 5

#: memory-leak heuristic: at least this many samples, at least this
#: fraction of successive deltas increasing, and at least this total
#: growth (percent of the first sample)
LEAK_MIN_SAMPLES = 6
LEAK_MIN_INCREASE_FRACTION = 0.75
LEAK_MIN_GROWTH_PCT = 2.0

#: mem record field -> memory-series key in the analysis
MEMORY_FIELDS = {
    "mem_host_rss_bytes": "host_rss",
    "mem_device_bytes_in_use": "device_in_use",
}

#: per-round fault count fields summed into the fault summary
FAULT_FIELDS = ("clients_dropped", "clients_quarantined",
                "clients_straggled", "clients_byzantine",
                "clients_signflipped", "clients_colluding",
                "clients_labelflipped", "fed_byzantine_flagged",
                "round_skipped")

#: numerics precursor warning: a layer group whose max-abs gauge sits
#: within this many doublings of the f32 overflow boundary is flagged
#: (non-finite gauges always flag)
NUMERICS_WARN_HEADROOM_BITS = 16.0

#: a client's drift is an outlier when it exceeds the cohort's median
#: by this many robust sigmas (1.4826 * MAD); non-finite drift always
NUMERICS_DRIFT_MAD_K = 3.5

_F32_MAX = 3.4028235e38


def _headroom_bits(maxabs: float) -> Optional[float]:
    """Doublings left before a gauge value overflows f32 (None when the
    gauge is zero/absent; 0.0 when it is already non-finite)."""
    if not isinstance(maxabs, (int, float)):
        return None
    if not math.isfinite(maxabs):
        return 0.0
    if maxabs <= 0:
        return None
    return math.log2(_F32_MAX / maxabs)


def _round_records(records: List[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    return [r for r in records
            if isinstance(r.get("round"), (int, float))
            and int(r["round"]) >= 0]


# ---------------------------------------------------------------------------
# section analyzers
# ---------------------------------------------------------------------------

def _analyze_rounds(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    idx = [int(r["round"]) for r in records]
    seen = set()
    dups = sorted({i for i in idx if i in seen or seen.add(i)})
    out: Dict[str, Any] = {"count": len(set(idx)),
                           "first": min(idx) if idx else None,
                           "last": max(idx) if idx else None,
                           "duplicates": dups, "missing": []}
    if idx:
        out["missing"] = sorted(
            set(range(min(idx), max(idx) + 1)) - set(idx))
    return out


def _analyze_round_time(records: List[Dict[str, Any]]
                        ) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    series = [(int(r["round"]), float(r["round_time_s"]))
              for r in records
              if isinstance(r.get("round_time_s"), (int, float))]
    if not series:
        return {"present": False, "rounds": 0}, []
    from .metrics import mad as _mad, median as _median, robust_sigma

    xs = [v for _, v in series]
    med = _median(xs)
    mad = _mad(xs, med)
    sigma = max(robust_sigma(xs, med), OUTLIER_REL_FLOOR * med, 1e-9)
    stats = {
        "present": True, "rounds": len(xs), "total_s": sum(xs),
        "mean_s": sum(xs) / len(xs), "median_s": med, "mad_s": mad,
        "min_s": min(xs), "max_s": max(xs),
    }
    outliers: List[Dict[str, Any]] = []
    if len(xs) >= MIN_ROUNDS_FOR_OUTLIERS:
        for r, v in series:
            dev = (v - med) / sigma
            if abs(dev) > OUTLIER_MAD_K:
                outliers.append({
                    "round": r, "round_time_s": v,
                    "deviation_sigmas": round(dev, 2),
                    "kind": "slow" if dev > 0 else "fast",
                })
    return stats, outliers


def _span_list(trace_doc: Optional[Dict[str, Any]]
               ) -> List[Dict[str, Any]]:
    if not trace_doc:
        return []
    return [e for e in trace_doc.get("traceEvents", ())
            if e.get("ph") == "X" and isinstance(e.get("dur"),
                                                 (int, float))]


def _analyze_phases(spans: List[Dict[str, Any]],
                    wall_total_s: Optional[float]) -> Dict[str, Any]:
    totals: Dict[str, Dict[str, float]] = {}
    for e in spans:
        phase = PHASE_OF_SPAN.get(e.get("name"), "other_host")
        if phase is None:
            continue
        t = totals.setdefault(phase, {"total_s": 0.0, "count": 0})
        t["total_s"] += float(e["dur"]) / 1e6  # trace dur is in us
        t["count"] += 1
    phases: Dict[str, Any] = {}
    for name, t in sorted(totals.items()):
        phases[name] = {
            "total_s": t["total_s"], "count": int(t["count"]),
            "mean_s": t["total_s"] / max(1, t["count"]),
        }
    if wall_total_s is not None:
        # the wall denominator covers the ROUND loop; per-round host
        # phases are sample + train dispatch/flush + eval
        in_round = sum(phases[p]["total_s"] for p in
                       ("sample", "train_dispatch", "train_flush",
                        "eval") if p in phases)
        phases["device_and_wait"] = {
            "total_s": max(0.0, wall_total_s - in_round),
            "count": 0, "mean_s": 0.0,
        }
        for name, p in phases.items():
            p["share_of_wall"] = (round(p["total_s"] / wall_total_s, 4)
                                  if wall_total_s > 0 else None)
    return phases


def _analyze_memory(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"present": False, "series": {},
                           "leaks_suspected": []}
    for field, key in MEMORY_FIELDS.items():
        series = [(int(r["round"]), float(r[field])) for r in records
                  if isinstance(r.get(field), (int, float))]
        if len(series) < 2:
            continue
        out["present"] = True
        rounds = [float(r) for r, _ in series]
        vals = [v for _, v in series]
        n = len(vals)
        # least-squares slope (bytes per round)
        mr, mv = sum(rounds) / n, sum(vals) / n
        denom = sum((r - mr) ** 2 for r in rounds) or 1.0
        slope = sum((r - mr) * (v - mv)
                    for (r, v) in zip(rounds, vals)) / denom
        deltas = [b - a for a, b in zip(vals, vals[1:])]
        inc_frac = (sum(1 for d in deltas if d > 0) / len(deltas)
                    if deltas else 0.0)
        growth = vals[-1] - vals[0]
        growth_pct = (100.0 * growth / vals[0]) if vals[0] else 0.0
        leak = bool(n >= LEAK_MIN_SAMPLES
                    and inc_frac >= LEAK_MIN_INCREASE_FRACTION
                    and growth > 0
                    and growth_pct >= LEAK_MIN_GROWTH_PCT)
        out["series"][key] = {
            "samples": n, "first_bytes": vals[0], "last_bytes": vals[-1],
            "growth_bytes": growth, "growth_pct": round(growth_pct, 3),
            "slope_bytes_per_round": slope,
            "increase_fraction": round(inc_frac, 3),
            "leak_suspected": leak,
        }
        if leak:
            out["leaks_suspected"].append(key)
    return out


def _analyze_faults(records: List[Dict[str, Any]],
                    metrics: Optional[Dict[str, Any]],
                    events: Optional[List[Dict[str, Any]]] = None
                    ) -> Dict[str, Any]:
    totals = {f: 0.0 for f in FAULT_FIELDS}
    rounds_with = 0
    for r in records:
        hit = False
        for f in FAULT_FIELDS:
            v = r.get(f)
            if isinstance(v, (int, float)) and math.isfinite(v):
                totals[f] += float(v)
                hit = hit or v > 0
        rounds_with += bool(hit)
    registry = {}
    for name, m in (metrics or {}).items():
        if name.startswith("fault_recovery_") and isinstance(m, dict):
            registry[name[len("fault_recovery_"):]] = m.get("value")
    # Byzantine attribution: the fed aggregator's norm-screen events
    # NAME the flagged sites (``sites`` on the raw event record) —
    # fold them into site -> flag count so the report prints WHO
    # attacked, not just how often the screen fired
    byzantine_sites: Dict[str, int] = {}
    for e in events or ():
        if e.get("event_type") != "BYZANTINE":
            continue
        for s in e.get("sites") or (e.get("detail") or {}).get(
                "sites") or ():
            k = str(int(s))
            byzantine_sites[k] = byzantine_sites.get(k, 0) + 1
    return {**{k: v for k, v in totals.items()},
            "rounds_with_faults": rounds_with, "registry": registry,
            "byzantine_sites": byzantine_sites}


def _straggler_rounds(records: List[Dict[str, Any]],
                      outliers: List[Dict[str, Any]],
                      config: Optional[Dict[str, Any]],
                      fault_trace=None) -> List[Dict[str, Any]]:
    """Straggler flags from both evidence sources, keyed by round.

    * ``fault_trace`` — the stream recorded ``clients_straggled > 0``
      (the runner's obs-time replay stamp), or the replay recomputes it
      here from the run config when the stream predates the stamp
      (through the ``fault_trace`` seam, ``obs/health.py``);
    * ``round_time`` — the round is a slow MAD outlier. The FIRST
      round of the series is exempt from timing-only flags: its wall
      time includes compilation (the analyzer's compile section prices
      that separately), which is not a straggler. It still appears in
      ``outlier_rounds``.

    A round backed by the fault trace is attributed to the ``train``
    phase (stragglers return partial local-training work); a purely
    timing-based flag stays unattributed (``phase: null``) rather than
    guessing.
    """
    by_round: Dict[int, Dict[str, Any]] = {}
    counts_fn = None
    cfg = config or {}
    if cfg.get("fault_spec") and cfg.get("client_num_in_total"):
        from .health import make_fault_counts_fn

        counts_fn = make_fault_counts_fn(
            str(cfg["fault_spec"]), int(cfg.get("seed") or 0),
            int(cfg["client_num_in_total"]),
            int(cfg.get("client_num_per_round")
                or cfg["client_num_in_total"]), fault_trace=fault_trace)
    for r in records:
        idx = int(r["round"])
        n = r.get("clients_straggled")
        if n is None and counts_fn is not None:
            n = counts_fn(idx, retry=int(r.get("rounds_retried") or 0)
                          )["clients_straggled"]
        if isinstance(n, (int, float)) and n > 0:
            by_round[idx] = {"round": idx, "phase": "train",
                             "source": "fault_trace",
                             "clients_straggled": float(n)}
    first_round = min((int(r["round"]) for r in records), default=None)
    for o in outliers:
        if o["kind"] != "slow":
            continue
        e = by_round.get(o["round"])
        if e is None:
            if o["round"] == first_round:
                continue  # compile round, not a straggler
            by_round[o["round"]] = {
                "round": o["round"], "phase": None,
                "source": "round_time",
                "deviation_sigmas": o["deviation_sigmas"]}
        else:
            e["source"] = "fault_trace+round_time"
            e["deviation_sigmas"] = o["deviation_sigmas"]
    return [by_round[k] for k in sorted(by_round)]


def _numerics_maps(rec: Dict[str, Any], prefix: str) -> Dict[str, float]:
    """``{suffix: value}`` for one record's ``<prefix><suffix>`` keys."""
    out = {}
    for k, v in rec.items():
        if k.startswith(prefix) and isinstance(v, (int, float)):
            out[k[len(prefix):]] = float(v)
    return out


def _replay_sel_fn(config: Optional[Dict[str, Any]]):
    """Slot → global-client mapper via the deterministic participation
    replay, or None when the run config lacks the cohort shape."""
    cfg = config or {}
    num = int(cfg.get("client_num_in_total") or 0)
    if not num:
        return None
    per = int(cfg.get("client_num_per_round") or num)
    from .health import replay_client_indexes

    def sel(round_idx: int, retry: int = 0):
        return replay_client_indexes(round_idx, num, per, retry=retry)

    return sel


def _analyze_numerics(records: List[Dict[str, Any]],
                      config: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The in-round numerics section: per-layer-group precursor trends,
    per-client drift trajectories (slots mapped to global client ids by
    the deterministic participation replay), headroom warnings, and —
    the flight-recorder question — the attribution of each
    fault/rollback round to the layer group and client trajectory that
    preceded it."""
    out: Dict[str, Any] = {
        "present": False, "groups": {}, "update_norm": {},
        "mask": {}, "clients": {}, "client_outliers": [],
        "warnings": [], "fault_attribution": [],
    }
    rows = [(int(r["round"]), r) for r in records
            if any(k.startswith("num_") for k in r)]
    if not rows:
        return out
    out["present"] = True
    # key on the round index alone: ties (duplicate rounds in a stream
    # analyzed without the dedupe pass) must not fall through to dict
    # comparison
    rows.sort(key=lambda t: t[0])
    sel_fn = _replay_sel_fn(config)

    # ---- per-layer-group precursor gauges -----------------------------
    maxabs_series: Dict[str, List[Tuple[int, float]]] = {}
    upd_series: Dict[str, List[Tuple[int, float]]] = {}
    total_upd: List[Tuple[int, float]] = []
    for ridx, rec in rows:
        for g, v in _numerics_maps(rec, "num_maxabs/").items():
            maxabs_series.setdefault(g, []).append((ridx, v))
        for g, v in _numerics_maps(rec, "num_upd/").items():
            upd_series.setdefault(g, []).append((ridx, v))
        tv = rec.get("num_update_norm")
        if isinstance(tv, (int, float)):
            total_upd.append((ridx, float(tv)))
    for g, series in sorted(maxabs_series.items()):
        vals = [v for _, v in series]
        finite = [v for v in vals if math.isfinite(v)]
        nonfinite_rounds = [r for r, v in series
                            if not math.isfinite(v)]
        entry = {
            "rounds": len(series),
            "maxabs_first": vals[0], "maxabs_last": vals[-1],
            "maxabs_peak": max(finite) if finite else None,
            "headroom_bits_last": _headroom_bits(vals[-1]),
            "nonfinite_rounds": nonfinite_rounds,
        }
        ug = upd_series.get(g)
        if ug:
            entry["update_norm_last"] = ug[-1][1]
        out["groups"][g] = entry
        for r, v in series:
            hb = _headroom_bits(v)
            if not math.isfinite(v) or (
                    hb is not None
                    and hb < NUMERICS_WARN_HEADROOM_BITS):
                out["warnings"].append(
                    {"round": r, "group": g, "maxabs": v,
                     "headroom_bits": hb})
    if total_upd:
        finite = [v for _, v in total_upd if math.isfinite(v)]
        out["update_norm"] = {
            "last": total_upd[-1][1],
            "peak": max(finite) if finite else None,
            "rounds": len(total_upd),
        }

    # ---- mask dynamics (SalientGrads) ---------------------------------
    churn = [(r, rec["num_mask_churn"]) for r, rec in rows
             if isinstance(rec.get("num_mask_churn"), (int, float))]
    agree = [(r, rec["num_mask_agree"]) for r, rec in rows
             if isinstance(rec.get("num_mask_agree"), (int, float))]
    if churn:
        out["mask"] = {
            "churn_last": float(churn[-1][1]),
            "churn_max": max(float(v) for _, v in churn),
            "agree_last": (float(agree[-1][1]) if agree else None),
            "agree_min": (min(float(v) for _, v in agree)
                          if agree else None),
        }

    # ---- per-client drift trajectories --------------------------------
    traj: Dict[Any, List[Tuple[int, float]]] = {}
    slot_by_round: Dict[int, Dict[int, float]] = {}
    from .numerics import drift_slots

    for ridx, rec in rows:
        slots = drift_slots(rec)
        if not slots:
            continue
        slot_by_round[ridx] = slots
        sel = None
        if sel_fn is not None:
            sel = sel_fn(ridx,
                         retry=int(rec.get("rounds_retried") or 0))
        for j, v in slots.items():
            cid = (int(sel[j]) if sel is not None and j < len(sel)
                   else f"slot{j}")
            traj.setdefault(cid, []).append((ridx, v))
    all_finite = [v for t in traj.values() for _, v in t
                  if math.isfinite(v)]
    med = sigma = None
    if all_finite:
        from .metrics import median as _median, robust_sigma

        med = _median(all_finite)
        sigma = max(robust_sigma(all_finite, med),
                    OUTLIER_REL_FLOOR * abs(med), 1e-12)
    for cid, t in sorted(traj.items(), key=lambda kv: str(kv[0])):
        finite = [(r, v) for r, v in t if math.isfinite(v)]
        nonfin = [r for r, v in t if not math.isfinite(v)]
        entry: Dict[str, Any] = {
            "points": len(t), "nonfinite_rounds": nonfin,
        }
        if finite:
            peak_r, peak = max(finite, key=lambda rv: rv[1])
            entry["max_drift"] = peak
            entry["max_drift_round"] = peak_r
            if med is not None:
                entry["drift_sigmas"] = round((peak - med) / sigma, 2)
        entry["outlier"] = bool(
            nonfin or (entry.get("drift_sigmas") or 0)
            > NUMERICS_DRIFT_MAD_K)
        out["clients"][str(cid)] = entry
        if entry["outlier"]:
            out["client_outliers"].append(str(cid))

    # ---- fault / rollback attribution ---------------------------------
    # total precursor gauge per round (max over groups, finite only) —
    # the "how many rounds of warning" series
    gauge: Dict[int, float] = {}
    for g, series in maxabs_series.items():
        for r, v in series:
            if math.isfinite(v):
                gauge[r] = max(gauge.get(r, 0.0), v)
    gauge_rounds = sorted(gauge)
    for ridx, rec in rows:
        sources = []
        for field, label in (("clients_quarantined", "guard_quarantine"),
                             ("rounds_retried", "rollback_retry"),
                             ("round_skipped", "round_skipped")):
            v = rec.get(field)
            if isinstance(v, (int, float)) and v > 0:
                sources.append(label)
        if not sources:
            continue
        slots = slot_by_round.get(ridx, {})
        bad_slots = sorted(j for j, v in slots.items()
                           if not math.isfinite(v))
        if not bad_slots and slots and med is not None:
            bad_slots = sorted(
                j for j, v in slots.items()
                if (v - med) / sigma > NUMERICS_DRIFT_MAD_K)
        if not bad_slots and slots:
            bad_slots = [max(slots, key=lambda j: slots[j])]
        sel = None
        if sel_fn is not None:
            sel = sel_fn(ridx,
                         retry=int(rec.get("rounds_retried") or 0))
        clients = [int(sel[j]) for j in bad_slots
                   if sel is not None and j < len(sel)]
        groups = sorted(
            g for g, series in maxabs_series.items()
            if any(r == ridx and not math.isfinite(v)
                   for r, v in series))
        if not groups and maxabs_series:
            # no non-finite gauge: name the group with the largest
            # gauge jump into the fault round (else largest gauge)
            def jump(g):
                s = dict(maxabs_series[g])
                cur = s.get(ridx)
                if cur is None or not math.isfinite(cur):
                    return float("-inf")
                prev = [v for r, v in sorted(s.items())
                        if r < ridx and math.isfinite(v)]
                return cur / prev[-1] if prev and prev[-1] > 0 else cur
            best = max(maxabs_series, key=jump)
            if jump(best) != float("-inf"):
                groups = [best]
        # consecutive rounds of rising precursor gauge before the fault
        prior = [r for r in gauge_rounds if r < ridx]
        warn = 0
        for a, b in zip(reversed(prior[:-1] or []), reversed(prior)):
            if gauge[b] > gauge[a]:
                warn += 1
            else:
                break
        out["fault_attribution"].append({
            "round": ridx, "sources": sources,
            "slots": bad_slots, "clients": clients,
            "layer_groups": groups, "precursor_rounds": warn,
        })
    return out


def _outlier_table(stragglers: List[Dict[str, Any]],
                   numerics: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Timing outliers and numeric drift outliers as ONE ranked table:
    each row is a round, carrying the timing deviation (when the round
    was a slow outlier / flagged straggler), the offending clients and
    their drift deviation (when the numerics flagged them there), and
    the union of evidence sources. Non-finite drift ranks first, then
    by the larger of the two robust deviations."""
    rows: Dict[int, Dict[str, Any]] = {}

    def row(r: int) -> Dict[str, Any]:
        return rows.setdefault(r, {
            "round": r, "clients": [], "timing_sigmas": None,
            "drift_sigmas": None, "nonfinite": False, "sources": []})

    for s in stragglers:
        e = row(int(s["round"]))
        e["timing_sigmas"] = s.get("deviation_sigmas")
        e["sources"].append(s["source"])
        if "clients_straggled" in s:
            e["clients_straggled"] = s["clients_straggled"]
    for cid in numerics.get("client_outliers", ()):
        c = numerics["clients"][cid]
        for r in c.get("nonfinite_rounds", ()):
            e = row(int(r))
            e["nonfinite"] = True
            if cid not in e["clients"]:
                e["clients"].append(cid)
            if "drift_nonfinite" not in e["sources"]:
                e["sources"].append("drift_nonfinite")
        if not c.get("nonfinite_rounds") and \
                c.get("max_drift_round") is not None:
            e = row(int(c["max_drift_round"]))
            if cid not in e["clients"]:
                e["clients"].append(cid)
            ds = c.get("drift_sigmas")
            if ds is not None:
                e["drift_sigmas"] = max(e["drift_sigmas"] or 0.0, ds)
            if "drift_outlier" not in e["sources"]:
                e["sources"].append("drift_outlier")

    def severity(e):
        return (0 if e["nonfinite"] else 1,
                -max(abs(e["timing_sigmas"] or 0.0),
                     abs(e["drift_sigmas"] or 0.0)))

    return sorted(rows.values(), key=severity)


#: the analyzer flags a round stream as aggregation-bound when the
#: median probed/measured agg share exceeds this (ROADMAP Open item 3's
#: "push agg share below 25% at scale-32" target makes >50% a finding)
COMM_AGG_SHARE_FLAG = 0.5


def _analyze_comm(records: List[Dict[str, Any]],
                  metrics: Optional[Dict[str, Any]],
                  devtrace: Optional[Dict[str, Any]] = None,
                  config: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """The schema-v3 comm section: modeled bytes per wire and per leaf
    group (obs/comm.py's per-round stamps), the what-if table at the
    live density, probed agg time/share, measured serialized bytes
    (Message accounting counters), and the device-trace attribution
    sidecar when one was captured. ``present`` only when the stream
    actually carries comm keys (comm telemetry was on) or a devtrace
    summary exists — v1/v2 streams analyze with an empty section."""
    out: Dict[str, Any] = {
        "present": False, "impl": None, "density": None,
        "n_params": None, "n_devices": None, "wire_bytes": None,
        "modeled": {}, "groups": {}, "what_if": [],
        "agg_ms": {}, "agg_share": {}, "probe_gbps": None,
        "measured": {}, "devtrace": {},
    }
    rows = [r for r in records
            if any(k.startswith("comm_") for k in r)]
    if devtrace and devtrace.get("present"):
        out["devtrace"] = {
            "agg_share": devtrace.get("totals", {}).get("agg_share"),
            "collective_s": devtrace.get("totals", {}).get(
                "collective_s"),
            "busy_s": devtrace.get("totals", {}).get("busy_s"),
            "devices": len(devtrace.get("devices") or {}),
            "achieved_gbps": devtrace.get("achieved_gbps"),
            "top_collectives": devtrace.get("top_collectives") or [],
        }
        if devtrace.get("kernels"):
            # the port's sidecar also ranks every compute kernel (which
            # hand kernels the profiled round ran, and for how long); a
            # JAX-format sidecar has no such list and none is added
            out["devtrace"]["kernels"] = devtrace["kernels"]
        out["present"] = True
    for name, entry in (metrics or {}).items():
        if name.startswith("comm_msg") and isinstance(entry, dict):
            out["measured"][name] = entry.get("value")
    if not rows:
        return out
    out["present"] = True
    last = rows[-1]
    out["impl"] = (config or {}).get("agg_impl")
    out["density"] = last.get("comm_density")
    out["n_params"] = last.get("comm_n_params")
    out["n_devices"] = last.get("comm_n_devices")
    out["wire_bytes"] = last.get("comm_bytes_wire")
    group_prefix = "comm_bytes_group/"
    for k, v in last.items():
        if not isinstance(v, (int, float)):
            continue
        if k.startswith(group_prefix):
            out["groups"][k[len(group_prefix):]] = float(v)
        elif k.startswith("comm_bytes_") and k != "comm_bytes_wire":
            out["modeled"][k[len("comm_bytes_"):]] = float(v)
    dense = out["modeled"].get("dense")
    out["what_if"] = sorted(
        ({"impl": impl, "bytes": b,
          "vs_dense": (round(b / dense, 4) if dense else None)}
         for impl, b in out["modeled"].items()),
        key=lambda e: e["bytes"])
    from .metrics import median as _median

    for key, sect in (("comm_agg_ms", "agg_ms"),
                      ("comm_agg_share", "agg_share")):
        series = [float(r[key]) for r in rows
                  if isinstance(r.get(key), (int, float))
                  and math.isfinite(r[key])]
        if series:
            out[sect] = {"median": _median(series),
                         "max": max(series), "min": min(series),
                         "rounds": len(series)}
    agg_ms = out["agg_ms"].get("median")
    if isinstance(out["wire_bytes"], (int, float)) and agg_ms:
        # EFFECTIVE bandwidth over the probe's FULL aggregation wall
        # (compute included) — deliberately named apart from the
        # devtrace's achieved_gbps, whose denominator is collective
        # kernel time only; the two answer different questions
        out["probe_gbps"] = out["wire_bytes"] / (agg_ms / 1e3) / 1e9
    # the no-trace fallback's AOT cost-analysis numbers (obs/comm.py
    # probe_agg_cost), when the backend reported them
    cost = {k: last[k] for k in ("comm_agg_flops",
                                 "comm_agg_bytes_accessed")
            if isinstance(last.get(k), (int, float))}
    if cost:
        out["cost_analysis"] = cost
    return out


def _injected_fault_fn(config: Optional[Dict[str, Any]],
                       fault_trace=None):
    """``fn(round, retry) -> {"poisoned": [...], "dropped": [...],
    "straggled": [...], "byzantine": [...], "signflipped": [...],
    "colluding": [...], "labelflipped": [...]}`` of global client ids
    via the deterministic fault-trace replay, or None when the run
    config lacks a fault spec / cohort shape — the breach-attribution
    join's evidence source (it NAMES the attackers behind a breach).
    ``fault_trace`` is the replay seam (``obs/health.py``)."""
    cfg = config or {}
    fault_spec = str(cfg.get("fault_spec") or "")
    num = int(cfg.get("client_num_in_total") or 0)
    if not fault_spec or not num:
        return None
    from ..robust.faults import parse_fault_spec

    spec = parse_fault_spec(fault_spec)
    if spec is None or not spec.any_active:
        return None
    per = int(cfg.get("client_num_per_round") or num)
    seed = int(cfg.get("seed") or 0)
    from .health import _trace_fn, replay_client_indexes

    fault_trace_round = _trace_fn(fault_trace)

    def injected(round_idx: int, retry: int = 0) -> Dict[str, Any]:
        sel = replay_client_indexes(round_idx, num, per, retry=retry)
        tr = fault_trace_round(spec, seed, round_idx, sel)
        # EFFECTIVE faults, mirroring the health ledger's convention
        # (obs/health.py): a draw overridden further up the injector's
        # chain (collude > byzantine/signflip > straggle; nan/drop
        # remove the contribution entirely) never reached the round
        # program, and the breach timeline must name the same clients
        # the ledger does
        from .health import _effective_masks

        eff = {"poisoned": tr["poisoned"], "dropped": tr["dropped"],
               **_effective_masks(tr)}
        return {field: [int(c) for c, hit in zip(sel, flags) if hit]
                for field, flags in eff.items()}

    return injected


def _analyze_slo(records: List[Dict[str, Any]],
                 events: Optional[List[Dict[str, Any]]],
                 config: Optional[Dict[str, Any]],
                 fault_trace=None) -> Dict[str, Any]:
    """The schema-v4 slo section: the recorded health trajectory, the
    engine's per-objective compliance/budget verdicts (rebuilt by a
    deterministic replay of the round stream against the run's
    recorded spec), and the breach timeline — every breach-family
    event joined against the fault-trace replay so the analyzer names
    the injected rounds and clients behind it. ``present`` only when
    the stream carries slo stamps or an events stream exists —
    pre-SLO streams analyze with an empty section."""
    out: Dict[str, Any] = {
        "present": False, "health_final": None, "transitions": [],
        "objectives": {}, "budget": {}, "breaches": [],
        "events": {"total": 0, "by_type": {}},
    }
    ev = list(events or [])
    stamped = [r for r in records
               if isinstance(r.get("slo_health"), str)]
    if not stamped and not ev:
        return out
    out["present"] = True
    # -- recorded health trajectory -------------------------------------
    prev = None
    for r in stamped:
        h = r["slo_health"]
        if h != prev:
            out["transitions"].append(
                {"round": int(r["round"]), "to": h, "from": prev})
            prev = h
    if stamped:
        out["health_final"] = stamped[-1]["slo_health"]
    # -- engine replay: per-objective compliance + budget spend ---------
    spec = str((config or {}).get("slo_spec") or "")
    if spec:
        from . import slo as obs_slo

        try:
            engine = obs_slo.SloEngine(obs_slo.load_slo_spec(spec))
            engine.replay(records)
            summary = engine.summary()
            out["objectives"] = summary["objectives"]
            out["budget"] = {
                name: {"budget": o["budget"],
                       "spend": o["budget_spend"],
                       "exhausted": o["budget_exhausted"]}
                for name, o in summary["objectives"].items()}
            if out["health_final"] is None:
                out["health_final"] = summary["health"]
        except ValueError:
            out["spec_error"] = spec  # unparseable recorded spec
    # -- breach timeline joined against the fault trace -----------------
    injected_fn = _injected_fault_fn(config, fault_trace)
    retry_of = {int(r["round"]): int(r.get("rounds_retried") or 0)
                for r in records
                if isinstance(r.get("round"), (int, float))
                and int(r.get("round", -1)) >= 0}
    rec_of = {int(r["round"]): r for r in records
              if isinstance(r.get("round"), (int, float))
              and int(r.get("round", -1)) >= 0}
    for e in ev:
        etype = e.get("event_type")
        out["events"]["total"] += 1
        out["events"]["by_type"][etype] = \
            out["events"]["by_type"].get(etype, 0) + 1
        if etype not in ("SLO_BREACH", "BUDGET_BURN",
                         "HEALTH_TRANSITION"):
            continue
        r = int(e.get("round", -1))
        entry: Dict[str, Any] = {
            "round": r, "event_type": etype,
            "objectives": [b.get("objective") for b in
                           (e.get("detail") or {}).get(
                               "objectives", [])],
        }
        if etype == "HEALTH_TRANSITION":
            entry["to"] = (e.get("detail") or {}).get("to")
        rec = rec_of.get(r) or {}
        q = rec.get("clients_quarantined")
        if isinstance(q, (int, float)) and q > 0:
            entry["clients_quarantined"] = float(q)
        if injected_fn is not None and r >= 0:
            inj = injected_fn(r, retry=retry_of.get(r, 0))
            entry["injected"] = {k: v for k, v in inj.items() if v}
        out["breaches"].append(entry)
    out["breaches"].sort(
        key=lambda b: (b["round"], str(b["event_type"])))
    return out


def _analyze_fleet(records: List[Dict[str, Any]],
                   events: Optional[List[Dict[str, Any]]]
                   ) -> Dict[str, Any]:
    """The schema-v6 fleet section: the live-telemetry plane's
    postmortem view — the ``fleet_*`` gauges the ledger joined onto
    the round stream (sites live / max heartbeat age / round
    progress trajectories) plus the SITE_DOWN / SITE_RECOVERED
    timeline from the events stream, each with the peers it named.
    ``present`` only for ``--obs_heartbeat_every`` runs — heartbeat-off
    streams analyze with an empty section (the twin contract)."""
    out: Dict[str, Any] = {
        "present": False, "sites_live_final": None,
        "sites_live_min": None, "sites_down_max": None,
        "max_heartbeat_age_s": None, "round_progress_min": None,
        "downs": [], "recoveries": [],
    }
    stamped = [r for r in records
               if isinstance(r.get("fleet_sites_live"), (int, float))]
    ev = [e for e in (events or ())
          if e.get("event_type") in ("SITE_DOWN", "SITE_RECOVERED")]
    if not stamped and not ev:
        return out
    out["present"] = True
    if stamped:
        out["sites_live_final"] = float(
            stamped[-1]["fleet_sites_live"])
        out["sites_live_min"] = min(
            float(r["fleet_sites_live"]) for r in stamped)
        out["sites_down_max"] = max(
            float(r.get("fleet_sites_down") or 0.0) for r in stamped)
        out["max_heartbeat_age_s"] = max(
            float(r.get("fleet_max_heartbeat_age_s") or 0.0)
            for r in stamped)
        out["round_progress_min"] = min(
            float(r.get("fleet_round_progress") or 0.0)
            for r in stamped)
    for e in ev:
        entry = {
            "round": int(e.get("round", -1)),
            "peers": [str(p) for p in
                      (e.get("detail") or {}).get("peers") or ()],
        }
        key = "downs" if e["event_type"] == "SITE_DOWN" \
            else "recoveries"
        out[key].append(entry)
    for key in ("downs", "recoveries"):
        out[key].sort(key=lambda d: (d["round"], d["peers"]))
    return out


#: merged-trace span names that each root one causal timeline: a sync
#: federation round (``fed_round``), a buffered flush (``flush``), or
#: a serving push (``publish``) — matched in this priority order
XTRACE_ROOT_SPANS = ("fed_round", "flush", "publish")

#: critical-path buckets, in timeline order. ``wire``/``queue_wait``
#: come from the aggregator's per-round wall stamps (a span cannot
#: straddle two clocks); everything else is a span duration. Buckets
#: a timeline does not exercise are simply absent from its row.
XTRACE_PHASES = ("dispatch", "site_train", "encode", "wire",
                 "queue_wait", "combine", "flush", "publish", "adopt")


def _xt_proc(span_id: str) -> str:
    """Span ids are ``<process>:<seq>`` — the lane is the prefix."""
    return str(span_id).rsplit(":", 1)[0]


def _xt_trace_key(trace: str) -> Tuple[str, int]:
    """Sort ``r0 < r1 < ... < v1 < ...`` numerically, not lexically."""
    head, tail = trace[:1], trace[1:]
    if tail.isdigit():
        return (head, int(tail))
    return (trace, -1)


def _analyze_xtrace(xtrace_doc: Optional[Dict[str, Any]],
                    records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The schema-v5 xtrace section: per-round critical-path rows over
    the clock-aligned merged trace (``federation.trace.json``). Each
    causal timeline (one trace id) decomposes into the phase buckets
    above; the slowest ``site_round`` lane names the round's straggler,
    which is cross-checked against the sites' own ``fed_straggled``
    records (the injected ground truth) — a disagreement lands in
    ``straggler_mismatches``. ``probe`` joins the serving worker's
    ``serve_probe_acc`` ticks against model staleness (satellite:
    accuracy-under-staleness). ``present`` only when a merged trace
    with spans exists — untraced runs analyze with an empty section."""
    out: Dict[str, Any] = {
        "present": False, "processes": [], "orphans": [],
        "rounds": [], "straggler_counts": {},
        "straggler_mismatches": [], "probe": {},
    }
    if not isinstance(xtrace_doc, dict):
        return out
    from . import xtrace as obs_xtrace

    idx = obs_xtrace.span_index(xtrace_doc)
    if not idx:
        return out
    out["present"] = True
    meta = xtrace_doc.get("xtrace") or {}
    out["processes"] = [str(p) for p in (meta.get("processes") or ())]
    out["orphans"] = obs_xtrace.validate_parentage(xtrace_doc)
    # joins from the round stream(s): the aggregator's wall stamps for
    # the two clock-straddling buckets, and the sites' straggle truth
    agg_ms: Dict[int, Dict[str, float]] = {}
    straggled_gt: Dict[int, set] = {}
    for r in records or ():
        if not isinstance(r.get("round"), (int, float)):
            continue
        rnd = int(r["round"])
        if rnd < 0:
            continue
        if "site" in r:
            if r.get("fed_straggled"):
                straggled_gt.setdefault(rnd, set()).add(
                    int(r["site"]))
        elif isinstance(r.get("fed_wire_ms"), (int, float)):
            agg_ms[rnd] = {
                "wire": float(r["fed_wire_ms"]),
                "queue_wait": float(r.get("fed_queue_ms") or 0.0)}
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for sid in sorted(idx):
        t = str((idx[sid].get("args") or {}).get("trace", ""))
        if t:
            by_trace.setdefault(t, []).append(idx[sid])
    counts: Dict[str, int] = {}
    for trace in sorted(by_trace, key=_xt_trace_key):
        evs = by_trace[trace]
        root = None
        for name in XTRACE_ROOT_SPANS:
            root = next((e for e in evs if e.get("name") == name),
                        None)
            if root is not None:
                break
        if root is None:
            continue
        rargs = root.get("args") or {}
        rnd = rargs.get("round", rargs.get("version"))
        if rnd is None and trace[1:].isdigit():
            rnd = int(trace[1:])
        rnd = int(rnd) if isinstance(rnd, (int, float)) else -1
        durs: Dict[str, List[float]] = {}
        sites: Dict[str, float] = {}
        injected: set = set()
        for e in evs:
            name = str(e.get("name", ""))
            d_ms = float(e.get("dur", 0.0)) / 1e3
            proc = _xt_proc((e.get("args") or {}).get("span_id", ""))
            if name == "site_round":
                sites[proc] = d_ms
            elif name == "straggle":
                injected.add(proc)
            durs.setdefault(name, []).append(d_ms)
        # sites run in parallel: their buckets enter the critical path
        # at the max across lanes, not the sum
        phases: Dict[str, float] = {}
        for bucket, src, how in (
                ("dispatch", "dispatch", sum),
                ("site_train", "train", max),
                ("encode", "encode", max),
                ("combine", "combine", sum),
                ("flush", "flush", sum),
                ("publish", "publish", sum),
                ("adopt", "adopt", max)):
            if src == root.get("name"):
                continue  # the root is the total, not a bucket
            if durs.get(src):
                phases[bucket] = how(durs[src])
        for bucket, v in (agg_ms.get(rnd) or {}).items():
            phases[bucket] = v
        row: Dict[str, Any] = {
            "trace": trace, "round": rnd,
            "root": str(root.get("name")),
            "total_ms": float(root.get("dur", 0.0)) / 1e3,
            "phases": {k: phases[k] for k in XTRACE_PHASES
                       if k in phases},
            "sites": {k: sites[k] for k in sorted(sites)},
        }
        if sites:
            straggler = max(sorted(sites), key=lambda p: sites[p])
            row["straggler"] = straggler
            counts[straggler] = counts.get(straggler, 0) + 1
            if injected:
                row["injected_straggle"] = sorted(injected)
            gt = {f"site{s}" for s in straggled_gt.get(rnd, ())}
            gt |= injected
            if gt and straggler not in gt:
                out["straggler_mismatches"].append(
                    {"trace": trace, "round": rnd,
                     "named": straggler, "injected": sorted(gt)})
        out["rounds"].append(row)
    out["straggler_counts"] = {k: counts[k] for k in sorted(counts)}
    # staleness -> accuracy join from the serving probe ticks
    pairs = [(float(r["serve_model_staleness_s"]),
              float(r["serve_probe_acc"]))
             for r in records or ()
             if isinstance(r.get("serve_probe_acc"), (int, float))
             and isinstance(r.get("serve_model_staleness_s"),
                            (int, float))]
    if pairs:
        stale = sorted(s for s, _ in pairs)
        accs = [a for _, a in pairs]
        med = stale[len(stale) // 2]
        fresh = [a for s, a in pairs if s <= med]
        old = [a for s, a in pairs if s > med]
        out["probe"] = {
            "n": len(pairs),
            "staleness_s": {"min": stale[0], "max": stale[-1],
                            "median": med},
            "acc": {"min": min(accs), "max": max(accs),
                    "last": accs[-1]},
            "acc_fresh_mean": (sum(fresh) / len(fresh)
                               if fresh else None),
            "acc_stale_mean": (sum(old) / len(old)
                               if old else None),
        }
    return out


def _analyze_compile(metrics: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The compile section over the port's compile kinds
    (``obs/compile.py``'s ``COMPILE_KINDS``: ``compile_kernel_build_s``,
    ``compile_graph_capture_s``), with the JAX package's output keys
    (``present``, ``total_s``, ``by_entry``, ``cache``)."""
    from .compile import COMPILE_KINDS

    m = metrics or {}
    out: Dict[str, Any] = {"present": False, "total_s": 0.0,
                           "by_entry": {}, "cache": {}}
    for name in COMPILE_KINDS.values():
        entry = m.get(name)
        if not isinstance(entry, dict):
            continue
        out["present"] = True
        val = entry.get("value") or {}
        out["total_s"] += float(val.get("sum") or 0.0)
        for label, v in (entry.get("labeled") or {}).items():
            # "entry=dispatch_round" -> dispatch_round
            key = label.split("=", 1)[-1]
            agg = out["by_entry"].setdefault(
                key, {"total_s": 0.0, "count": 0})
            agg["total_s"] += float((v or {}).get("sum") or 0.0)
            agg["count"] += int((v or {}).get("count") or 0)
    for name, entry in m.items():
        if name.startswith("compile_cache_") and isinstance(entry, dict):
            out["cache"][name[len("compile_cache_"):]] = entry.get("value")
    return out


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def analyze_records(records: List[Dict[str, Any]],
                    trace_doc: Optional[Dict[str, Any]] = None,
                    metrics: Optional[Dict[str, Any]] = None,
                    config: Optional[Dict[str, Any]] = None,
                    identity: str = "run",
                    devtrace: Optional[Dict[str, Any]] = None,
                    events: Optional[List[Dict[str, Any]]] = None,
                    xtrace_doc: Optional[Dict[str, Any]] = None,
                    fault_trace=None) -> Dict[str, Any]:
    """Pure-function analyzer core over an already-loaded round stream
    (plus optional trace / metrics.json / run-config dicts).
    ``fault_trace`` is the fault replay seam (``obs/health.py``'s
    ``FaultTraceFn``; None: the port's own draws)."""
    newer = [r.get("obs_schema") for r in records
             if isinstance(r.get("obs_schema"), int)
             and r["obs_schema"] > obs_export.OBS_SCHEMA_VERSION]
    if newer:
        raise ValueError(
            f"round stream carries obs_schema {max(newer)} but this "
            f"analyzer understands <= {obs_export.OBS_SCHEMA_VERSION} "
            "— upgrade before analyzing")
    # duplicate detection wants the RAW stream; everything else the
    # deduped (keep-last, sorted) timeline. The xtrace join also wants
    # the raw stream: fed dirs interleave aggregator and per-site
    # records sharing round numbers, which keep-last would collapse.
    raw_records = list(records)
    rounds_info = _analyze_rounds(_round_records(records))
    records = obs_export.dedupe_rounds(records)
    rounds = _round_records(records)
    rt_stats, outliers = _analyze_round_time(rounds)
    wall = rt_stats.get("total_s") if rt_stats.get("present") else None
    from .health import build_health_ledger

    health = build_health_ledger(rounds, config, fault_trace=fault_trace)
    stragglers = _straggler_rounds(rounds, outliers, config,
                                   fault_trace=fault_trace)
    numerics = _analyze_numerics(rounds, config)
    comm = _analyze_comm(rounds, metrics, devtrace=devtrace,
                         config=config)
    slo = _analyze_slo(rounds, events, config, fault_trace=fault_trace)
    fleet = _analyze_fleet(rounds, events)
    xtr = _analyze_xtrace(xtrace_doc, raw_records)
    analysis = {
        "schema_version": ANALYSIS_SCHEMA_VERSION,
        "identity": identity,
        "rounds": rounds_info,
        "round_time": rt_stats,
        "phases": _analyze_phases(_span_list(trace_doc), wall),
        "outlier_rounds": outliers,
        "stragglers": stragglers,
        "memory": _analyze_memory(rounds),
        "faults": _analyze_faults(rounds, metrics, events),
        "compile": _analyze_compile(metrics),
        "health": health,
        "numerics": numerics,
        "outlier_table": _outlier_table(stragglers, numerics),
        "comm": comm,
        "slo": slo,
        "fleet": fleet,
        "xtrace": xtr,
    }
    flags = []
    flags += [f"straggler_round_{s['round']}" for s in stragglers]
    flags += [f"memory_leak_{k}"
              for k in analysis["memory"]["leaks_suspected"]]
    flags += [f"missing_rounds_{len(analysis['rounds']['missing'])}"
              ] if analysis["rounds"]["missing"] else []
    flags += [f"degraded_site_{c}" for c in health["degraded_sites"]]
    flags += [f"byzantine_site_{s}" for s in sorted(
        analysis["faults"].get("byzantine_sites", {}),
        key=lambda s: int(s))]
    flags += [f"drift_outlier_client_{c}"
              for c in numerics["client_outliers"]]
    flags += [f"numerics_fault_round_{a['round']}"
              for a in numerics["fault_attribution"]]
    # aggregation-bound flag: the probed share (or, preferred when a
    # device trace was captured, the measured one) exceeds the SLO line
    agg_share = comm["devtrace"].get("agg_share") if comm["devtrace"] \
        else comm["agg_share"].get("median")
    if isinstance(agg_share, (int, float)) and \
            agg_share > COMM_AGG_SHARE_FLAG:
        flags.append(f"agg_share_{int(round(100 * agg_share))}pct")
    # run-health flags: the final SLO verdict plus the breach count
    if slo["present"] and slo.get("health_final") not in (None, "ok"):
        flags.append(f"slo_{slo['health_final']}")
    breach_rounds = sorted({b["round"] for b in slo["breaches"]
                            if b["event_type"] == "SLO_BREACH"})
    if breach_rounds:
        flags.append(f"slo_breach_rounds_{len(breach_rounds)}")
    down_peers = sorted({p for d in fleet["downs"]
                         for p in d["peers"]})
    if down_peers:
        flags.append("fleet_down_" + ",".join(down_peers))
    if xtr["present"]:
        if xtr["orphans"]:
            flags.append(f"xtrace_orphans_{len(xtr['orphans'])}")
        if xtr["straggler_mismatches"]:
            flags.append("xtrace_straggler_mismatch_"
                         f"{len(xtr['straggler_mismatches'])}")
    analysis["flags"] = flags
    return analysis


#: required top-level keys and their types — the schema contract tests
#: and scripts/obs_smoke.py validate against
_SCHEMA_KEYS = {
    "schema_version": int, "identity": str, "rounds": dict,
    "round_time": dict, "phases": dict, "outlier_rounds": list,
    "stragglers": list, "memory": dict, "faults": dict,
    "compile": dict, "health": dict, "flags": list,
}

#: keys ADDED by schema v2 — required only of v2+ documents, so v1
#: analysis.json files (PR-4-era run dirs) still validate cleanly
_SCHEMA_KEYS_V2 = {"numerics": dict, "outlier_table": list}

#: keys ADDED by schema v3 — required only of v3+ documents
_SCHEMA_KEYS_V3 = {"comm": dict}

#: keys ADDED by schema v4 — required only of v4+ documents
_SCHEMA_KEYS_V4 = {"slo": dict}

#: keys ADDED by schema v5 — required only of v5+ documents
_SCHEMA_KEYS_V5 = {"xtrace": dict}

#: keys ADDED by schema v6 — required only of v6+ documents
_SCHEMA_KEYS_V6 = {"fleet": dict}


def validate_analysis(analysis: Dict[str, Any]) -> None:
    """Raise ValueError describing every schema violation (an explicit
    raise, not an assert — this runs under CI gates)."""
    problems = []
    if not isinstance(analysis, dict):
        raise ValueError(f"analysis is {type(analysis).__name__}, "
                         "expected dict")
    required = dict(_SCHEMA_KEYS)
    if isinstance(analysis.get("schema_version"), int):
        if analysis["schema_version"] >= 2:
            required.update(_SCHEMA_KEYS_V2)
        if analysis["schema_version"] >= 3:
            required.update(_SCHEMA_KEYS_V3)
        if analysis["schema_version"] >= 4:
            required.update(_SCHEMA_KEYS_V4)
        if analysis["schema_version"] >= 5:
            required.update(_SCHEMA_KEYS_V5)
        if analysis["schema_version"] >= 6:
            required.update(_SCHEMA_KEYS_V6)
    for key, typ in required.items():
        if key not in analysis:
            problems.append(f"missing key {key!r}")
        elif not isinstance(analysis[key], typ):
            problems.append(
                f"key {key!r} is {type(analysis[key]).__name__}, "
                f"expected {typ.__name__}")
    if not problems and \
            analysis["schema_version"] > ANALYSIS_SCHEMA_VERSION:
        problems.append(
            f"schema_version {analysis['schema_version']} newer than "
            f"supported {ANALYSIS_SCHEMA_VERSION}")
    if not problems:
        try:
            json.dumps(analysis)
        except (TypeError, ValueError) as e:
            problems.append(f"not JSON-serializable: {e}")
    if problems:
        raise ValueError("invalid analysis: " + "; ".join(problems))


def write_analysis(analysis: Dict[str, Any], path: str) -> str:
    validate_analysis(analysis)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(analysis, f, indent=1)
    return path


def _maybe_json(path: Optional[str]) -> Optional[Dict[str, Any]]:
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def analyze_run_dir(run_dir: str, trace_dir: str = "",
                    write: bool = True,
                    fault_trace=None) -> List[Dict[str, Any]]:
    """Analyze every run recorded under ``run_dir`` (the
    ``<results_dir>/<dataset>`` directory holding ``*.obs.jsonl``
    streams and their sidecars). Returns one analysis per run; with
    ``write`` each is also written as ``<identity>.analysis.json``
    beside its stream. ``fault_trace`` is the fault replay seam."""
    if not os.path.isdir(run_dir):
        raise ValueError(f"not a directory: {run_dir}")
    from . import xtrace as obs_xtrace

    # the clock-aligned merged trace is per run DIR (one federation /
    # serving fleet), not per identity — every run under it shares it
    xtrace_doc = _maybe_json(
        os.path.join(run_dir, obs_xtrace.MERGED_TRACE_NAME))
    out = []
    for fname in sorted(os.listdir(run_dir)):
        if not fname.endswith(".obs.jsonl"):
            continue
        identity = fname[:-len(".obs.jsonl")]
        records = obs_export.read_jsonl(os.path.join(run_dir, fname))
        metrics = _maybe_json(
            os.path.join(run_dir, identity + ".metrics.json"))
        stat = _maybe_json(os.path.join(run_dir, identity + ".json"))
        trace_doc = None
        for td in filter(None, (trace_dir, run_dir)):
            trace_doc = _maybe_json(
                os.path.join(td, identity + ".trace.json"))
            if trace_doc is not None:
                break
        # obs/devtrace.py summary sidecar (written by the runner when
        # --obs_comm + --profile_dir were both set)
        devtrace = _maybe_json(
            os.path.join(run_dir, identity + ".devtrace.json"))
        # typed event stream (--slo_spec runs; obs/events.py) — torn
        # final line tolerated, keep-last dedupe by (round, type)
        events = None
        events_path = os.path.join(run_dir,
                                   identity + ".events.jsonl")
        if os.path.exists(events_path):
            events = obs_export.dedupe_events(obs_export.read_jsonl(
                events_path, allow_partial_tail=True))
        analysis = analyze_records(
            records, trace_doc=trace_doc, metrics=metrics,
            config=(stat or {}).get("config"), identity=identity,
            devtrace=devtrace, events=events, xtrace_doc=xtrace_doc,
            fault_trace=fault_trace)
        if write:
            analysis["analysis_path"] = write_analysis(
                analysis, os.path.join(run_dir,
                                       identity + ".analysis.json"))
        out.append(analysis)
    return out


def render_xtrace(xt: Dict[str, Any]) -> List[str]:
    """The human-readable side of the v5 xtrace section — shared by
    ``render_report`` and the ``obs xtrace`` CLI. Empty (no lines) for
    untraced runs."""
    if not xt.get("present"):
        return []
    lines = [
        "xtrace (clock-aligned causal trace): "
        + f"{len(xt.get('processes') or ())} lane(s): "
        + ", ".join(xt.get("processes") or ())]
    if xt.get("orphans"):
        lines.append(
            f"  WARNING {len(xt['orphans'])} orphan span(s) — "
            "causal tree not closed")
    for rd in (xt.get("rounds") or ())[:16]:
        bits = [f"{k} {v:.1f}" for k, v in rd["phases"].items()]
        lines.append(
            f"  {rd['trace']:<8} total {rd['total_ms']:8.1f} ms"
            + (" | " + " ".join(bits) if bits else "")
            + (f" | straggler {rd['straggler']}"
               if rd.get("straggler") else ""))
    if len(xt.get("rounds") or ()) > 16:
        lines.append(
            f"  ... {len(xt['rounds']) - 16} more timeline(s)")
    sc = xt.get("straggler_counts") or {}
    if sc:
        lines.append("  stragglers: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(
                sc.items(), key=lambda kv: -kv[1])))
    for m in xt.get("straggler_mismatches") or ():
        lines.append(
            f"  MISMATCH {m['trace']}: named {m['named']} but "
            "injected " + ", ".join(m["injected"]))
    pr = xt.get("probe") or {}
    if pr:
        fm, sm = pr.get("acc_fresh_mean"), pr.get("acc_stale_mean")
        lines.append(
            f"  staleness probe: {pr['n']} tick(s), staleness "
            f"{pr['staleness_s']['min']:.2f}-"
            f"{pr['staleness_s']['max']:.2f} s, acc last "
            f"{pr['acc']['last']:.3f}"
            + (f" (fresh-half mean {fm:.3f} vs stale-half "
               f"{sm:.3f})" if fm is not None and sm is not None
               else ""))
    return lines


def render_report(analysis: Dict[str, Any]) -> str:
    """The human-readable side of ``analysis.json``."""
    from .health import render_health

    a = analysis
    lines = [f"== telemetry analysis: {a['identity']} "
             f"(schema v{a['schema_version']}) =="]
    r = a["rounds"]
    lines.append(f"rounds: {r['count']} "
                 f"[{r['first']}..{r['last']}]"
                 + (f", missing {r['missing']}" if r["missing"] else "")
                 + (f", duplicates {r['duplicates']}"
                    if r["duplicates"] else ""))
    rt = a["round_time"]
    if rt.get("present"):
        lines.append(
            f"round time: median {rt['median_s'] * 1e3:.1f} ms, "
            f"mad {rt['mad_s'] * 1e3:.1f} ms, total {rt['total_s']:.2f} s"
            f" over {rt['rounds']} rounds")
    else:
        lines.append("round time: not recorded (pre-obs stream?)")
    if a["phases"]:
        lines.append("phase attribution (host spans vs round wall):")
        for name, p in sorted(a["phases"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            share = p.get("share_of_wall")
            lines.append(
                f"  {name:<16} {p['total_s'] * 1e3:9.1f} ms"
                + (f"  ({100 * share:5.1f}% of wall)"
                   if share is not None else ""))
        lines.append("  (in-graph phases local_train/guard/aggregate run "
                     "on the card: see the --profile_dir torch.profiler "
                     "trace, obs/devtrace.py)")
    for s in a["stragglers"]:
        lines.append(
            f"STRAGGLER round {s['round']}: source={s['source']}, "
            f"phase={s['phase'] or 'unattributed'}"
            + (f", clients={s['clients_straggled']:g}"
               if "clients_straggled" in s else ""))
    for o in a["outlier_rounds"]:
        lines.append(f"outlier round {o['round']}: {o['kind']} "
                     f"({o['deviation_sigmas']:+.1f} sigma, "
                     f"{o['round_time_s'] * 1e3:.1f} ms)")
    mem = a["memory"]
    if mem["present"]:
        for key, s in mem["series"].items():
            lines.append(
                f"memory[{key}]: {s['first_bytes'] / 1e6:.1f} -> "
                f"{s['last_bytes'] / 1e6:.1f} MB "
                f"({s['growth_pct']:+.2f}%, "
                f"slope {s['slope_bytes_per_round'] / 1e3:.1f} KB/round)"
                + ("  LEAK SUSPECTED" if s["leak_suspected"] else ""))
    f = a["faults"]
    if f["rounds_with_faults"]:
        lines.append(
            "faults: " + ", ".join(
                f"{k}={f[k]:g}" for k in FAULT_FIELDS if f.get(k)))
    if f.get("byzantine_sites"):
        lines.append(
            "byzantine sites (norm-screen flags): " + ", ".join(
                f"site {s} x{n}" for s, n in sorted(
                    f["byzantine_sites"].items(),
                    key=lambda kv: int(kv[0]))))
    n = a.get("numerics") or {}
    if n.get("present"):
        lines.append("numerics (in-jit telemetry):")
        un = n.get("update_norm") or {}
        if un:
            lines.append(
                f"  global update norm: last {un['last']:.4g}"
                + (f", peak {un['peak']:.4g}"
                   if un.get("peak") is not None else ""))
        for g, e in sorted((n.get("groups") or {}).items()):
            hb = e.get("headroom_bits_last")
            lines.append(
                f"  group {g:<14} maxabs {e['maxabs_last']:.4g}"
                + (f" (headroom {hb:.1f} bits)"
                   if hb is not None else "")
                + (f"  NONFINITE rounds {e['nonfinite_rounds']}"
                   if e["nonfinite_rounds"] else ""))
        m = n.get("mask") or {}
        if m:
            lines.append(
                f"  mask: churn last {m['churn_last']:.4g} "
                f"(max {m['churn_max']:.4g})"
                + (f", cross-client agreement {m['agree_last']:.4g}"
                   if m.get("agree_last") is not None else ""))
        for w in (n.get("warnings") or ())[:8]:
            lines.append(
                f"  WARNING round {w['round']}: group {w['group']} "
                f"maxabs {w['maxabs']:.4g}"
                + (f" ({w['headroom_bits']:.1f} bits of headroom)"
                   if w.get("headroom_bits") is not None else ""))
        for fa in n.get("fault_attribution") or ():
            who = (", ".join(f"client {c}" for c in fa["clients"])
                   or ", ".join(f"slot {j}" for j in fa["slots"])
                   or "unattributed")
            grp = ", ".join(fa["layer_groups"]) or "unattributed"
            lines.append(
                f"  FAULT round {fa['round']} "
                f"({'+'.join(fa['sources'])}): {who}; "
                f"layer group {grp}; "
                f"{fa['precursor_rounds']} round(s) of rising "
                "precursor gauge before it")
    table = a.get("outlier_table") or []
    if table:
        lines.append("outlier table (timing + numeric, ranked):")
        for e in table:
            bits = [f"round {e['round']}"]
            if e["clients"]:
                bits.append("clients " + ",".join(
                    str(c) for c in e["clients"]))
            if e["timing_sigmas"] is not None:
                bits.append(f"timing {e['timing_sigmas']:+.1f}σ")
            if e["drift_sigmas"] is not None:
                bits.append(f"drift {e['drift_sigmas']:+.1f}σ")
            if e["nonfinite"]:
                bits.append("NONFINITE drift")
            bits.append("[" + "+".join(e["sources"]) + "]")
            lines.append("  " + ", ".join(bits))
    cm = a.get("comm") or {}
    if cm.get("present"):
        lines.append("comm (wire-cost telemetry):")
        if cm.get("wire_bytes") is not None:
            lines.append(
                f"  active wire ({cm.get('impl') or 'dense'}): "
                f"{cm['wire_bytes'] / 1e6:.2f} MB/agg"
                + (f" at density {cm['density']:.3f}"
                   if isinstance(cm.get("density"), (int, float))
                   else "")
                + (f", {cm['n_devices']:g} device(s)"
                   if cm.get("n_devices") else ""))
        for e in cm.get("what_if") or ():
            lines.append(
                f"  what-if {e['impl']:<9} {e['bytes'] / 1e6:9.2f} MB"
                + (f"  ({e['vs_dense']:.2f}x dense)"
                   if e.get("vs_dense") is not None else ""))
        for g, b in sorted((cm.get("groups") or {}).items(),
                           key=lambda kv: -kv[1]):
            lines.append(f"  group {g:<16} {b / 1e6:9.2f} MB")
        ashare = cm.get("agg_share") or {}
        if ashare:
            lines.append(
                f"  probed agg: {cm['agg_ms']['median']:.2f} ms "
                f"({100 * ashare['median']:.1f}% of round median"
                + (f", {cm['probe_gbps']:.2f} GB/s effective over "
                   "the probe wall"
                   if cm.get("probe_gbps") is not None else "")
                + ")")
        dt = cm.get("devtrace") or {}
        if dt:
            lines.append(
                f"  devtrace: collective {dt['collective_s']:.3f} s of "
                f"{dt['busy_s']:.3f} s busy "
                f"({100 * (dt['agg_share'] or 0):.1f}% measured share, "
                f"{dt['devices']} device lane(s))"
                + (f", achieved {dt['achieved_gbps']:.2f} GB/s"
                   if dt.get("achieved_gbps") is not None else ""))
        meas = cm.get("measured") or {}
        if meas:
            lines.append("  measured messages: " + ", ".join(
                f"{k}={v:g}" for k, v in sorted(meas.items())
                if isinstance(v, (int, float))))
    sl = a.get("slo") or {}
    if sl.get("present"):
        hf = sl.get("health_final")
        lines.append("slo (online run-health):"
                     + (f" final {str(hf).upper()}" if hf else ""))
        for t in sl.get("transitions") or ():
            lines.append(
                f"  round {t['round']}: "
                f"{(t.get('from') or 'start').upper()} -> "
                f"{t['to'].upper()}")
        for o in (sl.get("objectives") or {}).values():
            comp = o.get("compliance")
            lines.append(
                f"  {o['name']:<40}"
                + (f" compliance {comp:.3f}," if comp is not None
                   else " not evaluated,")
                + f" budget spend {o['budget_spend']:.2f}"
                + ("  EXHAUSTED" if o.get("budget_exhausted") else ""))
        for b in sl.get("breaches") or ():
            who = ""
            inj = b.get("injected") or {}
            if inj:
                who = "; injected " + ", ".join(
                    f"{k} {v}" for k, v in sorted(inj.items()))
            lines.append(
                f"  BREACH round {b['round']} ({b['event_type']}"
                + (f" -> {b['to'].upper()}" if b.get("to") else "")
                + "): "
                + (", ".join(str(x) for x in b["objectives"])
                   or "run-level")
                + who)
        ev = sl.get("events") or {}
        if ev.get("total"):
            lines.append("  events: " + ", ".join(
                f"{k}={v}" for k, v in sorted(
                    (ev.get("by_type") or {}).items())))
    fl = a.get("fleet") or {}
    if fl.get("present"):
        head = "fleet (live heartbeat ledger):"
        if fl.get("sites_live_final") is not None:
            head += (f" live {fl['sites_live_final']:g} at end"
                     f" (min {fl['sites_live_min']:g}),"
                     f" max heartbeat age "
                     f"{fl['max_heartbeat_age_s']:.1f}s")
        lines.append(head)
        for d in fl.get("downs") or ():
            lines.append(f"  SITE_DOWN round {d['round']}: "
                         + ",".join(d["peers"]))
        for d in fl.get("recoveries") or ():
            lines.append(f"  SITE_RECOVERED round {d['round']}: "
                         + ",".join(d["peers"]))
    lines.extend(render_xtrace(a.get("xtrace") or {}))
    c = a["compile"]
    if c["present"]:
        lines.append(f"compile: {c['total_s']:.2f} s total"
                     + (", by entry: " + ", ".join(
                         f"{k}={v['total_s']:.2f}s"
                         for k, v in sorted(
                             c["by_entry"].items(),
                             key=lambda kv: -kv[1]["total_s"]))
                        if c["by_entry"] else ""))
        if c["cache"]:
            lines.append("compile cache: " + ", ".join(
                f"{k}={v:g}" for k, v in sorted(c["cache"].items())
                if isinstance(v, (int, float))))
    lines.append(render_health(a["health"]))
    lines.append("flags: " + (", ".join(a["flags"]) or "none"))
    return "\n".join(lines)
