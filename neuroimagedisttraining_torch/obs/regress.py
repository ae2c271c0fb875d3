"""Noise-aware cross-run performance regression detection (a copy of
``neuroimagedisttraining_tpu/obs/regress.py``: that module imports no
JAX).

* ``results/bench_torch_history.jsonl`` is the port's durable trajectory
  — one JSON line per bench result (metric, value, unit, git SHA,
  source). ``bench_torch.py`` appends to it on every run (and
  ``chip_smoke.py``'s ``offline`` phase writes a card history of its
  own). :func:`backfill_bench_files` and :func:`backfill_multichip_files`
  parse the JAX package's committed ``BENCH_r*.json`` /
  ``MULTICHIP_r*.json`` bench artifacts; those hold TPU-era numbers of
  the JAX package, so nothing in the port seeds its own history from
  them (``obs regress`` answers :data:`EXIT_NO_HISTORY` until the card
  has a history).
* :func:`detect_regression` compares a current value against the
  history's recent window with a median/MAD band: the allowed drop is
  ``max(rel_threshold * median, mad_k * 1.4826 * MAD)`` — a noisy
  metric earns a wider band, a rock-stable one a tight band, and a
  single hot or cold historical run cannot move the center the way it
  would move a mean.
* :func:`gate` is the CI entry (``python -m
  neuroimagedisttraining_torch.obs regress``): exit 0 on pass,
  :data:`EXIT_REGRESSION` on a significant regression,
  :data:`EXIT_NO_HISTORY` when there is not enough history to judge —
  distinct codes so a pipeline can treat "no baseline yet" as a
  soft-pass instead of a silent one.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "EXIT_NO_HISTORY", "EXIT_OK", "EXIT_REGRESSION",
    "METRIC_GATE_DEFAULTS", "MULTICHIP_METRICS", "append_history",
    "backfill_bench_files", "backfill_multichip_files",
    "detect_regression", "gate", "git_sha", "last_json_result",
    "metric_gate_defaults", "parse_multichip_artifact", "read_history",
]

EXIT_OK = 0
EXIT_REGRESSION = 1
EXIT_NO_HISTORY = 2

#: default relative drop tolerated before a regression verdict (the
#: committed BENCH trajectory's run-to-run spread is ~2-3%; 5% leaves
#: headroom without masking a real hit)
DEFAULT_REL_THRESHOLD = 0.05

#: robust-sigma multiplier for the noise-derived band
DEFAULT_MAD_K = 4.0

#: history entries (most recent) considered the comparison window
DEFAULT_WINDOW = 10

#: minimum history points before a verdict is attempted
MIN_HISTORY = 2


def git_sha(repo_root: Optional[str] = None) -> str:
    """Current commit SHA ('' when git is unavailable — history entries
    stay useful without it)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_root or None,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


def read_history(path: str,
                 metric: Optional[str] = None) -> List[Dict[str, Any]]:
    """History entries (optionally one metric's), oldest first. A
    missing file is an empty history, not an error — the gate's
    EXIT_NO_HISTORY covers the bootstrap case explicitly."""
    if not os.path.exists(path):
        return []
    from .export import read_jsonl

    entries = read_jsonl(path)
    if metric is not None:
        entries = [e for e in entries if e.get("metric") == metric]
    return entries


def append_history(path: str, result: Dict[str, Any],
                   source: str = "bench",
                   repo_root: Optional[str] = None,
                   **extra_fields: Any) -> Dict[str, Any]:
    """Append one bench result (the ``bench_torch.py`` JSON object) to the
    history stream; returns the entry written."""
    if not isinstance(result.get("value"), (int, float)):
        raise ValueError(
            f"bench result has no numeric 'value': {result!r}")
    entry = {
        "metric": result.get("metric", "unknown"),
        "value": float(result["value"]),
        "unit": result.get("unit", ""),
        "source": source,
        "git_sha": git_sha(repo_root),
        "ts": time.time(),
        **extra_fields,
    }
    if isinstance(result.get("extra"), dict):
        entry["extra"] = result["extra"]
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    return entry


def last_json_result(text: str,
                     required: tuple = ("metric", "value")
                     ) -> Optional[Dict[str, Any]]:
    """The LAST parseable JSON-object line in ``text`` carrying every
    ``required`` key — the one scanner behind both the BENCH_r*
    artifact tails and ``perf_gate --from-json`` (two hand-rolled
    copies would drift)."""
    result = None
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            cand = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(cand, dict) and all(k in cand for k in required):
            result = cand
    return result


def parse_bench_artifact(path: str) -> Optional[Dict[str, Any]]:
    """One committed ``BENCH_r*.json`` bench artifact -> the bench
    result JSON object its captured stdout tail holds (None when the
    run failed or printed no JSON line)."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("rc") not in (0, None):
        return None
    result = last_json_result(str(doc.get("tail", "")))
    if result is not None and isinstance(doc.get("n"), int):
        result = {**result, "bench_round": doc["n"]}
    return result


def backfill_bench_files(repo_root: str, history_path: str) -> int:
    """One-shot seed of the history from the repo's ``BENCH_r*.json``
    files. Idempotent: artifacts whose (metric, bench_round) already
    appear in the history are skipped. Returns entries appended."""
    import glob

    existing = {(e.get("metric"), e.get("bench_round"))
                for e in read_history(history_path)
                if e.get("bench_round") is not None}
    appended = 0
    for path in sorted(glob.glob(os.path.join(repo_root,
                                              "BENCH_r*.json"))):
        result = parse_bench_artifact(path)
        if result is None:
            continue
        key = (result.get("metric"), result.get("bench_round"))
        if key in existing:
            continue
        # bench_round carried on the entry keeps the backfill
        # idempotent; git_sha is deliberately blank — the artifact's
        # value was NOT measured at the current checkout, and gate()'s
        # own-commit exclusion must never drop the seeded baseline
        append_history(history_path, result,
                       source=os.path.basename(path),
                       repo_root=repo_root,
                       bench_round=result.get("bench_round"),
                       git_sha="")
        existing.add(key)
        appended += 1
    return appended


#: the scale-32 line a MULTICHIP_r*.json dry-run tail prints when the
#: probe ran: "... scale32: 32 clients on 8 devices, round 1819.6 ms,
#: train-only 803.9 ms, aggregation share 55.8%"
_SCALE32_RE = re.compile(
    r"scale32:.*?round ([0-9.]+) ms.*?aggregation share ([0-9.]+)%")

#: comm SLO metrics seeded from the committed MULTICHIP artifacts
MULTICHIP_METRICS = ("scale32_round_ms", "scale32_agg_ms",
                     "scale32_agg_share")

#: per-metric gate defaults. The comm SLO metrics are lower-is-better,
#: and their committed history is three points with one known slow-host
#: outlier (MULTICHIP_r04: round 3513 ms vs ~1.9 s on r03/r05), so a
#: MAD-derived band would be blown open by it — the comm gate uses a
#: pure 15% relative band on the median (mad_k=0) instead: wide enough
#: for the r03-vs-r05 run-to-run spread (~14%), tight enough that a
#: +20% agg_ms / +10pp agg_share regression fails. The ``agg_ms_``
#: prefix covers the scripts/bench_agg.py microbench metrics (same
#: lower-is-better orientation, default band).
METRIC_GATE_DEFAULTS: Dict[str, Dict[str, Any]] = {
    m: {"higher_is_better": False, "rel_threshold": 0.15, "mad_k": 0.0}
    for m in MULTICHIP_METRICS
}


def metric_gate_defaults(metric: str) -> Dict[str, Any]:
    """Gate parameter defaults for ``metric`` (empty dict = the generic
    higher-is-better bench defaults). scripts/perf_gate.py consults
    this for every flag the caller did not set explicitly.

    ``agg_ms_`` covers the scripts/bench_agg.py microbench timings
    (incl. the topk/hier impls and their per-kernel-backend
    ``agg_ms_<impl>-k<backend>_<tag>`` cells — prefix matching makes
    every backend's trajectory lower-is-better from its first append);
    ``agg_bytes_`` the modeled wire bytes
    recorded beside them — bytes are ANALYTIC (zero run-to-run noise),
    so any upward drift is a real model/impl change and the band is
    tight. ``cohort_mem_bytes_`` covers the BENCH_CONFIG=cohort sweep's
    peak-device-memory ledger (bench.py, obs/memory.py): lower is
    better, default band (the live-arrays fallback on backends without
    memory_stats carries some run-to-run spread); the sweep's
    ``cohort_rounds_per_sec_`` rates use the generic higher-is-better
    defaults. ``store_gather_ms_`` covers the sweep's client-store
    host->device gather timings (lower is better, default band —
    host-side timings carry run-to-run spread)."""
    if metric in METRIC_GATE_DEFAULTS:
        return dict(METRIC_GATE_DEFAULTS[metric])
    if metric.startswith("agg_ms_"):
        return {"higher_is_better": False}
    if metric.startswith("agg_bytes_"):
        return {"higher_is_better": False, "rel_threshold": 0.01,
                "mad_k": 0.0}
    if metric.startswith("cohort_mem_bytes_"):
        return {"higher_is_better": False}
    if metric.startswith("store_gather_ms_"):
        return {"higher_is_better": False}
    return {}


def parse_multichip_artifact(path: str) -> Optional[Dict[str, Any]]:
    """One committed ``MULTICHIP_r*.json`` bench artifact -> the comm
    SLO metric values its scale-32 probe line holds (None when the run
    failed, was skipped, or predates the probe — r01/r02). ``agg_ms``
    is derived as ``round_ms * share``: the two printed quantities the
    probe measures."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("rc") not in (0, None) or doc.get("skipped"):
        return None
    m = _SCALE32_RE.search(str(doc.get("tail", "")))
    if m is None:
        return None
    round_ms = float(m.group(1))
    share_pct = float(m.group(2))
    out: Dict[str, Any] = {
        "scale32_round_ms": round_ms,
        "scale32_agg_share": share_pct,
        "scale32_agg_ms": round_ms * share_pct / 100.0,
    }
    rm = re.search(r"r(\d+)", os.path.basename(path))
    if rm:
        out["bench_round"] = int(rm.group(1))
    return out


def backfill_multichip_files(repo_root: str, history_path: str) -> int:
    """One-shot seed of the comm SLO history from the repo's committed
    ``MULTICHIP_r*.json`` artifacts — the baseline scripts/perf_gate.py
    gates ``agg_ms`` / ``agg_share`` against (ROADMAP Open item 3's
    regression floor). Idempotent via (metric, bench_round); git_sha is
    blank like the bench backfill — seeded values were not measured at
    the current checkout, so the own-commit exclusion must never drop
    them. Returns entries appended."""
    import glob

    existing = {(e.get("metric"), e.get("bench_round"))
                for e in read_history(history_path)
                if e.get("bench_round") is not None}
    appended = 0
    for path in sorted(glob.glob(os.path.join(repo_root,
                                              "MULTICHIP_r*.json"))):
        parsed = parse_multichip_artifact(path)
        if parsed is None:
            continue
        rnd = parsed.pop("bench_round", None)
        for metric in MULTICHIP_METRICS:
            key = (metric, rnd)
            if key in existing or metric not in parsed:
                continue
            append_history(
                history_path,
                {"metric": metric, "value": parsed[metric],
                 "unit": "pct" if metric.endswith("share") else "ms"},
                source=os.path.basename(path), repo_root=repo_root,
                bench_round=rnd, git_sha="")
            existing.add(key)
            appended += 1
    return appended


def detect_regression(history_values: List[float], current: float,
                      rel_threshold: float = DEFAULT_REL_THRESHOLD,
                      mad_k: float = DEFAULT_MAD_K,
                      window: int = DEFAULT_WINDOW,
                      higher_is_better: bool = True) -> Dict[str, Any]:
    """Median/MAD verdict of ``current`` against the recent history.

    Returns a dict with ``regression`` (bool), ``baseline_median``,
    ``allowed_drop``, ``margin`` (how far current sits from the
    regression line; negative = regressed past it) and ``reason``.
    """
    if len(history_values) < MIN_HISTORY:
        return {"regression": False, "judged": False,
                "reason": f"history has {len(history_values)} points, "
                          f"need >= {MIN_HISTORY}"}
    from .metrics import mad as _mad, median as _median

    recent = [float(v) for v in history_values[-window:]]
    med = _median(recent)
    mad = _mad(recent, med)
    allowed = max(rel_threshold * abs(med), mad_k * 1.4826 * mad)
    drop = (med - current) if higher_is_better else (current - med)
    regression = drop > allowed
    return {
        "regression": regression, "judged": True,
        "baseline_median": med, "baseline_mad": mad,
        "baseline_window": len(recent), "current": float(current),
        "allowed_drop": allowed, "drop": drop,
        "margin": allowed - drop,
        "reason": (f"current {current:g} vs median {med:g}: drop "
                   f"{drop:g} {'exceeds' if regression else 'within'} "
                   f"allowed {allowed:g} (rel {rel_threshold:g}, "
                   f"mad_k {mad_k:g})"),
    }


def gate(history_path: str, metric: str, current: float,
         rel_threshold: float = DEFAULT_REL_THRESHOLD,
         mad_k: float = DEFAULT_MAD_K, window: int = DEFAULT_WINDOW,
         higher_is_better: bool = True,
         exclude_git_sha: str = "") -> Dict[str, Any]:
    """The CI verdict: compare ``current`` for ``metric`` against the
    recorded trajectory. The returned dict carries ``exit_code``
    (:data:`EXIT_OK` / :data:`EXIT_REGRESSION` /
    :data:`EXIT_NO_HISTORY`).

    ``exclude_git_sha`` drops history entries recorded at that commit
    from the baseline — ``bench_torch.py`` appends its result BEFORE the
    gate judges it, so without the exclusion a commit would be judged
    against its own (possibly regressed, possibly rerun-duplicated)
    measurements until they shifted the median. Pass the commit under
    test (``obs regress`` does)."""
    values = [e["value"] for e in read_history(history_path, metric)
              if isinstance(e.get("value"), (int, float))
              and not (exclude_git_sha
                       and e.get("git_sha") == exclude_git_sha)]
    verdict = detect_regression(
        values, current, rel_threshold=rel_threshold, mad_k=mad_k,
        window=window, higher_is_better=higher_is_better)
    verdict["metric"] = metric
    verdict["history_points"] = len(values)
    if not verdict["judged"]:
        verdict["exit_code"] = EXIT_NO_HISTORY
    else:
        verdict["exit_code"] = (EXIT_REGRESSION if verdict["regression"]
                                else EXIT_OK)
    return verdict
