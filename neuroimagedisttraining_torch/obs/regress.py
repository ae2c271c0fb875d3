"""The bench history and its noise-aware regression verdict (the part of
``neuroimagedisttraining_tpu/obs/regress.py`` the port needs, copied: that
module imports no JAX).

* :func:`append_history` appends one bench result (metric, value, unit,
  git SHA, source) to a JSONL trajectory: ``bench_torch.py`` writes
  ``results/bench_torch_history.jsonl``.
* :func:`detect_regression` compares a current value against the
  history's recent window with a median/MAD band: the allowed drop is
  ``max(rel_threshold * median, mad_k * 1.4826 * MAD)`` — a noisy
  metric earns a wider band, a rock-stable one a tight band, and a
  single hot or cold historical run cannot move the center the way it
  would move a mean.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

__all__ = ["append_history", "detect_regression", "git_sha",
           "read_history"]

#: default relative drop tolerated before a regression verdict
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
    missing file is an empty history, not an error."""
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
    """Append one bench result (the one-line JSON object of
    ``bench_torch.py``) to the history stream; returns the entry
    written."""
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

