"""One-round-deferred metric materialization (counterpart of
``neuroimagedisttraining_tpu/utils/records.py``).

Converting a device scalar to a Python float blocks the host until the card
has finished the work queued before it. Both round loops
(``FedAlgorithm.run`` and the CLI runner) therefore hold each round's record
as tensors and convert and log it only after the NEXT round's work is
queued: same values, same cadence, and the card's queue stays full.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def to_float(v):
    """0-d tensors and numpy arrays -> float; everything else (record keys
    like ``round`` stay ints, per-client vectors stay tensors) passes
    through untouched."""
    if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim == 0:
        return float(v)
    return v


class DeferredRecords:
    """Holds at most one pending record; ``push`` flushes the previous one.

    ``timed=True`` stamps ``round_time_s`` at flush boundaries (the time
    since the previous flush), so the sum over a run equals its wall time
    and each round's share is right to within one round. Call
    :meth:`flush_safely` on an exception path so a crash in round r still
    emits round r-1's metrics."""

    def __init__(self, log: Callable[[Dict[str, Any]], None],
                 timed: bool = False):
        self._log = log
        self._timed = timed
        self._pending: Optional[Dict[str, Any]] = None
        self._last_t = time.perf_counter()

    def push(self, record: Dict[str, Any]) -> None:
        self.flush()
        self._pending = record

    def flush(self) -> None:
        rec, self._pending = self._pending, None
        if rec is None:
            return
        for k, v in rec.items():
            rec[k] = to_float(v)
        if self._timed:
            t = time.perf_counter()
            rec["round_time_s"] = t - self._last_t
            self._last_t = t
        self._log(rec)

    def flush_safely(self) -> None:
        """``flush`` for exception paths: a fetch that dies with the device
        is swallowed so the original error propagates."""
        try:
            self.flush()
        except Exception:  # pragma: no cover - device-loss path
            self._pending = None


class RunCounters:
    """Run-level fault totals accumulated from per-round records, landing
    in ``stat_info["fault_recovery"]`` (beside the watchdog's own
    ``rounds_retried`` / ``rounds_skipped`` totals). The guarded round
    reports ``clients_dropped`` and ``clients_quarantined``; the round loops
    feed every record through :meth:`update`, the attempts a watchdog
    rolled back too. Without the guard no record carries them and the
    summary is empty."""

    FIELDS = ("clients_dropped", "clients_quarantined")

    def __init__(self, registry=None) -> None:
        """``registry`` (an ``obs.metrics.MetricsRegistry``) mirrors each
        accumulated field into a ``fault_<field>_total`` counter: the obs
        session's view of the totals."""
        self._totals: Dict[str, float] = {}
        self._registry = registry

    def update(self, record: Dict[str, Any]) -> None:
        for field in self.FIELDS:
            v = record.get(field)
            if v is not None:
                fv = float(to_float(v))
                self._totals[field] = self._totals.get(field, 0.0) + fv
                if self._registry is not None and fv:
                    self._registry.counter(
                        "fault_" + field + "_total").inc(fv)

    def summary(self) -> Dict[str, float]:
        return dict(self._totals)
