"""Round-granular recovery: the divergence watchdog and its rollback-retry
loop (counterpart of ``neuroimagedisttraining_tpu/robust/recovery.py``).

The guard catches non-finite updates inside the round; the watchdog, on the
host, judges each round's outcome (a finite train loss, optional loss and
global-update-norm thresholds):

1. a healthy round is adopted (OK);
2. an unhealthy one is not adopted: the round loop keeps the pre-round
   state, its last good one (a round never writes into its input state,
   so no copy is needed), and retries the round with a re-sampled cohort
   (``sample_client_indexes(..., retry=k)``), with a linear backoff;
3. a round still unhealthy after ``max_retries`` is skipped: the last-good
   state carries forward, and the skip is counted.

Verdicts are pure functions of the round's metrics, and the retry cohorts of
(round, retry), so a rerun replays the same retries and skips.

``train_loss`` is measured during round r's local training, against round
r-1's aggregate, so the loss checks flag a poisoned aggregate one round
late; ``norm_threshold`` judges the candidate aggregate itself.

When no in-memory last-good state exists (a rollback after the process
lost it), :meth:`RoundWatchdog.rollback` restores the newest checkpoint
(``ckpt_mgr``, shaped by ``template_fn()``), and with it the client store's
rows (``store``): the lineage holds only states the watchdog approved, so
the newest checkpoint is the last good state.

On a client mesh (``mesh``) every rank runs the loop and the watchdog: the
verdict is rank 0's health check, broadcast, so no rank retries, skips or
rolls back alone, and a checkpoint rollback goes through the manager's
mesh restore, so every rank restores the same step, each its block of the
rows (a client store's too: every rank reloads its block's rows from the
step's sidecar, after the round loop discarded every rank's staged rows).
A retry's cohort is the same on every rank, since every rank makes every
draw.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)

OK = "ok"
RETRY = "retry"
SKIP = "skip"


def _global_update_norm(new_state: Any, prev_state: Any) -> Optional[float]:
    """L2 norm of the global-model update, or None when the state has no
    ``global_params``."""
    new = getattr(new_state, "global_params", None)
    old = getattr(prev_state, "global_params", None)
    if new is None or old is None:
        return None
    sq = sum(torch.sum(torch.square(new[k] - old[k])) for k in new)
    return float(torch.sqrt(sq))


class RoundWatchdog:
    """Divergence watchdog with bounded rollback-retry.

    ``loss_threshold`` / ``norm_threshold`` of 0 disable the magnitude
    checks; a non-finite train loss (or update norm, with the norm check
    on) always trips. ``ckpt_mgr`` (a ``utils.checkpoint.
    CheckpointManager``), ``template_fn`` (a fresh ``algo.init_state``) and
    ``store`` (the algorithm's client store) back :meth:`rollback` when no
    in-memory state is left. ``mesh``: the client mesh whose ranks each
    run this watchdog (every rank then takes rank 0's verdict). ``sleep``
    is injectable for tests."""

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.0,
                 loss_threshold: float = 0.0, norm_threshold: float = 0.0,
                 ckpt_mgr=None,
                 template_fn: Optional[Callable[[], Any]] = None,
                 store=None,
                 sleep: Callable[[float], None] = time.sleep, mesh=None):
        self.mesh = mesh
        self.ckpt_mgr = ckpt_mgr
        self.template_fn = template_fn
        # a store-backed lineage: the checkpoint rollback reloads the
        # per-client rows with the state
        self.store = store
        self.max_retries = max(0, int(max_retries))
        self.backoff_s = float(backoff_s)
        self.loss_threshold = float(loss_threshold)
        self.norm_threshold = float(norm_threshold)
        self._sleep = sleep
        # cumulative run counters
        self.rounds_retried = 0
        self.rounds_skipped = 0
        # per-round retry state
        self._round: Optional[int] = None
        self._retries = 0

    def retries_at(self, round_idx: int) -> int:
        """Retry nonce of this attempt of ``round_idx`` (0 on the first
        attempt); reset when the round loop moves to a new round."""
        if round_idx != self._round:
            self._round = round_idx
            self._retries = 0
        return self._retries

    def healthy(self, record: Dict[str, Any], new_state: Any,
                prev_state: Any) -> bool:
        """Whether the round passes every enabled check; reads
        ``record['train_loss']`` (a wait on the card: the watchdog trades
        the deferred fetch for a verdict per round) and keeps it as a
        float."""
        loss = record.get("train_loss")
        if loss is not None:
            loss = float(loss)
            record["train_loss"] = loss
            if not math.isfinite(loss):
                return False
            if self.loss_threshold and loss > self.loss_threshold:
                return False
        if self.norm_threshold:
            norm = _global_update_norm(new_state, prev_state)
            if norm is not None and (
                    not math.isfinite(norm) or norm > self.norm_threshold):
                return False
        return True

    def judge(self, round_idx: int, record: Dict[str, Any], new_state: Any,
              prev_state: Any) -> str:
        """OK (adopt), RETRY (roll back, re-sample, re-run) or SKIP
        (retries exhausted: carry the last-good state). On a client mesh
        every rank returns rank 0's verdict."""
        self.retries_at(round_idx)
        healthy = self.healthy(record, new_state, prev_state)
        if self.mesh is not None:
            from ..parallel.mesh import broadcast_value

            healthy = bool(broadcast_value(self.mesh, float(healthy)))
        if healthy:
            return OK
        if self._retries < self.max_retries:
            self._retries += 1
            self.rounds_retried += 1
            logger.warning(
                "watchdog: round %d unhealthy (train_loss=%s); rolling "
                "back and retrying with a re-sampled cohort (%d/%d)",
                round_idx, record.get("train_loss"), self._retries,
                self.max_retries)
            if self.backoff_s:
                self._sleep(self.backoff_s * self._retries)
            return RETRY
        self.rounds_skipped += 1
        logger.error(
            "watchdog: round %d still unhealthy after %d retries; "
            "carrying the last-good state (round skipped)",
            round_idx, self.max_retries)
        return SKIP

    def rollback(self, prev_state: Any) -> Any:
        """The state to retry from: the pre-round (last-good) state the
        round loop still holds, or, given None, the newest checkpoint (with
        the store's rows), which holds the last state the watchdog
        approved."""
        if prev_state is not None:
            return prev_state
        if self.ckpt_mgr is None or self.template_fn is None:
            raise RuntimeError(
                "watchdog rollback: no in-memory last-good state and no "
                "checkpoint manager to restore from")
        restored = self.ckpt_mgr.restore_latest(self.template_fn(),
                                                store=self.store)
        if restored is None:
            raise RuntimeError(
                "watchdog rollback: checkpoint directory is empty")
        state, step = restored
        logger.warning("watchdog: rolled back to checkpoint step %d", step)
        return state

    def round_counters(self) -> Dict[str, float]:
        """Per-round record fields (floats)."""
        return {"rounds_retried": float(self._retries)}

    def totals(self) -> Dict[str, float]:
        return {"rounds_retried": float(self.rounds_retried),
                "rounds_skipped": float(self.rounds_skipped)}


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def tree_finite(tree: Any) -> bool:
    """Every floating tensor of ``tree`` (a tensor, a dict, list or tuple
    of them, or a state dataclass) all-finite, checked on the host."""
    return all(bool(torch.isfinite(x).all()) for x in _tensors(tree)
               if x.is_floating_point())
