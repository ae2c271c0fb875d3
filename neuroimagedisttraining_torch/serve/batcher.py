"""Micro-batch coalescing: the request queue in front of the served
forward (counterpart of ``neuroimagedisttraining_tpu/serve/batcher.py``,
copied).

Open-loop traffic arrives one request at a time; the device wants
``[B]``-stacked work. The batcher closes a micro-batch when either
``max_batch`` requests are pending (a full slab) or ``linger_ms`` has
elapsed since the OLDEST pending request (the latency bound: a lone
request on an idle worker never waits longer than the linger). This is
the classic serving trade — linger higher for throughput, lower for
tail latency — and both knobs are ``--serve_*`` flags so the RESULTS
table can sweep them.

Thread contract: any number of producer threads ``submit()``; one
consumer thread (the worker's serve loop) calls ``next_batch()``.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional


class ServeRequest:
    """One inference request: which client's personal model, which of
    its samples, and when it entered the queue (the latency clock —
    queueing time is part of what ``serve_latency_ms`` measures)."""

    __slots__ = ("client_id", "sample_idx", "t_submit")

    def __init__(self, client_id: int, sample_idx: int,
                 t_submit: Optional[float] = None):
        self.client_id = int(client_id)
        self.sample_idx = int(sample_idx)
        self.t_submit = (time.perf_counter()
                         if t_submit is None else float(t_submit))


class MicroBatcher:
    def __init__(self, max_batch: int = 16, linger_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if linger_ms < 0:
            raise ValueError(f"linger_ms must be >= 0, got {linger_ms}")
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_ms) / 1e3
        self._q: Deque[ServeRequest] = collections.deque()
        self._cond = threading.Condition()
        self.submitted = 0

    def submit(self, req: ServeRequest) -> None:
        with self._cond:
            self._q.append(req)
            self.submitted += 1
            self._cond.notify()

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def wake(self) -> None:
        """Nudge a consumer parked in ``next_batch`` (the drain path:
        ``serve_finish`` arrives while the queue is empty — without the
        wake the loop only notices after its idle timeout)."""
        with self._cond:
            self._cond.notify_all()

    def next_batch(self, timeout_s: float = 0.1
                   ) -> Optional[List[ServeRequest]]:
        """Block up to ``timeout_s`` for the first pending request;
        then coalesce until the batch is full or the oldest request has
        lingered ``linger_ms``. ``None`` = nothing arrived (the serve
        loop's idle tick — it checks the drain condition and re-arms).
        """
        deadline = time.perf_counter() + float(timeout_s)
        with self._cond:
            while not self._q:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return None
                self._cond.wait(left)
            close_at = self._q[0].t_submit + self.linger_s
            while len(self._q) < self.max_batch:
                left = close_at - time.perf_counter()
                if left <= 0:
                    break
                self._cond.wait(left)
            batch = [self._q.popleft()
                     for _ in range(min(self.max_batch, len(self._q)))]
        return batch
