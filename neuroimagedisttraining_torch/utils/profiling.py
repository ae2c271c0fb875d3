"""Runtime profiling hooks (counterpart of
``neuroimagedisttraining_tpu/utils/profiling.py``).

Wraps ``torch.profiler`` so any federated round can be captured as a
Chrome trace (host ops, the obs spans' ``record_function`` annotations
and, on the card, every kernel through CUPTI), viewable in Perfetto and
read back by ``obs.devtrace``. Host-side span tracing lives in
``obs.trace``.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)

__all__ = ["start_trace", "stop_trace", "trace", "trace_one_round"]


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace():
    """A started ``torch.profiler.profile`` (the CPU, and CUDA where there
    is a card)."""
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    return prof


def stop_trace(prof, log_dir: str, name: str = "trace",
               export: bool = True) -> str:
    """Stop ``prof`` (after the card has finished what it queued) and,
    with ``export``, write its Chrome trace to
    ``<log_dir>/<name>.pt.trace.json``; returns that path ('' without
    ``export``)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    if not export:
        return ""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace", export: bool = True):
    """``with trace("/tmp/prof"):`` — captures a host/device trace into
    ``log_dir`` (``export=False``: captured, not written — a client
    mesh's other ranks)."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, name, export)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def trace_one_round(algo, state, log_dir: str, round_idx: int = 0,
                    export: bool = True) -> float:
    """Profile a single federated round, eager (a fused block's replayed
    graph shows its kernels less reliably to CUPTI), after one warm-up
    round, so the trace shows steady-state device time. Returns the
    profiled round's milliseconds: CUDA events around it on the card, the
    host clock on the CPU.

    The caller's state is never written: the warm-up runs on a clone of
    it (``run_round`` leaves its input as it was anyway), and a client
    store's staged rows of both rounds are discarded. On a client mesh
    every rank calls it (the rounds' collectives need them all);
    ``export`` False on all but one rank."""
    state = algo.clone_state(state)
    try:
        state2, _ = algo.run_round(state, round_idx)
        dev = algo.device
        _sync(dev)
        cuda = torch.device(dev).type == "cuda"
        with trace(log_dir, export=export):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            state3, _ = algo.run_round(state2, round_idx + 1)
            if cuda:
                end.record()
            _sync(dev)
            ms = (start.elapsed_time(end) if cuda
                  else (time.perf_counter() - t0) * 1e3)
    finally:
        algo.store_discard()
    if export:
        logger.info("wrote profiler trace for one round to %s", log_dir)
    return ms
