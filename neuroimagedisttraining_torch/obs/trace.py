"""Hierarchical host-side span tracer with Chrome trace-event output
(counterpart of ``neuroimagedisttraining_tpu/obs/trace.py``).

Spans are host wall-clock intervals (``with span("sample"):``) collected
as Chrome trace-event JSON — loadable in Perfetto / ``chrome://tracing``
— and each span also enters ``torch.profiler.record_function`` and, on
a CUDA build, an NVTX range (rounds, :meth:`Tracer.step_span`, carry the
step number in the range's name) so that when a ``torch.profiler`` trace
is captured in the same region (``--profile_dir`` /
``utils.profiling.trace``), the host spans line up with the device
kernels in one view.

Disabled mode is a true no-op: the module-level tracer defaults to
:data:`NULL_TRACER`, whose ``span`` returns one shared singleton — no
string formatting, no dict churn, no timestamps on the hot path. Callers
therefore write ``with trace.span("name") as sp: ... sp.add(k, v)``
unconditionally; the whole construct costs two dynamic dispatches per
span when tracing is off.

Span timing caveat (CUDA's asynchronous launches): a host span around a
round measures the time to QUEUE its kernels unless the caller
synchronizes — which the round loop deliberately does not
(utils/records.DeferredRecords). Spans around fused blocks therefore wrap
the dispatch and the flush separately (whole-block attribution, never a
forced device sync inside the block). No span is opened inside a CUDA
graph capture: the fused round's graph body runs under none.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "NULL_TRACER", "NullSpan", "Tracer", "current_span_name",
    "get_tracer", "set_tracer", "span", "step_span", "tracing_enabled",
]


class NullSpan:
    """The shared disabled-mode span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, value: Any) -> None:
        """Per-span counter/attribute: dropped when tracing is off."""


_NULL_SPAN = NullSpan()


class NullTracer:
    """Disabled tracer: ``span`` hands back the shared :class:`NullSpan`
    without touching its arguments."""

    enabled = False

    def span(self, name: str, args: Optional[Dict[str, Any]] = None):
        return _NULL_SPAN

    def step_span(self, name: str, step: int):
        return _NULL_SPAN

    def current_span_name(self) -> str:
        return ""


NULL_TRACER = NullTracer()


class _Span:
    """One live span: a Chrome complete event ("ph": "X") in the making,
    mirrored into a profiler annotation for device-trace alignment."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_annotation")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]], annotation) -> None:
        self._tracer = tracer
        self._name = name
        self._args = args
        self._annotation = annotation
        self._t0 = 0

    def add(self, key: str, value: Any) -> None:
        """Attach a per-span counter/attribute (lands in the trace
        event's ``args``)."""
        if self._args is None:
            self._args = {}
        self._args[key] = value

    def __enter__(self) -> "_Span":
        if self._annotation is not None:
            self._annotation.__enter__()
        self._tracer._depth_push(self._name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        depth = self._tracer._depth_pop()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        self._tracer._emit(self._name, self._t0, dur_ns, depth, self._args)
        return False


class _Annotation:
    """A span's mirror on the profiler timelines: ``torch.profiler.
    record_function`` (a user annotation in a ``torch.profiler`` trace) and
    an NVTX range where torch was built with CUDA. Neither queues work on
    the card, and neither is entered inside a CUDA graph capture (no span
    is)."""

    __slots__ = ("_name", "_rf", "_nvtx")

    def __init__(self, name: str) -> None:
        self._name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self) -> "_Annotation":
        import torch

        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self._name)
            self._nvtx = True
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        self._rf.__exit__(*exc)
        return False


class Tracer:
    """Collects spans as Chrome trace events.

    ``annotate=True`` (default) also wraps each span in
    ``torch.profiler.record_function`` and an NVTX range (:class:`
    _Annotation`) so host spans appear on the device trace when one is
    being captured. ``max_events`` bounds memory on long runs — once
    full, new spans still time correctly but stop appending (the count
    of dropped events is recorded in the written file).
    """

    enabled = True

    def __init__(self, annotate: bool = True,
                 max_events: int = 200_000) -> None:
        self._events: List[Dict[str, Any]] = []
        self._max_events = int(max_events)
        self._dropped = 0
        self._annotate = annotate
        self._local = threading.local()
        self._pid = os.getpid()
        # one origin so event timestamps are small relative microseconds
        self._origin_ns = time.perf_counter_ns()

    # -- depth tracking (per thread) ------------------------------------
    # The open-span name stack doubles as the compile-attribution
    # context: obs/compile.py labels kernel builds and graph captures
    # with the innermost open span (the entry point being dispatched).
    def _depth_push(self, name: str = "") -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(name)

    def _depth_pop(self) -> int:
        stack = getattr(self._local, "stack", None)
        if stack:
            stack.pop()
        return len(stack or ())  # depth of the closed span (0 = top)

    def current_span_name(self) -> str:
        """Innermost OPEN span on this thread ('' outside any span)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else ""

    def _emit(self, name: str, t0_ns: int, dur_ns: int, depth: int,
              args: Optional[Dict[str, Any]]) -> None:
        if len(self._events) >= self._max_events:
            self._dropped += 1
            return
        ev: Dict[str, Any] = {
            "name": name, "ph": "X",
            "ts": (t0_ns - self._origin_ns) / 1e3,   # microseconds
            "dur": dur_ns / 1e3,
            "pid": self._pid, "tid": threading.get_ident(),
        }
        if depth or args:
            ev["args"] = dict(args or ())
            ev["args"]["depth"] = depth
        self._events.append(ev)

    # -- span construction ----------------------------------------------
    def span(self, name: str, args: Optional[Dict[str, Any]] = None):
        """Context manager timing a named host interval (nested spans
        stack by time containment in the viewer)."""
        annotation = _Annotation(name) if self._annotate else None
        return _Span(self, name, args, annotation)

    def step_span(self, name: str, step: int):
        """A round/step-level span: its annotation is named
        ``<name>#<step>``, which marks step boundaries on the device
        trace."""
        annotation = (_Annotation(f"{name}#{int(step)}") if self._annotate
                      else None)
        return _Span(self, name, {"step": int(step)}, annotation)

    # -- output ---------------------------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        return self._events

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        meta: Dict[str, Any] = {"displayTimeUnit": "ms"}
        if self._dropped:
            meta["obs_dropped_events"] = self._dropped
        return {"traceEvents": list(self._events), **meta}

    def write(self, path: str) -> str:
        """Write the trace to ``path`` (parent dirs created)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# -- module-level active tracer ----------------------------------------
# The hot-path entry points: library code calls ``trace.span(name)``
# unconditionally; with no tracer installed this is one global read +
# one method call returning the shared NullSpan.

_active: Any = NULL_TRACER


def set_tracer(tracer: Optional[Any]) -> None:
    """Install ``tracer`` as the process-wide active tracer (None
    restores the null tracer). The runner installs its per-run tracer at
    session start and restores on exit."""
    global _active
    _active = tracer if tracer is not None else NULL_TRACER


def get_tracer():
    return _active


def tracing_enabled() -> bool:
    return bool(getattr(_active, "enabled", False))


def span(name: str, args: Optional[Dict[str, Any]] = None):
    """``with trace.span("sample"): ...`` on whatever tracer is active."""
    return _active.span(name, args)


def step_span(name: str, step: int):
    """``with trace.step_span("round", r): ...`` — step-annotated span."""
    return _active.step_span(name, step)


def current_span_name() -> str:
    """Innermost open span name on the active tracer ('' when tracing is
    off or outside any span) — the compile-attribution context."""
    return _active.current_span_name()
