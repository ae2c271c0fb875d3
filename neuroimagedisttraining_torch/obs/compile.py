"""Compile-time observability: where the first-round seconds went
(counterpart of ``neuroimagedisttraining_tpu/obs/compile.py``).

The JAX package listens to ``jax.monitoring``'s compile events. The
port's compile-time work is its own, and each piece reports here through
:func:`note_compile`:

* ``kernel_build`` — ``ops.kernels.build``: the hand kernels compiled by
  ``nvcc`` (one process a source) and loaded; ``count`` is how many were
  compiled (0 when every library was already built and only loaded);
* ``graph_capture`` — ``algorithms.base._Graph``: a round's or an eval's
  warm-up runs and its capture as a chain of CUDA graphs
  (``core.capture.SegmentedGraph``); ``nodes`` is the chain's node count.

:class:`CompileWatch` feeds the registry while a session lives:
per-kind wall-time distributions (``compile_kernel_build_s``,
``compile_graph_capture_s``) labeled by the innermost open obs span at
that moment (``obs.trace.current_span_name()``: the entry point being
dispatched, ``dispatch_round``, ``fused_block_dispatch``, ``snip_mask``,
...), a ``compile_graph_nodes`` distribution and ``compile_events_total``.
With no session nothing listens, and :func:`note_compile` returns at
once.

:func:`agg_cost_analysis` is the counterpart of ``jit_cost_analysis``
for the one program the devtrace fallback prices, the aggregation: its
FLOPs and bytes counted from the stacked cohort's shapes, as the weighted
sum's bound is counted (each input read once, the output written once,
a multiply and an add per client and coordinate).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

from . import metrics as obs_metrics, trace as obs_trace

logger = logging.getLogger(__name__)

__all__ = ["COMPILE_KINDS", "CompileWatch", "agg_cost_analysis",
           "note_compile"]

#: compile-event kinds -> registry distribution names
COMPILE_KINDS = {
    "kernel_build": "compile_kernel_build_s",
    "graph_capture": "compile_graph_capture_s",
}

_LISTENERS: List[Callable[..., None]] = []


def note_compile(kind: str, seconds: float, **info: Any) -> None:
    """Report one compile event to the live watches (none: a no-op)."""
    for fn in list(_LISTENERS):
        fn(kind, seconds, **info)


class CompileWatch:
    """Listens to :func:`note_compile` and feeds ``registry``.
    ``install``/``uninstall`` are idempotent."""

    def __init__(self, registry: "obs_metrics.MetricsRegistry"):
        self._registry = registry
        self._installed = False

    def _on_compile(self, kind: str, seconds: float,
                    nodes: Optional[int] = None, **info: Any) -> None:
        name = COMPILE_KINDS.get(kind)
        if name is None:
            return
        try:
            entry = obs_trace.current_span_name() or "untraced"
            d = self._registry.distribution(name)
            d.observe(seconds)
            d.labels(entry=entry).observe(seconds)
            self._registry.counter("compile_events_total").inc()
            if nodes is not None:
                g = self._registry.distribution("compile_graph_nodes")
                g.observe(float(nodes))
                g.labels(entry=entry).observe(float(nodes))
            if info.get("count"):
                self._registry.counter("compile_kernels_built").inc(
                    float(info["count"]))
        except Exception:
            # telemetry never kills the run: log and drop
            logger.debug("compile-event recording failed", exc_info=True)

    def install(self) -> "CompileWatch":
        if not self._installed:
            _LISTENERS.append(self._on_compile)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            _LISTENERS.remove(self._on_compile)
            self._installed = False

    def summarize(self) -> Dict[str, float]:
        """Fold the per-kind distributions into end-of-run gauges
        (``compile_total_s``, ``compile_count``)."""
        total = 0.0
        count = 0
        for name in COMPILE_KINDS.values():
            if name in self._registry:
                d = self._registry.distribution(name)
                total += d.sum
                count += d.count
        self._registry.gauge("compile_total_s").set(total)
        self._registry.gauge("compile_count").set(float(count))
        return {"compile_total_s": total, "compile_count": float(count)}


def agg_cost_analysis(stacked: Dict[str, Any], weights: Any,
                      registry=None, entry: str = "aggregate"
                      ) -> Dict[str, Any]:
    """``{compile_s, flops, bytes_accessed}`` of one weighted mean of
    ``stacked`` (``[C, ...]`` per leaf) by ``weights`` (``[C]``), counted
    from the shapes: ``2 C n`` FLOPs; ``C n`` input elements at their
    itemsize, ``n`` float32 outputs and the ``C`` float32 weights. There
    is nothing to compile (the kernels are built ahead), so ``compile_s``
    is 0. With ``registry`` the numbers also land as gauges labeled
    ``entry`` (``compile_aot_flops`` / ``compile_aot_bytes``)."""
    c = int(weights.shape[0])
    flops = 0.0
    nbytes = 4.0 * c
    for v in stacked.values():
        n = v.numel() // max(c, 1)
        flops += 2.0 * c * n
        nbytes += float(c * n * v.element_size()) + 4.0 * n
    out = {"compile_s": 0.0, "flops": flops, "bytes_accessed": nbytes}
    if registry is not None and entry:
        registry.gauge("compile_aot_flops").labels(entry=entry).set(flops)
        registry.gauge("compile_aot_bytes").labels(entry=entry).set(nbytes)
    return out
