"""Observability subsystem: tracing, metrics registry, per-round telemetry
and their offline analysis (counterpart of
``neuroimagedisttraining_tpu/obs``).

* :mod:`~.trace` — hierarchical host-side span tracer emitting Chrome
  trace-event JSON, each span mirrored into ``torch.profiler.
  record_function`` and an NVTX range so host spans line up with the
  kernels of a ``torch.profiler`` capture. The module-level null tracer
  costs nothing when tracing is off.
* :mod:`~.metrics` — typed registry: counters, gauges, streaming
  distributions, labeled children behind a bounded-cardinality guard.
* :mod:`~.export` — sinks: per-round JSONL, end-of-run ``metrics.json``
  merged into ``stat_info``, optional TensorBoard scalars; every process
  records, only rank 0 exports.
* :mod:`~.memory` — the card's allocator watermark (``torch.cuda.
  memory_stats``) + host-RSS sampling at round boundaries.
* :mod:`~.compile` — the port's compile-time work: kernel builds and
  CUDA-graph captures, and the aggregation's counted FLOPs and bytes.
* :mod:`~.numerics` — training-dynamics telemetry computed in the round
  on its device tensors (``--obs_numerics``).
* :mod:`~.comm` — the analytical wire-cost model and the aggregation
  probe (``--obs_comm``).
* :mod:`~.devtrace` — ``torch.profiler`` trace attribution: collective
  (NCCL) vs compute kernel time.
* :mod:`~.health` — the per-site ledger and the fault-count replay, its
  fault draws through one seam (``fault_trace``).
* :mod:`~.analyze` — the offline analyzer (``python -m
  neuroimagedisttraining_torch.obs analyze <run_dir>``): per-phase
  round-time attribution, robust outlier/straggler detection, memory
  trends, faults, numerics, comm, SLO, fleet, xtrace and compile
  sections; versioned ``analysis.json`` + human report.
* :mod:`~.recorder` — the anomaly flight recorder (``--flight_recorder``).
* :mod:`~.slo` / :mod:`~.events` — the online SLO engine and its typed
  event bus (``--slo_spec``).
* :mod:`~.catalog` / :mod:`~.regress` — the run catalog (appended live,
  rebuilt from run dirs) and the bench history with its regression gate.
* :mod:`~.report` — the byte-deterministic static HTML fleet report
  (``obs report``).
* :mod:`~.xtrace` — cross-process causal tracing over ``Message`` headers
  for the federation (``--xtrace``).
* :mod:`~.live` — in-band heartbeats and the fleet ledger of the
  federation's aggregator (``--obs_heartbeat_every``).
* :mod:`~.prom` — the Prometheus ``/metrics`` exposition of a registry
  snapshot (``--obs_prom_port``: the federation's aggregator, the serving
  worker).
* :mod:`~.diff` — the cross-run diff engine and the bit-level parameter
  comparator (the serving plane's bit-identity gate).

``python -m neuroimagedisttraining_torch.obs`` (:mod:`~.__main__`) runs
the offline tier's nine subcommands: ``analyze``, ``tail``, ``slo``,
``regress``, ``ls``, ``diff``, ``report``, ``watch`` and ``xtrace``.

Nothing here enters run or checkpoint identity, and with ``--obs`` off
every hook is a no-op (bit-identical to the obs-off run).
"""
from . import (
    analyze,
    catalog,
    comm,
    compile,
    devtrace,
    diff,
    events,
    export,
    health,
    live,
    memory,
    metrics,
    numerics,
    prom,
    recorder,
    regress,
    report,
    slo,
    trace,
    xtrace,
)

__all__ = ["analyze", "catalog", "comm", "compile", "devtrace", "diff",
           "events", "export", "health", "live", "memory", "metrics",
           "numerics", "prom", "recorder", "regress", "report", "slo",
           "trace", "xtrace"]
