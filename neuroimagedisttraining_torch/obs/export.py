"""Telemetry sinks: per-round JSONL, end-of-run metrics.json, TensorBoard
(counterpart of ``neuroimagedisttraining_tpu/obs/export.py``).

* :class:`RoundLogWriter` — one JSON line per round under the run dir
  (timings, losses, fault-recovery counters, agg wire stats — whatever
  the round record carries). Multihost rule mirrors the checkpoint
  lineage rules: EVERY process records (registry, tracer), only
  process 0 exports files (on a client mesh the ``torch.distributed``
  rank 0); per-host streams (explicitly host-tagged
  paths) fold into one timeline with :func:`merge_host_jsonl`.
* :func:`write_metrics_json` — the registry snapshot as ``metrics.json``
  (the runner also merges it into ``save_stat_info``'s JSON).
* :func:`maybe_tensorboard_writer` — optional TB scalar export, gated on
  an importable writer (no hard dependency; returns None when absent).
* :class:`ObsSession` — the runner's per-run faceplate tying registry +
  tracer + memory sampler + sinks together behind one
  ``record_round``/``finish``/``close`` lifecycle.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

from . import metrics as obs_metrics, trace as obs_trace
from .memory import MemoryWatermark

logger = logging.getLogger(__name__)

__all__ = [
    "OBS_SCHEMA_VERSION", "ObsSession", "RoundLogWriter",
    "SUPPORTED_OBS_SCHEMAS", "dedupe_events", "dedupe_rounds",
    "maybe_tensorboard_writer", "merge_host_events",
    "merge_host_jsonl", "record_schema", "write_metrics_json",
]

#: version of the per-round JSONL record schema (stamped on every
#: exported line; obs/analyze.py refuses records from a NEWER schema
#: than it understands instead of misreading them).
#: v2 adds the flat in-jit numerics keys (``num_*`` — obs/numerics.py:
#: per-layer-group update/grad norms and max-abs precursor gauges,
#: per-slot client drift/cosine, mask churn/agreement). v3 adds the
#: communication-telemetry keys (``comm_*`` — obs/comm.py: modeled
#: wire bytes per agg_impl and per leaf group, live mask density, the
#: probed agg time/share). v4 adds the online-SLO keys (``slo_*`` —
#: obs/slo.py: the run-health state stamped on every line, the
#: currently-breached objective count, the round's top event) plus the
#: sibling ``<identity>.events.jsonl`` stream (obs/events.py). Older
#: streams carry none of them and still read/analyze cleanly — every
#: reader treats the keys as optional.
OBS_SCHEMA_VERSION = 4

#: every schema this module's readers (and obs/analyze.py) accept
SUPPORTED_OBS_SCHEMAS = (1, 2, 3, 4)


def record_schema(record: Dict[str, Any]) -> int:
    """The LOWEST schema a record actually requires: v4 only when it
    carries slo keys, v3 when comm keys, v2 when (only) numerics keys.
    A plain line is stamped 1 so older analyzers (which refuse schemas
    newer than they understand) keep reading the streams they can read
    perfectly — the v2/v3/v4 keys are purely additive."""
    if any(k.startswith("slo_") for k in record):
        return 4
    if any(k.startswith("comm_") for k in record):
        return 3
    return 2 if any(k.startswith("num_") for k in record) else 1


def _process_index() -> int:
    """Rank for the only-process-0-exports rule: the ``torch.distributed``
    rank of a client mesh's process group, 0 when none is initialized
    (patchable in tests)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # pragma: no cover - pre-init edge
        pass
    return 0


def _json_default(v: Any) -> Any:
    """Round records may still carry numpy scalars (DeferredRecords
    materializes floats, but fused/eval extras can be np types)."""
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray) and v.ndim == 0:
            return v.item()
    except ImportError:  # pragma: no cover
        pass
    return str(v)


def _json_safe_value(v: Any) -> Any:
    """Obs-extra enrichment values -> JSON-native (1-d arrays and tensors
    become float lists; scalars become floats; everything else passes
    through to the writer's default handler)."""
    if hasattr(v, "detach"):  # a tensor: read at the flush point
        v = v.detach().cpu().numpy()
    try:
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
        arr = np.asarray(v)
        if arr.ndim == 1 and arr.dtype.kind in "fiu":
            return [float(x) for x in arr]
    except Exception:  # non-array extras (strings, dicts)
        pass
    return v


class RoundLogWriter:
    """Append-mode JSONL sink, flushed per line so a crashed run keeps
    every completed round — and a ``--resume``d run continues its own
    stream (a FRESH rerun under the same identity appends too; remove
    the file, or tag the run, for a clean stream). Opens lazily on the
    first write; does nothing on non-zero processes unless ``force``
    (the host-tagged multi-stream mode merge_host_jsonl exists for)."""

    def __init__(self, path: str, force: bool = False):
        self.path = path
        self._force = force
        self._fh = None
        self._exports = force or _process_index() == 0
        self.lines = 0

    @property
    def exports(self) -> bool:
        return self._exports

    def write(self, record: Dict[str, Any]) -> None:
        if not self._exports:
            return
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(record, default=_json_default) + "\n")
        self._fh.flush()
        self.lines += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str,
               allow_partial_tail: bool = False) -> List[Dict[str, Any]]:
    """Parse one JSONL stream; a malformed line raises with its number
    (a telemetry file that silently drops rounds is worse than none).

    ``allow_partial_tail`` tolerates exactly ONE malformed line — the
    file's LAST non-empty one — by dropping it: a run killed mid-write
    leaves a torn final line on its events stream, and the fold over a
    crashed run's streams must read every completed event rather than
    refuse the file. A malformed line anywhere earlier still raises."""
    out = []
    bad: Optional[ValueError] = None
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            if bad is not None:
                raise bad  # the malformed line was NOT the tail
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                err = ValueError(
                    f"{path}:{i + 1}: malformed JSONL line: {e}")
                err.__cause__ = e
                if not allow_partial_tail:
                    raise err
                bad = err  # torn tail: drop iff nothing follows
    return out


def dedupe_rounds(records: List[Dict[str, Any]],
                  key: str = "round") -> List[Dict[str, Any]]:
    """Deterministic timeline repair for one stream: keep the LAST
    record per round index (an interrupted run that was rerun under the
    same identity APPENDS — the later attempt's record supersedes the
    orphaned one), then sort by round. Records without the key (e.g. a
    stream-level header) are dropped — they are not rounds. The
    round=-1 final record sorts first and survives as its own key."""
    last: Dict[Any, Dict[str, Any]] = {}
    for rec in records:
        r = rec.get(key)
        if r is None:
            continue
        last[r] = rec
    return [last[r] for r in sorted(last)]


def merge_host_jsonl(paths: List[str],
                     dedupe: bool = True) -> List[Dict[str, Any]]:
    """Fold per-host round streams into one timeline: records gain a
    ``host`` field (their stream's position in ``paths``) and sort by
    ``(round, host)`` — a stable global view of a multi-process run.

    Hardened against the timelines real runs produce: an empty (or
    all-blank) stream contributes nothing; out-of-order records sort
    deterministically; with ``dedupe`` (default) duplicate rounds
    WITHIN one host's stream keep the last occurrence (the rerun-
    appends semantics of :class:`RoundLogWriter`) — the same round on
    DIFFERENT hosts is not a duplicate, it is the multihost fold."""
    merged: List[Dict[str, Any]] = []
    for host, p in enumerate(paths):
        recs = read_jsonl(p)
        if dedupe:
            recs = dedupe_rounds(recs)
        for rec in recs:
            rec = dict(rec)
            rec.setdefault("host", host)
            merged.append(rec)
    merged.sort(key=lambda r: (r.get("round", -1), r.get("host", 0)))
    return merged


def dedupe_events(records: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Deterministic timeline repair for one EVENTS stream: keep the
    LAST record per ``(round, event_type)`` (the emission contract is
    at most one event per type per round, so a kill+resume rerun's
    re-emitted duplicates supersede the originals — which are
    bit-identical anyway, the determinism contract), sorted by
    ``(round, event_type)``. Records missing either key are dropped —
    they are not events."""
    from .events import event_key

    last: Dict[Any, Dict[str, Any]] = {}
    for rec in records:
        k = event_key(rec)
        if k[0] is None or k[1] is None:
            continue
        last[k] = rec
    return [last[k] for k in sorted(
        last, key=lambda k: (k[0], str(k[1])))]


def merge_host_events(paths: List[str],
                      dedupe: bool = True) -> List[Dict[str, Any]]:
    """The per-host fold for ``<identity>.events.jsonl`` streams: the
    ``merge_host_jsonl`` semantics with the EVENTS dedupe key
    (keep-last by ``(round, event_type)`` within one host) and a torn
    final line tolerated per stream (a killed run's last write). An
    empty (or all-blank) stream contributes nothing; the same
    ``(round, type)`` on DIFFERENT hosts is not a duplicate — it is
    the multihost fold."""
    merged: List[Dict[str, Any]] = []
    for host, p in enumerate(paths):
        recs = read_jsonl(p, allow_partial_tail=True)
        if dedupe:
            recs = dedupe_events(recs)
        for rec in recs:
            rec = dict(rec)
            rec.setdefault("host", host)
            merged.append(rec)
    merged.sort(key=lambda r: (r.get("round", -1), r.get("host", 0),
                               str(r.get("event_type", ""))))
    return merged


def write_metrics_json(registry: "obs_metrics.MetricsRegistry",
                       path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=1,
                  default=_json_default)
    return path


def maybe_tensorboard_writer(log_dir: str):
    """A TensorBoard SummaryWriter when one is importable
    (tensorboardX, or ``torch.utils.tensorboard``, which needs the
    tensorboard package), else None — TB export is optional, never a
    dependency."""
    try:
        from tensorboardX import SummaryWriter  # type: ignore

        return SummaryWriter(log_dir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:
        return None


class ObsSession:
    """Per-run telemetry lifecycle for the experiment runner.

    Owns a fresh registry (per-run metrics never mix across sequential
    runs in one process), a :class:`~.trace.Tracer` installed as the
    module-active tracer (so library spans flow), a round-boundary
    memory sampler, and the sinks. ``record_round`` is called from the
    runner's deferred-record emit hook — i.e. at the flush point where
    the record's device scalars are already materialized, so the JSONL
    write forces no extra device sync.

    None of this exists unless ``--obs`` is on; the off path never
    constructs a session (bit-identical pre-obs behavior, held by
    ``tests/test_torch_port_obs.py`` and ``chip_smoke.py``'s ``obs``
    phase). ``comm`` turns on the wire-cost metrics
    (:meth:`set_comm_metrics`); the port has no message transport, so
    there are no serialized-size counters.
    """

    def __init__(self, jsonl_path: str = "", trace_dir: str = "",
                 identity: str = "run", sample_every: int = 1,
                 tb_dir: str = "", comm: bool = False, slo=None,
                 events_path: str = "",
                 catalog_path: str = "",
                 catalog_info: Optional[Dict[str, Any]] = None):
        self.identity = identity
        self.registry = obs_metrics.MetricsRegistry()
        self.registry.gauge("obs_schema_version").set(OBS_SCHEMA_VERSION)
        # comm telemetry (--obs_comm): the wire-cost model's static
        # round metrics (set_comm_metrics) joined onto every JSONL line
        self.comm = bool(comm)
        self._comm_metrics: Optional[Dict[str, Any]] = None
        self.tracer = obs_trace.Tracer()
        self._prev_tracer = obs_trace.get_tracer()
        obs_trace.set_tracer(self.tracer)
        self.exports = _process_index() == 0
        self.jsonl_path = jsonl_path
        self.writer = RoundLogWriter(jsonl_path) if jsonl_path else None
        self.trace_dir = trace_dir
        self.memory = MemoryWatermark(self.registry,
                                      sample_every=sample_every)
        # compile-time observability (obs/compile.py): the kernel build
        # and graph-capture hooks live only while a session does, so
        # obs-off runs never touch them
        from .compile import CompileWatch

        self.compile_watch = CompileWatch(self.registry).install()
        self._tb = maybe_tensorboard_writer(tb_dir) if tb_dir else None
        self.metrics_json_path: Optional[str] = None
        self.trace_path: Optional[str] = None
        # online SLO engine (obs/slo.py) + typed event bus
        # (obs/events.py): constructed only when --slo_spec is set, so
        # slo-off sessions produce byte-identical artifacts to HEAD (no
        # slo_* keys, no events stream)
        self.slo = slo
        self.events_path = events_path or (
            jsonl_path[:-len(".obs.jsonl")] + ".events.jsonl"
            if slo is not None and jsonl_path.endswith(".obs.jsonl")
            else "")
        self.event_bus = None
        self.event_writer: Optional[RoundLogWriter] = None
        if slo is not None:
            from .events import EventBus

            self.event_bus = EventBus()
            if self.events_path:
                self.event_writer = RoundLogWriter(self.events_path)
                self.event_bus.subscribe(
                    lambda ev: self.event_writer.write(ev.to_record()))

            def _count_event(ev, _reg=self.registry) -> None:
                c = _reg.counter("slo_events_total")
                c.inc()
                c.labels(type=ev.type).inc()

            self.event_bus.subscribe(_count_event)
        # fleet catalog (--obs_catalog, obs/catalog.py): one entry
        # appended at close — on the CLOSE path, not finish, so a
        # crashed run still catalogs (with completed=False)
        self.catalog_path = catalog_path
        self._catalog_info: Dict[str, Any] = dict(catalog_info or {})
        self._final_metrics: Dict[str, float] = {}
        self._rounds_recorded = 0
        self._finished = False
        self._closed = False

    def set_catalog_info(self, **info: Any) -> None:
        """Late-bound catalog-entry fields (``config``,
        ``checkpoint_identity``, ``git_sha``, ``stat_json``) — the
        runner knows some of them only after session construction."""
        self._catalog_info.update(info)

    # -- comm telemetry --------------------------------------------------
    def set_comm_metrics(self, metrics: Dict[str, Any]) -> None:
        """Install the wire-cost model's static ``comm_*`` round
        metrics (obs/comm.py ``WireCostModel.round_metrics()``, plus
        the runner's ``comm_agg_ms`` probe). They join every exported
        round line — static per run, so the per-round cost is zero —
        and land as registry gauges for the metrics.json view."""
        self._comm_metrics = dict(metrics)
        for k, v in self._comm_metrics.items():
            if isinstance(v, (int, float)):
                self.registry.gauge(k).set(float(v))

    # -- per-round hook --------------------------------------------------
    def record_round(self, record: Dict[str, Any],
                     extra: Optional[Dict[str, Any]] = None) -> None:
        """Record one round's (already materialized) record: JSONL line,
        loss/time distributions, memory watermark sample.

        ``extra`` is obs-ONLY enrichment (per-site eval vectors, the
        runner's fault-trace stamps): it joins the exported JSONL line
        but never mutates ``record`` itself — the caller's history (and
        with it the obs-off record shape) stays untouched."""
        r = record.get("round")
        reg = self.registry
        reg.counter("rounds_recorded").inc()
        if isinstance(r, int) and r >= 0:
            self._rounds_recorded += 1
        if self.catalog_path:
            # the catalog entry's final-metrics snapshot: last-seen
            # fold, the same fold catalog.entry_from_run rebuilds
            from .catalog import FINAL_METRIC_KEYS

            for k in FINAL_METRIC_KEYS:
                v = record.get(k)
                if isinstance(v, (int, float)) and \
                        not isinstance(v, bool):
                    self._final_metrics[k] = float(v)
        for key in ("train_loss", "round_time_s", "global_loss",
                    "personal_loss"):
            v = record.get(key)
            if v is not None and isinstance(v, (int, float)):
                reg.distribution(key).observe(v)
        # fault counters are deliberately NOT re-counted here: per-round
        # values live on each JSONL line, and the registry totals come
        # from the RunCounters mirror (fault_<field>_total, which also
        # sees watchdog-discarded attempts) plus the runner's end-of-run
        # fault_recovery_* gauges (the stat_info-authoritative block)
        mem_sample = None
        if isinstance(r, int):
            mem_sample = self.memory.maybe_sample(r)
        if self.writer is not None:
            out = dict(record)
            if mem_sample:
                # per-round memory series: what obs/analyze.py's leak
                # detector trends over (gauges are last-value-wins)
                out.update(mem_sample)
            for k, v in (extra or {}).items():
                out[k] = _json_safe_value(v)
            if self._comm_metrics is not None and isinstance(r, int) \
                    and r >= 0:
                # comm telemetry: the static wire-model metrics join
                # every round line, and the probed agg time turns the
                # line's own wall time into a per-round agg share
                out.update(self._comm_metrics)
                agg_ms = self._comm_metrics.get("comm_agg_ms")
                rt = record.get("round_time_s")
                if isinstance(agg_ms, (int, float)) and \
                        isinstance(rt, (int, float)) and rt > 0:
                    share = agg_ms / 1e3 / rt
                    out["comm_agg_share"] = share
                    reg.distribution("comm_agg_share").observe(share)
            if self.slo is not None and isinstance(r, int) and r >= 0:
                # online SLO evaluation over the ENRICHED line (mem_*/
                # comm_* keys are objectives too), then the health
                # stamp — evaluated state, written on the same line
                events = self.slo.observe(out)
                out["slo_health"] = self.slo.health
                out["slo_breached"] = float(len(self.slo.breached))
                if events:
                    top = max(events, key=lambda e: e.severity)
                    out["slo_event"] = top.type + (
                        f"({top.objective})" if top.objective else "")
                reg.gauge("slo_health_rank").set(
                    float(self.slo.health_rank))
                if self.event_bus is not None:
                    for ev in events:
                        self.event_bus.emit(ev)
            # stamp from the ENRICHED line: comm keys promote it to
            # v3, slo keys to v4
            out["obs_schema"] = record_schema(out)
            self.writer.write(out)
        if self._tb is not None and isinstance(r, int):
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "round":
                    try:
                        self._tb.add_scalar(k, v, r)
                    except Exception:  # pragma: no cover - TB quirk
                        logger.debug("TB scalar export failed",
                                     exc_info=True)

    # -- resume ----------------------------------------------------------
    def slo_replay_from_stream(self, start_round: int) -> int:
        """Deterministically rebuild the SLO engine's estimator/budget/
        health state from this session's OWN existing JSONL stream on
        ``--resume``: feed the deduped records of rounds BEFORE
        ``start_round`` through the engine with event emission
        suppressed (the events stream already holds those rounds'
        events; the live rounds >= start_round re-emit, and the
        events-fold's keep-last dedupe absorbs the overlap). Returns
        the number of rounds replayed."""
        if self.slo is None or not self.jsonl_path or \
                not os.path.exists(self.jsonl_path):
            return 0
        prior = [r for r in dedupe_rounds(read_jsonl(
                     self.jsonl_path, allow_partial_tail=True))
                 if isinstance(r.get("round"), (int, float))
                 and 0 <= int(r["round"]) < int(start_round)]
        self.slo.replay(prior)  # events discarded: already on disk
        return len(prior)

    # -- end-of-run ------------------------------------------------------
    def finish(self) -> Dict[str, Any]:
        """Final memory sample, write sinks, return the registry
        snapshot (the runner merges it into stat_info)."""
        self.memory.sample()
        self.compile_watch.summarize()
        if self.slo is not None:
            # run-health summary into the registry so metrics.json
            # (and stat_info's obs_metrics merge) carry the verdict
            s = self.slo.summary()
            self.registry.gauge("slo_health_rank").set(
                float(s["health_rank"]))
            self.registry.gauge("slo_rounds_observed").set(
                float(s["rounds_observed"]))
            self.registry.gauge("slo_transitions").set(
                float(len(s["transitions"])))
            for name, o in s["objectives"].items():
                g = self.registry.gauge("slo_budget_spend")
                g.labels(objective=name).set(float(o["budget_spend"]))
                if o["compliance"] is not None:
                    c = self.registry.gauge("slo_compliance")
                    c.labels(objective=name).set(
                        float(o["compliance"]))
        if self.exports:
            if self.jsonl_path:
                self.metrics_json_path = write_metrics_json(
                    self.registry,
                    os.path.join(os.path.dirname(self.jsonl_path) or ".",
                                 self.identity + ".metrics.json"))
            if self.trace_dir:
                self.trace_path = self.tracer.write(os.path.join(
                    self.trace_dir, self.identity + ".trace.json"))
        snap = self.registry.snapshot()
        self._finished = True
        self.close()
        return snap

    def _write_catalog_entry(self) -> None:
        """The fleet-catalog append (--obs_catalog): one entry built
        from this session's observed state. Never raises — a catalog
        failure must not mask the run's own exit path."""
        from . import catalog as obs_catalog

        info = self._catalog_info
        artifacts = {
            "obs_jsonl": self.jsonl_path,
            "events_jsonl": self.events_path
            if self.event_writer is not None else "",
            "metrics_json": self.metrics_json_path or "",
            "trace": self.trace_path or "",
            "stat_json": str(info.get("stat_json", "")),
        }
        entry = obs_catalog.build_entry(
            identity=self.identity,
            config=info.get("config") or {},
            checkpoint_identity=str(info.get("checkpoint_identity",
                                             "")),
            git_sha=str(info.get("git_sha", "")),
            final_metrics=self._final_metrics,
            slo_health=self.slo.health if self.slo is not None else "",
            event_counts=dict(self.event_bus.counts)
            if self.event_bus is not None else {},
            rounds_recorded=self._rounds_recorded,
            artifacts=artifacts,
            completed=self._finished)
        try:
            obs_catalog.append_entry(self.catalog_path, entry)
        except OSError:  # pragma: no cover - disk-full edge
            logger.warning("run-catalog append failed",
                           exc_info=True)

    def close(self) -> None:
        """Idempotent teardown (the runner's ``finally`` path — a crash
        must still restore the null tracer and release the file)."""
        if self._closed:
            return
        self._closed = True
        if self.catalog_path and self.exports:
            self._write_catalog_entry()
        obs_trace.set_tracer(self._prev_tracer)
        self.compile_watch.uninstall()
        if self.writer is not None:
            self.writer.close()
        if self.event_writer is not None:
            self.event_writer.close()
        if self._tb is not None:
            try:
                self._tb.close()
            except Exception:  # pragma: no cover
                pass
