"""Append-only run catalog: the fleet's index of recorded runs (a copy of
``neuroimagedisttraining_tpu/obs/catalog.py``; the identity-bearing
flags are this module's :data:`IDENTITY_FLAGS`, the names the JAX
package's flag census classes ``identity``).

One JSONL line per run under ``<results_dir>/runs_index.jsonl``,
written by :class:`~.export.ObsSession` at close (process 0 only — the
same only-process-0-exports rule as every obs sink) and rebuildable
from run dirs via :func:`scan` / :func:`rebuild` (``obs ls --rebuild``)
for runs recorded before the catalog existed. Each entry carries what
the fleet tools need to index, compare, and summarize a run without
opening its artifacts:

* run identity + checkpoint identity (the two lineage keys);
* the identity-bearing flag values (:data:`IDENTITY_FLAGS` — the
  config axes a cross-run diff splits on);
* the repo git SHA and obs schema version the run recorded under;
* a final-metrics snapshot, the end run-health state, and per-type
  event counts;
* the artifact paths (round stream, events stream, metrics.json,
  stat_info JSON, trace).

Catalog writes ride the ``--obs_catalog`` flag (``obs_``-prefixed, so
the identity-inertness gate's hard rule applies): the catalog never
enters run or checkpoint identity, and a cataloged rerun APPENDS — the
read path keeps the last entry per ``(dataset, identity)``, the
``RoundLogWriter`` rerun semantics. Entries are deliberately
timestamp-free (the events-stream determinism convention): two
generations over the same run produce byte-identical lines.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from .export import (
    OBS_SCHEMA_VERSION, _process_index, dedupe_events, dedupe_rounds,
    read_jsonl,
)

__all__ = [
    "CATALOG_NAME", "CATALOG_SCHEMA_VERSION", "FINAL_METRIC_KEYS",
    "IDENTITY_FLAGS", "append_entry", "build_entry", "catalog_path",
    "entry_from_run", "entry_key", "final_metrics_from_records",
    "identity_flag_values", "read_catalog", "rebuild", "scan",
]

#: version stamped on every catalog line
CATALOG_SCHEMA_VERSION = 1

#: the catalog filename under the results dir (one level ABOVE the
#: per-dataset run dirs, so every dataset's runs share one index)
CATALOG_NAME = "runs_index.jsonl"

#: the final-metrics snapshot keys: the learning-curve endpoints the
#: fleet report and cross-run scatter read without opening streams
FINAL_METRIC_KEYS = (
    "train_loss", "global_loss", "global_acc", "personal_loss",
    "personal_acc",
)


#: the flags that key the run identity (sorted): the JAX package's flag
#: census (``analysis/identity.py``) classes exactly these ``identity``
IDENTITY_FLAGS = (
    "active", "agg_hier_inner", "agg_hier_wire", "agg_impl",
    "agg_topk_density", "agg_topk_sample", "algo", "anneal_factor",
    "augment", "batch_size", "batching", "client_num_in_total",
    "comm_round", "cs", "data_dtype", "dataset", "defense_type",
    "dense_ratio", "each_prune_ratio", "epochs", "eval_cache",
    "eval_clients", "fault_spec", "fed_buffer_k", "fed_mode", "fed_replay",
    "fed_site_faults", "fed_sites", "fed_staleness_bound", "final_finetune",
    "frac", "global_test", "itersnip_iteration", "lamda", "lr",
    "max_round_retries", "model", "n_groups", "norm_bound", "robust_agg",
    "robust_krum_f", "robust_trim", "seed", "stddev", "stratified_mode",
    "stratified_sampling", "tag", "track_personal", "watchdog",
    "watchdog_loss", "watchdog_norm",
)


def catalog_path(results_dir: str) -> str:
    """The fleet index path for one results tree."""
    return os.path.join(results_dir or ".", CATALOG_NAME)


def identity_flag_values(config: Dict[str, Any]) -> Dict[str, Any]:
    """The identity-bearing flag values present in one run config
    (:data:`IDENTITY_FLAGS`) — the axes two runs can
    legitimately differ on, as opposed to the inert telemetry knobs."""
    return {name: config[name] for name in IDENTITY_FLAGS
            if name in config}


def final_metrics_from_records(
        records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Last-seen value per snapshot key over a (deduped, sorted) round
    stream — the same fold the live session applies, so a rebuilt
    entry matches the one written at close. The round=-1 final-eval
    record sorts FIRST in a deduped stream but was recorded LAST, so
    it folds last here."""
    out: Dict[str, Any] = {}
    ordered = sorted(
        (r for r in records if isinstance(r.get("round"), int)),
        key=lambda r: (r["round"] < 0, abs(r["round"])))
    for rec in ordered:
        for k in FINAL_METRIC_KEYS:
            v = rec.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = float(v)
    return out


def _json_safe_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Flag values as the stat_info JSON sidecar records them
    (non-native values stringified), so a live entry and a rebuilt one
    agree byte-for-byte on the flags block."""
    out: Dict[str, Any] = {}
    for k, v in config.items():
        if v is None or isinstance(v, (bool, int, float, str)):
            out[k] = v
        else:
            out[k] = str(v)
    return out


def build_entry(identity: str,
                config: Optional[Dict[str, Any]] = None,
                checkpoint_identity: str = "",
                git_sha: str = "",
                final_metrics: Optional[Dict[str, Any]] = None,
                slo_health: str = "",
                event_counts: Optional[Dict[str, int]] = None,
                rounds_recorded: int = 0,
                artifacts: Optional[Dict[str, str]] = None,
                completed: bool = True,
                obs_schema: int = OBS_SCHEMA_VERSION) -> Dict[str, Any]:
    """Assemble one catalog entry. ``config`` is the run's full flag
    namespace (``vars(args)``); only the identity-bearing values enter
    the entry — the inert/unkeyed flags live in the stat_info sidecar
    the entry points at."""
    config = config or {}
    return {
        "catalog_schema": CATALOG_SCHEMA_VERSION,
        "identity": str(identity),
        "checkpoint_identity": str(checkpoint_identity),
        "dataset": str(config.get("dataset", "")),
        "algo": str(config.get("algo", "")),
        "git_sha": str(git_sha),
        "obs_schema_version": int(obs_schema),
        "flags": _json_safe_config(identity_flag_values(config)),
        "rounds_recorded": int(rounds_recorded),
        "final_metrics": dict(final_metrics or {}),
        "slo_health": str(slo_health),
        "event_counts": {str(k): int(v)
                         for k, v in sorted((event_counts or {}).items())},
        "completed": bool(completed),
        "artifacts": {str(k): str(v)
                      for k, v in sorted((artifacts or {}).items()) if v},
    }


def entry_key(entry: Dict[str, Any]):
    """The keep-last dedupe key of one entry: a rerun (or a rebuild)
    under the same lineage supersedes the earlier line."""
    return (entry.get("dataset"), entry.get("identity"))


def append_entry(path: str, entry: Dict[str, Any],
                 force: bool = False) -> bool:
    """Append one entry (process 0 only unless ``force`` — the
    multihost export rule). Returns whether a line was written. Keys
    are sorted so a rewrite of the same entry is byte-identical."""
    if not force and _process_index() != 0:
        return False
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")
    return True


def read_catalog(path: str,
                 dedupe: bool = True) -> List[Dict[str, Any]]:
    """The catalog's entries, keep-last per ``(dataset, identity)``
    (append-only rerun semantics), sorted by that key. A torn final
    line — a run killed mid-append — is tolerated."""
    if not os.path.exists(path):
        return []
    entries = read_jsonl(path, allow_partial_tail=True)
    if not dedupe:
        return entries
    last: Dict[Any, Dict[str, Any]] = {}
    for e in entries:
        if e.get("identity"):
            last[entry_key(e)] = e
    return [last[k] for k in sorted(last, key=lambda k: (str(k[0]),
                                                         str(k[1])))]


def _maybe_json(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def entry_from_run(run_dir: str, identity: str,
                   git_sha: str = "") -> Dict[str, Any]:
    """Rebuild one run's catalog entry from its on-disk artifacts (the
    pre-catalog path): the round stream is authoritative for metrics/
    health/schema, the stat_info JSON sidecar for config, the events
    stream for per-type counts. ``git_sha`` defaults to empty — the
    recording commit is unknowable after the fact unless the sidecar
    carries it."""
    jsonl = os.path.join(run_dir, identity + ".obs.jsonl")
    records = dedupe_rounds(
        read_jsonl(jsonl, allow_partial_tail=True)) \
        if os.path.exists(jsonl) else []
    events_path = os.path.join(run_dir, identity + ".events.jsonl")
    events = dedupe_events(
        read_jsonl(events_path, allow_partial_tail=True)) \
        if os.path.exists(events_path) else []
    counts: Dict[str, int] = {}
    for ev in events:
        t = str(ev.get("event_type"))
        counts[t] = counts.get(t, 0) + 1
    stat_json = os.path.join(run_dir, identity + ".json")
    stat = _maybe_json(stat_json) or {}
    config = stat.get("config") or {}
    ckpt_identity = ""
    if config.get("algo"):
        # recompute the checkpoint-lineage key from the recorded
        # config — the same function the live path used
        import argparse as _argparse

        from ..experiments.config import run_identity

        try:
            ckpt_identity = run_identity(
                _argparse.Namespace(**config), str(config["algo"]),
                for_checkpoint=True)
        except Exception:  # partial/foreign config: key unknowable
            ckpt_identity = ""
    health = ""
    schema = 1
    for rec in records:
        if isinstance(rec.get("slo_health"), str):
            health = rec["slo_health"]
        s = rec.get("obs_schema")
        if isinstance(s, int):
            schema = max(schema, s)
    artifacts = {"obs_jsonl": jsonl}
    if events:
        artifacts["events_jsonl"] = events_path
    if os.path.exists(stat_json):
        artifacts["stat_json"] = stat_json
    metrics_json = os.path.join(run_dir, identity + ".metrics.json")
    if os.path.exists(metrics_json):
        artifacts["metrics_json"] = metrics_json
    n_rounds = sum(1 for r in records
                   if isinstance(r.get("round"), int) and r["round"] >= 0)
    return build_entry(
        identity=identity, config=config,
        checkpoint_identity=ckpt_identity,
        git_sha=git_sha,
        final_metrics=final_metrics_from_records(records),
        slo_health=health, event_counts=counts,
        rounds_recorded=n_rounds, artifacts=artifacts,
        # finish() leaves one of three traces: the final (round -1)
        # eval record, the metrics.json snapshot it always writes
        # before closing, or — serving streams (serve/), which have no
        # training round -1 — the graceful-drain marker the worker
        # writes after serving its last request
        completed=(any(r.get("round") == -1 for r in records)
                   or any(bool(r.get("serve_drained"))
                          for r in records)
                   or os.path.exists(metrics_json)),
        obs_schema=schema)


def scan(run_dir: str, git_sha: str = "") -> List[Dict[str, Any]]:
    """Rebuild entries for every ``*.obs.jsonl`` stream under one run
    dir (a ``<results_dir>/<dataset>`` directory), sorted by
    identity."""
    if not os.path.isdir(run_dir):
        return []
    idents = sorted(f[:-len(".obs.jsonl")] for f in os.listdir(run_dir)
                    if f.endswith(".obs.jsonl"))
    return [entry_from_run(run_dir, i, git_sha=git_sha)
            for i in idents]


def rebuild(results_dir: str, path: str = "",
            force: bool = False) -> int:
    """Scan every dataset dir under ``results_dir`` and REWRITE the
    catalog from what is on disk (the pre-catalog migration; the live
    path appends instead). Returns entries written."""
    path = path or catalog_path(results_dir)
    entries: List[Dict[str, Any]] = []
    if os.path.isdir(results_dir):
        for name in sorted(os.listdir(results_dir)):
            sub = os.path.join(results_dir, name)
            if os.path.isdir(sub):
                entries.extend(scan(sub))
    if not force and _process_index() != 0:
        return 0
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(entries)
