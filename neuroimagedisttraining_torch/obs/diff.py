"""Cross-run diff engine: one hardened comparator for every twin check
(counterpart of ``neuroimagedisttraining_tpu/obs/diff.py``).

The repo's standing bit-determinism contracts — fused==unfused,
kill+resume==uninterrupted, donation on==off, obs on==off — were each
enforced by a hand-rolled comparison inside its own smoke script. This
module is the single comparator they (and the CLI: ``obs diff``) route
through, diffing two recorded runs on three planes:

* **config** — flag-value differences split by the identity-inertness
  census (:data:`FLAG_CLASSES`, the JAX package's census by class, plus
  the port's ``--device``): identity-bearing
  differences mean the runs are different experiments; inert/unkeyed
  differences are exactly the axes a twin check varies (fuse_rounds,
  donate_state, obs knobs) and never violate ``--expect identical``.
* **trajectory** — round-aligned per-metric comparison over the
  deduped streams: the first-bit-divergence round (exact float
  inequality — the determinism contracts are BIT contracts), the
  max abs delta, and a MAD-band significance verdict on overlapping
  rounds (the obs/regress.py noise model) for when bit equality is
  not expected. Volatile keys (wall times, memory watermarks, probed
  agg timings) never count: they differ across bit-identical runs.
* **event/health** — event-sequence diff keyed ``(round, type)`` (the
  events-stream dedupe key) and the run-health trajectory diff from
  the per-line ``slo_health`` stamps.

Machine JSON (:func:`diff_runs`) + human report (:func:`render_diff`);
``--expect identical`` / ``--expect different`` map the verdict to exit
codes so smoke scripts and determinism suites gate on it directly.
:func:`params_diff` is the parameter leg of the same contract — the
final-params bit-identity checks — over this package's ``state_dict``-named
dicts, walked in the reference's leaf order
(``convert.reference_leaf_order``)."""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .catalog import IDENTITY_FLAGS
from .export import dedupe_events, dedupe_rounds, read_jsonl

__all__ = [
    "FLAG_CLASSES", "VOLATILE_KEYS", "VOLATILE_PREFIXES", "config_diff",
    "diff_runs",
    "events_diff", "expect_exit_code", "health_diff", "load_run",
    "params_diff", "render_diff", "trajectory_diff",
]

#: per-round keys that legitimately differ between bit-identical runs
#: (wall clock, probed timings) — never part of any plane's verdict
VOLATILE_KEYS = {"round_time_s", "comm_agg_ms", "comm_agg_share",
                 "host", "obs_schema", "store_gather_ms",
                 # wall timings stamped by the federation / serving
                 # planes (obs/xtrace.py): pure clock, never verdict
                 "wall_s", "fed_round_ms", "fed_wire_ms",
                 "fed_queue_ms", "serve_adopt_lag_ms",
                 # probe accuracy depends on which model version the
                 # serving worker had adopted at tick time — wall
                 # scheduling, not run state
                 "serve_probe_acc",
                 # transport counters: tracing headers and HELLO
                 # clock-sync frames legitimately shift byte/message
                 # counts between otherwise bit-identical twins
                 "comm_bytes_sent", "comm_bytes_received",
                 "comm_messages_sent", "comm_messages_received",
                 "comm_messages_retried"}

#: key prefixes with the same exemption (memory watermarks are host
#: state, not run state; hb_* gauge snapshots and fleet_* liveness
#: gauges are wall-clock scheduling — a heartbeat-on run must still
#: compare `identical` against its heartbeat-off twin)
VOLATILE_PREFIXES = ("mem_", "hb_", "fleet_")

#: MAD multiplier of the significance band (the perf-gate default)
DEFAULT_MAD_K = 4.0

#: flags whose prefix makes them inert whatever the table says
INERT_PREFIXES = ("obs", "flight", "slo")

#: flags that leave the run identity alone but change the numbers (the
#: ablation axes a ``--tag`` names)
UNKEYED_FLAGS = (
    "acc_thresh", "client_optimizer", "compute_dtype", "diff_spa",
    "different_initial", "dis_gradient_check", "dist_thresh",
    "erk_power_scale", "fused_kernels", "grad_clip", "guard", "layout",
    "local_epochs", "lr_decay", "momentum", "partition_alpha",
    "partition_method", "snip_mask", "static", "uniform", "val_fraction",
    "wd",
)

#: flags that change neither the identity nor the numbers: placement,
#: paths, timing, residency, observability, the serving and federation
#: transports; ``device`` is the port's own (it names the card)
INERT_FLAGS = (
    "agg_bucket_size", "agg_kernels", "agg_overlap", "checkpoint_dir", "ci",
    "client_chunk", "client_store", "coordinator_address", "data_dir",
    "device", "donate_state", "fed_backend", "fed_backoff_s",
    "fed_endpoints", "fed_out", "fed_retries", "fed_role", "fed_site_rank",
    "fed_timeout_s", "fed_trace", "flight_profile", "flight_recorder",
    "flight_window", "frequency_of_the_test", "fuse_rounds", "gpu",
    "log_dir", "logfile", "mesh_devices", "mesh_space", "multihost",
    "multihost_retries", "multihost_timeout_s", "num_processes", "obs",
    "obs_catalog", "obs_comm", "obs_heartbeat_every", "obs_jsonl",
    "obs_numerics", "obs_prom_port", "obs_sample_every", "obs_tb_dir",
    "obs_watch_color", "obs_watch_every", "process_id", "profile_dir",
    "public_portion", "record_mask_diff", "remat", "results_dir", "resume",
    "retry_backoff_s", "save_masks", "serve_backend", "serve_batch",
    "serve_ckpt_dir", "serve_endpoints", "serve_linger_ms", "serve_out",
    "serve_probe_every", "serve_push_every", "serve_replay",
    "serve_requests", "serve_role", "serve_rps", "serve_store",
    "serve_timeout_s", "serve_trace", "serve_wire", "serve_workers",
    "serve_zipf", "slo_enforce", "slo_spec", "store_hot_clients",
    "strict_avg", "trace_dir", "type", "xtrace", "xtrace_dir",
)

#: flag -> class (identity | inert | unkeyed); a flag missing here is
#: ``unclassified``
FLAG_CLASSES: Dict[str, str] = {
    **{k: "identity" for k in IDENTITY_FLAGS},
    **{k: "unkeyed" for k in UNKEYED_FLAGS},
    **{k: "inert" for k in INERT_FLAGS},
}


def _volatile(key: str) -> bool:
    return key in VOLATILE_KEYS or key.startswith(VOLATILE_PREFIXES)


def load_run(target: str, identity: str = "") -> Dict[str, Any]:
    """One run's comparable state: deduped round records, deduped
    events, and the stat-sidecar config. ``target`` is a run dir (then
    ``identity`` picks the stream) or a ``*.obs.jsonl`` path."""
    if os.path.isdir(target):
        if not identity:
            streams = sorted(f for f in os.listdir(target)
                             if f.endswith(".obs.jsonl"))
            if len(streams) != 1:
                raise ValueError(
                    f"{target}: {len(streams)} streams — pass an "
                    "identity to pick one")
            identity = streams[0][:-len(".obs.jsonl")]
        run_dir, jsonl = target, os.path.join(
            target, identity + ".obs.jsonl")
    else:
        jsonl = target
        run_dir = os.path.dirname(target) or "."
        base = os.path.basename(target)
        identity = base[:-len(".obs.jsonl")] \
            if base.endswith(".obs.jsonl") else base
    records = dedupe_rounds(read_jsonl(jsonl, allow_partial_tail=True))
    events_path = os.path.join(run_dir, identity + ".events.jsonl")
    events = dedupe_events(
        read_jsonl(events_path, allow_partial_tail=True)) \
        if os.path.exists(events_path) else []
    stat = os.path.join(run_dir, identity + ".json")
    config: Dict[str, Any] = {}
    if os.path.exists(stat):
        import json

        try:
            with open(stat) as f:
                config = dict(json.load(f).get("config") or {})
        except (OSError, ValueError):
            config = {}
    return {"identity": identity, "jsonl": jsonl, "records": records,
            "events": events, "config": config}


# -- config plane ---------------------------------------------------------
def config_diff(config_a: Dict[str, Any],
                config_b: Dict[str, Any]) -> Dict[str, Any]:
    """Flag-value differences split by the identity census. The hard
    rule of the inertness gate applies here too: an ``obs``/``flight``/
    ``slo``-prefixed flag classifies inert regardless of the table."""
    buckets: Dict[str, Dict[str, List[Any]]] = {
        "identity": {}, "inert": {}, "unkeyed": {}, "unclassified": {}}
    for name in sorted(set(config_a) | set(config_b)):
        va, vb = config_a.get(name), config_b.get(name)
        if va == vb:
            continue
        if name.split("_")[0] in INERT_PREFIXES:
            cls = "inert"
        else:
            cls = FLAG_CLASSES.get(name, "unclassified")
        buckets[cls][name] = [va, vb]
    return {**buckets,
            "identical": not any(buckets[c] for c in buckets),
            "same_experiment": not buckets["identity"]}


# -- trajectory plane -----------------------------------------------------
def _metric_series(records: List[Dict[str, Any]]
                   ) -> Dict[str, Dict[int, float]]:
    """metric -> {round: value} over the non-volatile numeric keys."""
    series: Dict[str, Dict[int, float]] = {}
    for rec in records:
        r = rec.get("round")
        if not isinstance(r, int):
            continue
        for k, v in rec.items():
            if k == "round" or _volatile(k):
                continue
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                series.setdefault(k, {})[r] = float(v)
    return series


def trajectory_diff(records_a: List[Dict[str, Any]],
                    records_b: List[Dict[str, Any]],
                    metrics: Optional[List[str]] = None,
                    mad_k: float = DEFAULT_MAD_K) -> Dict[str, Any]:
    """Round-aligned comparison of every shared (non-volatile) metric:
    first-bit-divergence round, max abs delta, MAD-band significance
    over the overlapping rounds. Missing rounds and metric keys
    present on only one side are differences too."""
    from .metrics import mad as _mad, median as _median

    sa, sb = _metric_series(records_a), _metric_series(records_b)
    rounds_a = {r["round"] for r in records_a
                if isinstance(r.get("round"), int)}
    rounds_b = {r["round"] for r in records_b
                if isinstance(r.get("round"), int)}
    keys = sorted(set(sa) & set(sb))
    if metrics:
        keys = [k for k in keys if k in metrics]
    per_metric: Dict[str, Dict[str, Any]] = {}
    for k in keys:
        a, b = sa[k], sb[k]
        overlap = sorted(set(a) & set(b))
        first_div = None
        n_div = 0
        max_delta = 0.0
        deltas: List[float] = []
        for r in overlap:
            va, vb = a[r], b[r]
            # exact (bit-level) inequality: NaN on both sides is NOT a
            # divergence — a deterministic twin reproduces its NaNs
            same = (va == vb) or (math.isnan(va) and math.isnan(vb))
            d = 0.0 if same else abs(va - vb)
            if math.isnan(d):
                d = float("inf")
            deltas.append(d)
            if not same:
                n_div += 1
                max_delta = max(max_delta, d)
                if first_div is None:
                    first_div = r
        pooled = [v for s in (a, b) for r, v in sorted(s.items())
                  if not math.isnan(v)]
        band = 0.0
        if pooled:
            band = mad_k * 1.4826 * _mad(pooled, _median(pooled))
        per_metric[k] = {
            "overlap_rounds": len(overlap),
            "first_divergence_round": first_div,
            "diverged_rounds": n_div,
            "max_abs_delta": max_delta,
            "mad_band": band,
            "significant": bool(n_div and max_delta > band),
        }
    diverged = {k: m for k, m in per_metric.items()
                if m["diverged_rounds"]}
    firsts = [m["first_divergence_round"] for m in diverged.values()
              if m["first_divergence_round"] is not None]
    keys_only_a = sorted(k for k in set(sa) - set(sb)
                         if not metrics or k in metrics)
    keys_only_b = sorted(k for k in set(sb) - set(sa)
                         if not metrics or k in metrics)
    return {
        "metrics": per_metric,
        "diverged_metrics": sorted(diverged),
        "significant_metrics": sorted(
            k for k, m in per_metric.items() if m["significant"]),
        "first_divergence_round": min(firsts) if firsts else None,
        "rounds_only_a": sorted(rounds_a - rounds_b),
        "rounds_only_b": sorted(rounds_b - rounds_a),
        "keys_only_a": keys_only_a,
        "keys_only_b": keys_only_b,
        "identical": (not diverged and not keys_only_a
                      and not keys_only_b
                      and rounds_a == rounds_b),
    }


# -- event / health plane -------------------------------------------------
#: event-record fields whose change makes the "same" (round, type)
#: event a difference (severity/objective/message/detail — not host)
_EVENT_FIELDS = ("severity", "objective", "message", "detail")


def events_diff(events_a: List[Dict[str, Any]],
                events_b: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Event-sequence diff keyed ``(round, event_type)`` — the
    emission/dedupe contract's key, so a twin's re-emitted events line
    up positionally by construction."""
    from .events import event_key

    ka = {event_key(e): e for e in events_a}
    kb = {event_key(e): e for e in events_b}
    only_a = sorted((k for k in ka if k not in kb),
                    key=lambda k: (k[0], str(k[1])))
    only_b = sorted((k for k in kb if k not in ka),
                    key=lambda k: (k[0], str(k[1])))
    changed = []
    for k in sorted((k for k in ka if k in kb),
                    key=lambda k: (k[0], str(k[1]))):
        fields = [f for f in _EVENT_FIELDS
                  if ka[k].get(f) != kb[k].get(f)]
        if fields:
            changed.append({"round": k[0], "event_type": k[1],
                            "fields": fields})
    return {
        "only_a": [{"round": k[0], "event_type": k[1],
                    "message": ka[k].get("message", "")}
                   for k in only_a],
        "only_b": [{"round": k[0], "event_type": k[1],
                    "message": kb[k].get("message", "")}
                   for k in only_b],
        "changed": changed,
        "identical": not (only_a or only_b or changed),
    }


def _health_trajectory(records: List[Dict[str, Any]]
                       ) -> List[Tuple[int, str]]:
    """The compacted ``slo_health`` trajectory: (round, state) at each
    transition (first stamped round included)."""
    out: List[Tuple[int, str]] = []
    for rec in records:
        r, h = rec.get("round"), rec.get("slo_health")
        if not isinstance(r, int) or r < 0 or not isinstance(h, str):
            continue
        if not out or out[-1][1] != h:
            out.append((r, h))
    return out


def health_diff(records_a: List[Dict[str, Any]],
                records_b: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Run-health trajectory diff from the per-line health stamps."""
    ta, tb = _health_trajectory(records_a), _health_trajectory(records_b)
    first_div = None
    if ta != tb:
        for (ra, ha), (rb, hb) in zip(ta, tb):
            if (ra, ha) != (rb, hb):
                first_div = min(ra, rb)
                break
        else:
            longer = ta if len(ta) > len(tb) else tb
            first_div = longer[min(len(ta), len(tb))][0]
    return {
        "a": [[r, h] for r, h in ta],
        "b": [[r, h] for r, h in tb],
        "end_a": ta[-1][1] if ta else "",
        "end_b": tb[-1][1] if tb else "",
        "first_divergence_round": first_div,
        "identical": ta == tb,
    }


# -- the full diff --------------------------------------------------------
def diff_runs(run_a: Dict[str, Any], run_b: Dict[str, Any],
              metrics: Optional[List[str]] = None,
              mad_k: float = DEFAULT_MAD_K) -> Dict[str, Any]:
    """Three-plane diff of two loaded runs (:func:`load_run` outputs,
    or any dicts with ``records``/``events``/``config``/``identity``).

    ``identical`` is the TWIN verdict: trajectories, events, and
    health bit-match, and no identity-bearing flag differs — inert and
    unkeyed config differences (the axis a twin check varies) are
    reported but allowed."""
    ca, cb = run_a.get("config") or {}, run_b.get("config") or {}
    if ca and cb:
        cfg = config_diff(ca, cb)
    else:
        # a bare stream (no stat sidecar — e.g. an --obs_jsonl
        # override path, or a copied-out file) has no config to
        # compare; fabricating every-flag differences against a run
        # that HAS one would be noise, so the plane abstains
        cfg = {"identity": {}, "inert": {}, "unkeyed": {},
               "unclassified": {}, "identical": True,
               "same_experiment": True, "unavailable": True}
    traj = trajectory_diff(run_a.get("records") or [],
                           run_b.get("records") or [],
                           metrics=metrics, mad_k=mad_k)
    ev = events_diff(run_a.get("events") or [],
                     run_b.get("events") or [])
    health = health_diff(run_a.get("records") or [],
                         run_b.get("records") or [])
    return {
        "a": run_a.get("identity", "a"),
        "b": run_b.get("identity", "b"),
        "planes": {"config": cfg, "trajectory": traj, "events": ev,
                   "health": health},
        "identical": bool(cfg["same_experiment"] and traj["identical"]
                          and ev["identical"] and health["identical"]),
    }


def expect_exit_code(doc: Dict[str, Any], expect: str) -> int:
    """Map a diff verdict to the gate exit code: 0 when the
    expectation holds, 1 when it does not. ``expect`` is
    ``identical``, ``different``, or empty (always 0 — report-only)."""
    if expect == "identical":
        return 0 if doc["identical"] else 1
    if expect == "different":
        return 0 if not doc["identical"] else 1
    if expect:
        raise ValueError(
            f"unknown --expect {expect!r} (identical|different)")
    return 0


# -- the params-plane twin comparator ------------------------------------
def _flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """A parameter dict as ``{state_dict name: leaf}`` (a nested dict's
    scopes joined by dots)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _host(leaf: Any):
    """A leaf as a host numpy array of its own bits (a bf16 tensor as its
    16-bit pattern)."""
    import numpy as np

    if hasattr(leaf, "detach"):
        import torch

        t = leaf.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return np.asarray(leaf)


def params_diff(tree_a: Any, tree_b: Any) -> Dict[str, Any]:
    """Bit-level comparison of two parameter dicts (the final-params twin
    checks): torch tensors or numpy leaves under ``state_dict`` names,
    walked in the reference's leaf order, raw-bytes equality (exact even
    across NaNs), with the first differing leaves named."""
    import numpy as np

    from ..convert import reference_leaf_order

    fa, fb = _flat(tree_a), _flat(tree_b)
    la = [(k, fa[k]) for k in reference_leaf_order(fa)]
    lb = [(k, fb[k]) for k in reference_leaf_order(fb)]
    diverged: List[Dict[str, Any]] = []
    structure_ok = len(la) == len(lb)
    for (name, a), (name_b, b) in zip(la, lb):
        if name_b != name:
            structure_ok = False
            break
        xa, xb = _host(a), _host(b)
        if xa.shape != xb.shape or xa.dtype != xb.dtype:
            diverged.append({"leaf": name, "reason": "shape/dtype",
                             "a": f"{xa.dtype}{xa.shape}",
                             "b": f"{xb.dtype}{xb.shape}"})
            continue
        if xa.tobytes() != xb.tobytes():
            delta = np.abs(np.asarray(xa, np.float64)
                           - np.asarray(xb, np.float64))
            finite = delta[np.isfinite(delta)]
            diverged.append({
                "leaf": name, "reason": "values",
                "n_diff": int(np.sum(xa != xb)),
                "max_abs_delta": float(finite.max())
                if finite.size else float("inf")})
    return {
        "leaves": len(la),
        "structure_identical": structure_ok,
        "diverged": diverged,
        "identical": structure_ok and not diverged,
    }


# -- human report ---------------------------------------------------------
def render_diff(doc: Dict[str, Any]) -> str:
    """The three-plane human report of one :func:`diff_runs` output."""
    lines = [f"== obs diff: {doc['a']} vs {doc['b']} ==",
             "verdict: " + ("IDENTICAL (twin)" if doc["identical"]
                            else "DIFFERENT")]
    cfg = doc["planes"]["config"]
    lines.append("-- config plane --")
    if cfg.get("unavailable"):
        lines.append("  config unavailable on one side (no stat "
                     "sidecar) — plane abstains")
    elif cfg["identical"]:
        lines.append("  no flag differences")
    for bucket in ("identity", "inert", "unkeyed", "unclassified"):
        for name, (va, vb) in sorted(cfg[bucket].items()):
            mark = "SPLIT" if bucket == "identity" else bucket
            lines.append(f"  [{mark}] --{name}: {va!r} -> {vb!r}")
    traj = doc["planes"]["trajectory"]
    lines.append("-- trajectory plane --")
    if traj["identical"]:
        lines.append(
            f"  bit-identical over {len(traj['metrics'])} metric(s)")
    else:
        if traj["first_divergence_round"] is not None:
            lines.append("  first bit divergence at round "
                         f"{traj['first_divergence_round']}")
        for k in traj["diverged_metrics"]:
            m = traj["metrics"][k]
            lines.append(
                f"  {k}: diverges at round "
                f"{m['first_divergence_round']} "
                f"({m['diverged_rounds']}/{m['overlap_rounds']} "
                f"rounds, max |delta| {m['max_abs_delta']:g}"
                + (", SIGNIFICANT vs MAD band "
                   f"{m['mad_band']:g}" if m["significant"]
                   else ", within MAD band") + ")")
        for side, key in (("a", "rounds_only_a"),
                          ("b", "rounds_only_b")):
            if traj[key]:
                lines.append(f"  rounds only in {side}: "
                             + ",".join(str(r) for r in traj[key]))
        for side, key in (("a", "keys_only_a"), ("b", "keys_only_b")):
            if traj[key]:
                lines.append(f"  metrics only in {side}: "
                             + ", ".join(traj[key]))
    ev = doc["planes"]["events"]
    lines.append("-- event/health plane --")
    if ev["identical"]:
        lines.append("  event sequences identical")
    for side in ("only_a", "only_b"):
        for e in ev[side]:
            lines.append(
                f"  {side.replace('_', ' ')}: round {e['round']} "
                f"{e['event_type']}"
                + (f" ({e['message']})" if e.get("message") else ""))
    for c in ev["changed"]:
        lines.append(f"  changed: round {c['round']} "
                     f"{c['event_type']} fields "
                     + ",".join(c["fields"]))
    health = doc["planes"]["health"]
    if health["identical"]:
        if health["a"]:
            lines.append(
                f"  health trajectories identical (end "
                f"{health['end_a'].upper()})")
    else:
        lines.append(
            f"  health diverges at round "
            f"{health['first_divergence_round']}: "
            f"{health['a']} vs {health['b']}")
    return "\n".join(lines)
