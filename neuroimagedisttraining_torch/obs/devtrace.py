"""Device-trace attribution: collective vs compute time on the card
(counterpart of ``neuroimagedisttraining_tpu/obs/devtrace.py``).

The host span tracer (obs/trace.py) sees dispatch; the wire-cost model
(obs/comm.py) sees modeled bytes; this module reads what the DEVICE
actually did. It parses the Chrome-trace JSON that ``torch.profiler``
exports (``export_chrome_trace``; ``--profile_dir`` / ``trace_one_round``
write ``*.trace.json`` files) and attributes device time — the events with
``"cat": "kernel"``, one lane per device — to collective kernels (NCCL's
``ncclDevKernel_*`` / ``ncclKernel_*``, beside the XLA collective names of
:data:`COLLECTIVE_PATTERNS`) vs everything else, yielding the MEASURED agg
share and, against the wire model's bytes, the achieved wire GB/s — plus
the collective-vs-compute interval OVERLAP per device (``overlap_s`` /
``overlap_frac``: the share of collective seconds concurrent with compute
kernels on other streams of the same device). The directory summary also
ranks every compute kernel by its total time (``kernels``, the port's
addition: it names the hand kernels a round ran, which the offline
analyzer's comm section carries). A CPU capture has no kernel events, so
it has no device lane and its summary is ``present: False``.

A trace document without torch's ``cat`` fields (the JAX profiler's) is
read as the JAX package reads it: device lanes by process name, the
aggregate annotation rows skipped.

When no trace was captured, :func:`share_from_cost_analysis` gives the
fallback estimate from counted FLOPs / bytes (``obs.compile.
agg_cost_analysis`` of the aggregation vs the whole round).

Everything here is offline and side-effect-free; the runner (with
``--obs_comm`` + ``--profile_dir``) writes the summary as
``<identity>.devtrace.json`` beside the JSONL stream.
"""
from __future__ import annotations

import bisect
import glob
import gzip
import json
import logging
import os
import re
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "COLLECTIVE_PATTERNS", "analyze_profile_dir", "attribute_trace",
    "find_trace_files", "is_collective", "load_trace_doc",
    "share_from_cost_analysis", "write_summary",
]

#: lowercase substrings that mark a device event as a collective kernel
#: (XLA HLO names: ``all-reduce.N``, ``all-gather``, fusions named after
#: the collective they wrap, jax's psum/ppermute named_scopes)
COLLECTIVE_PATTERNS = (
    "all-reduce", "allreduce", "all-gather", "allgather",
    "reduce-scatter", "reducescatter", "collective-permute",
    "ppermute", "all-to-all", "alltoall", "psum",
    # NCCL's device kernels (ncclDevKernel_AllReduce_Sum_f32_RING_LL,
    # ncclKernel_AllGather_RING_LL_Sum_int8_t, ...)
    "nccldevkernel", "ncclkernel",
)

#: the torch.profiler event category of a kernel on a device lane
KERNEL_CAT = "kernel"

#: process-name metadata that marks a trace pid as a DEVICE lane (vs
#: python host threads); when no pid matches, every lane is used (CPU
#: profiles name lanes differently)
_DEVICE_PID_RE = re.compile(r"device|tpu|gpu|xla|stream", re.IGNORECASE)

#: thread-name metadata of AGGREGATE/annotation rows that overlap the
#: op-level rows of the same device pid ("Steps", "XLA Modules",
#: "Framework Name Scope", "Source code" in real jax.profiler traces) —
#: summing them would double- or triple-count busy time and understate
#: the collective share. Excluded when thread names are present; a
#: trace without thread metadata keeps every row.
_AGGREGATE_TID_RE = re.compile(
    r"step|module|framework|name scope|source", re.IGNORECASE)


def is_collective(name: str) -> bool:
    low = str(name).lower()
    return any(p in low for p in COLLECTIVE_PATTERNS)


def find_trace_files(profile_dir: str) -> List[str]:
    """Every ``*.trace.json[.gz]`` under ``profile_dir`` (recursively),
    sorted for determinism."""
    out: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        out += glob.glob(os.path.join(profile_dir, "**", pat),
                         recursive=True)
    return sorted(set(out))


def load_trace_doc(path: str) -> Dict[str, Any]:
    """One trace file -> its Chrome trace-event document."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _is_torch_trace(events: List[Dict[str, Any]]) -> bool:
    """A ``torch.profiler`` export: its events carry a ``cat``."""
    return any("cat" in e for e in events if e.get("ph") == "X")


def _kernel_lanes(events: List[Dict[str, Any]]) -> Dict[Any, str]:
    """pid -> lane name of the devices a torch trace's kernels ran on:
    the pid's ``process_name`` where the trace names it, else
    ``gpu<pid>``."""
    meta = {e.get("pid", 0): str((e.get("args") or {}).get("name", ""))
            for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    return {e.get("pid", 0): meta.get(e.get("pid", 0)) or
            f"gpu{e.get('pid', 0)}"
            for e in events if e.get("cat") == KERNEL_CAT}


def _device_pids(events: List[Dict[str, Any]]) -> Dict[int, str]:
    """pid -> lane name for the pids whose ``process_name`` metadata
    looks like a device lane; empty when the trace names none (caller
    falls back to all pids)."""
    names: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = str((e.get("args") or {}).get("name", ""))
            if _DEVICE_PID_RE.search(name):
                names[e.get("pid", 0)] = name
    return names


def _aggregate_tids(events: List[Dict[str, Any]]) -> set:
    """(pid, tid) pairs whose ``thread_name`` metadata marks an
    aggregate/annotation row (Steps / XLA Modules / ...) — these
    OVERLAP the op rows of the same device pid, so counting them would
    inflate busy time and understate the collective share."""
    out = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            name = str((e.get("args") or {}).get("name", ""))
            if _AGGREGATE_TID_RE.search(name):
                out.add((e.get("pid", 0), e.get("tid", 0)))
    return out


#: per-lane accumulator keys folded across files/devices (overlap_s =
#: collective time concurrent with compute on OTHER rows of the same
#: device pid — the compute/comm overlap evidence)
_LANE_KEYS = ("busy_s", "collective_s", "compute_s", "overlap_s")


def _interval_overlap_s(coll: List[tuple], comp: List[tuple]) -> float:
    """Total seconds where a collective interval and a compute interval
    are BOTH active (on any rows of one device pid): merge the compute
    intervals into a disjoint union, then sum each collective
    interval's intersection with it. Chrome-trace microseconds in,
    seconds out."""
    if not coll or not comp:
        return 0.0
    merged: List[List[float]] = []
    for s, e in sorted(comp):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    starts = [m[0] for m in merged]
    for s, e in coll:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(merged) and merged[i][0] < e:
            lo = max(s, merged[i][0])
            hi = min(e, merged[i][1])
            if hi > lo:
                total += hi - lo
            i += 1
    return total / 1e6


def _finalize_attribution(devices: Dict[str, Dict[str, float]],
                          top: Dict[str, Dict[str, float]],
                          top_k: Optional[int] = None
                          ) -> Dict[str, Any]:
    """Shared fold of per-lane sums into the summary shape: per-device
    ``agg_share`` and ``overlap_frac``, cross-device totals, ranked
    collectives (ONE implementation — attribute_trace and
    analyze_profile_dir must not drift). ``top_k=None`` keeps the FULL
    ranked kernel list: per-file attributions stay untruncated so a
    cross-file fold never drops a kernel that ranks low in every file
    but high globally; only the final dir-level summary bounds its
    list."""
    totals = {k: 0.0 for k in _LANE_KEYS}
    for d in devices.values():
        d.setdefault("overlap_s", 0.0)
        d["agg_share"] = (d["collective_s"] / d["busy_s"]
                          if d["busy_s"] > 0 else 0.0)
        d["overlap_frac"] = (d["overlap_s"] / d["collective_s"]
                             if d["collective_s"] > 0 else 0.0)
        for k in totals:
            totals[k] += d[k]
    totals["agg_share"] = (totals["collective_s"] / totals["busy_s"]
                           if totals["busy_s"] > 0 else 0.0)
    # share of collective seconds hidden behind concurrent compute —
    # the measured compute/comm overlap (0 on single-stream captures)
    totals["overlap_frac"] = (totals["overlap_s"] / totals["collective_s"]
                              if totals["collective_s"] > 0 else 0.0)
    top_list = [{"name": k, "total_s": v["total_s"],
                 "count": int(v["count"])}
                for k, v in sorted(top.items(),
                                   key=lambda kv: -kv[1]["total_s"])]
    return {"devices": devices, "totals": totals,
            "top_collectives": (top_list if top_k is None
                                else top_list[:top_k])}


def _device_events(doc: Dict[str, Any]):
    """``(lane, event)`` for every complete event on a device lane of one
    trace document: in a ``torch.profiler`` trace the kernels, in a JAX
    profiler trace the events on non-aggregate rows of device pids."""
    events = doc.get("traceEvents") or []
    torch_trace = _is_torch_trace(events)
    if torch_trace:
        device_names = _kernel_lanes(events)
        skip_tids: set = set()
    else:
        device_names = _device_pids(events)
        skip_tids = _aggregate_tids(events)
    for e in events:
        if e.get("ph") != "X" or not isinstance(e.get("dur"),
                                                (int, float)):
            continue
        pid = e.get("pid", 0)
        if torch_trace and e.get("cat") != KERNEL_CAT:
            continue
        if device_names and pid not in device_names:
            continue
        if (pid, e.get("tid", 0)) in skip_tids:
            continue
        yield device_names.get(pid, f"pid{pid}"), e


def _compute_kernels(doc: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """``{name: {"total_s", "count"}}`` of one trace document's compute
    (non-collective) device events, over every lane."""
    out: Dict[str, Dict[str, float]] = {}
    for _, e in _device_events(doc):
        name = str(e.get("name", ""))
        if is_collective(name):
            continue
        t = out.setdefault(name, {"total_s": 0.0, "count": 0})
        t["total_s"] += float(e["dur"]) / 1e6
        t["count"] += 1
    return out


def attribute_trace(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Attribute one trace document's device time.

    Returns per-device totals (``busy_s`` / ``collective_s`` /
    ``compute_s`` / ``agg_share``), the cross-device totals, and the
    top collective kernels by total time. Durations are Chrome-trace
    microseconds; only complete (``ph == "X"``) events count: in a
    ``torch.profiler`` trace the kernels (``"cat": "kernel"``), in a JAX
    profiler trace the events on non-aggregate rows of device pids (see
    :data:`_AGGREGATE_TID_RE`)."""
    devices: Dict[str, Dict[str, float]] = {}
    top: Dict[str, Dict[str, float]] = {}
    # per-lane (start, end) interval lists in trace microseconds, for
    # the collective-vs-compute overlap measurement
    coll_iv: Dict[str, List[tuple]] = {}
    comp_iv: Dict[str, List[tuple]] = {}
    for lane, e in _device_events(doc):
        d = devices.setdefault(lane, {"busy_s": 0.0, "collective_s": 0.0,
                                      "compute_s": 0.0})
        dur_s = float(e["dur"]) / 1e6
        d["busy_s"] += dur_s
        name = str(e.get("name", ""))
        ts = e.get("ts")
        iv = ((float(ts), float(ts) + float(e["dur"]))
              if isinstance(ts, (int, float)) else None)
        if is_collective(name):
            d["collective_s"] += dur_s
            if iv is not None:
                coll_iv.setdefault(lane, []).append(iv)
            t = top.setdefault(name, {"total_s": 0.0, "count": 0})
            t["total_s"] += dur_s
            t["count"] += 1
        else:
            d["compute_s"] += dur_s
            if iv is not None:
                comp_iv.setdefault(lane, []).append(iv)
    for lane, d in devices.items():
        d["overlap_s"] = _interval_overlap_s(
            coll_iv.get(lane, []), comp_iv.get(lane, []))
    return _finalize_attribution(devices, top)


def analyze_profile_dir(profile_dir: str,
                        modeled_bytes: Optional[float] = None
                        ) -> Dict[str, Any]:
    """Fold every trace file under ``profile_dir`` into one summary.

    ``modeled_bytes`` (the wire model's per-device payload of one
    aggregation) turns the measured collective seconds into achieved
    wire GB/s — the modeled-vs-achieved bandwidth the analyzer reports.
    A dir with no trace files returns ``{"present": False}`` (the
    cost-analysis fallback's cue). ``kernels`` ranks every compute kernel
    of the traces by its total seconds (``name``, ``total_s``,
    ``count``), untruncated: a short kernel launched once a round is
    named too."""
    files = find_trace_files(profile_dir)
    out: Dict[str, Any] = {"present": False, "files": len(files),
                           "profile_dir": profile_dir}
    if not files:
        return out
    devices: Dict[str, Dict[str, float]] = {}
    top: Dict[str, Dict[str, float]] = {}
    compute: Dict[str, Dict[str, float]] = {}
    for path in files:
        try:
            doc = load_trace_doc(path)
            att = attribute_trace(doc)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            logger.warning("unreadable trace %s: %s", path, e)
            continue
        for name, t in _compute_kernels(doc).items():
            c = compute.setdefault(name, {"total_s": 0.0, "count": 0})
            c["total_s"] += t["total_s"]
            c["count"] += t["count"]
        for lane, d in att["devices"].items():
            agg = devices.setdefault(
                lane, {k: 0.0 for k in _LANE_KEYS})
            for k in _LANE_KEYS:
                agg[k] += d.get(k, 0.0)
        for t in att["top_collectives"]:
            e2 = top.setdefault(t["name"], {"total_s": 0.0, "count": 0})
            e2["total_s"] += t["total_s"]
            e2["count"] += t["count"]
    if not devices:
        return out
    folded = _finalize_attribution(devices, top, top_k=10)
    out.update(present=True, **folded)
    out["kernels"] = [{"name": k, "total_s": v["total_s"],
                       "count": int(v["count"])}
                      for k, v in sorted(compute.items(),
                                         key=lambda kv: (-kv[1]["total_s"],
                                                         kv[0]))]
    totals = folded["totals"]
    if modeled_bytes is not None:
        out["modeled_bytes"] = float(modeled_bytes)
        # achieved per-device wire bandwidth: the collective seconds
        # are summed over lanes, so divide by lanes to keep the model's
        # per-device basis
        per_dev_s = totals["collective_s"] / max(len(devices), 1)
        if per_dev_s > 0:
            out["achieved_gbps"] = float(modeled_bytes) / per_dev_s / 1e9
    return out


def share_from_cost_analysis(agg_cost: Dict[str, Any],
                             round_cost: Dict[str, Any]) -> Dict[str, Any]:
    """The no-trace fallback: estimate the aggregation's round share
    from counted costs (``obs.compile.agg_cost_analysis`` of the
    aggregation, and the whole round's). Bytes-accessed is
    preferred (aggregation is memory/wire-bound); FLOPs is the coarser
    second choice; neither reported -> ``{"present": False}``."""
    for basis in ("bytes_accessed", "flops"):
        a = agg_cost.get(basis)
        r = round_cost.get(basis)
        if isinstance(a, (int, float)) and isinstance(r, (int, float)) \
                and r > 0:
            return {"present": True, "basis": basis,
                    "agg_share_est": min(1.0, float(a) / float(r))}
    return {"present": False}


def write_summary(summary: Dict[str, Any], path: str) -> str:
    """Write a devtrace summary sidecar (``<identity>.devtrace.json``
    beside the JSONL stream — where the analyzer looks)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    return path
