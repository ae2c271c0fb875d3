"""Cross-process causal tracing: context over ``Message`` headers,
per-process span streams, clock-aligned merge (the port's own copy of
``neuroimagedisttraining_tpu/obs/xtrace.py``).

Dapper-style propagation for the federation and serving planes. The
time authority (the aggregator, or the checkpoint publisher) mints a
:class:`TraceContext` per round and :func:`inject`\\ s it into the
control-plane params of every TRAIN/UPDATE/FINISH/push frame; each
process runs its own :class:`XTracer` whose spans carry explicit ids
(``span_id``/``parent``/``trace``) so the per-process streams link
into ONE causal round tree after :func:`merge_docs`.

Three contracts this module is built around:

* **Byte-inert off.** Headers are added only by explicit
  :func:`inject` calls, which every call site gates on its tracer
  being non-None (``--xtrace 0`` ⇒ no ``xt_*`` key ever enters
  ``Message.params`` ⇒ identical wire bytes). :func:`extract`
  tolerates absent headers — old traces and untraced peers read
  cleanly as ``None``.
* **Deterministic structure.** Span ids are ``"<process>:<seq>"``
  from a per-tracer counter and trace ids are minted from round
  indices, so twin runs produce identical ids and
  :func:`structure_of` (counts, types, parentage — timestamps
  erased) compares them directly. Wall-clock values are volatile and
  live only in ``ts``/``dur``/arg fields the structure view drops.
* **Deterministic merge.** :func:`merge_docs` is a pure function of
  its input documents: offsets come from the recorded HELLO
  estimates, lanes from the sorted process names, the timebase from
  the minimum aligned timestamp — same per-process streams in, byte-
  identical ``federation.trace.json`` out (pinned by
  ``tests/test_xtrace.py``).

Clock alignment uses the classic NTP midpoint over the HELLO/ACK
handshake (``fed/protocol.py``): initiator stamps ``t0``, the peer
echoes it with its own ``t1``, the initiator reads ``t2`` on the ACK
— ``offset = t1 - (t0 + t2) / 2`` (peer clock minus local clock),
``rtt = t2 - t0``. Each tracer's wall clock is its creation-time
epoch plus a ``perf_counter_ns`` delta, so a mid-run NTP step never
tears a stream.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "HDR_SEND_NS", "HDR_SPAN", "HDR_TRACE", "MERGED_TRACE_NAME",
    "TraceContext", "XTRACE_SCHEMA_VERSION", "XTracer", "extract",
    "inject", "load_doc", "merge_docs", "merge_run_dir", "ntp_offset",
    "send_wall_ns", "span_index", "stream_paths", "structure_of",
    "validate_parentage", "xspan",
]

XTRACE_SCHEMA_VERSION = 1

#: control-plane header keys (``Message.params``). Added ONLY by
#: :func:`inject`; their absence is the tracing-off wire contract.
HDR_TRACE = "xt_trace"
HDR_SPAN = "xt_span"
HDR_SEND_NS = "xt_send_ns"

#: the merged, Perfetto-loadable artifact every run dir converges on
MERGED_TRACE_NAME = "federation.trace.json"

#: per-process stream suffix (lands beside the per-site JSONL)
STREAM_SUFFIX = ".xtrace.json"


class TraceContext(NamedTuple):
    """What crosses the wire: the round's tree id and the sender's
    span id (the receiver's parent)."""

    trace_id: str
    span_id: str


def inject(msg, ctx: TraceContext,
           wall_ns: Optional[int] = None) -> None:
    """Stamp a context (+ the sender's wall clock, for wire-time and
    adopt-lag estimates) onto a message's control-plane params. Call
    sites gate on tracing being enabled — this function is what the
    byte-inert contract counts."""
    msg.add(HDR_TRACE, ctx.trace_id)
    msg.add(HDR_SPAN, ctx.span_id)
    msg.add(HDR_SEND_NS, int(wall_ns if wall_ns is not None
                             else time.time_ns()))


def extract(msg) -> Optional[TraceContext]:
    """The absent-tolerant read: ``None`` for untraced frames (old
    peers, tracing off) — never a KeyError."""
    t = msg.get(HDR_TRACE, None)
    s = msg.get(HDR_SPAN, None)
    if not t or not s:
        return None
    return TraceContext(str(t), str(s))


def send_wall_ns(msg) -> Optional[int]:
    v = msg.get(HDR_SEND_NS, None)
    return int(v) if isinstance(v, (int, float)) else None


def ntp_offset(t0_ns: int, t1_ns: int, t2_ns: int) -> Tuple[float, float]:
    """``(offset_ns, rtt_ns)`` from one HELLO/ACK round trip: offset is
    the PEER clock minus the initiator clock (NTP midpoint), rtt the
    full loop."""
    rtt = float(t2_ns - t0_ns)
    offset = float(t1_ns) - (float(t0_ns) + float(t2_ns)) / 2.0
    return offset, rtt


class _NullXSpan:
    """No-op twin for tracer-less call sites (``xspan(None, ...)``):
    the instrumented code path is identical whether tracing is on."""

    span_id = ""
    trace_id = ""

    def __enter__(self) -> "_NullXSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, **kw) -> None:
        return None

    def ctx(self) -> Optional[TraceContext]:
        return None


_NULL_XSPAN = _NullXSpan()


class XSpan:
    """One id-bearing span (context manager). ``parent``/``trace``
    default to the tracer's thread-local current span, so nested
    ``with`` blocks build the tree without explicit threading."""

    __slots__ = ("_tracer", "name", "span_id", "parent", "trace_id",
                 "_args", "_t0_perf", "_t0_wall")

    def __init__(self, tracer: "XTracer", name: str,
                 trace_id: Optional[str], parent: Optional[str],
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.span_id = tracer._next_id()
        self.parent = parent
        self.trace_id = trace_id
        self._args = dict(args) if args else {}
        self._t0_perf = 0
        self._t0_wall = 0

    def __enter__(self) -> "XSpan":
        cur = self._tracer._current()
        if self.parent is None and cur is not None:
            self.parent = cur.span_id
        if self.trace_id is None:
            self.trace_id = cur.trace_id if cur is not None else ""
        self._tracer._push(self)
        self._t0_wall = self._tracer.wall_ns()
        self._t0_perf = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dur_ns = time.perf_counter_ns() - self._t0_perf
        self._tracer._pop()
        self._tracer._emit(self, self._t0_wall, dur_ns)

    def add(self, **kw: Any) -> None:
        self._args.update(kw)

    def ctx(self) -> TraceContext:
        """The context a frame sent from inside this span carries."""
        return TraceContext(self.trace_id or "", self.span_id)


def xspan(tracer: Optional["XTracer"], name: str,
          trace_id: Optional[str] = None, parent: Optional[str] = None,
          args: Optional[Dict[str, Any]] = None):
    """Span-or-null: the one helper every instrumented call site uses,
    so tracing-off costs a None check and nothing else."""
    if tracer is None:
        return _NULL_XSPAN
    return XSpan(tracer, name, trace_id, parent, args)


class XTracer:
    """Per-process id-bearing span recorder.

    ``process`` names the lane (``aggregator``, ``site3``,
    ``publisher``, ``serve_worker``); ``ref`` names the process whose
    clock the merge aligns everything to. ``offset_ns`` is THIS
    process's clock minus the reference clock (0 on the reference
    itself, estimated at HELLO elsewhere); a reference-side tracer may
    instead carry the whole fleet's offsets in ``offsets_ns``
    (peer process name -> peer clock minus reference clock).
    """

    def __init__(self, process: str, ref: str = "",
                 max_spans: int = 200_000):
        self.process = str(process)
        self.ref = str(ref) or self.process
        self.offset_ns: float = 0.0
        self.offsets_ns: Dict[str, float] = {}
        self.hello: Dict[str, Dict[str, float]] = {}
        self._epoch_wall_ns = time.time_ns()
        self._epoch_perf_ns = time.perf_counter_ns()
        self._max_spans = int(max_spans)
        self._dropped = 0
        self._lock = threading.Lock()
        self._seq = 0
        self._spans: List[Dict[str, Any]] = []
        self._tls = threading.local()

    # -- clock ------------------------------------------------------------
    def wall_ns(self) -> int:
        """Monotonic wall clock: creation-time epoch + perf delta (an
        NTP step mid-run cannot tear the stream)."""
        return self._epoch_wall_ns + (time.perf_counter_ns()
                                      - self._epoch_perf_ns)

    def note_offset(self, peer: str, offset_ns: float,
                    rtt_ns: float) -> None:
        """Record one HELLO estimate (reference side: peer->offset).
        Overwrites: a re-handshake (``fed/aggregator.py`` re-initiates
        every ``CLOCK_RESYNC_EVERY`` rounds) replaces the stale
        estimate, and the ``hellos`` counter lets ``merge_docs`` pick
        the freshest table when several streams carry one peer."""
        prev = self.hello.get(str(peer))
        hellos = (float(prev.get("hellos", 1.0)) if prev else 0.0) + 1.0
        self.offsets_ns[str(peer)] = float(offset_ns)
        self.hello[str(peer)] = {"offset_ns": float(offset_ns),
                                 "rtt_ns": float(rtt_ns),
                                 "hellos": hellos}

    def to_ref_ns(self, wall_ns: float, peer: str = "") -> float:
        """A wall timestamp mapped onto the reference clock: the
        caller's own (``peer=""``, uses ``offset_ns``) or a known
        peer's (uses the ``offsets_ns`` estimate)."""
        off = self.offsets_ns.get(peer, 0.0) if peer else self.offset_ns
        return float(wall_ns) - off

    # -- spans ------------------------------------------------------------
    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self.process}:{self._seq}"

    def _stack(self) -> List[XSpan]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _current(self) -> Optional[XSpan]:
        st = self._stack()
        return st[-1] if st else None

    def _push(self, span: XSpan) -> None:
        self._stack().append(span)

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def _emit(self, span: XSpan, t0_wall_ns: int, dur_ns: int) -> None:
        with self._lock:
            if len(self._spans) >= self._max_spans:
                self._dropped += 1
                return
            self._spans.append({
                "name": span.name,
                "span_id": span.span_id,
                "parent": span.parent or "",
                "trace": span.trace_id or "",
                "t0_ns": int(t0_wall_ns),
                "dur_ns": int(dur_ns),
                "args": dict(span._args),
            })

    def span(self, name: str, trace_id: Optional[str] = None,
             parent: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None) -> XSpan:
        return XSpan(self, name, trace_id, parent, args)

    @property
    def n_spans(self) -> int:
        with self._lock:
            return len(self._spans)

    # -- export -----------------------------------------------------------
    def to_doc(self) -> Dict[str, Any]:
        """The per-process Chrome-trace stream: ``ph:"X"`` complete
        events in µs on THIS process's wall clock, ids in ``args``,
        the alignment metadata under the ``xtrace`` key."""
        with self._lock:
            spans = [dict(s) for s in self._spans]
            dropped = self._dropped
        events = []
        for s in spans:
            args = {"span_id": s["span_id"], "trace": s["trace"]}
            if s["parent"]:
                args["parent"] = s["parent"]
            args.update(s["args"])
            events.append({
                "name": s["name"], "ph": "X",
                "ts": s["t0_ns"] / 1e3, "dur": s["dur_ns"] / 1e3,
                "pid": 0, "tid": 0, "args": args,
            })
        meta: Dict[str, Any] = {
            "schema": XTRACE_SCHEMA_VERSION,
            "process": self.process,
            "ref": self.ref,
            "offset_ns": self.offset_ns,
            "offsets_ns": dict(self.offsets_ns),
            "hello": {k: dict(v) for k, v in self.hello.items()},
            "epoch_ns": self._epoch_wall_ns,
        }
        if dropped:
            meta["dropped_spans"] = dropped
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "xtrace": meta}

    def write(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, sort_keys=True)
            f.write("\n")
        return path


# -- merge ----------------------------------------------------------------

def load_doc(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def stream_paths(run_dir: str) -> List[str]:
    """The per-process streams under a run dir, sorted (the merge's
    deterministic input order)."""
    return sorted(glob.glob(os.path.join(run_dir,
                                         "*" + STREAM_SUFFIX)))


def merge_docs(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-process streams into one Perfetto-loadable document.

    Pure function of the inputs: lanes are the sorted process names,
    every stream's timestamps shift by its recorded clock offset onto
    the reference clock, the merged timebase starts at the minimum
    aligned timestamp, and events sort by ``(ts, pid, span_id)`` —
    identical inputs produce identical bytes.
    """
    by_proc: Dict[str, Dict[str, Any]] = {}
    offsets: Dict[str, float] = {}
    fresh: Dict[str, float] = {}
    refs: List[str] = []
    for doc in docs:
        meta = doc.get("xtrace") or {}
        proc = str(meta.get("process", "")) or f"p{len(by_proc)}"
        by_proc[proc] = doc
        refs.append(str(meta.get("ref", proc)))
        off = meta.get("offset_ns", 0.0)
        if isinstance(off, (int, float)) and off:
            # a process's OWN estimate always beats a fleet table's
            offsets[proc] = float(off)
            fresh[proc] = float("inf")
        # a reference-side stream may carry the fleet's offsets; the
        # FRESHEST estimate per peer wins (the ``hellos`` re-handshake
        # counter — long runs re-sync so drift does not accumulate
        # into the lane alignment)
        hello = meta.get("hello") or {}
        for peer, o in (meta.get("offsets_ns") or {}).items():
            if not isinstance(o, (int, float)):
                continue
            peer = str(peer)
            n = float((hello.get(peer) or {}).get("hellos", 1.0))
            if peer not in offsets or n > fresh.get(peer, 0.0):
                offsets[peer] = float(o)
                fresh[peer] = n
    procs = sorted(by_proc)
    aligned: List[Tuple[float, int, str, Dict[str, Any]]] = []
    for pid, proc in enumerate(procs):
        shift_us = offsets.get(proc, 0.0) / 1e3
        for ev in by_proc[proc].get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            ev = dict(ev)
            ev["pid"] = pid
            ev["tid"] = 0
            ev["ts"] = float(ev.get("ts", 0.0)) - shift_us
            args = ev.get("args") or {}
            sid = str(args.get("span_id", ""))
            aligned.append((ev["ts"], pid, sid, ev))
    t0 = min((t for t, _, _, _ in aligned), default=0.0)
    events: List[Dict[str, Any]] = []
    for pid, proc in enumerate(procs):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": proc}})
    aligned.sort(key=lambda e: (e[0], e[1], e[2]))
    for ts, _, _, ev in aligned:
        ev["ts"] = ts - t0
        events.append(ev)
    hello = {}
    for proc in procs:
        meta = by_proc[proc].get("xtrace") or {}
        for peer, h in (meta.get("hello") or {}).items():
            hello[str(peer)] = dict(h)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "xtrace": {
            "schema": XTRACE_SCHEMA_VERSION,
            "merged": True,
            "processes": procs,
            "ref": sorted(set(refs))[0] if refs else "",
            "offsets_ns": {k: offsets[k] for k in sorted(offsets)},
            "hello": {k: hello[k] for k in sorted(hello)},
        },
    }


def write_merged(doc: Dict[str, Any], path: str) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = json.dumps(doc, sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.write(payload)
    return path


def merge_run_dir(run_dir: str,
                  out_name: str = MERGED_TRACE_NAME) -> Optional[str]:
    """Merge every ``*.xtrace.json`` under ``run_dir`` into
    ``federation.trace.json`` (``None`` when there are no streams)."""
    paths = stream_paths(run_dir)
    if not paths:
        return None
    doc = merge_docs([load_doc(p) for p in paths])
    return write_merged(doc, os.path.join(run_dir, out_name))


# -- analysis helpers ------------------------------------------------------

def span_index(doc: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``span_id -> event`` over a (merged or per-process) document."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        sid = str((ev.get("args") or {}).get("span_id", ""))
        if sid:
            out[sid] = ev
    return out


def validate_parentage(doc: Dict[str, Any]) -> List[str]:
    """Span ids whose recorded parent is missing from the document —
    empty means the causal tree is closed (the smoke's gate)."""
    idx = span_index(doc)
    orphans = []
    for sid, ev in sorted(idx.items()):
        parent = str((ev.get("args") or {}).get("parent", ""))
        if parent and parent not in idx:
            orphans.append(sid)
    return orphans


def structure_of(doc: Dict[str, Any]) -> Dict[str, Any]:
    """The deterministic, twin-comparable view of a trace: span
    counts by name, parentage edges by (parent name -> child name),
    distinct trace ids — every volatile field (timestamps, durations,
    pids) erased."""
    idx = span_index(doc)
    names: Dict[str, int] = {}
    edges: Dict[str, int] = {}
    traces = set()
    for sid in sorted(idx):
        ev = idx[sid]
        args = ev.get("args") or {}
        name = str(ev.get("name", ""))
        names[name] = names.get(name, 0) + 1
        parent = str(args.get("parent", ""))
        pname = str(idx[parent].get("name", "")) if parent in idx \
            else ""
        edge = f"{pname}>{name}"
        edges[edge] = edges.get(edge, 0) + 1
        t = str(args.get("trace", ""))
        if t:
            traces.add(t)
    return {
        "n_spans": len(idx),
        "names": {k: names[k] for k in sorted(names)},
        "edges": {k: edges[k] for k in sorted(edges)},
        "traces": sorted(traces),
    }
