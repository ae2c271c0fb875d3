"""Static HTML fleet report over the run catalog — byte-deterministic (a
copy of ``neuroimagedisttraining_tpu/obs/report.py``: the same bytes on
the same inputs).

``obs report`` renders one self-contained HTML file (inline CSS +
SVG, zero external assets, zero JS dependencies) summarizing every
cataloged run:

* per-run rows with identity, lineage keys, final-metrics snapshot,
  end run-health, and event counts;
* metric SPARKLINES (inline SVG) read from each run's round stream;
* health/event TIMELINES: one colored cell per round from the
  ``slo_health`` stamps, event markers from the events stream;
* the WIRE-COST table from the ``comm_*`` stamps (obs/comm.py's
  analytical model) of each run that recorded them;
* FEDERATION LANES: every federation run dir under the results dir
  (a subdir holding ``aggregator.jsonl`` + ``site<k>.jsonl``
  per-process streams — these live outside the catalog) renders one
  row per process: rounds, loss/wall sparklines, straggle counts,
  and whether a clock-aligned ``federation.trace.json`` was merged;
* a cross-run SCATTER (rounds/sec vs cohort size) from the bench
  history (the port's ``results/bench_torch_history.jsonl`` by default,
  ``obs report --history``).

The report is a PURE function of its inputs: no timestamps (the
events-stream convention), every iteration sorted, every float
formatted through one deterministic formatter — two generations over
the same catalog are byte-identical (``chip_smoke.py``'s ``offline``
phase pins it on the card's artifacts). That is what makes the report
diffable and cacheable: a changed byte means a changed fleet."""
from __future__ import annotations

import html as _html
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from .catalog import read_catalog
from .export import dedupe_rounds, read_jsonl

__all__ = [
    "REPORT_SCHEMA_VERSION", "build_report", "find_fed_dirs",
    "load_fed_lanes", "load_runs", "scatter_points", "write_report",
]

#: stamped in the report header (a report consumer's compat check)
REPORT_SCHEMA_VERSION = 1

#: sparkline metrics, in render order
SPARK_METRICS = ("train_loss", "global_acc", "personal_acc")

#: wire-cost table columns: catalog/record key -> column header
WIRE_COLUMNS = (
    ("comm_bytes_wire", "wire bytes/round"),
    ("comm_density", "density"),
    ("comm_n_params", "params"),
    ("comm_n_devices", "devices"),
)

_HEALTH_COLORS = {"ok": "#2da44e", "degraded": "#d4a72c",
                  "failing": "#cf222e", "": "#d0d7de"}


def _fmt(v: Any) -> str:
    """One deterministic scalar formatter for every number in the
    report (repr drift between generations would break byte
    identity)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return format(v, ".6g")
    return _html.escape(str(v), quote=True)


def _sparkline(values: List[float], width: int = 140,
               height: int = 28) -> str:
    """Inline-SVG sparkline of one metric series (empty string when
    nothing to draw)."""
    pts = [v for v in values if v == v]  # NaN never plots
    if len(pts) < 2:
        return ""
    lo, hi = min(pts), max(pts)
    span = (hi - lo) or 1.0
    n = len(values)
    coords = []
    for i, v in enumerate(values):
        if v != v:
            continue
        x = (width - 2) * i / (n - 1) + 1
        y = height - 2 - (height - 4) * (v - lo) / span
        coords.append(f"{x:.1f},{y:.1f}")
    return (f'<svg class="spark" width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<polyline fill="none" stroke="#0969da" '
            f'stroke-width="1.2" points="{" ".join(coords)}"/></svg>')


def _timeline(records: List[Dict[str, Any]],
              event_rounds: Dict[int, str]) -> str:
    """One cell per round, colored by the run-health stamp; rounds
    with events carry the event types in the cell title."""
    cells = []
    for rec in records:
        r = rec.get("round")
        if not isinstance(r, int) or r < 0:
            continue
        h = rec.get("slo_health")
        color = _HEALTH_COLORS.get(h if isinstance(h, str) else "",
                                   _HEALTH_COLORS[""])
        title = f"round {r}" + (f": {h}" if isinstance(h, str) else "")
        mark = ""
        if r in event_rounds:
            title += " [" + event_rounds[r] + "]"
            mark = ' class="ev"'
        cells.append(f'<i{mark} style="background:{color}" '
                     f'title="{_html.escape(title, quote=True)}"></i>')
    return ('<span class="tl">' + "".join(cells) + "</span>") \
        if cells else ""


def load_runs(entries: List[Dict[str, Any]]
              ) -> Dict[str, Dict[str, Any]]:
    """Per-entry stream data for the sparkline/timeline columns, keyed
    by ``dataset/identity``. Missing or unreadable artifacts degrade
    to an empty run (the catalog line still renders)."""
    out: Dict[str, Dict[str, Any]] = {}
    for e in entries:
        key = f"{e.get('dataset', '')}/{e.get('identity', '')}"
        arts = e.get("artifacts") or {}
        records: List[Dict[str, Any]] = []
        events: List[Dict[str, Any]] = []
        jsonl = arts.get("obs_jsonl", "")
        if jsonl and os.path.exists(jsonl):
            try:
                records = dedupe_rounds(
                    read_jsonl(jsonl, allow_partial_tail=True))
            except ValueError:
                records = []
        ev_path = arts.get("events_jsonl", "")
        if ev_path and os.path.exists(ev_path):
            try:
                events = read_jsonl(ev_path, allow_partial_tail=True)
            except ValueError:
                events = []
        out[key] = {"records": records, "events": events}
    return out


def find_fed_dirs(results_dir: str) -> List[str]:
    """Federation run dirs under ``results_dir``: immediate subdirs
    holding an ``aggregator.jsonl`` per-process stream (these runs
    live outside the catalog — their streams are plain ``.jsonl``,
    one per process). Sorted, so the report stays deterministic."""
    if not results_dir or not os.path.isdir(results_dir):
        return []
    out = []
    for name in sorted(os.listdir(results_dir)):
        d = os.path.join(results_dir, name)
        if os.path.isdir(d) and \
                os.path.exists(os.path.join(d, "aggregator.jsonl")):
            out.append(d)
    return out


def load_fed_lanes(fed_dir: str) -> Dict[str, Any]:
    """One federation run dir's per-process lanes (aggregator +
    every site), plus whether the clock-aligned merged trace exists.
    Unreadable streams degrade to empty lanes."""
    lanes = []
    for fname in sorted(os.listdir(fed_dir)):
        if not fname.endswith(".jsonl") or \
                fname.endswith(".events.jsonl") or \
                fname == "federation.jsonl":
            continue
        stem = fname[:-len(".jsonl")]
        if stem != "aggregator" and not stem.startswith("site"):
            continue
        try:
            records = read_jsonl(os.path.join(fed_dir, fname),
                                 allow_partial_tail=True)
        except (OSError, ValueError):
            records = []
        lanes.append({"process": stem, "records": records})
    return {
        "dir": fed_dir, "lanes": lanes,
        "traced": os.path.exists(
            os.path.join(fed_dir, "federation.trace.json")),
    }


def _fed_lane_rows(fed: Dict[str, Any]) -> List[str]:
    rows = []
    for lane in fed["lanes"]:
        recs = [r for r in lane["records"]
                if isinstance(r.get("round"), int)
                and r["round"] >= 0]
        loss = [float(r["train_loss"]) for r in recs
                if isinstance(r.get("train_loss"), (int, float))]
        wall = [float(r["wall_s"]) for r in recs
                if isinstance(r.get("wall_s"), (int, float))]
        straggles = sum(1 for r in recs if r.get("fed_straggled"))
        cells = [
            f"<td><code>{_html.escape(lane['process'], quote=True)}"
            "</code></td>",
            f"<td>{len(recs)}</td>",
            f"<td>{_sparkline(loss) or '—'}</td>",
            f"<td>{_sparkline(wall) or '—'}</td>",
            f"<td>{straggles or '—'}</td>",
        ]
        rows.append("<tr>" + "".join(cells) + "</tr>")
    return rows


def scatter_points(history: List[Dict[str, Any]]
                   ) -> List[Tuple[str, int, float]]:
    """(metric, cohort size, rounds/sec) points from the bench
    history: every ``*rounds_per_sec*`` metric whose name carries a
    ``_<N>clients`` cohort tag, keep-last per metric (the history is
    append-only), sorted."""
    last: Dict[str, Tuple[str, int, float]] = {}
    for rec in history:
        metric = str(rec.get("metric", ""))
        v = rec.get("value")
        if "rounds_per_sec" not in metric or \
                not isinstance(v, (int, float)):
            continue
        m = re.search(r"_(\d+)clients", metric)
        if not m:
            continue
        last[metric] = (metric, int(m.group(1)), float(v))
    return [last[k] for k in sorted(last)]


def _scatter_svg(points: List[Tuple[str, int, float]],
                 width: int = 420, height: int = 220) -> str:
    if not points:
        return "<p>no rounds/sec bench points with a cohort tag</p>"
    xs = [p[1] for p in points]
    ys = [p[2] for p in points]
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = min(ys), max(ys)
    x_span = (x_hi - x_lo) or 1
    y_span = (y_hi - y_lo) or 1.0
    dots = []
    for metric, x, y in points:
        px = 40 + (width - 60) * (x - x_lo) / x_span
        py = height - 30 - (height - 50) * (y - y_lo) / y_span
        dots.append(
            f'<circle cx="{px:.1f}" cy="{py:.1f}" r="4" '
            f'fill="#0969da" fill-opacity="0.7">'
            f'<title>{_html.escape(metric, quote=True)}: '
            f'{x} clients, {_fmt(y)} rounds/s</title></circle>')
    return (
        f'<svg width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}">'
        f'<line x1="40" y1="{height - 30}" x2="{width - 10}" '
        f'y2="{height - 30}" stroke="#6e7781"/>'
        f'<line x1="40" y1="10" x2="40" y2="{height - 30}" '
        f'stroke="#6e7781"/>'
        f'<text x="{width // 2}" y="{height - 8}" class="ax">'
        f'cohort size (clients): {x_lo} .. {x_hi}</text>'
        f'<text x="12" y="{height // 2}" class="ax" '
        f'transform="rotate(-90 12 {height // 2})">rounds/sec: '
        f'{_fmt(y_lo)} .. {_fmt(y_hi)}</text>'
        + "".join(dots) + "</svg>")


_CSS = """
body{font:13px/1.45 -apple-system,'Segoe UI',sans-serif;margin:24px;
     color:#1f2328}
h1{font-size:20px}h2{font-size:15px;margin-top:28px}
table{border-collapse:collapse;width:100%}
th,td{border:1px solid #d0d7de;padding:4px 8px;text-align:left;
      vertical-align:middle}
th{background:#f6f8fa}
code{background:#f6f8fa;padding:1px 4px;border-radius:3px;
     font-size:12px}
.tl i{display:inline-block;width:7px;height:14px;margin-right:1px}
.tl i.ev{outline:1.5px solid #1f2328}
.ax{font-size:11px;fill:#57606a}
.muted{color:#57606a}
svg.spark{vertical-align:middle}
"""


def build_report(entries: List[Dict[str, Any]],
                 runs: Optional[Dict[str, Dict[str, Any]]] = None,
                 history: Optional[List[Dict[str, Any]]] = None,
                 fed_runs: Optional[List[Dict[str, Any]]] = None
                 ) -> str:
    """The full fleet report HTML (a pure function of its inputs —
    the byte-determinism contract)."""
    runs = runs if runs is not None else load_runs(entries)
    history = history or []
    rows = []
    wire_rows = []
    for e in entries:
        key = f"{e.get('dataset', '')}/{e.get('identity', '')}"
        data = runs.get(key) or {"records": [], "events": []}
        records = data["records"]
        ev_rounds: Dict[int, str] = {}
        for ev in data["events"]:
            r = ev.get("round")
            if isinstance(r, int) and r >= 0:
                t = str(ev.get("event_type", "?"))
                ev_rounds[r] = (ev_rounds[r] + "," + t) \
                    if r in ev_rounds else t
        sparks = []
        for metric in SPARK_METRICS:
            series = [float(rec[metric]) for rec in records
                      if isinstance(rec.get("round"), int)
                      and rec["round"] >= 0
                      and isinstance(rec.get(metric), (int, float))]
            svg = _sparkline(series)
            if svg:
                sparks.append(
                    f'<div><span class="muted">{metric}</span> '
                    f'{svg}</div>')
        finals = e.get("final_metrics") or {}
        final_txt = ", ".join(f"{k}={_fmt(v)}"
                              for k, v in sorted(finals.items()))
        counts = e.get("event_counts") or {}
        counts_txt = ", ".join(f"{k}:{_fmt(v)}"
                               for k, v in sorted(counts.items()))
        health = str(e.get("slo_health", ""))
        health_cell = (
            f'<b style="color:{_HEALTH_COLORS.get(health, "#57606a")}">'
            f'{health.upper() or "—"}</b>')
        rows.append(
            "<tr>"
            f"<td><code>{_html.escape(key, quote=True)}</code>"
            f'<br><span class="muted">algo {_fmt(e.get("algo", ""))}'
            f' · sha {_fmt((e.get("git_sha") or "")[:12]) or "?"}'
            f' · schema v{_fmt(e.get("obs_schema_version", 1))}'
            + ("" if e.get("completed") else " · INCOMPLETE")
            + "</span></td>"
            f"<td>{_fmt(e.get('rounds_recorded', 0))}</td>"
            f"<td>{health_cell}</td>"
            f"<td>{''.join(sparks) or '—'}</td>"
            f"<td>{_timeline(records, ev_rounds) or '—'}</td>"
            f'<td><span class="muted">{final_txt or "—"}</span>'
            + (f'<br><span class="muted">events: {counts_txt}</span>'
               if counts_txt else "")
            + "</td></tr>")
        # wire-cost table: the last record carrying the static comm_*
        # stamps speaks for the run
        comm_rec = None
        for rec in records:
            if any(k for k in rec if k.startswith("comm_")):
                comm_rec = rec
        if comm_rec is not None:
            cells = "".join(
                f"<td>{_fmt(comm_rec.get(k, '—'))}</td>"
                for k, _ in WIRE_COLUMNS)
            agg = (e.get("flags") or {}).get("agg_impl", "")
            wire_rows.append(
                f"<tr><td><code>{_html.escape(key, quote=True)}"
                f"</code></td><td>{_fmt(agg)}</td>{cells}</tr>")
    points = scatter_points(history)
    parts = [
        "<!DOCTYPE html>",
        '<html lang="en"><head><meta charset="utf-8">',
        "<title>fleet report</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>Fleet report <span class='muted'>(catalog of "
        f"{len(entries)} run(s), report schema "
        f"v{REPORT_SCHEMA_VERSION})</span></h1>",
        "<h2>Runs</h2>",
        "<table><tr><th>run</th><th>rounds</th><th>health</th>"
        "<th>sparklines</th><th>health/event timeline</th>"
        "<th>final metrics</th></tr>",
        "".join(rows) or
        '<tr><td colspan="6">no cataloged runs</td></tr>',
        "</table>",
        "<h2>Wire cost (obs.comm model)</h2>",
    ]
    if wire_rows:
        parts.append(
            "<table><tr><th>run</th><th>agg_impl</th>"
            + "".join(f"<th>{h}</th>" for _, h in WIRE_COLUMNS)
            + "</tr>" + "".join(wire_rows) + "</table>")
    else:
        parts.append('<p class="muted">no runs recorded comm_* '
                     "telemetry (--obs_comm)</p>")
    if fed_runs:
        parts.append("<h2>Federation lanes "
                     '<span class="muted">(per-process streams '
                     "under the fed run dirs)</span></h2>")
        for fed in fed_runs:
            base = os.path.basename(fed["dir"].rstrip("/"))
            parts.append(
                f"<p><code>{_html.escape(base, quote=True)}</code>"
                + (' <span class="muted">· clock-aligned merged '
                   "trace (federation.trace.json)</span>"
                   if fed.get("traced") else "")
                + "</p>")
            rows = _fed_lane_rows(fed)
            parts.append(
                "<table><tr><th>process</th><th>rounds</th>"
                "<th>train_loss</th><th>wall_s</th>"
                "<th>straggles</th></tr>"
                + ("".join(rows)
                   or '<tr><td colspan="5">no lanes</td></tr>')
                + "</table>")
    parts.append("<h2>Rounds/sec vs cohort size "
                 '<span class="muted">(bench history)</span></h2>')
    parts.append(_scatter_svg(points))
    parts.append("</body></html>")
    return "\n".join(parts) + "\n"


def write_report(out_path: str, catalog: str,
                 history_path: str = "",
                 results_dir: str = "") -> str:
    """Read the catalog (+ optional bench history + federation run
    dirs under ``results_dir``, default: the catalog's own dir),
    render, write. Returns ``out_path``."""
    entries = read_catalog(catalog)
    history: List[Dict[str, Any]] = []
    if history_path and os.path.exists(history_path):
        try:
            history = read_jsonl(history_path, allow_partial_tail=True)
        except ValueError:
            history = []
    results_dir = results_dir or (os.path.dirname(catalog) or ".")
    fed_runs = [load_fed_lanes(d) for d in find_fed_dirs(results_dir)]
    html_text = build_report(entries, history=history,
                             fed_runs=fed_runs)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    # newline-normalized binary write: byte-identical across
    # platforms and generations
    with open(out_path, "wb") as f:
        f.write(html_text.encode("utf-8"))
    return out_path
