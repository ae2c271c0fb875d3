"""Telemetry analysis CLI (counterpart of
``neuroimagedisttraining_tpu/obs/__main__.py``: the same nine
subcommands, arguments, output and exit codes).

    # analyze every recorded run under a run dir (the
    # <results_dir>/<dataset> directory holding *.obs.jsonl streams):
    # prints the human report, writes <identity>.analysis.json beside
    # each stream
    python -m neuroimagedisttraining_torch.obs analyze results/synthetic \
        [--trace-dir /tmp/trace] [--no-write] [--json]

    # live-tail a running (or finished) run's per-round JSONL: one
    # formatted line per round as it lands — round time, agg share,
    # run-health state + last event (--slo_spec runs), and the
    # guard/watchdog/drift events; --events follows the typed
    # <identity>.events.jsonl stream instead
    python -m neuroimagedisttraining_torch.obs tail results/synthetic \
        [--identity <run-identity>] [--poll 0.5] [--once] [--events]

    # offline SLO replay: re-evaluate a recorded run's round stream
    # through the engine (bit-identical to the in-run verdicts), or
    # judge a pre-SLO run against a spec after the fact
    python -m neuroimagedisttraining_torch.obs slo results/synthetic \
        [--slo_spec 'p99:round_time_s<2.5@w=20'] [--enforce] [--json]

    # regression-gate a value against the port's bench history
    # (bench_torch.py appends to it); with no history it exits 2 — the
    # JAX package's committed BENCH_r*/MULTICHIP_r* TPU numbers never
    # seed it
    python -m neuroimagedisttraining_torch.obs regress --value 4.4 \
        --metric salientgrads_rounds_per_sec_abcd_alexnet3d_8clients \
        [--history results/bench_torch_history.jsonl]

    # FLEET: list the run catalog (--rebuild rescans run dirs first —
    # the pre-catalog migration)
    python -m neuroimagedisttraining_torch.obs ls results [--json] \
        [--rebuild]

    # three-plane cross-run diff (config/trajectory/event+health);
    # --expect identical is the twin gate every smoke check routes
    # through
    python -m neuroimagedisttraining_torch.obs diff \
        results/synthetic/<runA>.obs.jsonl \
        results/synthetic/<runB>.obs.jsonl \
        [--expect identical] [--json] [--metrics train_loss,...]

    # byte-deterministic static HTML fleet report from the catalog
    python -m neuroimagedisttraining_torch.obs report results \
        [--out results/fleet_report.html] \
        [--history results/bench_torch_history.jsonl]

    # cross-process causal trace: merge the per-process
    # *.xtrace.json streams of a --xtrace federation/serving run dir
    # (if not already merged) and print the per-round critical-path
    # decomposition — dispatch / site train / encode / wire /
    # queue-wait / combine / flush / publish / adopt — with the
    # straggler site named per round
    python -m neuroimagedisttraining_torch.obs xtrace results/fed_run \
        [--json] [--enforce]

    # LIVE fleet dashboard: one lane per peer (health glyph, heartbeat
    # age, round progress, key gauges) + the fleet summary line,
    # re-rendered every --every seconds from the run dir's fleet.json
    # (written by --obs_heartbeat_every runs) or scraped from a
    # --obs_prom_port /metrics endpoint; --once prints one frame and
    # exits (the scriptable mode — the frame is a pure function of the
    # ledger snapshot, byte-pinned in tests/test_live.py and held to it
    # in tests/test_torch_port_obs_cli.py)
    python -m neuroimagedisttraining_torch.obs watch results/fed_run \
        [--once] [--every 1.0] [--color 0|1]

Exit codes: analyze — 0 on success, 2 when the dir holds no streams;
tail — 0 (interrupt to stop; --once prints what's there and exits,
--all prints the newest line of every cataloged run, 2 when no stream
resolves); slo — 0, 1 with --enforce when a replayed run ends
FAILING, 2 when nothing replays; regress — the perf-gate codes (0
pass, 1 regression, 2 no history); ls — 0, 2 when the catalog is
empty and nothing rescans; diff — 0 when the --expect expectation
holds (or no expectation), 1 when it is violated, 2 when a run fails
to load; report — 0, 2 when the catalog resolves empty; xtrace — 0,
1 with --enforce when the causal tree has orphan spans or a named
straggler contradicts the injected straggle trace, 2 when the dir
holds no trace streams; watch — 0 (interrupt to stop; --once prints
one frame and exits), 2 when no fleet snapshot resolves.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Optional, Sequence

#: the port's bench history file name (``bench_torch.py`` writes
#: ``results/<HISTORY_NAME>``): the default of ``regress --history`` and
#: of ``report --history`` under the results dir
HISTORY_NAME = "bench_torch_history.jsonl"


def resolve_stream(target: str, identity: str = "",
                   suffix: str = ".obs.jsonl") -> Optional[str]:
    """``tail``'s stream resolution: an explicit JSONL path passes
    through; a run dir picks ``<identity><suffix>`` when given, else
    the most recently modified stream (the live run).

    A NAMED stream (explicit ``<suffix>`` path or dir+identity) need
    not exist yet — a just-launched run opens its stream lazily at the
    first flush, and ``tail_stream``'s follow mode waits for exactly
    that; only the pick-the-newest mode needs something on disk. A run
    dir holding ONLY an events stream (an early-killed run whose first
    round never flushed, or a copied-out events file) resolves to that
    events stream instead of nothing — ``format_tail_line`` renders
    event records natively."""
    if os.path.isfile(target):
        return target
    if target.endswith((suffix, ".events.jsonl")) and \
            os.path.isdir(os.path.dirname(target) or "."):
        return target
    if not os.path.isdir(target):
        return None
    if identity:
        return os.path.join(target, identity + suffix)
    streams = [os.path.join(target, f) for f in os.listdir(target)
               if f.endswith(suffix)]
    if not streams and suffix == ".obs.jsonl":
        # hardening: a dir with only events streams still tails
        streams = [os.path.join(target, f) for f in os.listdir(target)
                   if f.endswith(".events.jsonl")]
    return max(streams, key=os.path.getmtime) if streams else None


def resolve_all_streams(target: str,
                        suffix: str = ".obs.jsonl") -> list:
    """``tail --all``'s fan-out: every stream the target covers. A
    results dir holding a run catalog resolves through it (each
    cataloged run's recorded stream path); a plain run dir falls back
    to its on-disk ``*<suffix>`` streams; a file is itself. Sorted,
    deduped, existing streams only."""
    from . import catalog as obs_catalog

    if os.path.isfile(target):
        return [target]
    if not os.path.isdir(target):
        return []
    paths = []
    cat = obs_catalog.catalog_path(target)
    if os.path.exists(cat):
        art_key = "events_jsonl" if suffix == ".events.jsonl" \
            else "obs_jsonl"
        for entry in obs_catalog.read_catalog(cat):
            p = (entry.get("artifacts") or {}).get(art_key, "")
            if p and os.path.exists(p):
                paths.append(p)
    if not paths:
        paths = [os.path.join(target, f) for f in os.listdir(target)
                 if f.endswith(suffix)]
    if not paths and suffix == ".obs.jsonl":
        # federation run dirs carry per-process streams under plain
        # ``.jsonl`` names (aggregator.jsonl + site<k>.jsonl — the
        # merged federation.jsonl fold is skipped so no line prints
        # twice): ``tail --all`` renders one lane per process
        paths = [os.path.join(target, f) for f in os.listdir(target)
                 if f.endswith(".jsonl")
                 and not f.endswith(".events.jsonl")
                 and (f == "aggregator.jsonl"
                      or (f.startswith("site")))]
    return sorted(set(paths))


def tail_all(target: str, suffix: str = ".obs.jsonl",
             out: Callable[[str], None] = print) -> int:
    """Print the NEWEST record of every resolved stream (one line per
    run, identity-prefixed) — the fleet's at-a-glance state. Returns
    streams printed."""
    from .export import read_jsonl

    printed = 0
    for path in resolve_all_streams(target, suffix=suffix):
        try:
            records = read_jsonl(path, allow_partial_tail=True)
        except (OSError, ValueError):
            continue
        if not records:
            continue
        ident = os.path.basename(path)
        for s in (".obs.jsonl", ".events.jsonl", ".jsonl"):
            if ident.endswith(s):
                ident = ident[:-len(s)]
                break
        out(f"{ident}: {format_tail_line(records[-1])}")
        printed += 1
    return printed


def format_tail_line(rec: dict) -> str:
    """One round record -> one human line: round index, wall time,
    loss, agg share, the run-health state and last event (--slo_spec
    runs), and any guard / watchdog / drift events. An EVENT record
    (a line from the events stream — the only-events-dir hardening)
    renders in the event format instead."""
    if "event_type" in rec:
        from .events import format_event_line

        return format_event_line(rec)
    r = rec.get("round")
    parts = ["final " if r == -1 else f"round {r:<4}"
             if isinstance(r, (int, float)) else "?     "]
    rt = rec.get("round_time_s")
    if isinstance(rt, (int, float)):
        parts.append(f"{rt * 1e3:8.1f} ms")
    for key, label in (("train_loss", "loss"), ("global_acc", "acc"),
                       ("personal_acc", "pacc")):
        v = rec.get(key)
        if isinstance(v, (int, float)):
            parts.append(f"{label} {v:.4f}")
    share = rec.get("comm_agg_share")
    if isinstance(share, (int, float)):
        agg_ms = rec.get("comm_agg_ms")
        parts.append(f"agg {100 * share:.1f}%"
                     + (f" ({agg_ms:.2f} ms)"
                        if isinstance(agg_ms, (int, float)) else ""))
    events = []
    if (rec.get("clients_dropped") or 0) > 0:
        events.append(f"DROP {rec['clients_dropped']:g}")
    if (rec.get("clients_quarantined") or 0) > 0:
        events.append(f"GUARD quarantined={rec['clients_quarantined']:g}")
    if (rec.get("rounds_retried") or 0) > 0:
        events.append(f"WATCHDOG retried={rec['rounds_retried']:g}")
    if (rec.get("round_skipped") or 0) > 0:
        events.append("WATCHDOG skipped")
    from .numerics import drift_slots

    bad = sorted(j for j, v in drift_slots(rec).items()
                 if v != v or v in (float("inf"), float("-inf")))
    if bad:
        events.append("DRIFT nonfinite slots " +
                      ",".join(str(j) for j in bad))
    if events:
        parts.append("[" + "; ".join(events) + "]")
    # run-health state + the round's top event (--slo_spec runs stamp
    # both on every line; pre-SLO streams carry neither)
    health = rec.get("slo_health")
    if isinstance(health, str):
        parts.append(health.upper())
    ev = rec.get("slo_event")
    if isinstance(ev, str) and ev:
        parts.append(f"!{ev}")
    return "  ".join(parts)


def tail_stream(path: str, poll: float = 0.5, follow: bool = True,
                out: Callable[[str], None] = print,
                stop: Optional[Callable[[], bool]] = None) -> int:
    """Follow one per-round JSONL stream, emitting a formatted line per
    record as it lands (the file may not exist yet — a just-launched
    run opens it lazily at the first flush). Returns records printed;
    ``follow=False`` prints what is there and returns. ``stop`` is the
    test hook (checked each idle poll)."""
    while not os.path.exists(path):
        if not follow or (stop is not None and stop()):
            return 0
        time.sleep(poll)
    printed = 0
    buf = ""
    with open(path) as fh:
        while True:
            chunk = fh.readline()
            if chunk:
                buf += chunk
                if not buf.endswith("\n"):
                    continue  # partial line: the writer is mid-flush
                line, buf = buf.strip(), ""
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    out(f"?? malformed line: {line[:80]}")
                    continue
                out(format_tail_line(rec))
                printed += 1
                continue
            if not follow or (stop is not None and stop()):
                return printed
            time.sleep(poll)


def slo_replay_cli(run_dir: str, identity: str = "",
                   slo_spec: str = "", enforce: bool = False,
                   as_json: bool = False,
                   out: Callable[[str], None] = print) -> int:
    """``obs slo <run_dir>``: deterministically replay recorded round
    streams through the SLO engine (the engine is a pure function of
    the record stream, so the offline replay reproduces the in-run
    verdicts bit-for-bit — including for runs recorded WITHOUT
    ``--slo_spec``, evaluated after the fact against a spec given
    here). Exit 0, 1 with ``enforce`` when any run ends FAILING, 2
    when nothing replays (no streams, or no spec anywhere)."""
    import json as _json

    from . import export as obs_export, slo as obs_slo
    from .events import format_event_line

    if not os.path.isdir(run_dir):
        print(f"not a directory: {run_dir}", file=sys.stderr)
        return 2
    names = sorted(f for f in os.listdir(run_dir)
                   if f.endswith(".obs.jsonl"))
    if identity:
        names = [n for n in names
                 if n == identity + ".obs.jsonl"]
    if not names:
        print(f"no *.obs.jsonl streams under {run_dir} "
              "(was the run launched with --obs 1?)", file=sys.stderr)
        return 2
    any_failing = False
    replayed = 0
    for name in names:
        ident = name[:-len(".obs.jsonl")]
        records = obs_export.read_jsonl(
            os.path.join(run_dir, name), allow_partial_tail=True)
        spec = slo_spec
        if not spec:
            stat = os.path.join(run_dir, ident + ".json")
            if os.path.exists(stat):
                with open(stat) as f:
                    spec = str((_json.load(f).get("config") or {})
                               .get("slo_spec") or "")
        if not spec:
            print(f"{ident}: no --slo_spec given and the run recorded "
                  "none; skipping", file=sys.stderr)
            continue
        engine = obs_slo.SloEngine(obs_slo.load_slo_spec(spec))
        events = engine.replay(records)
        replayed += 1
        summary = engine.summary()
        any_failing = any_failing or summary["health"] == \
            obs_slo.FAILING
        if as_json:
            out(_json.dumps({"identity": ident, **summary}, indent=1))
            continue
        out(f"== slo replay: {ident} ==")
        out(f"health: {summary['health'].upper()} over "
            f"{summary['rounds_observed']} round(s), "
            f"{summary['events_total']} event(s)")
        for o in summary["objectives"].values():
            comp = o["compliance"]
            out(f"  {o['name']:<40} "
                + (f"compliance {comp:.3f}, " if comp is not None
                   else "not evaluated, ")
                + f"budget spend {o['budget_spend']:.2f}"
                + ("  EXHAUSTED" if o["budget_exhausted"] else "")
                + ("  (violating)" if o["violating"] else ""))
        for ev in events:
            out("  " + format_event_line(ev.to_record()))
    if not replayed:
        return 2
    return 1 if (enforce and any_failing) else 0


def fleet_ls_cli(target: str, as_json: bool = False,
                 rebuild: bool = False,
                 out: Callable[[str], None] = print) -> int:
    """``obs ls``: list the run catalog (one line per run). ``target``
    is a results dir (its ``runs_index.jsonl``) or a catalog path;
    ``rebuild`` rescans the run dirs first — the pre-catalog
    migration. Exit 2 when nothing lists."""
    import json as _json

    from . import catalog as obs_catalog

    path = target
    if os.path.isdir(target):
        path = obs_catalog.catalog_path(target)
        if rebuild:
            obs_catalog.rebuild(target, path=path, force=True)
    entries = obs_catalog.read_catalog(path)
    if not entries:
        print(f"no catalog entries at {path} "
              "(run with --obs, or rescan with --rebuild)",
              file=sys.stderr)
        return 2
    if as_json:
        out(_json.dumps(entries, indent=1, sort_keys=True))
        return 0
    out(f"{'run':<44} {'rounds':>6} {'health':<9} {'done':<4} "
        "final")
    for e in entries:
        key = f"{e.get('dataset', '')}/{e.get('identity', '')}"
        finals = e.get("final_metrics") or {}
        final_txt = " ".join(f"{k}={v:.4g}"
                             for k, v in sorted(finals.items()))
        out(f"{key:<44} {e.get('rounds_recorded', 0):>6} "
            f"{(e.get('slo_health') or '-'):<9} "
            f"{'yes' if e.get('completed') else 'NO':<4} "
            f"{final_txt}")
    return 0


def fleet_diff_cli(target_a: str, target_b: str,
                   identity_a: str = "", identity_b: str = "",
                   expect: str = "", as_json: bool = False,
                   metrics: str = "",
                   out: Callable[[str], None] = print) -> int:
    """``obs diff``: the three-plane cross-run diff. Exit 0 when the
    ``--expect`` expectation holds (or none was given), 1 when it is
    violated, 2 when a run fails to load."""
    import json as _json

    from . import diff as obs_diff

    try:
        run_a = obs_diff.load_run(target_a, identity=identity_a)
        run_b = obs_diff.load_run(target_b, identity=identity_b)
    except (OSError, ValueError) as e:
        print(f"obs diff: {e}", file=sys.stderr)
        return 2
    metric_list = [m for m in metrics.split(",") if m] or None
    doc = obs_diff.diff_runs(run_a, run_b, metrics=metric_list)
    if as_json:
        out(_json.dumps(doc, indent=1, sort_keys=True))
    else:
        out(obs_diff.render_diff(doc))
    try:
        return obs_diff.expect_exit_code(doc, expect)
    except ValueError as e:
        print(f"obs diff: {e}", file=sys.stderr)
        return 2


def fleet_report_cli(target: str, out_path: str = "",
                     history: str = "",
                     out: Callable[[str], None] = print) -> int:
    """``obs report``: render the static HTML fleet report from the
    catalog. Exit 2 when the catalog resolves empty."""
    from . import catalog as obs_catalog, report as obs_report

    path = target
    results_dir = os.path.dirname(target) or "."
    if os.path.isdir(target):
        path = obs_catalog.catalog_path(target)
        results_dir = target
    if not obs_catalog.read_catalog(path):
        print(f"no catalog entries at {path} — nothing to report "
              "(obs ls --rebuild migrates pre-catalog runs)",
              file=sys.stderr)
        return 2
    out_path = out_path or os.path.join(results_dir,
                                        "fleet_report.html")
    history = history or os.path.join(results_dir, HISTORY_NAME)
    written = obs_report.write_report(out_path, path,
                                      history_path=history,
                                      results_dir=results_dir)
    out(f"fleet report -> {written}")
    return 0


def xtrace_cli(run_dir: str, as_json: bool = False,
               enforce: bool = False,
               out: Callable[[str], None] = print) -> int:
    """``obs xtrace <run_dir>``: the cross-process causal-trace
    report. Loads the clock-aligned merged trace (merging the
    per-process ``*.xtrace.json`` streams first when no
    ``federation.trace.json`` exists yet — e.g. a TCP run whose
    processes exited before the best-effort runtime merge saw every
    lane), joins it against the dir's round streams, and prints the
    per-round critical-path decomposition. Exit 2 when the dir holds
    no trace streams; 1 with ``enforce`` when the causal tree has
    orphan spans or a named straggler contradicts the injected
    straggle trace."""
    import json as _json

    from . import analyze as obs_analyze, export as obs_export, \
        xtrace as obs_xtrace

    if not os.path.isdir(run_dir):
        print(f"not a directory: {run_dir}", file=sys.stderr)
        return 2
    merged = os.path.join(run_dir, obs_xtrace.MERGED_TRACE_NAME)
    if obs_xtrace.stream_paths(run_dir):
        # always re-merge: pure function of the streams, and a
        # late-written site lane must not be left out
        obs_xtrace.merge_run_dir(run_dir)
    if not os.path.exists(merged):
        print(f"no *{obs_xtrace.STREAM_SUFFIX} streams or merged "
              f"trace under {run_dir} (was the run launched with "
              "--xtrace 1?)", file=sys.stderr)
        return 2
    doc = obs_xtrace.load_doc(merged)
    # every round stream in the dir joins: the aggregator's
    # wire/queue stamps, the sites' straggle truth, serve probe ticks
    records = []
    for fname in sorted(os.listdir(run_dir)):
        if not fname.endswith(".jsonl") or \
                fname.endswith(".events.jsonl") or \
                fname == "federation.jsonl":
            continue
        try:
            records.extend(obs_export.read_jsonl(
                os.path.join(run_dir, fname), allow_partial_tail=True))
        except (OSError, ValueError):
            continue
    xt = obs_analyze._analyze_xtrace(doc, records)
    if as_json:
        out(_json.dumps(xt, indent=1, sort_keys=True))
    else:
        out(f"== xtrace: {run_dir} ==")
        for line in obs_analyze.render_xtrace(xt):
            out(line)
        out(f"merged trace -> {merged}")
    if enforce and (xt["orphans"] or xt["straggler_mismatches"]):
        return 1
    return 0


def watch_snapshot(target: str):
    """``watch``'s snapshot resolution: ``(snapshot, slo_health)`` from
    a run dir (its ``fleet.json``, written by ``--obs_heartbeat_every``
    runs), an explicit ``fleet.json`` path, or an
    ``http(s)://`` ``--obs_prom_port`` endpoint (the ``fleet_*`` gauges
    of a ``/metrics`` scrape render the summary header; per-peer lanes
    live only in the ledger snapshot). ``(None, "")`` when nothing
    resolves — never raises."""
    if target.startswith(("http://", "https://")):
        from urllib.error import URLError
        from urllib.request import urlopen

        from . import prom as obs_prom

        url = target if target.endswith("/metrics") \
            else target.rstrip("/") + "/metrics"
        try:
            with urlopen(url, timeout=5.0) as resp:
                body = resp.read().decode("utf-8", "replace")
        except (URLError, OSError, ValueError):
            return None, ""
        samples = obs_prom.parse_prom_text(body)
        fleet = {k: v for k, v in samples.items()
                 if k.startswith("fleet_")}
        if not fleet:
            return None, ""
        return {"round": -1, "interval_s": 0.0, "peers": [],
                "fleet": fleet}, ""
    path = os.path.join(target, "fleet.json") \
        if os.path.isdir(target) else target
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return None, ""
    if not isinstance(snap, dict) or "peers" not in snap:
        return None, ""
    # the run-health verdict joins the header when the run declared
    # --slo_spec: the newest round record of the dir's aggregator
    # stream carries it
    health = ""
    agg = os.path.join(os.path.dirname(path) or ".",
                       "aggregator.jsonl")
    if os.path.exists(agg):
        from .export import read_jsonl

        try:
            records = read_jsonl(agg, allow_partial_tail=True)
        except (OSError, ValueError):
            records = []
        for rec in reversed(records):
            if isinstance(rec.get("slo_health"), str):
                health = rec["slo_health"]
                break
    return snap, health


def watch_cli(target: str, once: bool = False, every: float = 1.0,
              color: bool = False,
              out: Callable[[str], None] = print,
              stop: Optional[Callable[[], bool]] = None) -> int:
    """``obs watch``: the live fleet dashboard — re-render the frame
    (a pure function of the ledger snapshot) every ``every`` seconds;
    ``once`` prints a single frame and exits (the scriptable mode).
    ``stop`` is the test hook. Exit 2 when ``once`` resolves no
    snapshot; follow mode keeps polling (the run may not have written
    its first snapshot yet)."""
    from . import live as obs_live

    while True:
        snap, health = watch_snapshot(target)
        if snap is not None:
            out(obs_live.render_frame(snap, color=color,
                                      slo_health=health))
        elif once:
            print(f"no fleet snapshot under {target} (was the run "
                  "launched with --obs_heartbeat_every > 0?)",
                  file=sys.stderr)
            return 2
        if once or (stop is not None and stop()):
            return 0
        time.sleep(max(0.05, every))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m neuroimagedisttraining_torch.obs",
        description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("analyze", help="analyze recorded run telemetry")
    pa.add_argument("run_dir", help="directory holding *.obs.jsonl "
                                    "streams (+ metrics/stat sidecars)")
    pa.add_argument("--trace-dir", default="",
                    help="where --trace_dir wrote <identity>.trace.json "
                         "(default: look in run_dir)")
    pa.add_argument("--no-write", action="store_true",
                    help="do not write <identity>.analysis.json files")
    pa.add_argument("--json", action="store_true",
                    help="print the analysis JSON instead of the report")

    pt = sub.add_parser("tail", help="live-tail a run's per-round JSONL")
    pt.add_argument("target", help="run dir holding *.obs.jsonl streams, "
                                   "or one stream path")
    pt.add_argument("--identity", default="",
                    help="stream to follow when the dir holds several "
                         "(default: the most recently modified)")
    pt.add_argument("--poll", type=float, default=0.5,
                    help="seconds between polls of the stream")
    pt.add_argument("--once", action="store_true",
                    help="print the records already there and exit "
                         "(the scriptable mode; default follows live)")
    pt.add_argument("--events", action="store_true",
                    help="follow the run's <identity>.events.jsonl "
                         "stream (the typed SLO/guard/watchdog event "
                         "bus) instead of the per-round records")
    pt.add_argument("--all", action="store_true",
                    help="print the newest record of EVERY run the "
                         "target covers (catalog-resolved when the "
                         "dir holds runs_index.jsonl) and exit — the "
                         "fleet's at-a-glance state")

    ps = sub.add_parser(
        "slo", help="offline SLO replay over a recorded run")
    ps.add_argument("run_dir", help="directory holding *.obs.jsonl "
                                    "streams (+ stat_info sidecars)")
    ps.add_argument("--identity", default="",
                    help="replay one stream (default: every stream "
                         "in the dir)")
    ps.add_argument("--slo_spec", default="",
                    help="objectives to evaluate (inline DSL or spec "
                         "file); default: the run's recorded "
                         "--slo_spec from its stat_info config")
    ps.add_argument("--enforce", action="store_true",
                    help="exit 1 when any replayed run ends FAILING")
    ps.add_argument("--json", action="store_true",
                    help="print the summary JSON instead of the "
                         "report")

    pr = sub.add_parser("regress", help="bench-history regression gate")
    pr.add_argument("--history",
                    default=os.path.join("results", HISTORY_NAME))
    pr.add_argument("--metric", required=True)
    pr.add_argument("--value", type=float, required=True)
    pr.add_argument("--lower-is-better", action="store_true")

    pl = sub.add_parser("ls", help="list the run catalog")
    pl.add_argument("target", nargs="?", default="results",
                    help="results dir (its runs_index.jsonl) or a "
                         "catalog path")
    pl.add_argument("--json", action="store_true",
                    help="print the entries as JSON")
    pl.add_argument("--rebuild", action="store_true",
                    help="rescan the run dirs and rewrite the catalog "
                         "first (migrates pre-catalog runs)")

    pd = sub.add_parser(
        "diff", help="three-plane cross-run diff (the twin gate)")
    pd.add_argument("a", help="run A: run dir or *.obs.jsonl path")
    pd.add_argument("b", help="run B: run dir or *.obs.jsonl path")
    pd.add_argument("--identity-a", default="",
                    help="stream when run A is a multi-stream dir")
    pd.add_argument("--identity-b", default="",
                    help="stream when run B is a multi-stream dir")
    pd.add_argument("--expect", default="",
                    choices=["", "identical", "different"],
                    help="gate the verdict: exit 1 when violated")
    pd.add_argument("--json", action="store_true",
                    help="print the machine diff instead of the "
                         "report")
    pd.add_argument("--metrics", default="",
                    help="comma-separated metric allowlist for the "
                         "trajectory plane (default: every shared "
                         "non-volatile metric)")

    pp = sub.add_parser(
        "report", help="byte-deterministic static HTML fleet report")
    pp.add_argument("target", nargs="?", default="results",
                    help="results dir (its runs_index.jsonl) or a "
                         "catalog path")
    pp.add_argument("--out", default="",
                    help="output path (default "
                         "<results_dir>/fleet_report.html)")
    pp.add_argument("--history", default="",
                    help="bench history for the rounds/sec scatter "
                         f"(default <results_dir>/{HISTORY_NAME})")

    pw = sub.add_parser(
        "watch", help="live fleet dashboard (heartbeat ledger lanes)")
    pw.add_argument("target", help="run dir holding fleet.json, an "
                                   "explicit fleet.json path, or an "
                                   "http(s):// --obs_prom_port "
                                   "endpoint")
    pw.add_argument("--once", action="store_true",
                    help="print one frame and exit (the scriptable "
                         "mode; default re-renders live)")
    pw.add_argument("--every", type=float, default=1.0,
                    help="seconds between frame refreshes")
    pw.add_argument("--color", type=int, default=None,
                    choices=(0, 1),
                    help="ANSI health colors (default: on for a TTY, "
                         "off when piped — frames stay "
                         "byte-deterministic for scripts)")

    px = sub.add_parser(
        "xtrace", help="cross-process causal-trace report (merged "
                       "critical-path decomposition)")
    px.add_argument("run_dir", help="a --xtrace federation/serving "
                                    "run dir (holds *.xtrace.json "
                                    "streams / federation.trace.json)")
    px.add_argument("--json", action="store_true",
                    help="print the xtrace section JSON instead of "
                         "the report")
    px.add_argument("--enforce", action="store_true",
                    help="exit 1 on orphan spans or a straggler "
                         "attribution that contradicts the injected "
                         "straggle trace")

    args = p.parse_args(argv)

    if args.cmd == "watch":
        color = bool(args.color) if args.color is not None \
            else sys.stdout.isatty()
        try:
            return watch_cli(args.target, once=args.once,
                             every=args.every, color=color)
        except KeyboardInterrupt:
            return 0

    if args.cmd == "xtrace":
        return xtrace_cli(args.run_dir, as_json=args.json,
                          enforce=args.enforce)

    if args.cmd == "analyze":
        from . import analyze as obs_analyze

        analyses = obs_analyze.analyze_run_dir(
            args.run_dir, trace_dir=args.trace_dir,
            write=not args.no_write)
        if not analyses:
            print(f"no *.obs.jsonl streams under {args.run_dir} "
                  "(was the run launched with --obs 1?)",
                  file=sys.stderr)
            return 2
        for a in analyses:
            if args.json:
                print(json.dumps(a, indent=1))
            else:
                print(obs_analyze.render_report(a))
                if "analysis_path" in a:
                    print(f"analysis.json -> {a['analysis_path']}")
                print()
        return 0

    if args.cmd == "tail":
        suffix = ".events.jsonl" if args.events else ".obs.jsonl"
        if args.all:
            return 0 if tail_all(args.target, suffix=suffix) else 2
        path = resolve_stream(args.target, args.identity,
                              suffix=suffix)
        if path is None:
            print(f"no *{suffix} stream under {args.target} "
                  "(was the run launched with --obs 1"
                  + ("" if args.events else "?")
                  + (" and --slo_spec?)" if args.events else ")"),
                  file=sys.stderr)
            return 2
        print(f"tailing {path}", file=sys.stderr)
        try:
            tail_stream(path, poll=args.poll, follow=not args.once)
        except KeyboardInterrupt:
            pass
        return 0

    if args.cmd == "slo":
        return slo_replay_cli(args.run_dir, identity=args.identity,
                              slo_spec=args.slo_spec,
                              enforce=args.enforce,
                              as_json=args.json)

    if args.cmd == "ls":
        return fleet_ls_cli(args.target, as_json=args.json,
                            rebuild=args.rebuild)

    if args.cmd == "diff":
        return fleet_diff_cli(args.a, args.b,
                              identity_a=args.identity_a,
                              identity_b=args.identity_b,
                              expect=args.expect, as_json=args.json,
                              metrics=args.metrics)

    if args.cmd == "report":
        return fleet_report_cli(args.target, out_path=args.out,
                                history=args.history)

    from . import regress as obs_regress

    # the JAX package's per-metric defaults (comm SLO metrics are
    # lower-is-better with their own band) and own-commit exclusion (a
    # rerun's just-appended measurement must not join its own
    # baseline). No backfill: the committed BENCH_r*/MULTICHIP_r*
    # artifacts are TPU numbers, and a card's value gated against them
    # is no verdict — a missing history answers EXIT_NO_HISTORY (2)
    defaults = obs_regress.metric_gate_defaults(args.metric)
    verdict = obs_regress.gate(
        args.history, args.metric, args.value,
        rel_threshold=defaults.get(
            "rel_threshold", obs_regress.DEFAULT_REL_THRESHOLD),
        mad_k=defaults.get("mad_k", obs_regress.DEFAULT_MAD_K),
        higher_is_better=(not args.lower_is_better
                          and defaults.get("higher_is_better", True)),
        exclude_git_sha=obs_regress.git_sha())
    print(json.dumps(verdict))
    return int(verdict["exit_code"])


if __name__ == "__main__":
    raise SystemExit(main())
