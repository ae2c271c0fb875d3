"""The offline analyzer and the health ledger of the port
(``neuroimagedisttraining_torch/obs/analyze.py``, ``obs/health.py``) held to
the JAX package's on the same inputs.

* Hand-built round streams, as ``tests/test_obs_analyze.py`` builds them
  (clean, an injected straggler round, memory growth, flat noisy memory,
  missing and duplicate rounds, a newer schema, phases from trace spans)
  and the later sections' streams (numerics, comm, SLO, fleet): both
  packages' ``analyze_records`` give the same JSON
  (``json.dumps(..., sort_keys=True)``, bitwise) in every section but
  ``compile``, whose kinds are each package's own.
* Fault-bearing streams: the port's replay seam (``fault_trace``) fed the
  JAX package's ``fault_trace_round`` gives the JAX analysis and health
  ledger byte for byte; with the port's own draws (``torch`` generators)
  the flagged rounds are exactly those of the port's replay.
* One small CLI run per package (``small3dcnn``, ``synthetic``, FedAvg,
  4 rounds, ``--obs 1 --trace_dir ... --fault_spec straggle=0.4``, as
  ``tests/test_obs_analyze.py`` runs it), shared by a module fixture: the
  port's analyzer on the port's run meets that file's end-to-end
  acceptance with the compile section on the port's kinds, and on the JAX
  run's dir, with the JAX draws at the seam, it gives the JAX analyzer's
  JSON.

Every comparison is bitwise (equal JSON text or equal values) unless a
test says otherwise.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.obs import analyze as janalyze  # noqa: E402
from neuroimagedisttraining_tpu.obs import health as jhealth  # noqa: E402
from neuroimagedisttraining_tpu.obs import trace as jtrace  # noqa: E402
from neuroimagedisttraining_tpu.robust import faults as jfaults  # noqa: E402
from neuroimagedisttraining_torch.obs import analyze as tanalyze  # noqa: E402
from neuroimagedisttraining_torch.obs import compile as tcompile  # noqa: E402
from neuroimagedisttraining_torch.obs import export as texport  # noqa: E402
from neuroimagedisttraining_torch.obs import health as thealth  # noqa: E402
from neuroimagedisttraining_torch.obs import metrics as tmetrics  # noqa: E402
from neuroimagedisttraining_torch.obs import trace as ttrace  # noqa: E402
from neuroimagedisttraining_torch.robust import faults as tfaults  # noqa: E402


def _stream(n_rounds=12, round_time=0.1, train_loss=0.5):
    return [{"round": r, "train_loss": train_loss,
             "round_time_s": round_time} for r in range(n_rounds)]


def _text(doc):
    return json.dumps(doc, sort_keys=True)


def _but_compile(analysis):
    return _text({k: v for k, v in analysis.items() if k != "compile"})


def _both(records, **kw):
    """Both packages' analyses of the same inputs (the inputs deep-copied
    for each side: the analyzers must not see each other's edits)."""
    j = janalyze.analyze_records(json.loads(json.dumps(records)), **kw)
    t = tanalyze.analyze_records(json.loads(json.dumps(records)), **kw)
    return j, t


# ---------------------------------------------------------------------------
# hand-built streams, every section but compile
# ---------------------------------------------------------------------------

def _straggler():
    recs = _stream(20)
    recs[7]["round_time_s"] = 0.4
    return recs, {}


def _stamped():
    recs = _stream(12)
    recs[3]["clients_straggled"] = 2.0
    return recs, {}


def _memory_growth():
    recs = _stream(15)
    for r, rec in enumerate(recs):
        rec["mem_host_rss_bytes"] = 1e8 + r * 1e6
        rec["mem_device_bytes_in_use"] = 5e8
    return recs, {}


def _noisy_memory():
    rng = np.random.RandomState(0)
    recs = _stream(20)
    for rec in recs:
        rec["mem_host_rss_bytes"] = 1e8 + rng.randint(-5, 6) * 1e5
    return recs, {}


def _gaps():
    recs = _stream(6)
    del recs[3]
    recs.append({"round": 5, "train_loss": 0.1, "round_time_s": 0.1})
    return recs, {}


def _phases(tracer_cls):
    t = tracer_cls(annotate=False)
    with t.span("build"):
        pass
    for r in range(6):
        with t.step_span("round", r):
            with t.span("sample"):
                pass
            with t.span("dispatch_round"):
                pass
            with t.span("fused_block_flush"):
                pass
        with t.span("eval"):
            pass
    with t.span("finalize"):
        with t.span("finetune"):
            pass
    with t.span("mystery"):
        pass
    return t.to_chrome_trace()


def _numerics():
    """In-round numerics (obs_schema 2 keys): gauges per layer group, a
    non-finite gauge, update norms, mask churn, per-slot drift with a NaN
    slot and an outlier, and the fault/rollback rounds they attribute."""
    recs = _stream(10)
    for r, rec in enumerate(recs):
        rec["num_maxabs/conv"] = 1.0 + 0.5 * r
        rec["num_maxabs/dense"] = 2.0 ** (100 + r) if r < 9 else float("inf")
        rec["num_upd/conv"] = 0.01 * (r + 1)
        rec["num_update_norm"] = 0.1 * (r + 1)
        rec["num_mask_churn"] = 0.02 / (r + 1)
        rec["num_mask_agree"] = 0.9 - 0.01 * r
        for j in range(4):
            rec[f"num_drift_s{j}"] = 0.1 + 0.01 * j + 0.001 * r
    recs[4]["num_drift_s2"] = 5.0
    recs[6]["num_drift_s1"] = float("nan")
    recs[6]["clients_quarantined"] = 1.0
    recs[8]["rounds_retried"] = 1.0
    recs[9]["round_skipped"] = 1.0
    return recs, {"config": {"client_num_in_total": 8,
                             "client_num_per_round": 4, "seed": 0}}


def _comm():
    recs = _stream(8)
    for r, rec in enumerate(recs):
        rec.update({"comm_density": 0.5, "comm_n_params": 1000,
                    "comm_n_devices": 1, "comm_bytes_wire": 4000.0,
                    "comm_bytes_dense": 4000.0, "comm_bytes_int8": 1100.0,
                    "comm_bytes_topk": 800.0,
                    "comm_bytes_group/conv": 3000.0,
                    "comm_bytes_group/dense": 1000.0,
                    "comm_agg_ms": 1.0 + 0.1 * r,
                    "comm_agg_share": 0.6 + 0.01 * r,
                    "comm_agg_flops": 16000.0,
                    "comm_agg_bytes_accessed": 36032.0})
    metrics = {"comm_msg_bytes_sent": {"type": "counter", "value": 9.0},
               "comm_msg_frames": {"type": "counter", "value": 3.0}}
    devtrace = {"present": True, "devices": {"GPU 0": {}},
                "totals": {"agg_share": 0.25, "collective_s": 0.1,
                           "busy_s": 0.4},
                "achieved_gbps": 12.5,
                "top_collectives": [{"name": "ncclDevKernel_AllReduce",
                                     "total_s": 0.1, "count": 4}]}
    return recs, {"metrics": metrics, "devtrace": devtrace,
                  "config": {"agg_impl": "dense"}}


def _slo():
    recs = _stream(8)
    health = ["ok", "ok", "degraded", "degraded", "failing", "failing",
              "degraded", "ok"]
    for rec, h in zip(recs, health):
        rec["slo_health"] = h
        rec["clients_quarantined"] = 1.0 if h == "failing" else 0.0
    events = [
        {"round": 2, "event_type": "SLO_BREACH", "severity": "warning",
         "detail": {"objectives": [{"objective": "p99:train_loss<0.4"}]}},
        {"round": 2, "event_type": "HEALTH_TRANSITION",
         "severity": "warning", "detail": {"to": "degraded"}},
        {"round": 4, "event_type": "BUDGET_BURN", "severity": "critical",
         "detail": {"objectives": [{"objective": "p99:train_loss<0.4"}]}},
        {"round": 4, "event_type": "HEALTH_TRANSITION",
         "severity": "critical", "detail": {"to": "failing"}},
        {"round": 5, "event_type": "GUARD_QUARANTINE", "severity": "info"},
        {"round": 6, "event_type": "BYZANTINE", "severity": "warning",
         "sites": [3, 1]},
        {"round": 7, "event_type": "BYZANTINE", "severity": "warning",
         "detail": {"sites": [3]}},
    ]
    return recs, {"events": events,
                  "config": {"slo_spec": "p99:train_loss<0.4@w=4",
                             "client_num_in_total": 6, "seed": 2,
                             "fault_spec": ""}}


def _fleet():
    recs = _stream(6)
    for r, rec in enumerate(recs):
        rec.update({"fleet_sites_live": 3.0 - (r >= 3),
                    "fleet_sites_down": float(r >= 3),
                    "fleet_max_heartbeat_age_s": 0.2 * r,
                    "fleet_round_progress": r / 6.0})
    events = [{"round": 3, "event_type": "SITE_DOWN", "severity": "critical",
               "detail": {"peers": ["site2"]}},
              {"round": 5, "event_type": "SITE_RECOVERED",
               "severity": "info", "detail": {"peers": ["site2"]}}]
    return recs, {"events": events}


STREAMS = {
    "clean": lambda: (_stream(20), {}),
    "straggler": _straggler,
    "stamped_straggler": _stamped,
    "memory_growth": _memory_growth,
    "flat_noisy_memory": _noisy_memory,
    "missing_and_duplicate_rounds": _gaps,
    "numerics": _numerics,
    "comm": _comm,
    "slo": _slo,
    "fleet": _fleet,
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_analysis_equals_jax_on_hand_built_streams(case):
    """Every section but ``compile`` equal as sorted JSON text (bitwise),
    each package's analysis valid under both validators, and the two
    human reports the same lines but the phases note (the port names the
    ``torch.profiler`` trace where the JAX package names XLA scopes)."""
    recs, kw = STREAMS[case]()
    j, t = _both(recs, identity=case, **kw)
    assert _but_compile(t) == _but_compile(j)
    assert set(t["compile"]) == set(j["compile"])
    for a in (j, t):
        janalyze.validate_analysis(a)
        tanalyze.validate_analysis(a)
    jl = janalyze.render_report(j).splitlines()
    tl = tanalyze.render_report(t).splitlines()
    note = [i for i, ln in enumerate(jl) if "named_scope" in ln]
    assert [ln for i, ln in enumerate(jl) if i not in note] == \
        [ln for i, ln in enumerate(tl) if i not in note]
    for i in note:
        assert "torch.profiler" in tl[i]


def test_phases_from_trace_spans_equal_jax():
    """Both tracers' Chrome traces of the same spans, each analyzed by its
    package: the phases (container spans skipped, unknown spans
    ``other_host``) equal within 1e-4 s a phase (the spans' own host
    durations differ between the two traces; counts and keys are
    exact), and each trace read by the other package gives that
    package's phases bitwise."""
    recs = _stream(6, round_time=0.05)
    jdoc, tdoc = _phases(jtrace.Tracer), _phases(ttrace.Tracer)
    ja = janalyze.analyze_records(recs, trace_doc=jdoc, identity="p")
    ta = tanalyze.analyze_records(recs, trace_doc=tdoc, identity="p")
    assert set(ta["phases"]) == set(ja["phases"]) >= {
        "sample", "train_dispatch", "train_flush", "eval", "setup",
        "finalize", "other_host", "device_and_wait"}
    for name, p in ja["phases"].items():
        assert ta["phases"][name]["count"] == p["count"]
        assert ta["phases"][name]["total_s"] == pytest.approx(
            p["total_s"], abs=1e-4)
    for doc in (jdoc, tdoc):
        j, t = _both(recs, trace_doc=doc, identity="p")
        assert _but_compile(t) == _but_compile(j)


def test_newer_schema_refused_by_both():
    recs = [{"round": 0, "obs_schema": texport.OBS_SCHEMA_VERSION + 1}]
    for mod in (janalyze, tanalyze):
        with pytest.raises(ValueError, match="obs_schema"):
            mod.analyze_records(recs)
    assert tanalyze.ANALYSIS_SCHEMA_VERSION == \
        janalyze.ANALYSIS_SCHEMA_VERSION == 6
    assert tanalyze._SCHEMA_KEYS == janalyze._SCHEMA_KEYS


def test_validate_analysis_rejects_what_jax_rejects():
    a = tanalyze.analyze_records(_stream(5))
    bad = dict(a)
    del bad["stragglers"]
    bad["rounds"] = "nope"
    newer = dict(a, schema_version=tanalyze.ANALYSIS_SCHEMA_VERSION + 1)
    for doc in (bad, newer, [1]):
        with pytest.raises(ValueError) as te:
            tanalyze.validate_analysis(doc)
        with pytest.raises(ValueError) as je:
            janalyze.validate_analysis(doc)
        assert str(te.value) == str(je.value)


def test_compile_section_reads_the_ports_kinds():
    """The port's compile events (``obs/compile.py``: ``kernel_build``,
    ``graph_capture``) recorded by a live ``CompileWatch`` under their
    spans fold into the JAX package's output keys; the JAX package's XLA
    kinds are not the port's and are not read (and the other way
    round)."""
    reg = tmetrics.MetricsRegistry()
    watch = tcompile.CompileWatch(reg).install()
    tracer = ttrace.Tracer(annotate=False)
    ttrace.set_tracer(tracer)
    try:
        with tracer.span("build"):
            tcompile.note_compile("kernel_build", 1.5, count=8)
        with tracer.span("fused_block_dispatch"):
            tcompile.note_compile("graph_capture", 0.25, nodes=100)
            tcompile.note_compile("graph_capture", 0.5, nodes=120)
    finally:
        ttrace.set_tracer(None)
        watch.uninstall()
    m = reg.snapshot()
    m["compile_backend_s"] = {"type": "distribution",
                              "value": {"count": 1, "sum": 9.0},
                              "labeled": {"entry=x": {"count": 1,
                                                      "sum": 9.0}}}
    c = tanalyze.analyze_records(_stream(5), metrics=m)["compile"]
    assert c["present"] and c["total_s"] == 2.25
    assert c["by_entry"] == {
        "build": {"total_s": 1.5, "count": 1},
        "fused_block_dispatch": {"total_s": 0.75, "count": 2}}
    assert c["cache"] == {}
    jc = janalyze.analyze_records(_stream(5), metrics=m)["compile"]
    assert jc["total_s"] == 9.0 and set(jc["by_entry"]) == {"x"}
    assert set(c) == set(jc)


def test_devtrace_ranks_the_compute_kernels(tmp_path):
    """The port's profile-dir summary ranks every compute kernel of its
    traces (collectives apart, CPU ops not counted), summed over files and
    untruncated, bitwise; the attribution's totals beside it as before
    (sums of float seconds: within pytest's default 1e-6 relative)."""
    from neuroimagedisttraining_torch.obs import devtrace as tdevtrace

    def kernel(name, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                "tid": 7, "ts": ts, "dur": dur}

    doc = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 9,
         "tid": 1, "ts": 0, "dur": 900},
        kernel("stem_fwd_kernel", 0, 100), kernel("stem_bwd_kernel", 100, 60),
        kernel("weighted_sum_kernel", 160, 2),
        kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 170, 40)]}
    for i in range(2):
        d = tmp_path / f"r{i}"
        d.mkdir()
        (d / "x.trace.json").write_text(json.dumps(doc))
    s = tdevtrace.analyze_profile_dir(str(tmp_path))
    assert s["kernels"] == [
        {"name": "stem_fwd_kernel", "total_s": 2e-4, "count": 2},
        {"name": "stem_bwd_kernel", "total_s": 1.2e-4, "count": 2},
        {"name": "weighted_sum_kernel", "total_s": 4e-6, "count": 2}]
    assert s["top_collectives"][0]["count"] == 2
    assert s["totals"]["busy_s"] == pytest.approx(2 * 202e-6)
    assert s["totals"]["collective_s"] == pytest.approx(2 * 40e-6)


def test_devtrace_kernels_join_the_comm_section():
    """The port's devtrace sidecar ranks the profiled round's compute
    kernels; the comm section carries that list (a JAX-format sidecar has
    none, and the section is then the JAX package's, bitwise)."""
    recs, kw = _comm()
    kernels = [{"name": "stem_fwd_kernel", "total_s": 0.02, "count": 45},
               {"name": "weighted_sum_kernel", "total_s": 3e-5,
                "count": 1}]
    kw["devtrace"] = dict(kw["devtrace"], kernels=kernels)
    t = tanalyze.analyze_records(recs, **kw)
    assert t["comm"]["devtrace"]["kernels"] == kernels
    j = janalyze.analyze_records(recs, **kw)
    assert "kernels" not in j["comm"]["devtrace"]
    t["comm"]["devtrace"].pop("kernels")
    assert _but_compile(t) == _but_compile(j)


# ---------------------------------------------------------------------------
# fault-bearing streams: the replay seam
# ---------------------------------------------------------------------------

ALL_FAULTS = ("drop=0.15,straggle=0.35,nan=0.1,scale=0.1:10x,signflip=0.1,"
              "collude=0.1:5x,labelflip=0.15")


def _faulty(fault_spec=ALL_FAULTS, n_rounds=14):
    """A stream with no replay stamps (the analyzer replays every round),
    a watchdog-retried round (its re-drawn cohort), per-site accuracy,
    per-slot drift and SLO events, at partial participation."""
    config = {"client_num_in_total": 10, "client_num_per_round": 5,
              "seed": 3, "fault_spec": fault_spec,
              "slo_spec": "p99:train_loss<0.4@w=4"}
    recs = _stream(n_rounds)
    for r, rec in enumerate(recs):
        rec["acc_per_client"] = [0.8 - (0.05 * r if c == 4 else 0.0)
                                 for c in range(10)]
        rec["slo_health"] = "ok" if r < 5 else "degraded"
        for j in range(5):
            rec[f"num_drift_s{j}"] = 0.1 + 0.01 * j
    recs[5]["rounds_retried"] = 1.0
    recs[9]["num_drift_s3"] = float("inf")
    recs[9]["clients_quarantined"] = 2.0
    events = [{"round": 5, "event_type": "SLO_BREACH",
               "severity": "warning",
               "detail": {"objectives": [{"objective": "p99"}]}},
              {"round": 9, "event_type": "HEALTH_TRANSITION",
               "severity": "warning", "detail": {"to": "degraded"}}]
    return recs, config, events


def _jax_trace(spec, seed, round_idx, client_ids):
    """The JAX package's replay at the port's seam (its ``FaultSpec`` has
    the same fields)."""
    return jfaults.fault_trace_round(spec, seed, round_idx, client_ids)


@pytest.mark.parametrize("fault_spec", [ALL_FAULTS, "straggle=0.4",
                                        "drop=0.5"])
def test_jax_draws_at_the_seam_give_the_jax_analysis(fault_spec):
    recs, config, events = _faulty(fault_spec)
    j = janalyze.analyze_records(json.loads(json.dumps(recs)),
                                 config=config, events=events)
    t = tanalyze.analyze_records(json.loads(json.dumps(recs)),
                                 config=config, events=events,
                                 fault_trace=_jax_trace)
    assert _but_compile(t) == _but_compile(j)
    assert j["health"]["replay"]["faults"]
    assert any(s["dropped"] or s["straggled"]
               for s in j["health"]["sites"].values())
    jl = jhealth.build_health_ledger(recs, config)
    tl = thealth.build_health_ledger(recs, config, fault_trace=_jax_trace)
    assert _text(tl) == _text(jl)
    assert thealth.render_health(tl) == jhealth.render_health(jl)
    jc = jhealth.make_fault_counts_fn(fault_spec, 3, 10, 5)
    tc = thealth.make_fault_counts_fn(fault_spec, 3, 10, 5,
                                      fault_trace=_jax_trace)
    for r in range(len(recs)):
        for retry in (0, 1):
            assert tc(r, retry=retry) == jc(r, retry=retry)


def test_port_draws_attribute_the_ports_replay():
    """Without the seam the port replays its own draws: the straggler
    rounds, the ledger's per-site counts and the SLO breaches' injected
    clients are those of ``robust.faults.fault_trace_round`` (the
    ``torch`` generators the port's rounds draw from), not the JAX
    package's."""
    recs, config, events = _faulty()
    t = tanalyze.analyze_records(recs, config=config, events=events)
    spec = tfaults.parse_fault_spec(ALL_FAULTS)
    straggled, sites = [], np.zeros((10, 3), np.int64)
    for r in range(len(recs)):
        retry = int(recs[r].get("rounds_retried") or 0)
        sel = thealth.replay_client_indexes(r, 10, 5, retry=retry)
        tr = tfaults.fault_trace_round(spec, 3, r, sel)
        eff = thealth._effective_masks(tr)
        if eff["straggled"].sum():
            straggled.append(r)
        sites[sel, 0] += tr["dropped"]
        sites[sel, 1] += tr["poisoned"]
        sites[sel, 2] += eff["straggled"]
    got = [s["round"] for s in t["stragglers"] if "fault_trace" in
           s["source"]]
    assert got == straggled and straggled
    for c in range(10):
        s = t["health"]["sites"][str(c)]
        assert [s["dropped"], s["quarantined"], s["straggled"]] == \
            sites[c].tolist()
    breach = {b["round"]: b for b in t["slo"]["breaches"]}
    sel = thealth.replay_client_indexes(5, 10, 5, retry=1)
    tr = tfaults.fault_trace_round(spec, 3, 5, sel)
    want = {k: [int(c) for c, hit in zip(sel, v) if hit]
            for k, v in {"poisoned": tr["poisoned"],
                         "dropped": tr["dropped"],
                         **thealth._effective_masks(tr)}.items()}
    assert breach[5]["injected"] == {k: v for k, v in want.items() if v}
    j = janalyze.analyze_records(recs, config=config, events=events)
    assert _but_compile(t) != _but_compile(j)


# ---------------------------------------------------------------------------
# one small CLI run per package
# ---------------------------------------------------------------------------

def _argv(root):
    return ["--algo", "fedavg", "--model", "small3dcnn", "--dataset",
            "synthetic", "--client_num_in_total", "8", "--batch_size", "8",
            "--epochs", "1", "--comm_round", "4", "--lr", "0.05",
            "--final_finetune", "0", "--log_dir", "",
            "--results_dir", os.path.join(root, "results"),
            "--obs", "1", "--trace_dir", os.path.join(root, "tr"),
            "--fault_spec", "straggle=0.4", "--watchdog", "0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CLI run on the CPU (torch on one thread) and the JAX
    CLI's run of the same command line, each into its own tree."""
    from neuroimagedisttraining_tpu.experiments import runner as jrunner
    from neuroimagedisttraining_torch.experiments import runner as trunner

    root = tmp_path_factory.mktemp("obs_analyze_runs")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t = trunner.main(_argv(str(root / "t")) + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    j = jrunner.main(_argv(str(root / "j")))
    return {"root": root, "t": t, "j": j}


def test_port_run_analyzed_by_the_port(runs):
    """``test_e2e_straggle_run_analyzed``'s acceptance on the port's run:
    the straggler rounds backed by the fault trace are exactly the rounds
    the port's replay of ``straggle=0.4`` fires in (and it fires), each
    attributed to ``train``; the records carry the schema stamp, the
    replayed counts and the per-site accuracy; the phases come from the
    trace; the ledger replays the faults. The compile section reads the
    port's kinds: a CPU run builds no kernel and captures no graph, so
    there is none to read, and the XLA kinds are absent."""
    root, out = runs["root"], runs["t"]
    run_dir = os.path.join(str(root), "t", "results", "synthetic")
    analyses = tanalyze.analyze_run_dir(
        run_dir, trace_dir=os.path.join(str(root), "t", "tr"))
    assert len(analyses) == 1
    a = analyses[0]
    tanalyze.validate_analysis(a)
    ap = os.path.join(run_dir, out["identity"] + ".analysis.json")
    assert a["analysis_path"] == ap
    with open(ap) as f:
        doc = json.load(f)
    tanalyze.validate_analysis(doc)
    janalyze.validate_analysis(doc)
    spec = tfaults.parse_fault_spec("straggle=0.4")
    expected = [r for r in range(4) if tfaults.fault_trace_round(
        spec, 0, r, np.arange(8))["straggled"].sum()]
    got = [s["round"] for s in a["stragglers"]
           if "fault_trace" in s["source"]]
    assert got == expected and expected
    assert all(s["phase"] == "train" for s in a["stragglers"]
               if "fault_trace" in s["source"])
    recs = texport.read_jsonl(os.path.join(run_dir,
                                           out["identity"] + ".obs.jsonl"))
    assert all(r["obs_schema"] == 1 for r in recs)
    assert all("clients_straggled" in r for r in recs if r["round"] >= 0)
    assert any(isinstance(r.get("acc_per_client"), list) for r in recs)
    assert {"train_dispatch", "device_and_wait"} <= set(a["phases"])
    assert a["health"]["replay"]["faults"]
    with open(os.path.join(run_dir, out["identity"] + ".metrics.json")) as f:
        metrics = json.load(f)
    assert not any(k in metrics for k in (
        "compile_trace_s", "compile_lower_s", "compile_backend_s"))
    assert set(tcompile.COMPILE_KINDS.values()) == {
        "compile_kernel_build_s", "compile_graph_capture_s"}
    assert a["compile"] == {"present": False, "total_s": 0.0,
                            "by_entry": {}, "cache": {}}


def test_jax_run_analyzed_by_the_port_with_jax_draws(runs):
    """The port's analyzer on the JAX CLI's run dir, the JAX draws at the
    seam, against the JAX analyzer: equal JSON (bitwise) but ``compile``
    (the JAX run's XLA kinds, which the port does not read); no
    ``analysis.json`` is written (``write=False``), so no absolute path
    enters either document."""
    root = str(runs["root"])
    run_dir = os.path.join(root, "j", "results", "synthetic")
    tr = os.path.join(root, "j", "tr")
    j = janalyze.analyze_run_dir(run_dir, trace_dir=tr, write=False)
    t = tanalyze.analyze_run_dir(run_dir, trace_dir=tr, write=False,
                                 fault_trace=_jax_trace)
    assert len(j) == len(t) == 1
    assert "analysis_path" not in t[0]
    assert _but_compile(t[0]) == _but_compile(j[0])
    assert j[0]["stragglers"] and j[0]["compile"]["present"]
