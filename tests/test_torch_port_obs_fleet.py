"""The fleet half of the port's offline tier (``obs/catalog.py``'s scan and
rebuild, ``obs/report.py``, ``obs/regress.py``'s gate and parsers) held to
the JAX package's on the same inputs.

* ``catalog``: ``entry_from_run``, ``scan`` and ``rebuild`` give the JAX
  package's line bytes on the same run dirs (hand-seeded ones and a port
  CLI run's); ``final_metrics_from_records`` the same fold; the port's
  rebuilt line equals the line its session wrote live but the git SHA
  (which a rebuild cannot know, in both packages).
* ``report``: ``build_report`` / ``write_report`` give the JAX package's
  bytes on the same catalog, history and federation dirs. No string of
  the report names a package (:data:`PACKAGE_STRINGS` is empty and the
  test says so); two generations are byte-identical.
* ``regress``: ``gate`` and ``metric_gate_defaults`` give the same
  verdicts on the same history; the committed ``BENCH_r*`` /
  ``MULTICHIP_r*`` artifacts parse and backfill alike; the port's ``obs
  regress`` with no history exits 2 and reads no ``BENCH_r*``.

Every comparison is bitwise (equal bytes or equal values).
"""
import glob
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.obs import __main__ as jmain  # noqa: E402
from neuroimagedisttraining_tpu.obs import catalog as jcatalog  # noqa: E402
from neuroimagedisttraining_tpu.obs import regress as jregress  # noqa: E402
from neuroimagedisttraining_tpu.obs import report as jreport  # noqa: E402
from neuroimagedisttraining_torch.obs import __main__ as tmain  # noqa: E402
from neuroimagedisttraining_torch.obs import catalog as tcatalog  # noqa: E402
from neuroimagedisttraining_torch.obs import regress as tregress  # noqa: E402
from neuroimagedisttraining_torch.obs import report as treport  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the strings of the fleet report that name a package: none (the HTML
#: names runs, flags and metrics only), so the two packages' reports are
#: compared whole
PACKAGE_STRINGS = ()


def _write_jsonl(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# catalog: scan / rebuild / final metrics
# ---------------------------------------------------------------------------

def _seed_run(run_dir, identity, with_final=False, with_metrics_json=False,
              health=None, config=None):
    records = [{"round": r, "obs_schema": 4, "train_loss": 1.0 / (r + 1),
                "global_acc": 0.5 + 0.1 * r} for r in range(3)]
    if health:
        for rec, h in zip(records, health):
            rec["slo_health"] = h
    if with_final:
        records.append({"round": -1, "global_acc": 0.75, "obs_schema": 4})
    _write_jsonl(os.path.join(run_dir, identity + ".obs.jsonl"), records)
    _write_jsonl(os.path.join(run_dir, identity + ".events.jsonl"),
                 [{"round": 1, "event_type": "SLO_BREACH",
                   "severity": "warning"},
                  {"round": 2, "event_type": "SLO_BREACH",
                   "severity": "warning"},
                  {"round": 2, "event_type": "SLO_RECOVERY",
                   "severity": "info"}])
    with open(os.path.join(run_dir, identity + ".json"), "w") as f:
        json.dump({"config": config or {
            "dataset": "synthetic", "algo": "fedavg",
            "fault_spec": "nan=0.1"}}, f)
    if with_metrics_json:
        with open(os.path.join(run_dir, identity + ".metrics.json"),
                  "w") as f:
            json.dump({}, f)


def _seeded_results(tmp_path):
    results = str(tmp_path / "results")
    run_dir = os.path.join(results, "synthetic")
    os.makedirs(run_dir)
    _seed_run(run_dir, "run-a", with_final=True,
              health=["ok", "degraded", "degraded"])
    _seed_run(run_dir, "run-b")
    _seed_run(run_dir, "run-c", with_metrics_json=True)
    other = os.path.join(results, "cifar10")
    os.makedirs(other)
    _seed_run(other, "run-d", config={"dataset": "cifar10",
                                      "algo": "salientgrads"})
    return results


def test_scan_and_rebuild_give_the_jax_lines(tmp_path):
    results = _seeded_results(tmp_path)
    for run_dir in (os.path.join(results, "synthetic"),
                    os.path.join(results, "cifar10"),
                    str(tmp_path / "missing")):
        assert json.dumps(tcatalog.scan(run_dir), sort_keys=True) == \
            json.dumps(jcatalog.scan(run_dir), sort_keys=True)
    e = tcatalog.entry_from_run(os.path.join(results, "synthetic"), "run-a",
                                git_sha="abc")
    assert e == jcatalog.entry_from_run(os.path.join(results, "synthetic"),
                                        "run-a", git_sha="abc")
    assert e["completed"] and e["final_metrics"]["global_acc"] == 0.75
    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert tcatalog.rebuild(results, path=tp, force=True) == \
        jcatalog.rebuild(results, path=jp, force=True) == 4
    assert _read(tp) == _read(jp)
    first = _read(tp)
    tcatalog.rebuild(results, path=tp, force=True)
    assert _read(tp) == first


def test_final_metrics_fold_equals_jax():
    recs = [{"round": 2, "train_loss": 0.3, "global_acc": 0.6},
            {"round": -1, "global_acc": 0.9, "personal_acc": 0.8},
            {"round": 0, "train_loss": 0.9, "global_loss": 1.0},
            {"round": 1, "train_loss": 0.5, "personal_loss": True},
            {"round": "x", "train_loss": 7.0}]
    got = tcatalog.final_metrics_from_records(recs)
    assert got == jcatalog.final_metrics_from_records(recs)
    assert got == {"train_loss": 0.3, "global_loss": 1.0,
                   "global_acc": 0.9, "personal_acc": 0.8}


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """One port CLI run on the CPU with the catalog on and an SLO spec
    (the events stream), torch on one thread."""
    from neuroimagedisttraining_torch.experiments import runner as trunner

    root = tmp_path_factory.mktemp("obs_fleet_run")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = trunner.main([
            "--algo", "salientgrads", "--model", "small3dcnn", "--dataset",
            "synthetic", "--comm_round", "3", "--log_dir", "",
            "--results_dir", str(root / "results"), "--obs", "1",
            "--slo_spec", "p99:train_loss<0.01", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return root, out


def test_port_run_rebuilds_its_live_line(port_run, tmp_path):
    """A rebuild of the port's run gives the line its session appended at
    close, byte for byte, once the rebuild is given the live git SHA (the
    one field a rebuild cannot recover; the JAX package's rebuild leaves
    it empty too); the JAX package's rebuild of the same dir gives the
    same bytes (its ``run_identity`` keys the checkpoint lineage alike)."""
    root, out = port_run
    results = str(root / "results")
    (live,) = tcatalog.read_catalog(tcatalog.catalog_path(results))
    assert live["completed"] and live["slo_health"]
    assert live["checkpoint_identity"]
    assert live["event_counts"] == {"SLO_BREACH": 1}
    run_dir = os.path.join(results, "synthetic")
    t = tcatalog.entry_from_run(run_dir, out["identity"],
                                git_sha=live["git_sha"])
    j = jcatalog.entry_from_run(run_dir, out["identity"],
                                git_sha=live["git_sha"])
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True) \
        == json.dumps(live, sort_keys=True)
    tp, jp = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    tcatalog.rebuild(results, path=tp, force=True)
    jcatalog.rebuild(results, path=jp, force=True)
    assert _read(tp) == _read(jp)
    assert json.loads(_read(tp)) == dict(live, git_sha="")


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _seed_fleet(tmp_path, n_runs=3):
    """A results tree with cataloged runs (streams, events, comm stamps,
    an incomplete run, a missing stream), a bench history under both
    packages' default names, and a federation run dir."""
    results = str(tmp_path / "results")
    run_dir = os.path.join(results, "synthetic")
    cat = jcatalog.catalog_path(results)
    for i in range(n_runs):
        ident = f"run-{i}"
        records = [{"round": r, "train_loss": 1.0 / (r + i + 1),
                    "global_acc": 0.1 * (r + 1), "personal_acc": 0.3,
                    "slo_health": ["ok", "degraded", "failing"][r % 3],
                    "comm_bytes_wire": 1024.0, "comm_density": 0.5,
                    "comm_n_params": 1000, "comm_n_devices": 2}
                   for r in range(4)]
        jsonl = os.path.join(run_dir, ident + ".obs.jsonl")
        if i < 2:
            _write_jsonl(jsonl, records)
        ev_path = os.path.join(run_dir, ident + ".events.jsonl")
        _write_jsonl(ev_path, [{"round": 1, "event_type": "SLO_BREACH"},
                               {"round": 1, "event_type": "BUDGET_BURN"}])
        e = jcatalog.build_entry(
            ident, config={"dataset": "synthetic", "algo": "fedavg",
                           "agg_impl": "int8", "lr": 0.05 * (i + 1)},
            final_metrics={"train_loss": 1.0 / (2 + i + 1)},
            git_sha="0123456789abcdef", slo_health="degraded",
            rounds_recorded=4, event_counts={"SLO_BREACH": 1},
            artifacts={"obs_jsonl": jsonl, "events_jsonl": ev_path},
            completed=(i != 1))
        jcatalog.append_entry(cat, e, force=True)
    history = [{"metric": "salientgrads_rounds_per_sec_abcd_8clients",
                "value": 4.4}, {"metric": "fedavg_rounds_per_sec_32clients",
                                "value": 1.25},
               {"metric": "agg_ms_dense", "value": 0.5}]
    _write_jsonl(os.path.join(results, "bench_torch_history.jsonl"),
                 history)
    _write_jsonl(os.path.join(results, "bench_history.jsonl"), history[:1])
    fed = os.path.join(results, "fed_run")
    _write_jsonl(os.path.join(fed, "aggregator.jsonl"),
                 [{"round": r, "train_loss": 0.7 - 0.1 * r, "wall_s": 1.0}
                  for r in range(3)])
    _write_jsonl(os.path.join(fed, "site1.jsonl"),
                 [{"round": r, "site": 1, "fed_straggled": r == 1,
                   "train_loss": 0.6, "wall_s": 0.5} for r in range(3)])
    _write_jsonl(os.path.join(fed, "federation.jsonl"), [{"round": 0}])
    with open(os.path.join(fed, "federation.trace.json"), "w") as f:
        json.dump({"traceEvents": []}, f)
    return results, cat


def test_report_bytes_equal_jax(tmp_path):
    results, cat = _seed_fleet(tmp_path)
    hist = os.path.join(results, "bench_torch_history.jsonl")
    tp = treport.write_report(str(tmp_path / "t.html"), cat,
                              history_path=hist)
    jp = jreport.write_report(str(tmp_path / "j.html"), cat,
                              history_path=hist)
    t, j = _read(tp), _read(jp)
    for s in PACKAGE_STRINGS:  # none to take out
        t, j = t.replace(s, b""), j.replace(s, b"")
    assert t == j
    assert b"neuroimagedisttraining" not in t
    html = t.decode()
    assert all(k in html for k in (
        "run-0", "run-2", "INCOMPLETE", "<polyline", "wire bytes/round",
        "Federation lanes", "fed_run", "<circle", "32 clients"))
    treport.write_report(str(tmp_path / "t2.html"), cat, history_path=hist)
    assert _read(str(tmp_path / "t2.html")) == _read(tp)
    entries = tcatalog.read_catalog(cat)
    assert treport.build_report(entries) == jreport.build_report(entries)
    assert treport.build_report([]) == jreport.build_report([])


def test_report_cli_reads_the_ports_history(tmp_path):
    """``obs report`` defaults its history to the port's
    ``bench_torch_history.jsonl`` under the results dir (the JAX CLI to
    its ``bench_history.jsonl``): given each other's file the two CLIs
    write the same bytes."""
    results, cat = _seed_fleet(tmp_path)
    out = []
    assert tmain.fleet_report_cli(results, out_path=str(tmp_path / "t.html"),
                                  out=out.append) == 0
    assert jmain.fleet_report_cli(
        results, out_path=str(tmp_path / "j.html"), out=out.append,
        history=os.path.join(results, "bench_torch_history.jsonl")) == 0
    assert _read(str(tmp_path / "t.html")) == _read(str(tmp_path / "j.html"))
    assert b"32 clients" in _read(str(tmp_path / "t.html"))
    assert tmain.fleet_report_cli(str(tmp_path / "empty")) == \
        jmain.fleet_report_cli(str(tmp_path / "empty")) == 2


# ---------------------------------------------------------------------------
# regress
# ---------------------------------------------------------------------------

METRICS = ("salientgrads_rounds_per_sec_abcd_alexnet3d_8clients",
           "scale32_agg_ms", "scale32_agg_share", "agg_ms_dense-kcuda_x",
           "agg_bytes_int8_x", "cohort_mem_bytes_32", "store_gather_ms_x",
           "cohort_rounds_per_sec_16")


def test_gate_and_defaults_equal_jax(tmp_path):
    path = str(tmp_path / "h.jsonl")
    for i, v in enumerate((1.0, 1.02, 0.98, 1.01, 0.99, 1.0)):
        for m in METRICS:
            tregress.append_history(path, {"metric": m, "value": v},
                                    git_sha="sha-%d" % (i % 2))
    for m in METRICS:
        assert tregress.metric_gate_defaults(m) == \
            jregress.metric_gate_defaults(m)
        d = tregress.metric_gate_defaults(m)
        for v in (1.0, 0.8, 1.2, 0.96):
            for excl in ("", "sha-1"):
                kw = dict(rel_threshold=d.get("rel_threshold", 0.05),
                          mad_k=d.get("mad_k", 4.0),
                          higher_is_better=d.get("higher_is_better", True),
                          exclude_git_sha=excl)
                assert tregress.gate(path, m, v, **kw) == \
                    jregress.gate(path, m, v, **kw)
    assert tregress.gate(str(tmp_path / "none"), METRICS[0], 1.0) == \
        jregress.gate(str(tmp_path / "none"), METRICS[0], 1.0)
    assert tregress.gate(str(tmp_path / "none"), METRICS[0],
                         1.0)["exit_code"] == tregress.EXIT_NO_HISTORY == 2
    assert (tregress.EXIT_OK, tregress.EXIT_REGRESSION) == (0, 1)


def test_committed_artifacts_parse_and_backfill_alike(tmp_path):
    for path in sorted(glob.glob(os.path.join(ROOT, "BENCH_r*.json"))):
        assert tregress.parse_bench_artifact(path) == \
            jregress.parse_bench_artifact(path)
    for path in sorted(glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json"))):
        assert tregress.parse_multichip_artifact(path) == \
            jregress.parse_multichip_artifact(path)
    text = 'x\n{"metric": "m", "value": 1}\n{"bad"\n{"metric": "n"}\n'
    assert tregress.last_json_result(text) == \
        jregress.last_json_result(text) == {"metric": "m", "value": 1}
    assert tregress.MULTICHIP_METRICS == jregress.MULTICHIP_METRICS
    hists = {}
    for name, mod in (("t", tregress), ("j", jregress)):
        h = str(tmp_path / f"{name}.jsonl")
        n = (mod.backfill_bench_files(ROOT, h),
             mod.backfill_multichip_files(ROOT, h))
        assert mod.backfill_bench_files(ROOT, h) == 0  # idempotent
        hists[name] = (n, [{k: v for k, v in e.items() if k != "ts"}
                           for e in mod.read_history(h)])
    assert hists["t"] == hists["j"] and sum(hists["t"][0]) > 0


def test_regress_cli_without_history_exits_2_and_reads_no_bench(
        tmp_path, monkeypatch, capsys):
    """The port's ``obs regress`` in a directory holding the committed
    TPU artifacts and no history: exit 2 (no verdict), no history file
    written, no ``BENCH_r*`` / ``MULTICHIP_r*`` parsed. The JAX CLI in the
    same place backfills its default history from them and judges."""
    for path in glob.glob(os.path.join(ROOT, "BENCH_r*.json")) + \
            glob.glob(os.path.join(ROOT, "MULTICHIP_r*.json")):
        shutil.copy(path, tmp_path)
    monkeypatch.chdir(tmp_path)

    def refuse(*a, **k):
        raise AssertionError("the port's regress read a TPU artifact")

    for name in ("backfill_bench_files", "backfill_multichip_files",
                 "parse_bench_artifact", "parse_multichip_artifact"):
        monkeypatch.setattr(tregress, name, refuse)
    metric = "salientgrads_rounds_per_sec_abcd_alexnet3d_8clients"
    argv = ["regress", "--metric", metric, "--value", "1.66"]
    assert tmain.main(argv) == 2
    verdict = json.loads(capsys.readouterr().out)
    assert verdict["exit_code"] == 2 and verdict["history_points"] == 0
    assert not os.path.exists(tmp_path / "results")
    assert jmain.main(argv) in (0, 1)
    assert json.loads(capsys.readouterr().out)["history_points"] > 0
    hist = os.path.join("results", "bench_torch_history.jsonl")
    for v in (4.4, 4.5, 4.45):
        tregress.append_history(hist, {"metric": metric, "value": v},
                                git_sha="")
    assert tmain.main(["regress", "--metric", metric, "--value",
                       "4.43"]) == 0
    assert tmain.main(["regress", "--metric", metric, "--value",
                       "2.0"]) == 1
