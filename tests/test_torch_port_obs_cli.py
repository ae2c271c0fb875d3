"""``python -m neuroimagedisttraining_torch.obs``: the port's nine offline
subcommands (``analyze``, ``tail``, ``slo``, ``regress``, ``ls``, ``diff``,
``report``, ``watch``, ``xtrace``) held to the JAX package's
``neuroimagedisttraining_tpu.obs`` CLI on the same inputs.

The inputs are real runs of the port on the CPU, made once for the module:
a SalientGrads CLI run with the in-process obs tier on (faults, an SLO
spec, numerics), its exact twin in another results dir, a run that differs
(another learning rate), and a two-round loopback federation with
``--xtrace``, heartbeats and site 2 straggling. Both CLIs run in-process
(``main(argv)``, their output captured); one subprocess checks the ``-m``
entry point itself.

Each subcommand must give the JAX CLI's exit code, the empty-dir and
missing-target cases (exit 2) included. These outputs are held equal byte
for byte: ``watch --once`` (also against the frame pinned in
``tests/test_live.py``), ``xtrace --json``, ``slo --json`` (and its text),
``tail --once`` and ``tail --all``, ``diff --json``, ``ls --json``, the
``report`` HTML and the ``regress`` verdict. ``analyze``'s JSON is held in
``tests/test_torch_port_obs_analyze.py`` (it differs in ``compile``).
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.obs import __main__ as jmain  # noqa: E402
from neuroimagedisttraining_torch.obs import __main__ as tmain  # noqa: E402
from neuroimagedisttraining_torch.obs import prom as tprom  # noqa: E402
from neuroimagedisttraining_torch.obs import regress as tregress  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the offline tier's modules, and the standard library they import
#: beside torch, numpy and what the port's other modules import
#: (``tests/test_torch_port_collectives.py``'s allow-list)
OFFLINE_MODULES = ("obs/analyze.py", "obs/report.py", "obs/__main__.py",
                   "obs/catalog.py", "obs/health.py", "obs/regress.py",
                   "obs/devtrace.py")
ALLOWED_IMPORTS = (
    "torch", "numpy", "__future__", "typing", "math", "ctypes", "hashlib",
    "os", "shutil", "subprocess", "time", "pathlib", "abc", "logging",
    "dataclasses", "threading",
    # the offline tier's own
    "json", "sys", "argparse", "html", "re", "glob", "gzip", "bisect",
    "urllib")


def _salientgrads(results, *extra):
    return ["--algo", "salientgrads", "--model", "small3dcnn", "--dataset",
            "synthetic", "--comm_round", "3", "--log_dir", "",
            "--results_dir", results, "--obs", "1", "--obs_numerics", "1",
            "--slo_spec", "p99:train_loss<0.01",
            "--fault_spec", "straggle=0.4,nan=0.2", "--watchdog", "0",
            "--device", "cpu"] + list(extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's runs on the CPU (torch on one thread): ``a`` and, at
    another learning rate, ``other`` under one results dir; ``a``'s exact
    twin under its own; the federation under a third."""
    from neuroimagedisttraining_torch.experiments import runner as trunner

    root = tmp_path_factory.mktemp("obs_cli_runs")
    results, twin = str(root / "results"), str(root / "twin")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a = trunner.main(_salientgrads(results))
        trunner.main(_salientgrads(twin))
        other = trunner.main(_salientgrads(results, "--lr", "0.01"))
        fed = trunner.main([
            "--algo", "fedavg", "--dataset", "synthetic", "--model",
            "small3dcnn", "--client_num_in_total", "4", "--comm_round", "2",
            "--final_finetune", "0", "--log_dir", "", "--results_dir",
            str(root / "fedres"), "--fed_role", "aggregator", "--fed_mode",
            "sync", "--fed_sites", "2", "--xtrace", "1",
            "--obs_heartbeat_every", "0.3",
            "--fed_site_faults", "2:straggle=1.0:0.5", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    empty = root / "empty"
    empty.mkdir()
    return {"root": str(root), "results": results,
            "run_dir": os.path.join(results, "synthetic"),
            "twin_dir": os.path.join(twin, "synthetic"),
            "a": a["identity"], "other": other["identity"],
            "fed_dir": fed["fed"]["out_dir"], "empty": str(empty),
            "missing": str(root / "missing")}


def _run(main, argv, capsys):
    """One in-process CLI call: ``(exit code, stdout, stderr)``."""
    code = main(argv)
    got = capsys.readouterr()
    return code, got.out, got.err


def _same(argv, capsys, out=True, err=False):
    """Both CLIs on ``argv``: the same exit code, and (``out``/``err``)
    the same stdout/stderr bytes. Returns the port's result."""
    t = _run(tmain.main, argv, capsys)
    j = _run(jmain.main, argv, capsys)
    assert t[0] == j[0], (argv, t, j)
    if out:
        assert t[1] == j[1], argv
    if err:
        assert t[2] == j[2], argv
    return t


def test_analyze_exit_codes(runs, capsys):
    """``analyze`` exits 0 on a run dir and 2 on a dir with no stream; a
    missing dir raises ``ValueError`` in both."""
    assert _same(["analyze", runs["run_dir"], "--no-write"], capsys,
                 out=False)[0] == 0
    assert _same(["analyze", runs["empty"]], capsys, err=True)[0] == 2
    for main in (tmain.main, jmain.main):
        with pytest.raises(ValueError, match="not a directory"):
            main(["analyze", runs["missing"]])


def test_tail_once_all_and_events(runs, capsys):
    ident = runs["a"]
    code, out, _ = _same(["tail", runs["run_dir"], "--identity", ident,
                          "--once"], capsys, err=True)
    assert code == 0 and len(out.splitlines()) == 3 + 1  # rounds + final
    assert _same(["tail", os.path.join(runs["run_dir"],
                                       ident + ".obs.jsonl"), "--once"],
                 capsys)[0] == 0
    assert _same(["tail", runs["run_dir"], "--identity", ident, "--once",
                  "--events"], capsys, err=True)[1]
    code, out, _ = _same(["tail", runs["results"], "--all"], capsys)
    assert code == 0 and len(out.splitlines()) == 2
    assert _same(["tail", runs["fed_dir"], "--all"], capsys)[0] == 0
    for target in (runs["empty"], runs["missing"]):
        assert _same(["tail", target, "--once"], capsys, err=True)[0] == 2
        assert _same(["tail", target, "--all"], capsys)[0] == 2


def test_slo_replay(runs, capsys):
    code, out, _ = _same(["slo", runs["run_dir"], "--identity", runs["a"],
                          "--json"], capsys)
    assert code == 0 and json.loads(out)["events_total"] > 0
    assert _same(["slo", runs["run_dir"]], capsys)[0] == 0
    assert _same(["slo", runs["run_dir"], "--enforce"], capsys)[0] in (0, 1)
    assert _same(["slo", runs["run_dir"], "--slo_spec",
                  "p99:train_loss<100", "--enforce", "--json"],
                 capsys)[0] == 0
    for target in (runs["empty"], runs["missing"]):
        assert _same(["slo", target], capsys, err=True)[0] == 2


def test_regress_verdicts(runs, capsys, tmp_path):
    metric = "salientgrads_rounds_per_sec_abcd_alexnet3d_8clients"
    hist = str(tmp_path / "h.jsonl")
    for v in (4.4, 4.5, 4.45, 4.42):
        tregress.append_history(hist, {"metric": metric, "value": v},
                                git_sha="")
    for value, want in (("4.43", 0), ("3.0", 1)):
        assert _same(["regress", "--history", hist, "--metric", metric,
                      "--value", value], capsys)[0] == want
    assert _same(["regress", "--history", hist, "--metric", metric,
                  "--value", "6.0", "--lower-is-better"], capsys)[0] == 1
    assert _same(["regress", "--history", str(tmp_path / "none.jsonl"),
                  "--metric", metric, "--value", "1"], capsys)[0] == 2


def test_ls_and_rebuild(runs, capsys, tmp_path):
    code, out, _ = _same(["ls", runs["results"], "--json"], capsys)
    assert code == 0 and [e["identity"] for e in json.loads(out)] == \
        sorted([runs["a"], runs["other"]])
    assert _same(["ls", runs["results"]], capsys)[0] == 0
    for name in ("t", "j"):
        shutil.copytree(runs["results"], str(tmp_path / name))
    t = _run(tmain.main, ["ls", str(tmp_path / "t"), "--rebuild",
                          "--json"], capsys)
    j = _run(jmain.main, ["ls", str(tmp_path / "j"), "--rebuild",
                          "--json"], capsys)
    assert t[0] == j[0] == 0
    assert t[1].replace(str(tmp_path / "t"), "R") == \
        j[1].replace(str(tmp_path / "j"), "R")
    for target in (runs["empty"], runs["missing"]):
        assert _same(["ls", target], capsys, err=True)[0] == 2


def test_diff_twin_and_other(runs, capsys):
    a = os.path.join(runs["run_dir"], runs["a"] + ".obs.jsonl")
    twin = os.path.join(runs["twin_dir"], runs["a"] + ".obs.jsonl")
    other = os.path.join(runs["run_dir"], runs["other"] + ".obs.jsonl")
    code, out, _ = _same(["diff", a, twin, "--json"], capsys)
    assert code == 0 and json.loads(out)
    assert _same(["diff", a, twin, "--expect", "identical"], capsys)[0] == 0
    assert _same(["diff", a, twin, "--expect", "different"], capsys)[0] == 1
    assert _same(["diff", a, other, "--expect", "identical", "--json"],
                 capsys)[0] == 1
    assert _same(["diff", a, other, "--expect", "different",
                  "--metrics", "train_loss"], capsys)[0] == 0
    assert _same(["diff", runs["run_dir"], twin, "--identity-a", runs["a"],
                  "--json"], capsys)[0] == 0
    assert _same(["diff", a, runs["missing"]], capsys, err=True)[0] == 2


def test_report_html(runs, capsys, tmp_path):
    hist = str(tmp_path / "h.jsonl")
    tregress.append_history(hist, {"metric": "x_rounds_per_sec_8clients",
                                   "value": 4.4}, git_sha="")
    outs = {}
    for name, main in (("t", tmain.main), ("j", jmain.main)):
        outs[name] = str(tmp_path / f"{name}.html")
        assert main(["report", runs["results"], "--out", outs[name],
                     "--history", hist]) == 0
    capsys.readouterr()
    with open(outs["t"], "rb") as f, open(outs["j"], "rb") as g:
        t = f.read()
        assert t == g.read() and b"<circle" in t
    for target in (runs["empty"], runs["missing"]):
        assert _same(["report", target], capsys, err=True)[0] == 2


def test_watch_frames(runs, capsys, tmp_path):
    """``watch --once``: the frame pinned in ``tests/test_live.py`` from a
    run dir's ``fleet.json`` (plain and colored, with the aggregator's
    SLO verdict), the federation run's own snapshot, a ``/metrics``
    endpoint's summary header; exit 2 with no snapshot."""
    from test_live import _FRAME_PLAIN, _FROZEN_SNAPSHOT

    d = tmp_path / "frozen"
    d.mkdir()
    (d / "fleet.json").write_text(json.dumps(_FROZEN_SNAPSHOT))
    code, out, _ = _same(["watch", str(d), "--once", "--color", "0"],
                         capsys)
    assert code == 0 and out == _FRAME_PLAIN + "\n"
    with open(d / "aggregator.jsonl", "w") as f:
        f.write(json.dumps({"round": 7, "slo_health": "degraded"}) + "\n")
    assert "\x1b[33mDEGRADED" in _same(
        ["watch", str(d / "fleet.json"), "--once", "--color", "1"],
        capsys)[1]
    assert "site2" in _same(["watch", runs["fed_dir"], "--once"],
                            capsys)[1]
    server = tprom.PromServer(lambda: {
        "fleet_sites_live": {"type": "gauge", "value": 2.0},
        "fleet_sites_down": {"type": "gauge", "value": 1.0},
        "train_loss": {"type": "gauge", "value": 0.5}}).start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        assert "live 2/" in _same(["watch", url, "--once"], capsys)[1]
    finally:
        server.close()
    for target in (runs["empty"], runs["missing"]):
        assert _same(["watch", target, "--once"], capsys, err=True)[0] == 2


def test_xtrace_names_the_straggling_site(runs, capsys):
    code, out, _ = _same(["xtrace", runs["fed_dir"], "--json"], capsys)
    xt = json.loads(out)
    assert code == 0 and xt["present"] and not xt["orphans"]
    assert all(r["straggler"] == "site2" for r in xt["rounds"])
    assert xt["straggler_counts"] == {"site2": 2}
    assert _same(["xtrace", runs["fed_dir"], "--enforce"], capsys)[0] == 0
    for target in (runs["empty"], runs["missing"]):
        assert _same(["xtrace", target], capsys, err=True)[0] == 2


def test_module_entry_point(runs):
    """``python -m neuroimagedisttraining_torch.obs`` as a user runs it:
    its ``prog``, and ``xtrace --json`` printing what the in-process call
    prints."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    help_ = subprocess.run(
        [sys.executable, "-m", "neuroimagedisttraining_torch.obs", "xtrace",
         runs["fed_dir"], "--json"], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120)
    assert help_.returncode == 0, help_.stderr
    xt = json.loads(help_.stdout)
    assert xt["straggler_counts"] == {"site2": 2}
    usage = subprocess.run(
        [sys.executable, "-m", "neuroimagedisttraining_torch.obs"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert usage.returncode == 2
    assert "python -m neuroimagedisttraining_torch.obs" in usage.stderr


@pytest.mark.parametrize("module", OFFLINE_MODULES)
def test_offline_modules_import_the_allowed_set(module):
    """The offline tier imports torch, numpy and the standard library only
    (the package-wide walk for JAX is in ``tests/test_torch_port_round.py``):
    the allow-list of ``tests/test_torch_port_collectives.py`` and the
    standard-library modules these files use."""
    path = os.path.join(ROOT, "neuroimagedisttraining_torch", module)
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] in ALLOWED_IMPORTS, (module, mod)
