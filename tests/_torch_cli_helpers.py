"""Shared by the port's CLI tests (``tests/test_torch_port_cli.py``,
``tests/test_torch_port_cli_runs.py``, ``tests/test_torch_port_cli_mesh.py``):
the small command line, the image CLI's run against the JAX CLI's, both
sides' ``build_algorithm``, the reference's ``stat_info`` keys, and the
observability tier's runs (:func:`jax_obs_run`, :func:`run_obs_case`), the
way ``tests/_torch_mesh_workers.py`` holds the mesh helpers."""
import argparse
import json
import os
import pickle

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--dataset", "synthetic", "--model", "small3dcnn"]


def _run_image_cli(tmp_path, argv, reference_run=True):
    """``argv`` on 2 clients of pickled CIFAR-10 batches, one round of one
    epoch: the port's CLI in-process against the JAX CLI's: the same
    identity, ``stat_info`` path and keys, record keys round by round, the
    built cohort bitwise (pad value included) and the same parameter
    names; finite losses; the crop and flip wired on both sides. With
    ``reference_run`` the JAX CLI runs the command too; without it (a
    full-width ResNet-18, whose XLA:CPU compile would take minutes) the
    JAX side is built, not run, and the port's ``stat_info`` keys are held
    to a clean reference run's (``_stat_keys``)."""
    from test_torch_port_image_data import _write_cifar

    _write_cifar(str(tmp_path), "cifar10", 0)
    built = {}
    build = trunner.build_algorithm

    def capture(*args, **kwargs):
        built["algo"], built["data"] = build(*args, **kwargs)
        return built["algo"], built["data"]

    argv = argv + ["--data_dir", str(tmp_path), "--client_num_in_total", "2",
                   "--comm_round", "1", "--epochs", "1", "--batch_size", "16"]
    jargs = jconfig.parse_args(argv)
    ja, jd = jrunner.build_algorithm(jargs, jargs.algo)
    trunner.build_algorithm = capture
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops among the suite's parallel workers
    try:
        t = trunner.main(argv + ["--results_dir", str(tmp_path / "t"),
                                 "--log_dir", "", "--device", "cpu"])
    finally:
        trunner.build_algorithm = build
        torch.set_num_threads(threads)
    assert t["identity"] == jconfig.run_identity(jargs, jargs.algo)
    assert os.path.relpath(t["stat_path"], tmp_path / "t") == os.path.join(
        "cifar10", t["identity"])
    pc.assert_data_equal(built["data"], jd)
    assert built["data"].aug_pad_value == jd.aug_pad_value is not None
    shapes = jax.eval_shape(lambda: jinit(
        ja.model, jax.random.PRNGKey(0), tuple(jd.sample_shape)))
    assert sorted(".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_leaves_with_path(shapes)) == \
        sorted(dict(built["algo"].model.named_parameters()))
    with open(t["stat_path"], "rb") as f:
        ts = pickle.load(f)
    if reference_run:
        j = jrunner.main(argv + ["--results_dir", str(tmp_path / "j"),
                                 "--log_dir", ""])
        assert j["identity"] == t["identity"]
        assert os.path.relpath(j["stat_path"], tmp_path / "j") == \
            os.path.relpath(t["stat_path"], tmp_path / "t")
        assert [sorted(h) for h in t["history"]] == \
            [sorted(h) for h in j["history"]]
        with open(j["stat_path"], "rb") as f:
            assert sorted(ts) == sorted(pickle.load(f))
    else:
        assert sorted(ts) == _stat_keys(tmp_path)
    assert all(np.isfinite(h["train_loss"]) for h in t["history"]
               if h["round"] >= 0)
    assert built["algo"].augment_fn is not None and ja.augment_fn is not None
    assert built["algo"].loss_type == ja.loss_type == "ce"


def _built(algo, argv):
    """Both sides' ``build_algorithm`` from one unified-parser command
    line (whose fedfomo ``--val_fraction`` default carves a validation
    split on both)."""
    argv = ["--algo", algo] + argv
    j_algo, j_data = jrunner.build_algorithm(jconfig.parse_args(argv), algo)
    t_algo, t_data = trunner.build_algorithm(
        tconfig.parse_args(argv + ["--device", "cpu"]), algo)
    return j_algo, j_data, t_algo, t_data


def _stat_keys(tmp_path):
    """The top-level keys of the reference's stat_info for a clean run."""
    ns = argparse.Namespace(results_dir=str(tmp_path / "keys"),
                            dataset="synthetic")
    path = jrunner.save_stat_info(ns, "x", [], {}, fault_counters={})
    with open(path, "rb") as f:
        return sorted(pickle.load(f))


# -- the observability tier (--obs and the flags that ride it) -------------

#: the command line of the obs cases: every client poisoned (``nan=1.0``),
#: so the guard quarantines in every round on both sides whatever their
#: draws, and the flight recorder's ``guard`` trigger has its bundles
OBS_ARGV = ["--algo", "salientgrads"] + SMALL + [
    "--comm_round", "2", "--epochs", "1", "--frac", "0.5",
    "--fault_spec", "nan=1.0", "--frequency_of_the_test", "1"]
#: the seven in-process obs flags as the CLI refusal table held them, by
#: case id, each with what completes its command line on the port's side
#: (the JAX CLI runs all seven at once: :func:`jax_obs_run`)
OBS_CASES = {
    "--obs 1": [],
    "--obs_numerics 1": ["--obs", "1"],
    "--obs_comm 1": ["--obs", "1"],
    "--trace_dir tr": ["--obs", "1"],
    "--slo_spec p99:round_time_s<2": ["--obs", "1"],
    "--flight_recorder guard": ["--obs", "1"],
    "--profile_dir prof": ["--obs", "1", "--obs_comm", "1"],
}
#: the keys each flag adds to a JSONL line, by prefix
OBS_KEY_PREFIX = {"--obs_numerics": "num_", "--obs_comm": "comm_",
                  "--slo_spec": "slo_"}
#: the wire model's values that are the run's own: the probe's time and
#: share, the aggregation's FLOPs and bytes (XLA's cost analysis on the
#: JAX side, counted from the shapes here) and the devices (the JAX CLI
#: shards the cohort over its virtual CPU devices, the port runs on one)
COMM_MEASURED = ("comm_agg_ms", "comm_agg_share", "comm_agg_flops",
                 "comm_agg_bytes_accessed", "comm_n_devices")


def _paths(root, tmp):
    """Every file under ``root``, relative, with ``tmp`` in names cut."""
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


def _obs_flags(tmp):
    flags = []
    for case in OBS_CASES:
        flag, value = case.split(" ", 1)
        if flag in ("--trace_dir", "--profile_dir"):
            value = str(tmp / value)
        flags += [flag, value]
    return flags


def jax_obs_run(tmp):
    """The JAX CLI's run of :data:`OBS_ARGV` with all seven obs flags:
    ``{"res": runner.main's result, "root": tmp, "jsonl": its JSONL
    records}``."""
    argv = OBS_ARGV + _obs_flags(tmp) + ["--results_dir", str(tmp / "res"),
                                         "--log_dir", ""]
    res = jrunner.main(argv)
    jsonl = tmp / "res" / "synthetic" / (res["identity"] + ".obs.jsonl")
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    return {"res": res, "root": tmp, "jsonl": recs}


def _keys_without(rec, flags):
    """A JSONL record's keys less those of the obs flags not in
    ``flags``."""
    drop = tuple(p for f, p in OBS_KEY_PREFIX.items() if f not in flags)
    return sorted(k for k in rec if not k.startswith(drop))


def run_obs_case(tmp_path, case, ref):
    """The port's CLI with the obs flag of ``case`` (an :data:`OBS_CASES`
    id, completed by its entry) against the JAX CLI's run ``ref``
    (:func:`jax_obs_run`): the same identity and ``stat_info`` keys
    (``obs_metrics`` among them), the same artifacts, the same JSONL keys
    round by round (those of the flags both ran), the values that no draw
    decides equal (the wire model's bytes, the schema, the rounds, the
    guard's counters), and the training bitwise the same command line's
    without the flag (``round_time_s`` and the numerics, which the flags
    add, aside)."""
    flag, value = case.split(" ", 1)
    if flag in ("--trace_dir", "--profile_dir"):
        value = str(tmp_path / value)
    flags = [flag, value] + OBS_CASES[case]
    base = OBS_ARGV + ["--log_dir", "", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops among the suite's parallel workers
    try:
        t = trunner.main(base + flags + ["--results_dir",
                                         str(tmp_path / "res")])
        off = trunner.main(base + ["--results_dir", ""])
    finally:
        torch.set_num_threads(threads)
    j = ref["res"]
    ident = t["identity"]
    assert ident == j["identity"] == off["identity"]
    with open(t["stat_path"], "rb") as f:
        ts = pickle.load(f)
    with open(j["stat_path"], "rb") as f:
        js = pickle.load(f)
    assert sorted(ts) == sorted(js) and "obs_metrics" in ts
    # the training: bitwise the obs-off run's
    added = ("round_time_s", "num_")
    assert len(t["history"]) == len(off["history"])
    for h, h0 in zip(t["history"], off["history"]):
        assert {k: v for k, v in h.items() if not k.startswith(added)} \
            == h0
    for k, v in off["state"].global_params.items():
        assert torch.equal(t["state"].global_params[k], v), k
    # the history's keys: the JAX run's (numerics only where asked)
    on = set(flags)
    for h, hj in zip(t["history"], j["history"]):
        assert _keys_without(h, on) == _keys_without(hj, on)
    # the artifacts beside the results
    tres, jres = tmp_path / "res", ref["root"] / "res"
    names = {p.replace(ident, "ID") for p in _paths(tres, tmp_path)}
    jnames = {p.replace(ident, "ID") for p in _paths(jres, ref["root"])}
    want = {"runs_index.jsonl", "synthetic/ID", "synthetic/ID.json",
            "synthetic/ID.obs.jsonl", "synthetic/ID.metrics.json"}
    assert want <= names and want <= jnames
    # the JSONL: the same keys round by round, the static values equal
    with open(tres / "synthetic" / (ident + ".obs.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["round"] for r in recs] == [r["round"]
                                          for r in ref["jsonl"]]
    for r, rj in zip(recs, ref["jsonl"]):
        assert _keys_without(r, on) == _keys_without(rj, on)
        for k in ("round", "clients_quarantined", "clients_dropped"):
            if k in rj:
                assert r[k] == rj[k], k
        if "--obs_comm" in on and r["round"] >= 0:
            for k, v in rj.items():
                if k.startswith("comm_") and k not in COMM_MEASURED:
                    assert r[k] == v, k
    from neuroimagedisttraining_tpu.obs.export import record_schema

    # the schema the JAX package stamps on a line of these keys
    assert all(r["obs_schema"] == record_schema(r) for r in recs)
    snap = ts["obs_metrics"]
    assert snap["rounds_recorded"]["value"] == len(recs)
    if flag == "--obs_numerics":
        assert all(np.isnan(r["num_drift_s0"]) for r in recs
                   if r["round"] >= 0)  # every client poisoned
    if flag == "--trace_dir":
        with open(os.path.join(value, ident + ".trace.json")) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]}
        with open(ref["root"] / "tr" / (ident + ".trace.json")) as f:
            jspans = {e["name"] for e in json.load(f)["traceEvents"]}
        assert {"build", "init_state", "snip_mask", "round", "sample",
                "dispatch_round", "eval", "finalize"} <= spans & jspans
    if flag == "--slo_spec":
        assert all(r["slo_health"] in ("ok", "degraded", "failing")
                   for r in recs if r["round"] >= 0)
    if flag == "--flight_recorder":
        bundles = sorted(os.listdir(tres / "synthetic" / (ident +
                                                          ".flight")))
        jbundles = sorted(os.listdir(jres / "synthetic" / (ident +
                                                           ".flight")))
        assert bundles == jbundles == ["r00000-guard_quarantine",
                                       "r00001-guard_quarantine"]
        for b in bundles:
            assert sorted(os.listdir(tres / "synthetic" / (ident + ".flight")
                                     / b)) == ["trigger.json",
                                               "window.jsonl"]
    if flag == "--profile_dir":
        from neuroimagedisttraining_torch.obs import devtrace

        (path,) = devtrace.find_trace_files(value)
        doc = devtrace.load_trace_doc(path)
        assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
        # a CPU capture has no kernel lane: no attribution, no sidecar
        assert not devtrace.analyze_profile_dir(value)["present"]
        from neuroimagedisttraining_tpu.obs import devtrace as jdevtrace

        assert jdevtrace.find_trace_files(str(ref["root"] / "prof"))
