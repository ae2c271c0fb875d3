"""The port's command-line entry point on a client mesh of gloo ranks on
the CPU (``--mesh_devices``), against the JAX CLI's and the port's
one-process runs (the shared helpers in ``tests/_torch_cli_helpers.py``):
the mesh's size, SalientGrads and FedAvg against the JAX CLI, the robust
and state tiers and the client store. (The other algorithms, fused blocks
and the eval options are in ``tests/test_torch_port_cli_mesh_algos.py``.)"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cli_helpers import SMALL  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402


# -- the client mesh (--mesh_devices) ----------------------------------------

#: the client store on the client mesh: ``--mesh_devices 2`` with
#: ``--client_store`` (host, or disk in the fused case), beside each flag
#: the mesh runs (Ditto, the one of the seven a store serves, for the
#: algorithms). (extra argv, the store flag, the flag it runs beside: the
#: case's id; the cases keep the ids they had when the mesh refused the
#: store). Each is held to the one-process run of the same flags.
_STORE = ["--client_store", "host", "--frac", "0.5"]
MESH_STORE = [
    (["--algo", "ditto"] + _STORE, "--client_store", "--algo ditto"),
    (["--fuse_rounds", "2", "--frequency_of_the_test", "0",
      "--checkpoint_dir", "{tmp}/ck", "--algo", "ditto"] + _STORE,
     "--client_store", "--fuse_rounds"),
    (["--checkpoint_dir", "{tmp}/ck"] + _STORE, "--client_store",
     "--checkpoint_dir"),
    (["--checkpoint_dir", "{tmp}/ck", "--resume", "--algo", "ditto"]
     + _STORE, "--client_store", "--resume"),
    (_STORE, "--client_store", None),
    (["--fault_spec", "nan=0.125", "--algo", "ditto"] + _STORE,
     "--client_store", "--fault_spec"),
    (["--guard", "1"] + _STORE, "--client_store", "--guard"),
    (["--defense_type", "weak_dp"] + _STORE, "--client_store",
     "--defense_type"),
    (["--robust_agg", "median", "--algo", "ditto"] + _STORE,
     "--client_store", "--robust_agg"),
    (["--watchdog", "1"] + _STORE, "--client_store", "--watchdog"),
    (["--eval_cache", "1"] + _STORE, "--client_store", "--eval_cache"),
    (["--stratified_sampling", "1", "--stratified_mode", "balanced"]
     + _STORE, "--client_store", "--stratified_sampling"),
    # a disk store in fused blocks (the case the flags' refusal list held)
    (["--fuse_rounds", "2", "--frequency_of_the_test", "0",
      "--client_store", "disk", "--store_hot_clients", "2", "--frac",
      "0.5"], "--client_store", "--mesh_devices 2 --fuse_rounds 2"),
]
#: the JAX store's gauge names, each rank's in the run's result
STORE_GAUGES = ["mem_host_cache_bytes", "mem_store_disk_bytes",
                "mem_store_hits", "mem_store_misses", "mem_store_prefetched",
                "store_gather_ms"]


@pytest.mark.parametrize("extra,names,runs", MESH_STORE,
                         ids=[r or n for _, n, r in MESH_STORE])
def test_cli_mesh_runs_the_store(tmp_path, extra, names, runs):
    """``runner.main --device cpu --mesh_devices 2 --client_store ...``
    (two gloo ranks, each rank's store over its block) against the
    one-process run of the same flags, torch on one thread on both sides:
    the same records round by round (the guard's and the watchdog's
    counters equal), within rtol 1e-5 (round 0's train loss bitwise: only
    the aggregate's cross-rank sum reassociates), the final eval too, and
    each rank's store gauges under the JAX store's names. ``--resume``:
    each side first runs one round into its lineage, then resumes it."""
    argv = (["--algo", "salientgrads"] + SMALL + [
        "--epochs", "1", "--log_dir", "", "--device", "cpu"])
    resume = "--resume" in extra
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the parent's share
    try:
        out = {}
        for side, mesh in (("mesh", ["--mesh_devices", "2"]), ("one", [])):
            flags = [a.format(tmp=tmp_path / side) for a in extra] + mesh
            if resume:  # the lineage's first round
                trunner.main(argv + [a for a in flags if a != "--resume"]
                             + ["--comm_round", "1", "--results_dir", ""])
            out[side] = trunner.main(argv + flags + [
                "--comm_round", "2", "--results_dir",
                str(tmp_path / side / "res")])
    finally:
        torch.set_num_threads(threads)
    mesh, one = out["mesh"], out["one"]
    assert mesh["client_mesh_devices"] == 2 and mesh["state"] is None
    assert one["client_mesh_devices"] == 1
    assert mesh["identity"] == one["identity"]
    rounds = [h["round"] for h in mesh["history"] if h["round"] >= 0]
    assert rounds == ([1] if resume else [0, 1])
    assert len(mesh["history"]) == len(one["history"])
    for h, h1 in zip(mesh["history"], one["history"]):
        assert sorted(h) == sorted(h1)
        for k in ("clients_dropped", "clients_quarantined",
                  "rounds_retried", "round", "finetune"):
            if k in h1:
                assert h[k] == h1[k], k
        for k, v in h.items():
            np.testing.assert_allclose(v, h1[k], rtol=1e-5, err_msg=k)
    assert mesh["history"][0]["train_loss"] == \
        one["history"][0]["train_loss"]
    for k, v in one["final_eval"].items():
        if np.ndim(v) == 0:
            np.testing.assert_allclose(float(mesh["final_eval"][k]),
                                       float(v), rtol=1e-5, err_msg=k)
    assert len(mesh["store_stats"]) == 2 and len(one["store_stats"]) == 1
    for st in mesh["store_stats"] + one["store_stats"]:
        assert sorted(st) == STORE_GAUGES
        assert st["mem_store_hits"] + st["mem_store_misses"] > 0
    if "disk" in extra:
        assert all(st["mem_store_disk_bytes"] > 0
                   for st in mesh["store_stats"])
    if "{tmp}/ck" in extra:  # rank 0 wrote each step's store sidecar
        (lineage,) = list((tmp_path / "mesh" / "ck").iterdir())
        assert "store_2.npz" in os.listdir(lineage)
    assert names == "--client_store"


def test_cli_mesh_size_is_the_reference_fit():
    """``--mesh_devices`` fitted as the JAX CLI's ``maybe_shard`` fits it:
    on the CPU the ranks asked for, down to a divisor of the cohort."""
    for asked, clients, want in ((0, 8, 1), (1, 8, 1), (2, 8, 2), (3, 8, 2),
                                 (4, 6, 3), (8, 8, 8), (5, 7, 1)):
        args = tconfig.parse_args(SMALL + [
            "--algo", "fedavg", "--mesh_devices", str(asked),
            "--client_num_in_total", str(clients), "--device", "cpu"])
        assert trunner.client_mesh_size(args, "fedavg") == want, \
            (asked, clients)


@pytest.mark.parametrize("algo", ["salientgrads", "fedavg"])
def test_cli_mesh_runs_match_reference_cli(tmp_path, algo):
    """``--mesh_devices 2 --device cpu``: two gloo ranks. Against the JAX
    CLI's ``--mesh_devices 2`` the identity, the stat_info keys and the
    record keys round by round (FedAvg's cost counters exactly), as the
    single-device CLI tests hold them; the history within rtol 1e-5 of the
    port's single-device run (the mask and round 0's models are bitwise,
    only the aggregate's cross-rank sum reassociates); SalientGrads run
    twice with bitwise-equal histories."""
    argv = SMALL + ["--comm_round", "2", "--epochs", "1", "--log_dir", ""]
    mesh = ["--mesh_devices", "2", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the parent's share
    try:
        t = trunner.main(argv + mesh + ["--results_dir",
                                        str(tmp_path / "t")], algo)
        one = trunner.main(argv + ["--device", "cpu", "--results_dir", ""],
                           algo)
        twin = (trunner.main(argv + mesh + ["--results_dir", ""], algo)
                if algo == "salientgrads" else None)
    finally:
        torch.set_num_threads(threads)
    j = jrunner.main(argv + ["--mesh_devices", "2", "--results_dir",
                             str(tmp_path / "j")], algo)
    assert t["client_mesh_devices"] == 2 and t["state"] is None
    assert one["client_mesh_devices"] == 1
    assert t["identity"] == j["identity"] == one["identity"]
    assert os.path.relpath(t["stat_path"], tmp_path / "t") == \
        os.path.relpath(j["stat_path"], tmp_path / "j")
    assert [sorted(h) for h in t["history"]] == \
        [sorted(h) for h in j["history"]]
    with open(t["stat_path"], "rb") as f:
        ts = pickle.load(f)
    with open(j["stat_path"], "rb") as f:
        js = pickle.load(f)
    assert sorted(ts) == sorted(js)
    if algo == "fedavg":
        for k in ("sum_comm_params", "sum_training_flops",
                  "avg_inference_flops"):
            assert ts[k] == js[k], k
    for h, h1 in zip(t["history"], one["history"]):
        assert sorted(h) == sorted(h1)
        for k, v in h.items():
            np.testing.assert_allclose(v, h1[k], rtol=1e-5, err_msg=k)
    assert t["history"][0]["train_loss"] == one["history"][0]["train_loss"]
    if twin is not None:
        assert twin["history"] == t["history"]


#: the robust and the state tiers on ``--mesh_devices 2``: faults, the
#: guard, the weak-DP defense, the median, the watchdog and the checkpoints
MESH_ROBUST = ["--fault_spec", "drop=0.125,nan=0.125,scale=0.125:100x",
               "--guard", "1", "--defense_type", "weak_dp", "--robust_agg",
               "median", "--watchdog", "1"]


def test_cli_mesh_runs_the_robust_and_state_tiers(tmp_path):
    """``--device cpu --mesh_devices 2`` with the robust flags and
    ``--checkpoint_dir``: end to end, the guard's counters and the
    watchdog's in the records equal to the single-device run's and the
    history within rtol 1e-5 of it (round 0 bitwise); rank 0 alone writes
    (one log, one stat_info, the steps and their metadata, no partial
    file). Then ``--resume`` to a third round on the mesh: its record
    bitwise the uninterrupted three-round mesh run's."""
    argv = SMALL + ["--comm_round", "2", "--epochs", "1",
                    "--frequency_of_the_test", "1"] + MESH_ROBUST
    mesh = ["--mesh_devices", "2", "--device", "cpu"]
    ck = ["--checkpoint_dir", str(tmp_path / "ck")]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the parent's share
    try:
        t = trunner.main(argv + mesh + ck + [
            "--results_dir", str(tmp_path / "t"), "--log_dir",
            str(tmp_path / "log")], "salientgrads")
        one = trunner.main(argv + ["--device", "cpu", "--results_dir", "",
                                   "--log_dir", ""], "salientgrads")
        three = ["--comm_round", "3"]
        resumed = trunner.main(argv + three + mesh + ck + [
            "--resume", "--results_dir", "", "--log_dir", ""],
            "salientgrads")
        twin = trunner.main(argv + three + mesh + [
            "--checkpoint_dir", str(tmp_path / "twin"), "--results_dir", "",
            "--log_dir", ""], "salientgrads")
    finally:
        torch.set_num_threads(threads)
    assert t["client_mesh_devices"] == 2 and t["state"] is None
    rounds = [h for h in t["history"] if h["round"] >= 0]
    assert [h["round"] for h in rounds] == [0, 1]
    for h, h1 in zip(t["history"], one["history"]):
        assert sorted(h) == sorted(h1)
        for k in ("clients_dropped", "clients_quarantined",
                  "rounds_retried"):
            if k in h1:
                assert h[k] == h1[k], k
        for k, v in h.items():
            np.testing.assert_allclose(v, h1[k], rtol=1e-5, err_msg=k)
    assert rounds[0]["train_loss"] == one["history"][0]["train_loss"]
    assert all({"clients_dropped", "clients_quarantined",
                "rounds_retried"} <= set(h) for h in rounds)
    assert len(os.listdir(tmp_path / "log")) == 1
    with open(t["stat_path"], "rb") as f:
        fault = pickle.load(f)["fault_recovery"]
    assert fault["checkpoint_save_failures"] == 0.0
    assert {"rounds_retried", "rounds_skipped"} <= set(fault)
    lineage = [p for p in (tmp_path / "ck").iterdir()]
    assert len(lineage) == 1
    # the two rounds' steps and the resumed run's third
    assert sorted(os.listdir(lineage[0])) == [
        "1", "2", "3", "meta_1.json", "meta_2.json", "meta_3.json"]
    assert all(os.listdir(lineage[0] / s) == ["state.pt"] for s in "123")
    assert [h["round"] for h in resumed["history"]] == [2, -1]
    assert resumed["history"][0] == twin["history"][2]
    assert resumed["final_eval"] == twin["final_eval"]
