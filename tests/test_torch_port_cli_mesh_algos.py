"""The port's command-line entry point on a client mesh of gloo ranks on
the CPU (``--mesh_devices``) against its one-process runs: the seven
algorithms besides SalientGrads and FedAvg, fused blocks and the eval
options (the rest of the mesh CLI is in ``tests/test_torch_port_cli_mesh.py``,
the shared helpers in ``tests/_torch_cli_helpers.py``)."""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cli_helpers import SMALL  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402


#: each of the seven algorithms besides SalientGrads and FedAvg on
#: ``--mesh_devices 2``, with flags the mesh runs for it: Ditto's global leg
#: under the faults, the guard and the median (run on the mesh, not
#: refused: the robust tier's shared code), the eval subset and the
#: watchdog, a fused run, DisPFL's end-of-run masks and distances and its
#: checkpoints
MESH_SEVEN = [
    ("local", ["--eval_clients", "4", "--watchdog", "1"]),
    ("ditto", ["--fault_spec", "drop=0.25,nan=0.25", "--guard", "1",
               "--robust_agg", "median"]),
    ("subavg", []),
    ("dpsgd", ["--fuse_rounds", "2"]),
    ("dispfl", ["--save_masks", "--record_mask_diff", "--checkpoint_dir",
                "{tmp}/ck"]),
    ("fedfomo", []),
    ("turboaggregate", []),
]


@pytest.mark.parametrize("algo,flags", MESH_SEVEN,
                         ids=[a for a, _ in MESH_SEVEN])
def test_cli_mesh_runs_every_algorithm(tmp_path, algo, flags):
    """``--device cpu --mesh_devices 2`` (two gloo ranks) against the
    one-device run of the same flags, torch on one thread on both sides:
    every record (metrics, evals, cost counters, the guard's and the
    watchdog's counters), the final eval and ``stat_info``'s counters and
    extras bitwise. Every exchange of these algorithms computes the single
    process's result on gathered rows, and Ditto's global model here is the
    median of the gathered deltas, so no sum reassociates."""
    argv = SMALL + ["--comm_round", "2", "--frac", "0.5", "--epochs", "1",
                    "--log_dir", "", "--frequency_of_the_test", "1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the parent's share
    try:
        runs = {}
        for side, extra in (("mesh", ["--mesh_devices", "2"]), ("one", [])):
            runs[side] = trunner.main(
                argv + [a.format(tmp=tmp_path / side) for a in flags]
                + extra + ["--device", "cpu", "--results_dir",
                           str(tmp_path / side / "res")], algo)
    finally:
        torch.set_num_threads(threads)
    mesh, one = runs["mesh"], runs["one"]
    assert mesh["client_mesh_devices"] == 2 and mesh["state"] is None
    assert one["client_mesh_devices"] == 1
    assert [h["round"] for h in mesh["history"]
            if h["round"] >= 0] == [0, 1]
    assert mesh["history"] == one["history"]
    assert {k: float(v) for k, v in mesh["final_eval"].items()
            if np.ndim(v) == 0} == {k: float(v) for k, v in
                                    one["final_eval"].items()
                                    if np.ndim(v) == 0}
    stats = {}
    for side, res in runs.items():
        with open(res["stat_path"], "rb") as f:
            stats[side] = pickle.load(f)
    assert sorted(stats["mesh"]) == sorted(stats["one"])
    for k in ("sum_training_flops", "sum_comm_params", "avg_inference_flops",
              "fault_recovery"):
        assert stats["mesh"][k] == stats["one"][k], k
    if algo == "dispfl":
        for k, v in stats["one"]["final_masks"].items():
            np.testing.assert_array_equal(stats["mesh"]["final_masks"][k], v)
        np.testing.assert_array_equal(stats["mesh"]["mask_distance_matrix"],
                                      stats["one"]["mask_distance_matrix"])
        assert len(os.listdir(tmp_path / "mesh" / "ck")) == 1


#: (algorithm, the flags the mesh runs, ``--fuse_rounds`` last): each on
#: ``--mesh_devices 2``, its eager twin on the mesh, and the single-device
#: run
MESH_FLAGS = [
    ("salientgrads", ["--fuse_rounds", "2"]),
    ("fedavg", ["--eval_cache", "1", "--fuse_rounds", "2"]),
    ("salientgrads", ["--stratified_sampling", "1", "--stratified_mode",
                      "balanced", "--fuse_rounds", "2"]),
]


@pytest.mark.parametrize("algo,flags", MESH_FLAGS,
                         ids=[" ".join(f[:2]) for _, f in MESH_FLAGS])
def test_cli_mesh_runs_fused_blocks_and_eval_options(tmp_path, algo, flags):
    """``--device cpu --mesh_devices 2`` with ``--fuse_rounds 2``, with
    ``--eval_cache`` and with stratified SNIP: every record bitwise the
    same run's with the rounds one at a time on the mesh, and within rtol
    1e-5 of the single-device run's (round 0's train loss bitwise: the mask
    and the first round's models are, only the aggregate's cross-rank sum
    reassociates)."""
    argv = SMALL + ["--comm_round", "2", "--epochs", "1", "--log_dir", "",
                    "--frequency_of_the_test", "1"]
    mesh = ["--mesh_devices", "2", "--device", "cpu"]
    eager = flags[:flags.index("--fuse_rounds")]  # the rounds one by one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the parent's share
    try:
        fused = trunner.main(argv + flags + mesh + [
            "--results_dir", str(tmp_path / "t")], algo)
        twin = trunner.main(argv + eager + mesh + ["--results_dir", ""],
                            algo)
        one = trunner.main(argv + flags + ["--device", "cpu",
                                           "--results_dir", ""], algo)
    finally:
        torch.set_num_threads(threads)
    assert fused["client_mesh_devices"] == 2 and fused["state"] is None
    assert os.path.exists(fused["stat_path"])
    assert fused["history"] == twin["history"]
    assert fused["final_eval"] == twin["final_eval"]
    assert len(fused["history"]) == len(one["history"]) == 3
    for h, h1 in zip(fused["history"], one["history"]):
        assert sorted(h) == sorted(h1)
        for k, v in h.items():
            np.testing.assert_allclose(v, h1[k], rtol=1e-5, err_msg=k)
    assert fused["history"][0]["train_loss"] == \
        one["history"][0]["train_loss"]
