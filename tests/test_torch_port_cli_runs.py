"""The port's command-line entry point run on the CPU, against the JAX
package's (its flags and refusals are in ``tests/test_torch_port_cli.py``,
the shared helpers in ``tests/_torch_cli_helpers.py``).

* Both ``build_algorithm`` give equal hyperparameters, loss type and data
  from one command line, and two rounds of each agree (the reference's
  draws fed to the port at its seams; losses rtol 1e-5, parameters rtol
  1e-5 / atol 2e-7, as ``test_salientgrads_two_rounds_match_reference``).
* The CLI end to end: ``stat_info`` at the JAX CLI's path with its
  top-level keys, and history records with its keys at its cadence; the
  per-algorithm mains; the ABCD cohort files in both layouts.
* The training options and the robustness tier run end to end on the CPU
  (``--batching replacement``, ``--remat``, stratified SNIP, faults and the
  guard, every ``--robust_agg``, both defenses, the watchdog), under the
  JAX CLI's identity.
"""
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from _torch_cli_helpers import ROOT, SMALL, _built, _stat_keys  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvgState,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import broadcast_tree  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402


# -- the algorithm the CLI builds --------------------------------------------

@pytest.mark.parametrize("algo,seed,extra", [
    ("salientgrads", 0, []),
    ("salientgrads", 0, ["--track_personal", "0", "--snip_mask", "0"]),
    ("fedavg", 9, []),
    ("fedavg", 9, ["--track_personal", "0"]),
])
def test_cli_built_rounds_match_reference(algo, seed, extra):
    argv = SMALL + ["--seed", str(seed), "--epochs", "1", "--lr", "0.01",
                    "--momentum", "0.9", "--wd", "5e-4", "--batch_size",
                    "8"] + extra
    ja, jd, ta, td = _built(algo, argv)
    pc.assert_data_equal(td, jd)  # the unified parser's val split too
    for f in ("lr", "lr_decay", "momentum", "weight_decay", "grad_clip",
              "local_epochs", "steps_per_epoch", "batch_size"):
        assert getattr(ta.hp, f) == getattr(ja.hp, f), f
    assert ta.hp.local_steps == ja.hp.local_steps
    assert ta.loss_type == ja.loss_type == "bce"
    assert (ta.num_clients, ta.clients_per_round) == \
        (ja.num_clients, ja.clients_per_round)

    jstate = ja.init_state(jax.random.PRNGKey(seed))
    g = jax_params_to_torch(pc.np_tree(jstate.global_params))
    personal = (None if jstate.personal_params is None
                else broadcast_tree(g, ta.num_clients))
    assert (ta.init_state().personal_params is None) == (personal is None)
    if algo == "salientgrads":
        if "--snip_mask" in extra:  # the dense control: all ones
            assert all(bool((m == 1).all()) for m in
                       ta.init_state().mask.values())
            assert all(bool((np.asarray(m) == 1).all()) for m in
                       jax.tree_util.tree_leaves(jstate.mask))
        state = SalientGradsState(
            global_params=g, mask=jax_params_to_torch(pc.np_tree(jstate.mask)),
            personal_params=personal, generator=torch.Generator())
    else:
        state = FedAvgState(global_params=g, personal_params=personal,
                            generator=torch.Generator())
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    spe, bs = ja.hp.steps_per_epoch, ja.hp.batch_size
    rng = jstate.rng
    for r in range(2):
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, ta.num_clients + 1)
        perms = [np.array(epoch_permutations(
            jax.random.split(keys[c])[0], jnp.int32(nvals[c]), 1, spe * bs,
            n_rows=jd.x_train.shape[1])) for c in range(ta.num_clients)]
        jstate, jmet = ja.run_round(jstate, r)
        state, tmet = ta.run_round(state, r, perms=perms)
        np.testing.assert_allclose(float(tmet["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    pc.compare(state.global_params, jstate.global_params, "dense")
    for c in range(ta.num_clients if personal is not None else 0):
        pc.compare({k: v[c] for k, v in state.personal_params.items()},
                   jax.tree_util.tree_map(lambda x: x[c],
                                          jstate.personal_params), "dense")
    jev, tev = ja.evaluate(jstate), ta.evaluate(state)
    assert sorted(tev) == sorted(jev)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
    if algo == "salientgrads":
        assert tev["mask_density"] == float(jev["mask_density"])


def test_cli_built_uneven_epoch_steps(tmp_path):
    """The step count is the largest client's, over an uneven cohort read
    from a cohort file; the smaller clients' extra steps are masked."""
    rng = np.random.RandomState(0)
    n = 40
    path = str(tmp_path / "c.h5")
    from neuroimagedisttraining_torch.data import write_abcd_h5

    write_abcd_h5(path, rng.rand(n, 10, 12, 10).astype(np.float32),
                  rng.randint(0, 2, n), rng.choice([0, 1, 2], n,
                                                   p=[0.6, 0.3, 0.1]))
    argv = ["--dataset", "abcd_site", "--data_dir", path,
            "--model", "small3dcnn_s2d", "--layout", "s2d",
            "--batch_size", "4", "--client_num_in_total", "0"]
    ja, jd, ta, td = _built("fedavg", argv)
    pc.assert_data_equal(td, jd)
    counts = np.asarray(td.n_train)
    assert counts.max() > counts.min()
    assert ta.hp.steps_per_epoch == ja.hp.steps_per_epoch == \
        -(-int(counts.max()) // 4)
    assert not ta._full_batches()


# -- the CLI end to end ------------------------------------------------------


def test_cli_end_to_end_writes_stat_info_at_reference_path(tmp_path):
    argv = ["--algo", "salientgrads"] + SMALL + [
        "--comm_round", "2", "--results_dir", str(tmp_path / "res"),
        "--log_dir", str(tmp_path / "log"), "--client_chunk", "2"]
    out = subprocess.run(
        [sys.executable, "-m", "neuroimagedisttraining_torch.experiments"]
        + argv + ["--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    identity = jconfig.run_identity(jconfig.parse_args(argv))
    path = tmp_path / "res" / "synthetic" / identity
    assert path.is_file() and (tmp_path / "res" / "synthetic" /
                               (identity + ".json")).is_file()
    with open(path, "rb") as f:
        stat = pickle.load(f)
    assert sorted(stat) == _stat_keys(tmp_path)
    assert stat["config"]["device"] == "cpu"
    rounds = [h for h in stat["history"] if h["round"] >= 0]
    assert [h["round"] for h in stat["history"]] == [0, 1, -1]
    for h in rounds:
        assert {"train_loss", "global_acc", "global_loss",
                "personal_acc", "personal_loss", "mask_density",
                "sum_training_flops", "sum_comm_params"} <= set(h)
        assert all(isinstance(v, (int, float)) for v in h.values())
    assert len(stat["global_test_acc"]) == 3  # two rounds and the final
    assert stat["avg_inference_flops"] > 0 and stat["sum_comm_params"] > 0
    log = (tmp_path / "log" / (identity + ".log")).read_text()
    assert "--client_chunk 2 has no effect in the PyTorch port" in log


@pytest.mark.parametrize("main,algo", [
    ("main_salientgrads", "salientgrads"),
    ("main_sailentgrads", "salientgrads"),
    ("main_fedavg", "fedavg"),
])
def test_per_algorithm_mains_run_on_cpu(tmp_path, main, algo):
    argv = SMALL + ["--comm_round", "1", "--epochs", "1", "--results_dir",
                    str(tmp_path / "res"), "--log_dir", ""]
    out = subprocess.run(
        [sys.executable, "-m",
         f"neuroimagedisttraining_torch.experiments.{main}"]
        + argv + ["--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    identity = jconfig.run_identity(jconfig.parse_args(argv, algo), algo)
    assert (tmp_path / "res" / "synthetic" / identity).is_file()


@pytest.mark.parametrize("algo", ["salientgrads", "fedavg"])
def test_cli_history_matches_reference_cadence(tmp_path, algo):
    """The same command line through both CLIs in-process: the same
    identity and stat_info path, the same record keys round by round at
    ``--frequency_of_the_test 2`` and the same cost counters."""
    argv = SMALL + ["--comm_round", "3", "--frequency_of_the_test", "2",
                    "--epochs", "1"]
    j = jrunner.main(argv + ["--results_dir", str(tmp_path / "j"),
                             "--log_dir", ""], algo)
    t = trunner.main(argv + ["--results_dir", str(tmp_path / "t"),
                             "--log_dir", "", "--device", "cpu"], algo)
    assert t["identity"] == j["identity"]
    assert os.path.relpath(t["stat_path"], tmp_path / "t") == \
        os.path.relpath(j["stat_path"], tmp_path / "j")
    assert [sorted(h) for h in t["history"]] == \
        [sorted(h) for h in j["history"]]
    assert [h["round"] for h in t["history"]] == [0, 1, 2, -1]
    assert "global_acc" in t["history"][1] and \
        "global_acc" not in t["history"][0]
    with open(t["stat_path"], "rb") as f:
        ts = pickle.load(f)
    with open(j["stat_path"], "rb") as f:
        js = pickle.load(f)
    assert sorted(ts) == sorted(js)
    # FedAvg's model is dense on both sides, so the counters agree exactly;
    # SalientGrads' SNIP masks come from each side's own draws
    for k in ("sum_comm_params", "sum_training_flops",
              "avg_inference_flops"):
        assert ts[k] > 0
        if algo == "fedavg":
            assert ts[k] == js[k], k


def test_cli_abcd_rescale_s2d_end_to_end(tmp_path):
    rng = np.random.RandomState(1)
    n = 60
    path = str(tmp_path / "final_dataset_60subs.h5")
    from neuroimagedisttraining_torch.data import write_abcd_h5

    write_abcd_h5(path, rng.rand(n, 10, 12, 10).astype(np.float32),
                  rng.randint(0, 2, n), rng.randint(0, 3, n))
    argv = ["--algo", "salientgrads", "--dataset", "abcd_rescale",
            "--data_dir", path, "--layout", "s2d", "--model", "small3dcnn",
            "--client_num_in_total", "4", "--batch_size", "4",
            "--comm_round", "2", "--results_dir", str(tmp_path / "res"),
            "--log_dir", ""]
    res = trunner.main(argv + ["--device", "cpu"])
    identity = jconfig.run_identity(jconfig.parse_args(argv))
    assert res["identity"] == identity
    assert res["stat_path"] == str(tmp_path / "res" / "abcd_rescale" /
                                   identity)
    losses = [h["train_loss"] for h in res["history"] if h["round"] >= 0]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert set(res["state"].global_params) >= {"S2DStemConv_0.kernel"}


def test_cli_dense_alexnet_flat_layout_end_to_end(tmp_path):
    """The reference's ABCD command line with its default model: ``--model
    3dcnn`` (the dense stem, full widths) on a 69^3 cohort file the test
    writes, stored ``--layout flat`` (channel-less, the channel injected at
    apply time) with the eval cache on: the JAX CLI's identity and path,
    finite losses, and the same history and final parameters as the
    ``--layout channels`` run of the same command line, bit for bit."""
    rng = np.random.RandomState(2)
    n = 12
    path = str(tmp_path / "c69.h5")
    from neuroimagedisttraining_torch.data import write_abcd_h5

    write_abcd_h5(path, rng.rand(n, 69, 69, 69).astype(np.float32),
                  rng.randint(0, 2, n), np.repeat([0, 1], n // 2))
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = {}
        for layout in ("flat", "channels"):
            argv = ["--algo", "salientgrads", "--dataset", "abcd_site",
                    "--data_dir", path, "--layout", layout, "--model",
                    "3dcnn", "--client_num_in_total", "0", "--batch_size",
                    "2", "--epochs", "1", "--comm_round", "1",
                    "--eval_cache", "1", "--results_dir",
                    str(tmp_path / layout), "--log_dir", ""]
            res[layout] = trunner.main(argv + ["--device", "cpu"])
            identity = jconfig.run_identity(jconfig.parse_args(argv))
            assert res[layout]["identity"] == identity
            assert res[layout]["stat_path"] == str(
                tmp_path / layout / "abcd_site" / identity)
    finally:
        torch.set_num_threads(torch_threads)
    flat, chan = res["flat"], res["channels"]
    assert flat["history"][0]["round"] == 0
    assert np.isfinite(flat["history"][0]["train_loss"])
    assert flat["history"] == chan["history"]
    g_f, g_c = flat["state"].global_params, chan["state"].global_params
    assert "_Features_0.Conv3d_0.kernel" in g_f
    assert all(torch.equal(g_f[k], g_c[k]) for k in g_c)
    assert flat["state"].eval_cache is not None


#: the lifted flags' runs on the CPU: (extra argv, what the history shows)
LIFTED_RUNS = [
    (["--batching", "replacement"], None),
    (["--remat", "1"], None),
    (["--stratified_sampling", "1", "--stratified_mode", "balanced"], None),
    (["--stratified_sampling", "1", "--batch_size", "50"], None),
    (["--fault_spec", "drop=0.2,nan=0.2,scale=0.2:100x", "--frac", "0.5"],
     "guard"),
    (["--algo", "fedavg", "--fault_spec", "nan=0.5,labelflip=0.3",
      "--guard", "1", "--watchdog", "1"], "watchdog"),
] + [
    (["--robust_agg", kind, "--agg_impl", impl], None)
    for kind, impl in (("median", "dense"), ("trimmed_mean", "bf16"),
                       ("krum", "int8"), ("multikrum", "topk"),
                       ("norm_krum", "dense"))
] + [
    (["--algo", a, "--defense_type", d], None)
    for a, d in (("salientgrads", "weak_dp"),
                 ("fedavg", "norm_diff_clipping"))
]


@pytest.mark.parametrize("extra,shows", LIFTED_RUNS,
                         ids=[" ".join(e) for e, _ in LIFTED_RUNS])
def test_cli_runs_the_lifted_flags_on_cpu(tmp_path, extra, shows):
    """Each training option and robustness flag through
    ``experiments.runner.main`` on the CPU: the JAX CLI's identity, finite
    losses, the guard's counters under faults and the watchdog's in the
    records and in ``stat_info``."""
    argv = (["--algo", "salientgrads", "--dataset", "synthetic", "--model",
             "small3dcnn", "--comm_round", "2", "--epochs", "1",
             "--results_dir", str(tmp_path / "res"), "--log_dir", ""]
            + extra)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops among the suite's parallel workers
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the splitter's small classes
            res = trunner.main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert res["identity"] == jconfig.run_identity(jconfig.parse_args(argv))
    rounds = [h for h in res["history"] if h["round"] >= 0]
    assert [h["round"] for h in rounds] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in rounds)
    for v in res["state"].global_params.values():
        assert bool(torch.isfinite(v).all())
    with open(res["stat_path"], "rb") as f:
        fault = pickle.load(f)["fault_recovery"]
    if shows is None:
        assert fault == {}
        assert all("clients_quarantined" not in h for h in rounds)
        return
    assert all({"clients_dropped", "clients_quarantined"} <= set(h)
               for h in rounds)
    assert fault["clients_quarantined"] == sum(
        h["clients_quarantined"] for h in rounds) or shows == "watchdog"
    if shows == "watchdog":
        assert all("rounds_retried" in h for h in rounds)
        assert {"rounds_retried", "rounds_skipped"} <= set(fault)
