"""The port's command-line entry point against the JAX package's, on the CPU.

* Flags and identity: over a table of command lines, both ``parse_args``
  give equal namespaces (the port's own ``--device`` aside) and both
  ``run_identity`` equal strings, so logs and results land at the same
  paths.
* Every flag of a feature the port has not got ends the run with
  ``SystemExit`` naming the flag, before any work; the combinations the
  JAX CLI refuses (``--eval_cache`` with another algorithm, with
  ``--track_personal 0`` or with ``--eval_clients``; the faults, the guard,
  the robust statistics and the defenses on an algorithm without a central
  aggregate; ``--watchdog`` in fused blocks; ``drop=`` without the guard;
  the estimators' bounds; exact stratified SNIP on small shards) end it
  with the JAX CLI's reason, and a volume too small for a dense-stem
  AlexNet with a ``ValueError`` naming it.
* The training options and the robustness tier run end to end on the CPU
  (``--batching replacement``, ``--remat``, stratified SNIP, faults and the
  guard, every ``--robust_agg``, both defenses, the watchdog), under the
  JAX CLI's identity.
* Both ``build_algorithm`` give equal hyperparameters, loss type and data
  from one command line, and two rounds of each agree (the reference's
  draws fed to the port at its seams; losses rtol 1e-5, parameters rtol
  1e-5 / atol 2e-7, as ``test_salientgrads_two_rounds_match_reference``).
* The CLI end to end: ``stat_info`` at the JAX CLI's path with its
  top-level keys, and history records with its keys at its cadence.
"""
import argparse
import json
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
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.utils import records as jrecords  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvgState,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import broadcast_tree  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.utils import records as trecords  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--dataset", "synthetic", "--model", "small3dcnn"]

#: (per-algorithm main or None for the unified --algo parser, argv)
COMMAND_LINES = [
    (None, ["--algo", "salientgrads"] + SMALL),
    (None, ["--algo", "fedavg"] + SMALL),
    ("salientgrads", SMALL),
    ("fedavg", SMALL),
    (None, ["--algo", "salientgrads", "--dataset", "abcd_rescale",
            "--layout", "s2d", "--model", "3dcnn", "--compute_dtype",
            "bfloat16", "--data_dtype", "bfloat16", "--data_dir", "x.h5"]),
    ("salientgrads", ["--dataset", "abcd", "--layout", "channels",
                      "--model", "small3dcnn", "--client_num_in_total", "0"]),
    ("salientgrads", SMALL + ["--dense_ratio", "0.2",
                              "--itersnip_iteration", "3"]),
    ("salientgrads", SMALL + ["--track_personal", "0"]),
    ("fedavg", SMALL + ["--track_personal", "0", "--final_finetune", "0"]),
    ("salientgrads", SMALL + ["--snip_mask", "0"]),
    (None, ["--algo", "salientgrads", "--frac", "0.5", "--seed", "3",
            "--lr", "0.01", "--epochs", "1", "--batch_size", "4",
            "--comm_round", "7", "--tag", "t1", "--ci", "1"]),
    (None, ["--algo", "dispfl", "--cs", "ring", "--active", "0.7"]),
    (None, ["--algo", "fedavg", "--defense_type", "weak_dp",
            "--robust_agg", "norm_krum", "--eval_cache", "1"]),
    (None, ["--algo", "fedavg", "--fed_role", "aggregator", "--fed_sites",
            "3", "--fed_mode", "buffered", "--batching", "replacement"]),
    (None, ["--algo", "salientgrads", "--eval_cache", "1"] + SMALL),
    # the training options and the robustness tier
    ("salientgrads", SMALL + ["--batching", "replacement"]),
    ("fedavg", SMALL + ["--remat", "1"]),
    ("salientgrads", SMALL + ["--stratified_sampling", "1",
                              "--stratified_mode", "balanced"]),
    (None, ["--algo", "salientgrads", "--stratified_sampling", "1"]),
    (None, ["--algo", "fedavg", "--fault_spec",
            "drop=0.125,nan=0.125,scale=0.125:100x"] + SMALL),
    (None, ["--algo", "salientgrads", "--fault_spec", "nan=0.2",
            "--guard", "0", "--fuse_rounds", "2"]),
    ("fedavg", SMALL + ["--guard", "1", "--watchdog", "1",
                        "--max_round_retries", "3", "--retry_backoff_s",
                        "0.5", "--watchdog_loss", "5", "--watchdog_norm",
                        "10"]),
    ("salientgrads", SMALL + ["--robust_agg", "trimmed_mean",
                              "--robust_trim", "0.1"]),
    (None, ["--algo", "salientgrads", "--robust_agg", "krum",
            "--robust_krum_f", "2", "--agg_impl", "int8"]),
    ("fedavg", SMALL + ["--defense_type", "norm_diff_clipping",
                        "--norm_bound", "2", "--stddev", "0.05"]),
    ("fedavg", SMALL + ["--eval_clients", "3"]),
    ("salientgrads", ["--dataset", "abcd_site", "--layout", "flat",
                      "--model", "3dcnn_deeper", "--eval_cache", "1",
                      "--track_personal", "0"]),
] + [
    (None, ["--algo", a, "--agg_impl", impl, "--agg_topk_density", "0.05",
            "--agg_topk_sample", "100", "--agg_hier_wire", "int8",
            "--agg_hier_inner", "2", "--agg_bucket_size", "4096"])
    for a in ("salientgrads", "fedavg")
    for impl in ("dense", "bucketed", "bf16", "int8", "sparse", "topk",
                 "hier")
]


def _ids(table):
    return [" ".join([m or "unified"] + argv) for m, argv in table]


@pytest.mark.parametrize("algo,argv", COMMAND_LINES,
                         ids=_ids(COMMAND_LINES))
def test_flags_and_identity_match_reference(algo, argv):
    j = jconfig.parse_args(argv, algo)
    t = tconfig.parse_args(argv, algo)
    tv = vars(t)
    assert tv.pop("device") == "cuda"
    assert tv == vars(j)
    for ck in (False, True):
        assert tconfig.run_identity(t, algo, for_checkpoint=ck) == \
            jconfig.run_identity(j, algo, for_checkpoint=ck)
    assert tconfig.run_identity(tconfig.parse_args(
        argv + ["--device", "cpu"], algo), algo) == \
        jconfig.run_identity(j, algo)


def test_flag_table_matches_reference():
    for algo in (None,) + jconfig.ALGO_NAMES:
        jp, tp = jconfig.build_parser(algo), tconfig.build_parser(algo)
        jflags = {a.dest: (a.default, a.choices, a.type)
                  for a in jp._actions}
        tflags = {a.dest: (a.default, a.choices, a.type)
                  for a in tp._actions}
        assert tflags.pop("device")[0] == "cuda"
        assert tflags == jflags
    assert tconfig.ALGO_NAMES == jconfig.ALGO_NAMES


#: (extra argv, flag the refusal names): every unported feature, set; and
#: the two algorithms without a fused loop in fused blocks, which the JAX
#: CLI refuses too (the cases keep the names they had when the port
#: refused the algorithms themselves)
_NO_FUSED = ("fedfomo", "turboaggregate")
REFUSED = [
    (["--algo", a, "--fuse_rounds", "2"], "--fuse_rounds") for a in _NO_FUSED
] + [
    (["--obs", "1"], "--obs"),
    (["--obs_numerics", "1"], "--obs_numerics"),
    (["--obs_comm", "1"], "--obs_comm"),
    (["--trace_dir", "tr"], "--trace_dir"),
    (["--slo_spec", "p99:round_time_s<2"], "--slo_spec"),
    (["--flight_recorder", "guard"], "--flight_recorder"),
    # the client mesh runs (test_cli_mesh_*) every algorithm, fused blocks,
    # the state tier and the client store (test_cli_mesh_runs_the_store)
    (["--mesh_space", "2"], "--mesh_space"),
    (["--multihost"], "--multihost"),
    (["--serve_role", "worker"], "--serve_role"),
    (["--fed_role", "aggregator", "--fed_sites", "2"], "--fed_role"),
    (["--fed_role", "aggregator", "--fed_sites", "2", "--fed_site_faults",
      "1:drop=1.0"], "--fed_site_faults"),
    (["--profile_dir", "prof"], "--profile_dir"),
    (["--dataset", "cifar10"], "--dataset"),
    (["--model", "resnet18"], "--model"),
]


def _refused_id(extra):
    if extra[0] == "--algo":
        return " ".join(extra[:2])
    return " ".join(extra)


@pytest.mark.parametrize("extra,flag", REFUSED,
                         ids=[_refused_id(e) for e, _ in REFUSED])
def test_unported_flags_refused_before_any_work(tmp_path, extra, flag):
    """Refused before any work: an unported feature naming its ROADMAP
    item; fused blocks of fedfomo or turboaggregate with the JAX CLI's
    message, word for word."""
    argv = (["--algo", "salientgrads", "--dataset", "synthetic", "--model",
             "small3dcnn", "--results_dir", str(tmp_path / "res"),
             "--log_dir", str(tmp_path / "log")] + extra)
    with pytest.raises(SystemExit) as e:
        trunner.main(argv + ["--device", "cpu"])
    msg = str(e.value.code)
    assert msg.startswith(flag + ":") or msg.startswith(flag + " "), msg
    assert not (tmp_path / "res").exists() and \
        not (tmp_path / "log").exists()
    if extra[0] == "--algo":
        jargv = [str(tmp_path / "j") if a.startswith(str(tmp_path)) else a
                 for a in argv]
        with pytest.raises(SystemExit) as je:
            jrunner.main(jargv)
        assert str(je.value.code) == msg
    else:
        assert "ROADMAP item" in msg


@pytest.mark.parametrize("layout", ["s2d", "channels"])
def test_resnet3d_is_not_refused(layout):
    """The 3D-ResNet and its phased twin are ported: their ABCD command
    line passes every refusal (the 2D models stay refused, above)."""
    for p in (["salientgrads"], ["fedavg"]):
        args = tconfig.parse_args(
            ["--dataset", "abcd", "--layout", layout, "--model", "3dresnet",
             "--device", "cpu"], p[0])
        trunner.refuse_unported(args, p[0])
        assert trunner._model_key(args) == (
            "3dresnet_s2d" if layout == "s2d" else "3dresnet")


#: (extra argv, the exception, what its message says): the JAX CLI's own
#: refusals of the flags this port has, and the dense-stem AlexNet and the
#: 3D-ResNet on the synthetic 8^3 volume (the JAX initializer fails there
#: with a ZeroDivisionError; the port names the volume)
REFERENCE_REFUSALS = [
    (["--algo", "dispfl", "--eval_cache", "1"], SystemExit,
     "--eval_cache caches the per-client personal-eval terms in algorithm "
     "state; only fedavg/salientgrads"),
    (["--eval_cache", "1", "--track_personal", "0"], SystemExit,
     "--eval_cache needs the personal stack; it cannot combine with "
     "--track_personal 0"),
    (["--eval_cache", "1", "--eval_clients", "2"], SystemExit,
     "--eval_cache indexes the full cohort"),
    (["--model", "3dcnn_deeper"], ValueError,
     "AlexNet3DDeeper: the volume 8x8x8 is too small"),
    (["--model", "3dresnet"], ValueError,
     "ResNet3DL3: the volume 8x8x8 is too small"),
]


@pytest.mark.parametrize("extra,exc,says", REFERENCE_REFUSALS,
                         ids=[" ".join(e) for e, _, _ in REFERENCE_REFUSALS])
def test_reference_refusals(tmp_path, extra, exc, says):
    """What the JAX CLI refuses, the port refuses: the ``--eval_cache``
    combinations before any work, with the JAX CLI's message (its
    ``build_algorithm`` raises the same), the too-small volume at the
    model's construction."""
    argv = (["--algo", "salientgrads", "--dataset", "synthetic", "--model",
             "small3dcnn", "--results_dir", str(tmp_path / "res"),
             "--log_dir", str(tmp_path / "log")] + extra)
    with pytest.raises(exc) as e:
        trunner.main(argv + ["--device", "cpu"])
    msg = str(e.value.code if exc is SystemExit else e.value)
    assert msg.startswith(says), msg
    if exc is SystemExit:
        assert not (tmp_path / "res").exists() and \
            not (tmp_path / "log").exists()
        jargs = jconfig.parse_args(argv)
        with pytest.raises(SystemExit) as je:
            jrunner.build_algorithm(jargs, jargs.algo)
        assert str(je.value.code) == msg


#: (extra argv, the exception, what its message starts with): the JAX CLI's
#: refusals of the training options and the robustness tier, at parse
#: time, in its build or before its round loop
ROBUST_REFUSALS = [
    (["--algo", "dispfl", "--fault_spec", "drop=0.2"], SystemExit,
     "--fault_spec/--guard protect the CENTRAL aggregation round"),
    (["--algo", "subavg", "--guard", "1"], SystemExit,
     "--fault_spec/--guard protect the CENTRAL aggregation round"),
    (["--algo", "local", "--robust_agg", "median"], SystemExit,
     "--robust_agg median replaces the CENTRAL weighted mean"),
    (["--algo", "dpsgd", "--defense_type", "weak_dp"], SystemExit,
     "--defense_type weak_dp guards the global aggregation"),
    (["--watchdog", "1", "--fuse_rounds", "2"], SystemExit,
     "--watchdog rolls rounds back and retries them"),
    (["--fault_spec", "drop=0.2", "--guard", "0"], ValueError,
     "fault_spec drop=... requires the guard"),
    (["--fault_spec", "drop=0.2,bogus=1"], ValueError,
     "unknown fault kind 'bogus'"),
    (["--robust_agg", "trimmed_mean", "--robust_trim", "0.5"], ValueError,
     "--robust_trim 0.5 out of range [0, 0.5)"),
    (["--robust_agg", "krum", "--robust_krum_f", "-1"], ValueError,
     "--robust_krum_f -1 must be >= 0"),
    (["--robust_agg", "norm_krum", "--norm_bound", "0"], ValueError,
     "robust_norm_bound 0.0 must be > 0"),
    (["--stratified_sampling", "1", "--stratified_mode", "exact"],
     ValueError, "exact stratified SNIP needs >= 25 samples of every class"),
]


@pytest.mark.parametrize("extra,exc,says", ROBUST_REFUSALS,
                         ids=[" ".join(e) for e, _, _ in ROBUST_REFUSALS])
def test_reference_refusals_of_the_lifted_flags(tmp_path, extra, exc, says):
    """The lifted flags' refusals: the JAX CLI's own, message for message
    (the port's ``SystemExit`` before any work, the ``ValueError`` where
    the JAX CLI raises it: its parser or the algorithm's constructor)."""
    def argv(side):
        return (["--algo", "salientgrads", "--dataset", "synthetic",
                 "--model", "small3dcnn", "--comm_round", "1",
                 "--results_dir", str(tmp_path / side / "res"),
                 "--log_dir", ""] + extra)

    with pytest.raises(exc) as e:
        trunner.main(argv("t") + ["--device", "cpu"])
    msg = str(e.value.code if exc is SystemExit else e.value)
    assert msg.startswith(says), msg
    if exc is SystemExit:
        assert not (tmp_path / "t").exists()
    with pytest.raises(exc) as je:
        jrunner.main(argv("j"))
    assert str(je.value.code if exc is SystemExit else je.value) == msg


def test_eval_flags_split_run_identity_as_reference():
    """``--eval_cache`` (with the personal stack) and ``--eval_clients K``
    change the run identity, ``evcache`` and ``evK<K>``, as the JAX CLI's
    does; ``--eval_cache`` without the personal stack does not."""
    base = ["--algo", "salientgrads"] + SMALL
    ids = {}
    for tag, extra in (("base", []), ("cache", ["--eval_cache", "1"]),
                       ("sub", ["--eval_clients", "3"]),
                       ("nopers", ["--eval_cache", "1", "--track_personal",
                                   "0"])):
        t = tconfig.parse_args(base + extra + ["--device", "cpu"])
        j = jconfig.parse_args(base + extra)
        for ck in (False, True):
            assert tconfig.run_identity(t, for_checkpoint=ck) == \
                jconfig.run_identity(j, for_checkpoint=ck)
        ids[tag] = tconfig.run_identity(t)
    assert "evcache" in ids["cache"] and "evcache" not in ids["base"]
    assert "evK3" in ids["sub"] and "evK" not in ids["base"]
    assert len({ids["base"], ids["cache"], ids["sub"]}) == 3
    assert "evcache" not in ids["nopers"]


def test_cli_without_cuda_exits_naming_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = subprocess.run(
        [sys.executable, "-m", "neuroimagedisttraining_torch.experiments",
         "--algo", "salientgrads"] + SMALL + [
         "--results_dir", str(tmp_path / "res"), "--log_dir",
         str(tmp_path / "log")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "CUDA" in out.stderr, out.stderr
    assert not (tmp_path / "res").exists()
    bench = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert bench.returncode == 2 and bench.stdout == "", bench
    assert "CUDA" in bench.stderr


def test_seed_everything_sets_cudnn_deterministic():
    """The CLI's seeding puts cuDNN in its deterministic mode with the
    autotuner off, as the original's does (``main_sailentgrads.py:263-267``):
    without it two runs of one command line differ in the last bits on the
    card."""
    c = torch.backends.cudnn
    saved = (c.deterministic, c.benchmark)
    try:
        c.deterministic, c.benchmark = False, True
        trunner.seed_everything(3)
        assert (c.deterministic, c.benchmark) == (True, False)
        assert torch.initial_seed() == 3
    finally:
        c.deterministic, c.benchmark = saved


#: BENCH_CONFIG -> (BENCH_DENSE, bench.py's metric name)
BENCH_METRICS = {
    "": (False, "salientgrads_rounds_per_sec_abcd_alexnet3d_8clients"),
    "resnet3d": (False,
                 "salientgrads_rounds_per_sec_abcd_3dresnet_s2d_8clients"),
    "resnet3d_dense": (True,
                       "salientgrads_rounds_per_sec_abcd_3dresnet_8clients"),
    "uneven": (False,
               "salientgrads_rounds_per_sec_abcd_alexnet3d_8clients_uneven"),
    "clients32": (False,
                  "salientgrads_rounds_per_sec_abcd_alexnet3d_32clients"),
}


@pytest.fixture(scope="module")
def bench_configs():
    """Every ``BENCH_CONFIG`` of ``bench_torch.py`` through its
    ``bench_config`` and ``main(emit=False)`` in one fresh interpreter,
    with the modules it imported; without CUDA ``main`` returns None."""
    code = (
        "import sys, json\n"
        "import bench_torch as b\n"
        "out = {}\n"
        f"for key, (dense, _) in {BENCH_METRICS!r}.items():\n"
        "    name = key.replace('_dense', '')\n"
        "    out[key] = {**b.bench_config(name, dense),\n"
        "                'rec': b.main(emit=False, config=name, dense=dense)}\n"
        "out['jax'] = sorted(m for m in sys.modules if m == 'jax' or\n"
        "                    m.startswith('neuroimagedisttraining_tpu'))\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("config", sorted(BENCH_METRICS))
def test_bench_torch_configs_without_cuda(bench_configs, config):
    """Each ``BENCH_CONFIG`` of ``bench_torch.py`` under ``bench.py``'s
    metric name and constants; without CUDA ``main`` returns None and the
    script has imported nothing of JAX."""
    got, stderr = bench_configs
    assert got["jax"] == []
    cfg = got[config]
    assert cfg["metric"] == BENCH_METRICS[config][1]
    if not torch.cuda.is_available():
        assert cfg["rec"] is None and "CUDA is not available" in stderr
    want = {"": ("3dcnn_s2d", 8, False, None),
            "resnet3d": ("3dresnet_s2d", 8, False, None),
            "resnet3d_dense": ("3dresnet", 8, False, None),
            "uneven": ("3dcnn_s2d", 8, True, None),
            "clients32": ("3dcnn_s2d", 32, False, 4)}[config]
    assert (cfg["model_key"], cfg["n_clients"], cfg["uneven"],
            cfg["test_per_client"]) == want


def test_bench_torch_refuses_an_unknown_config():
    env = dict(os.environ, BENCH_CONFIG="resnet")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode not in (0, 2) and out.stdout == ""
    assert "unknown BENCH_CONFIG 'resnet'" in out.stderr


# -- the algorithm the CLI builds --------------------------------------------

def _built(algo, argv):
    """Both sides' ``build_algorithm`` from one unified-parser command
    line (whose fedfomo ``--val_fraction`` default carves a validation
    split on both)."""
    argv = ["--algo", algo] + argv
    j_algo, j_data = jrunner.build_algorithm(jconfig.parse_args(argv), algo)
    t_algo, t_data = trunner.build_algorithm(
        tconfig.parse_args(argv + ["--device", "cpu"]), algo)
    return j_algo, j_data, t_algo, t_data


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

def _stat_keys(tmp_path):
    """The top-level keys of the reference's stat_info for a clean run."""
    ns = argparse.Namespace(results_dir=str(tmp_path / "keys"),
                            dataset="synthetic")
    path = jrunner.save_stat_info(ns, "x", [], {}, fault_counters={})
    with open(path, "rb") as f:
        return sorted(pickle.load(f))


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


# -- the deferred records ----------------------------------------------------

def test_deferred_records_match_reference():
    logs = {"j": [], "t": []}
    jd = jrecords.DeferredRecords(log=logs["j"].append, timed=True)
    td = trecords.DeferredRecords(log=logs["t"].append, timed=True)
    for r in range(3):
        jd.push({"round": r, "loss": jnp.float32(r / 3),
                 "acc": np.float32(0.5), "vec": np.arange(2)})
        td.push({"round": r, "loss": torch.tensor(r / 3),
                 "acc": np.float32(0.5), "vec": torch.arange(2)})
        assert len(logs["t"]) == len(logs["j"]) == r
    jd.flush()
    td.flush()
    for a, b in zip(logs["t"], logs["j"]):
        assert sorted(a) == sorted(b)
        assert a["round"] == b["round"] and isinstance(a["round"], int)
        assert a["loss"] == b["loss"] and isinstance(a["loss"], float)
        assert isinstance(a["vec"], torch.Tensor)
        assert a["round_time_s"] >= 0
    assert trecords.to_float(torch.tensor([1.0, 2.0])).shape == (2,)
    counters = trecords.RunCounters()
    counters.update({"clients_dropped": torch.tensor(2.0)})
    counters.update({"clients_dropped": 1.0, "round": 3})
    assert counters.summary() == {"clients_dropped": 3.0}


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
