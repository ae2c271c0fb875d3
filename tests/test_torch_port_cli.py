"""The port's command-line entry point against the JAX package's, on the CPU:
its flags, identity and refusals. (Its runs on the CPU are in
``tests/test_torch_port_cli_runs.py``, on the client mesh in
``tests/test_torch_port_cli_mesh.py``; the shared helpers in
``tests/_torch_cli_helpers.py``.)

* Flags and identity: over a table of command lines, both ``parse_args``
  give equal namespaces (the port's own ``--device`` aside) and both
  ``run_identity`` equal strings, so logs and results land at the same
  paths.
* Every flag of a feature the port has not got ends the run with
  ``SystemExit`` naming the flag, before any work; the flags lifted since
  run instead, each held to the JAX CLI's run (the image side; the
  in-process observability tier, against one JAX run of all seven obs
  flags); the combinations the
  JAX CLI refuses (``--eval_cache`` with another algorithm, with
  ``--track_personal 0`` or with ``--eval_clients``; the faults, the guard,
  the robust statistics and the defenses on an algorithm without a central
  aggregate; ``--watchdog`` in fused blocks; ``drop=`` without the guard;
  the estimators' bounds; exact stratified SNIP on small shards) end it
  with the JAX CLI's reason, and a volume too small for a dense-stem
  AlexNet with a ``ValueError`` naming it.
* ``bench_torch.py``'s configurations without a card, and the deferred
  records against the reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from _torch_cli_helpers import (  # noqa: E402
    OBS_CASES,
    ROOT,
    SMALL,
    _run_image_cli,
    jax_obs_run,
    run_obs_case,
)
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.utils import records as jrecords  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.utils import records as trecords  # noqa: E402

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
#: refused the algorithms themselves). The image side's cases (``LIFTED``)
#: and the observability tier's (``OBS_CASES``) run instead.
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
    # run since the image side was ported (LIFTED below)
    (["--dataset", "cifar10"], "--dataset"),
    (["--model", "resnet18"], "--model"),
]


def _refused_id(extra):
    if extra[0] == "--algo":
        return " ".join(extra[:2])
    return " ".join(extra)


#: the refusals lifted once the image side was ported (ROADMAP item 11),
#: by id: each now runs both CLIs on pickled CIFAR-10 batches, with what
#: completes its command line
LIFTED = {"--dataset cifar10": ["--model", "cnn_cifar10"],
          "--model resnet18": ["--dataset", "cifar10"]}
#: the refusals lifted once the federation was ported (ROADMAP item 12),
#: by id: on SalientGrads both CLIs now reach the federation runtime, which
#: refuses every algorithm but FedAvg with the same message
LIFTED_FED = ("--fed_role aggregator --fed_sites 2",
              "--fed_role aggregator --fed_sites 2 --fed_site_faults "
              "1:drop=1.0")
#: the refusal lifted once the serving plane was ported (ROADMAP item 13):
#: on SalientGrads both CLIs now reach the serving runtime, which refuses
#: every algorithm but FedAvg with the same message
LIFTED_SERVE = {"--serve_role worker": "serving deployment"}


@pytest.fixture(scope="module")
def jax_obs(tmp_path_factory):
    """One JAX CLI run with all seven obs flags, shared by the obs cases."""
    return jax_obs_run(tmp_path_factory.mktemp("jax_obs"))


@pytest.mark.parametrize("extra,flag", REFUSED,
                         ids=[_refused_id(e) for e, _ in REFUSED])
def test_unported_flags_refused_before_any_work(tmp_path, request, extra,
                                                flag):
    """Refused before any work: an unported feature naming its ROADMAP
    item; fused blocks of fedfomo or turboaggregate with the JAX CLI's
    message, word for word. The image side's former refusals (``LIFTED``)
    and the observability tier's (``OBS_CASES``: ``run_obs_case``) run
    instead, each held to the JAX CLI's run."""
    argv = (["--algo", "salientgrads", "--dataset", "synthetic", "--model",
             "small3dcnn"] + extra)
    if _refused_id(extra) in OBS_CASES:
        run_obs_case(tmp_path, _refused_id(extra),
                     request.getfixturevalue("jax_obs"))
        return
    if _refused_id(extra) in LIFTED:
        _run_image_cli(tmp_path, argv + LIFTED[_refused_id(extra)],
                       reference_run="--model" not in extra)
        return
    argv += ["--results_dir", str(tmp_path / "res"), "--log_dir",
             str(tmp_path / "log")]
    with pytest.raises(SystemExit) as e:
        trunner.main(argv + ["--device", "cpu"])
    msg = str(e.value.code)
    lifted = {**{k: "federated deployment" for k in LIFTED_FED},
              **LIFTED_SERVE}.get(_refused_id(extra))
    if lifted:
        with pytest.raises(SystemExit) as je:
            jrunner.main([str(tmp_path / "j") if a.startswith(str(tmp_path))
                          else a for a in argv])
        assert msg == str(je.value.code) and msg.startswith(
            f"{lifted}: algo 'salientgrads' unsupported"), msg
        assert not (tmp_path / "res").exists()
        return
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


#: the observability flags of the later tiers: the offline tier's watch
#: (ported with ``obs/__main__.py``), the federation's live telemetry and
#: cross-process traces (ported with fed/) and the Prometheus exporter
#: (ported with serve/): all of them are ``OBS_LIFTED`` now
OBS_STILL_REFUSED = [
    ["--obs_watch_every", "2"], ["--obs_watch_color", "0"],
    ["--xtrace", "1"], ["--xtrace_dir", "xt"],
    ["--obs_heartbeat_every", "1"], ["--obs_prom_port", "9000"],
]
OBS_LIFTED = ("--obs_watch_every", "--obs_watch_color", "--xtrace",
              "--xtrace_dir", "--obs_heartbeat_every", "--obs_prom_port")


@pytest.mark.parametrize("extra", OBS_STILL_REFUSED,
                         ids=[e[0] for e in OBS_STILL_REFUSED])
def test_obs_flags_of_later_tiers_stay_refused(tmp_path, extra):
    """The observability flags of the later tiers pass every refusal, as
    in the JAX CLI, with the JAX CLI's values: the watch flags are the
    offline ``obs watch``'s defaults, which no run reads (the JAX run
    checks ``--obs_watch_every`` > 0 and reads neither); the federation's
    and the serving plane's act on ``--fed_role`` and ``--serve_role``
    runs (``tests/test_torch_port_fed_runtime.py``,
    ``tests/test_torch_port_serve_runtime.py``). None of them is left in
    ``runner._UNPORTED``."""
    argv = ["--algo", "salientgrads"] + SMALL + ["--obs", "1"] + extra + [
        "--results_dir", str(tmp_path / "res"), "--log_dir",
        str(tmp_path / "log"), "--device", "cpu"]
    assert extra[0] in OBS_LIFTED
    assert extra[0][2:] not in trunner._UNPORTED
    args = tconfig.parse_args(argv)
    trunner.refuse_unported(args, "salientgrads")
    assert vars(args)[extra[0][2:]] == vars(jconfig.parse_args(
        argv[:-2]))[extra[0][2:]]


@pytest.mark.parametrize("layout", ["s2d", "channels"])
def test_resnet3d_is_not_refused(layout):
    """The 3D-ResNet and its phased twin are ported: their ABCD command
    line passes every refusal."""
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
    "cohort": (False,
               "fedavg_cohort_rounds_per_sec_small3dcnn_c256_fused_evcache"),
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
            "clients32": ("3dcnn_s2d", 32, False, 4),
            "cohort": ("small3dcnn", 256, False, 4)}[config]
    assert (cfg["model_key"], cfg["n_clients"], cfg["uneven"],
            cfg["test_per_client"]) == want


def test_bench_torch_refuses_an_unknown_config():
    env = dict(os.environ, BENCH_CONFIG="resnet")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode not in (0, 2) and out.stdout == ""
    assert "unknown BENCH_CONFIG 'resnet'" in out.stderr


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
