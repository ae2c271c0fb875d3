"""The port's distributed federation (``fed/``) against its own in-process
run and against the JAX package's federation, on the CPU (``small3dcnn``,
6 clients, 2-3 sites, 2 rounds).

1. Site training: the port's ``SiteTrainer.train_sync`` on one site's slots
   of a round, fed that round's JAX draws (the epoch permutations of the
   slots' keys of ``split(round_key, S + 1)``), against the JAX package's
   ``SiteTrainer.train_sync`` on the same slots, at the FedAvg round
   tolerance of ``tests/test_torch_port_fedavg.py`` (rtol 1e-5, atol 1e-5
   of each leaf's largest value; the losses rtol 1e-5).
2. The loopback sync federation through the CLI (``--device cpu``) is
   bitwise its in-process twin (global parameters, every round's loss, the
   final eval), with the gradient clip active, whose norm sums the leaves
   in the model's order; over the native TCP transport, three processes
   started by ``scripts/torch_run_federation.py``, it is bitwise the
   loopback run.
3. Fed the JAX rounds' draws and initial parameters, the port's loopback
   sync federation lies within that tolerance of the JAX package's own
   loopback sync federation.
4. The buffered flush is bitwise the JAX package's ``_flush`` on the same
   member deltas (dense and int8 codecs, stale members), and a buffered
   loopback run with a straggling site replays its trace bitwise.
5. No fallback: a federation role on CUDA without a card ends the run.
   No port module imports ``jax`` or the JAX package.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.comm.local import LocalRouter as JRouter  # noqa: E402
from neuroimagedisttraining_tpu.comm.message import Message as JMessage  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.experiments import config as jconfig  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.fed import aggregator as jaggregator  # noqa: E402
from neuroimagedisttraining_tpu.fed import wire as jwire  # noqa: E402
from neuroimagedisttraining_tpu.fed.trainer import SiteTrainer as JSiteTrainer  # noqa: E402
from neuroimagedisttraining_torch.comm import LocalRouter, Message  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.experiments import config as tconfig  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.fed import (  # noqa: E402
    aggregator,
    protocol,
    runtime,
    wire,
)
from neuroimagedisttraining_torch.fed.trainer import SiteTrainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SITES = 6, 3
BASE = ["--algo", "fedavg", "--model", "small3dcnn", "--dataset", "synthetic",
        "--client_num_in_total", str(N), "--frac", "1.0", "--batch_size", "8",
        "--epochs", "1", "--comm_round", "2", "--lr", "0.05",
        "--final_finetune", "0"]
FED = ["--fed_role", "aggregator", "--fed_mode", "sync", "--fed_sites",
       str(SITES)]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the processes a TCP federation starts run on
    one thread too (``OMP_NUM_THREADS=1``), and float sums on the CPU
    follow the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dirs(tmp_path, sub):
    return ["--log_dir", str(tmp_path / sub / "log"), "--results_dir",
            str(tmp_path / sub / "res")]


def _t_args(tmp_path, sub, *extra):
    return tconfig.parse_args(BASE + _dirs(tmp_path, sub) + list(extra)
                              + ["--device", "cpu"])


def _close(t_tree, j_tree):
    """The FedAvg round tolerance: rtol 1e-5, atol 1e-5 of the leaf's
    largest value (every weight trains; an element's round-off follows
    its leaf's scale)."""
    want = jax_params_to_torch(jax.tree_util.tree_map(np.asarray, j_tree))
    assert sorted(want) == sorted(t_tree)
    for k, v in want.items():
        v = v.numpy()
        np.testing.assert_allclose(
            np.asarray(t_tree[k]), v, rtol=1e-5,
            atol=max(2e-7, 1e-5 * float(np.abs(v).max())), err_msg=k)


def _jax_side(tmp_path):
    """The JAX CLI's algorithm for the federation's command line, its
    initial state and its rounds' keys and draws."""
    jargs = jconfig.parse_args(BASE + _dirs(tmp_path, "j") + FED)
    jalgo, jdata = jrunner.build_algorithm(jargs, "fedavg")
    jstate = jalgo.init_state(jax.random.PRNGKey(jargs.seed))
    nvals = [int(n) for n in np.asarray(jdata.n_train)]
    spe = -(-max(nvals) // 8)
    n_rows = jdata.x_train.shape[1]
    rng, rounds = jstate.rng, []
    for r in range(2):
        rng, round_key = jax.random.split(rng)
        sel = np.asarray(jalgo._selected_client_indexes(r))
        keys = jax.random.split(round_key, len(sel) + 1)
        perms = [np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(nvals[int(c)]), 1,
            spe * 8, n_rows=n_rows)) for i, c in enumerate(sel)]
        rounds.append(dict(round_key=round_key, sel=sel, perms=perms))
    return jargs, jalgo, jstate, rounds


def _with_init(talgo, jstate):
    """``talgo`` starting from the JAX run's initial parameters: its
    ``init_state`` (which the aggregator calls) given them."""
    params = jax_params_to_torch(jax.tree_util.tree_map(
        np.asarray, jstate.global_params))
    init = talgo.init_state
    talgo.init_state = lambda generator=None: init(generator, params=params)
    return params


def test_site_training_matches_the_reference_on_its_draws(tmp_path):
    jargs, jalgo, jstate, rounds = _jax_side(tmp_path)
    talgo, _ = trunner.build_algorithm(_t_args(tmp_path, "t"), "fedavg")
    params = _with_init(talgo, jstate)
    r0 = rounds[0]
    pos = protocol.partition_slots(len(r0["sel"]), SITES)[1]
    ids = r0["sel"][pos]
    jrows, jlosses = JSiteTrainer(jalgo).train_sync(
        jstate.global_params, r0["round_key"], 0, ids, pos, len(r0["sel"]))
    rows, losses = SiteTrainer(talgo).train_sync(
        {k: v.numpy() for k, v in params.items()}, 0, ids,
        {"perms": [r0["perms"][i] for i in pos]})
    assert losses.shape == (len(pos),)
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    for j, i in enumerate(pos):
        _close({k: v[j] for k, v in rows.items()},
               jax.tree_util.tree_map(lambda a: a[j], jrows))


def test_loopback_sync_is_bitwise_its_in_process_twin(tmp_path):
    clip = ["--grad_clip", "0.01"]  # the clip active on every step
    fed = trunner.main(BASE + _dirs(tmp_path, "fed") + FED + clip
                       + ["--device", "cpu"])
    twin = trunner.main(BASE + _dirs(tmp_path, "twin") + clip
                        + ["--frequency_of_the_test", "1", "--device",
                           "cpu"])
    for k, v in twin["state"].global_params.items():
        np.testing.assert_array_equal(fed["global_params"][k], v.numpy())
    rounds = [r for r in fed["history"] if r["round"] >= 0]
    t_rounds = [r for r in twin["history"] if r["round"] >= 0]
    assert [r["train_loss"] for r in rounds] == \
        [r["train_loss"] for r in t_rounds]
    assert fed["final_eval"] == {"global_acc": t_rounds[-1]["global_acc"],
                                 "global_loss": t_rounds[-1]["global_loss"]}
    assert [r["sites_reported"] for r in rounds] == [SITES, SITES]
    out = fed["fed"]["out_dir"]
    summary = json.load(open(os.path.join(out, "summary.json")))
    assert summary["final_eval"] == fed["final_eval"]
    assert summary["params_sha256"] == runtime.params_digest(
        fed["global_params"])
    merged = [json.loads(line) for line in open(
        fed["fed"]["federation_jsonl"])]
    assert {r.get("host") for r in merged} >= {0, 1, 2, 3}
    # the launcher: an aggregator and three site processes over TCP
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "torch_run_federation.py"),
         "--sites", str(SITES), "--device", "cpu", "--out",
         str(tmp_path / "tcp"), "--"] + BASE + _dirs(tmp_path, "tcp")
        + clip + ["--fed_mode", "sync"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    launch = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and launch["launcher_ok"], proc.stderr[-3000:]
    assert launch["site_rcs"] == {str(k): 0 for k in range(1, SITES + 1)}
    got = np.load(tmp_path / "tcp" / runtime.PARAMS_FILE)
    for k, v in fed["global_params"].items():
        np.testing.assert_array_equal(got[k], v)
    tcp_summary = json.load(open(tmp_path / "tcp" / "summary.json"))
    assert tcp_summary["final_eval"] == fed["final_eval"]
    assert tcp_summary["fed"]["comm_messages_received"] == 2 * SITES


def test_fed_the_reference_draws_it_matches_the_reference_federation(
        tmp_path):
    jargs, jalgo, jstate, rounds = _jax_side(tmp_path)
    jfed = jrunner.run_experiment(jargs, "fedavg")
    targs = _t_args(tmp_path, "t", *FED)
    trunner.seed_everything(targs.seed)
    talgo, _ = trunner.build_algorithm(targs, "fedavg")
    _with_init(talgo, jstate)
    fed = runtime.run_federated(targs, "fedavg", algo=talgo, round_draws=[
        {"perms": r["perms"]} for r in rounds])
    _close(fed["global_params"], jfed["global_params"])
    t_losses = [r["train_loss"] for r in fed["history"] if r["round"] >= 0]
    j_losses = [r["train_loss"] for r in jfed["history"] if r["round"] >= 0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for k in ("global_acc", "global_loss"):
        np.testing.assert_allclose(fed["final_eval"][k],
                                   jfed["final_eval"][k], rtol=1e-5)


# -- the buffered policy -----------------------------------------------------

@dataclasses.dataclass
class _TState:
    global_params: dict
    generator: object = None


def _aggregators(g):
    """A port and a JAX buffered aggregator over the same global model
    (stub algorithms: the flush reads only the model and the version)."""
    tstub = types.SimpleNamespace(
        num_clients=N, device=torch.device("cpu"),
        init_state=lambda: _TState({k: torch.from_numpy(v.copy())
                                    for k, v in g.items()}),
        _row_fields_of=lambda state: [])
    jstub = types.SimpleNamespace(
        num_clients=N, init_state=lambda key: types.SimpleNamespace(
            global_params={k: jnp.asarray(v) for k, v in g.items()},
            rng=key))
    kw = dict(mode="buffered", rounds=3, seed=0, buffer_k=3,
              staleness_bound=2)
    return (aggregator.FedAggregator(LocalRouter(4).manager(0), 4, tstub,
                                     **kw),
            jaggregator.FedAggregator(JRouter(4).manager(0), 4, jstub, **kw))


@pytest.mark.parametrize("impl", ["dense", "int8"])
def test_buffered_flush_is_bitwise_the_reference(impl):
    r = np.random.RandomState(5)
    g = {"conv.w": r.randn(4, 3, 3).astype(np.float32),
         "conv.b": r.randn(4).astype(np.float32),
         "head.w": r.randn(2, 4).astype(np.float32)}
    tagg, jagg = _aggregators(g)
    tagg.version = jagg.version = 2
    t_members, j_members = [], []
    for site, base, n_sum in ((2, 2, 16.0), (1, 1, 24.0), (3, 0, 8.0)):
        delta = {k: (r.randn(*v.shape) * 0.1).astype(np.float32)
                 for k, v in g.items()}
        tm, jm = Message("fed_update", site, 0), JMessage("fed_update",
                                                          site, 0)
        wire.encode_update(tm, delta, impl)
        jwire.encode_update(jm, delta, impl)
        loss = float(r.rand())
        t_members.append((site, base, wire.decode_update(
            Message.from_bytes(tm.to_bytes())), n_sum, loss))
        j_members.append((site, base, jwire.decode_update(
            JMessage.from_bytes(jm.to_bytes())), n_sum, loss))
    tagg._flush(t_members, 0, 3)
    jagg._flush(j_members, 0, 3)
    for k in g:
        np.testing.assert_array_equal(tagg.global_params[k].numpy(),
                                      np.asarray(jagg.global_params[k]))
    assert tagg.version == jagg.version == 3
    assert tagg.trace == jagg.trace
    assert tagg.staleness_hist == jagg.staleness_hist
    assert tagg.history == jagg.history


def test_buffered_straggler_run_replays_bitwise(tmp_path):
    buf = ["--fed_role", "aggregator", "--fed_mode", "buffered",
           "--fed_sites", str(SITES), "--fed_buffer_k", "2",
           "--fed_site_faults", "3:straggle=1.0:30.0"]
    out = trunner.main(BASE + _dirs(tmp_path, "buf") + buf
                       + ["--device", "cpu"])
    trace = json.load(open(out["fed"]["trace_path"]))
    assert len(trace["flushes"]) == 2
    assert all(site != SITES for fl in trace["flushes"]
               for site, _ in fl["members"])
    rep = trunner.main(BASE + _dirs(tmp_path, "rep") + buf + [
        "--fed_replay", out["fed"]["trace_path"], "--device", "cpu"])
    assert rep["fed"]["replayed"]
    for k, v in out["global_params"].items():
        np.testing.assert_array_equal(rep["global_params"][k], v)
    assert [r["train_loss"] for r in rep["history"] if r["round"] >= 0] == \
        [r["train_loss"] for r in out["history"] if r["round"] >= 0]


def test_synthetic_volume_cohort(monkeypatch):
    """``--dataset synthetic_volume`` (the port's own, the federation's
    full-width cohort on the card), here at a small volume: 40 training
    and 10 test rows a client, phased for the s2d stem or with a channel
    axis, bf16, the same cohort from the same flags; other layouts are
    refused before any data is made."""
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    monkeypatch.setattr(trunner, "VOLUME_SYNTH_SHAPE", (9, 11, 9))
    base = ["--dataset", "synthetic_volume", "--client_num_in_total", "2",
            "--device", "cpu"]
    s2d = tconfig.parse_args(base + ["--layout", "s2d", "--model", "3dcnn"])
    a, b = trunner.build_data(s2d), trunner.build_data(s2d)
    assert tuple(a.x_train.shape) == (2, 40) + phased_sample_shape(
        (9, 11, 9), *trunner.S2D_SPECS["3dcnn_s2d"])
    assert tuple(a.x_test.shape[:2]) == (2, 10)
    assert a.x_train.dtype == torch.bfloat16
    assert torch.equal(a.x_train, b.x_train) and torch.equal(a.y_test,
                                                             b.y_test)
    assert [int(n) for n in a.n_train] == [40, 40]
    flat = trunner.build_data(tconfig.parse_args(base))
    assert tuple(flat.x_train.shape) == (2, 40, 9, 11, 9, 1)
    with pytest.raises(SystemExit, match="--layout flat"):
        trunner.build_algorithm(tconfig.parse_args(base + ["--layout",
                                                           "flat"]),
                                "fedavg")


# -- no fallback, no JAX ----------------------------------------------------

def test_federation_roles_need_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        return
    for role in (FED, ["--fed_role", "site", "--fed_backend", "tcp",
                       "--fed_sites", "2", "--fed_site_rank", "1",
                       "--fed_endpoints",
                       "127.0.0.1:1,127.0.0.1:2,127.0.0.1:3"]):
        with pytest.raises(SystemExit, match="CUDA"):
            trunner.main(BASE + _dirs(tmp_path, "cuda") + role)
    with pytest.raises(SystemExit, match="fed_role site needs a real"):
        trunner.main(BASE + _dirs(tmp_path, "site") + [
            "--fed_role", "site", "--fed_sites", "2", "--device", "cpu"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_module_imports_jax():
    pkg = os.path.join(ROOT, "neuroimagedisttraining_torch")
    paths = [os.path.join(ROOT, "scripts", "torch_run_federation.py"),
             os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert any(p.endswith(os.path.join("fed", "aggregator.py"))
               for p in paths)
    for p in paths:
        for name in _imports(p):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "neuroimagedisttraining_tpu"), (p, name)
