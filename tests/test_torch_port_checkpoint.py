"""The port's checkpoint and resume (``utils/checkpoint.py`` and the CLI's
``--checkpoint_dir`` / ``--resume``), on the CPU.

* The torch format: every state field round-trips bit for bit (the
  generator's state, ``None`` fields, the eval cache, DisPFL's masks),
  ``max_to_keep`` and ``save_every``, ``save_failures`` on a directory that
  cannot be written, the fallback past a step cut short, the sidecars
  pruned with their steps, a schema mismatch on every step raising with the
  caller's hint, and an orbax step of the JAX package refused by name.
* Kill and resume: through the CLI, a run cut after round 2 and resumed
  equals the uninterrupted run bit for bit (histories, ``stat_info``'s cost
  totals, the final state), eager, fused (``--fuse_rounds 2``, saved at
  block boundaries) and a fused lineage resumed unfused; the library's
  ``run_round`` across a save and a restore as well.
* The lineage reconciliation (``--batching``, ``--augment``,
  ``--track_personal``) adopts and refuses as the JAX CLI does, message
  for message, and ``CostTracker.restore_totals`` restores what the JAX
  package's does.
* The cross-load: the JAX package runs 2 SalientGrads rounds and saves them
  with its orbax ``CheckpointManager``; the step restored to numpy and
  converted (``convert.jax_state_to_torch``) is saved and restored in the
  port's format and runs round 3 with the reference's draws at the seams,
  against the JAX package's own resumed round 3 at the trajectory tolerance
  (``tests/test_torch_port_round.py``'s cohort and bounds: rtol 1e-5, atol
  2e-7 for the GroupNorm-fed biases).
"""
import argparse
import json
import os
import pickle

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.utils import flops as jflops  # noqa: E402
from neuroimagedisttraining_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    DisPFL,
    Ditto,
    FedAvg,
    SalientGrads,
)
from neuroimagedisttraining_torch.convert import jax_state_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.utils import flops as tflops  # noqa: E402
from neuroimagedisttraining_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
    ForeignCheckpointError,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small CPU ops among the suite's parallel workers: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(cls, frac=0.5, **kw):
    data = make_synthetic_federated(seed=3, n_clients=6, samples_per_client=8,
                                    test_per_client=4,
                                    sample_shape=(6, 6, 6, 1), uneven=True)
    torch.manual_seed(0)
    hp = HyperParams(lr=0.05, lr_decay=0.998, momentum=0.9, local_epochs=1,
                     steps_per_epoch=2, batch_size=4)
    return cls(create_model("small3dcnn", num_classes=1), data, hp,
               loss_type="bce", frac=frac, seed=3, device="cpu", **kw)


def _same(a, b):
    """Two values of a state field bit for bit (trees, tensors,
    generators, None)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def _states_equal(a, b):
    import dataclasses

    return type(a) is type(b) and all(
        _same(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a))


STATES = [
    pytest.param(SalientGrads, dict(dense_ratio=0.5, eval_cache=True),
                 id="salientgrads-evalcache"),
    pytest.param(FedAvg, dict(agg_impl="topk", track_personal=False),
                 id="fedavg-topk-nopersonal"),
    pytest.param(Ditto, {}, id="ditto"),
    pytest.param(DisPFL, dict(dense_ratio=0.5), id="dispfl-masks"),
]


@pytest.mark.parametrize("cls,kw", STATES)
def test_round_trip_every_state_field(tmp_path, cls, kw):
    """A state after a round, saved and restored into a fresh template:
    every field bit for bit, the generator's state included, None fields
    None, every tensor a fresh one on the template's device; the restored
    state's next round equals the original's."""
    algo = _small(cls, **kw)
    state, _ = algo.run_round(algo.init_state(), 0)
    mgr = CheckpointManager(str(tmp_path), "lineage")
    assert mgr.save(1, state)
    template = algo.init_state()
    got, step = mgr.restore_latest(template)
    assert step == 1 and _states_equal(got, state)
    assert got.generator is not state.generator
    a, ma = algo.run_round(state, 1)
    b, mb = algo.run_round(got, 1)
    assert _states_equal(a, b) and all(float(ma[k]) == float(mb[k])
                                       for k in ma)


def test_max_to_keep_and_save_every(tmp_path):
    """Every ``save_every``-th step is saved unless forced; only the
    ``max_to_keep`` newest stay; ``latest_step`` names the newest."""
    algo = _small(FedAvg)
    state = algo.init_state()
    mgr = CheckpointManager(str(tmp_path), "run", max_to_keep=2,
                            save_every=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(state) is None
    saved = [mgr.save(s, state) for s in range(1, 6)]
    assert saved == [False, True, False, True, False]
    assert mgr.save(5, state, force=True)
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert mgr.save_failures == 0


def test_save_failures_on_an_unwritable_directory(tmp_path):
    """A save that cannot write logs, counts ``save_failures`` and returns
    False instead of raising: the run goes on."""
    algo = _small(FedAvg)
    mgr = CheckpointManager(str(tmp_path), "run")
    os.rmdir(mgr.directory)
    with open(mgr.directory, "w") as f:  # the lineage is now a file
        f.write("x")
    assert not mgr.save(1, algo.init_state(), metadata={"a": 1})
    assert not mgr.save(2, algo.init_state())
    assert mgr.save_failures == 2


def test_fallback_past_a_step_cut_short(tmp_path):
    """The newest step truncated, and a step dir holding only a temporary
    file (a kill mid-write): both skipped, the next older one restored;
    when no step loads the error names the steps and the caller's hint."""
    algo = _small(FedAvg)
    s1, _ = algo.run_round(algo.init_state(), 0)
    s2, _ = algo.run_round(s1, 1)
    mgr = CheckpointManager(str(tmp_path), "run", max_to_keep=5)
    mgr.save(1, s1)
    mgr.save(2, s2)
    path = os.path.join(mgr.directory, "2", "state.pt")
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    os.makedirs(os.path.join(mgr.directory, "3"))
    with open(os.path.join(mgr.directory, "3", "state.pt.tmp"), "wb") as f:
        f.write(blob[:100])
    got, step = mgr.restore_latest(algo.init_state())
    assert step == 1 and _states_equal(got, s1)
    other = _small(FedAvg, agg_impl="topk")  # another schema: a residual
    with pytest.raises(RuntimeError, match=r"tried steps \[3, 2, 1\].*HINT"):
        mgr.restore_latest(other.init_state(), schema_hint="HINT")


def test_sidecars_pruned_with_their_steps(tmp_path):
    """``meta_<step>.json`` and ``store_<step>.npz`` live and go with
    their step; the metadata reads back."""
    algo = _small(FedAvg, client_store="host")
    state = algo.init_state()
    mgr = CheckpointManager(str(tmp_path), "run", max_to_keep=2)
    for r in range(4):
        state, _ = algo.run_round(state, r)
        assert mgr.save(r + 1, state, metadata={"round": r + 1},
                        store=algo._store)
    names = sorted(os.listdir(mgr.directory))
    assert names == ["3", "4", "meta_3.json", "meta_4.json", "store_3.npz",
                     "store_4.npz"]
    assert mgr.load_metadata(4) == {"round": 4}
    assert mgr.load_metadata(2) is None


# ------------------------------------------------------------- the CLI


def _cli(tmp_path, tag, extra):
    argv = ["--algo", "salientgrads", "--dataset", "synthetic", "--model",
            "small3dcnn", "--client_num_in_total", "6", "--device", "cpu",
            "--results_dir", str(tmp_path / tag), "--log_dir", ""] + extra
    return trunner.main(argv)


def _hist(res, rounds=None):
    return [{k: v for k, v in h.items() if k != "round_time_s"}
            for h in res["history"]
            if rounds is None or h["round"] in rounds]


KILLS = [
    pytest.param(["--frequency_of_the_test", "1"], [], id="eager"),
    pytest.param(["--fuse_rounds", "2", "--frequency_of_the_test", "0"],
                 None, id="fused"),
    pytest.param(["--fuse_rounds", "2", "--frequency_of_the_test", "0"],
                 ["--fuse_rounds", "1"], id="fused-resumed-unfused"),
]


@pytest.mark.parametrize("first,second", KILLS)
def test_kill_and_resume_bitwise(tmp_path, first, second):
    """A run cut after round 2 (its checkpoints every round, or at block
    boundaries) and resumed to round 4 under ``--resume``: the resumed
    rounds' records, the final record, ``stat_info``'s cost totals and the
    final state equal the uninterrupted run's bit for bit."""
    second = first if second is None else first + second
    ck = ["--checkpoint_dir", str(tmp_path / "ck")]
    full = _cli(tmp_path, "full", first + ["--comm_round", "4"])
    cut = _cli(tmp_path, "cut", first + ck + ["--comm_round", "2"])
    assert _hist(cut, (0, 1)) == _hist(full, (0, 1))
    res = _cli(tmp_path, "res", second + ck + ["--comm_round", "4",
                                               "--resume"])
    assert _hist(res) == _hist(full, (2, 3, -1))
    assert _states_equal(res["state"], full["state"])
    with open(res["stat_path"], "rb") as f:
        got = pickle.load(f)
    with open(full["stat_path"], "rb") as f:
        want = pickle.load(f)
    for k in ("sum_training_flops", "sum_comm_params", "final_eval"):
        assert got[k] == want[k], k
    assert got["fault_recovery"] == {"checkpoint_save_failures": 0.0}


def test_library_rounds_across_a_save_and_restore(tmp_path):
    """The library spelling of a kill: rounds 0-1, a save, a fresh
    algorithm restoring into its own template, rounds 2-3, eager and as a
    fused block: bitwise the uninterrupted rounds."""
    a = _small(SalientGrads, dense_ratio=0.5)
    sa = a.init_state()
    for r in range(4):
        sa, _ = a.run_round(sa, r)
    b = _small(SalientGrads, dense_ratio=0.5)
    sb = b.init_state()
    mgr = CheckpointManager(str(tmp_path), "run")
    for r in range(2):
        sb, _ = b.run_round(sb, r)
        mgr.save(r + 1, sb)
    for fused in (False, True):
        c = _small(SalientGrads, dense_ratio=0.5)
        sc, step = mgr.restore_latest(c.init_state())
        assert step == 2
        if fused:
            sc, _ = c.run_rounds_fused(sc, 2, 2)
        else:
            for r in range(2, 4):
                sc, _ = c.run_round(sc, r)
        assert _states_equal(sc, sa), fused


def _ns(**kw):
    base = dict(resume=False, batching="epoch", batching_explicit=False,
                augment=1, augment_explicit=False, track_personal=1,
                track_personal_explicit=False, dataset="synthetic")
    base.update(kw)
    return argparse.Namespace(**base)


#: (meta, args, algo): the lineage reconciliations of the JAX CLI
LINEAGES = [
    ({"batching": "epoch", "augment": False, "track_personal": True},
     dict(), "salientgrads"),
    ({"batching": "replacement"}, dict(resume=True), "fedavg"),
    ({"batching": "replacement"}, dict(resume=True, batching_explicit=True),
     "fedavg"),
    ({"batching": "replacement"}, dict(), "fedavg"),
    ({}, dict(resume=True), "fedavg"),
    ({}, dict(), "fedavg"),
    ({"batching": "epoch", "augment": True}, dict(resume=True), "fedavg"),
    ({"batching": "epoch", "augment": True},
     dict(resume=True, augment_explicit=True), "fedavg"),
    ({"batching": "epoch", "track_personal": None},
     dict(resume=True), "salientgrads"),
    ({"batching": "epoch", "track_personal": None},
     dict(resume=True, track_personal_explicit=True), "salientgrads"),
    ({"batching": "epoch", "track_personal": False},
     dict(track_personal=1), "salientgrads"),
]


@pytest.mark.parametrize("meta,kw,algo", LINEAGES)
def test_lineage_reconciliation_matches_jax_cli(meta, kw, algo):
    """Each lineage/flag combination: the port adopts what the JAX CLI
    adopts and refuses what it refuses, with its message."""
    outcomes = []
    for mod in (trunner, jrunner):
        args = _ns(**kw)
        try:
            mod._resolve_lineage_semantics(args, dict(meta), 7, "/ck/dir",
                                           algo)
            outcomes.append(("ok", vars(args)))
        except SystemExit as e:
            outcomes.append(("exit", str(e.code)))
    assert outcomes[0] == outcomes[1]


def test_cli_adopts_the_lineage_batching_on_a_defaulted_resume(tmp_path):
    """A lineage written with ``--batching replacement`` resumed by a
    command that leaves the batching at its default continues it (the
    identity and the records of an uninterrupted replacement run), and a
    fresh run over it with the other batching named is refused."""
    wr = ["--batching", "replacement", "--frequency_of_the_test", "0"]
    ck = ["--checkpoint_dir", str(tmp_path / "ck")]
    full = _cli(tmp_path, "full", wr + ["--comm_round", "3"])
    _cli(tmp_path, "cut", wr + ck + ["--comm_round", "1"])
    res = _cli(tmp_path, "res", ["--frequency_of_the_test", "0"] + ck +
               ["--comm_round", "3", "--resume"])
    assert res["identity"] == full["identity"]
    assert _hist(res) == _hist(full, (1, 2, -1))
    with pytest.raises(SystemExit, match="would mix training semantics"):
        _cli(tmp_path, "fresh", ["--batching", "epoch"] + ck +
             ["--comm_round", "1"])


def test_cost_totals_restore_as_the_reference():
    """``CostTracker.snapshot_totals`` / ``restore_totals`` against the JAX
    package's on the same counters: the same sidecar, the same restored
    totals and next repeat."""
    t, j = tflops.CostTracker(), jflops.CostTracker()
    for tr in (t, j):
        tr.sum_training_flops, tr.sum_comm_params = 1.5e9, 123456
        tr.per_round = [{"training_flops": 5e8, "comm_params": 41152,
                         "sum_training_flops": 1.5e9,
                         "sum_comm_params": 123456}]
    assert t.snapshot_totals() == j.snapshot_totals()
    meta = json.loads(json.dumps(j.snapshot_totals()))
    t2, j2 = tflops.CostTracker(), jflops.CostTracker()
    t2.restore_totals(meta)
    j2.restore_totals(meta)
    assert t2.per_round == j2.per_round
    assert t2.record_repeat() == j2.record_repeat()


# ------------------------------------------------ the cross-load from orbax


@pytest.fixture(scope="module")
def jax_lineage(tmp_path_factory):
    """The JAX package's SalientGrads on the round test's cohort (data
    seed 4, its main path's kernel flags): 2 rounds saved as an orbax step,
    then the reference's own resumed round 3 from that step."""
    c = pc.cohort(seed=4)
    root = str(tmp_path_factory.mktemp("orbax"))
    jalgo = JSalientGrads(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                          loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                          itersnip_iterations=1, fused_kernels=True,
                          agg_kernels="pallas")
    js = jalgo.init_state(jax.random.PRNGKey(0))
    for r in range(2):
        js, _ = jalgo.run_round(js, r)
    mgr = JCheckpointManager(root, "lineage")
    assert mgr.save(2, js, force=True)
    mgr.close()
    mgr = JCheckpointManager(root, "lineage")
    restored, step = mgr.restore_latest(
        jalgo.init_state(jax.random.PRNGKey(0)))
    mgr.close()
    assert step == 2
    # taken before round 3, which may consume the restored state's buffers
    fields = {f: pc.np_tree(getattr(restored, f)) for f in (
        "global_params", "mask", "personal_params", "agg_residual",
        "eval_cache") if getattr(restored, f) is not None}
    _, perms, _ = pc.draws(restored.rng, c)
    j3, jmet = jalgo.run_round(restored, 2)
    return dict(c=c, root=root, fields=fields, perms=perms,
                j3=pc.np_tree(j3), loss=float(jmet["train_loss"]))


def test_orbax_step_refused_by_name(jax_lineage):
    """The port's manager over the JAX package's lineage refuses its orbax
    step, naming it, instead of skipping it."""
    c = jax_lineage["c"]
    algo = SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                        loss_type="bce", dense_ratio=0.5, device="cpu")
    mgr = CheckpointManager(jax_lineage["root"], "lineage")
    assert mgr.latest_step() == 2
    with pytest.raises(ForeignCheckpointError,
                       match=r"checkpoint step 2 at .* is an orbax step"):
        mgr.restore_latest(algo.init_state())


def test_cross_load_from_an_orbax_checkpoint(tmp_path, jax_lineage):
    """The JAX package's orbax step after 2 rounds, restored to numpy and
    converted, saved and restored in the port's format, then round 3 with
    the reference's draws: within the trajectory tolerance of the JAX
    package's own resumed round 3 (losses rtol 1e-5; parameters rtol 1e-5,
    atol 2e-7; per-client accuracies equal)."""
    c = jax_lineage["c"]
    algo = SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                        loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                        itersnip_iterations=1, device="cpu")
    state = jax_state_to_torch(algo.init_state(), jax_lineage["fields"])
    mgr = CheckpointManager(str(tmp_path), "lineage")
    assert mgr.save(2, state)
    state, step = mgr.restore_latest(algo.init_state())
    assert step == 2
    state, met = algo.run_round(state, 2, perms=jax_lineage["perms"])
    j3 = jax_lineage["j3"]
    np.testing.assert_allclose(float(met["train_loss"]), jax_lineage["loss"],
                               rtol=1e-5)
    pc.compare(state.global_params, j3.global_params, "dense")
    pc.compare(state.personal_params, j3.personal_params, "dense",
               stacked=True)
    for k, v in pc.jax_params_to_torch(j3.mask).items():
        assert torch.equal(state.mask[k], v), k
