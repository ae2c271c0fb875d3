"""Checkpoints, resume and the watchdog's rollback on the port's client
mesh, on the CPU: gloo ranks (``tests/_torch_mesh_workers.py``) at D = 2
and 4 and the single process, ``small3dcnn``, 8 clients, SalientGrads on
the top-k wire under the guard with NaN clients (its state has both row
fields, the personal stack and the top-k residual).

* A step written at D = 2 is a single-process step: the same field names,
  shapes and dtypes, its row fields the ranks' rows in client order, bit
  for bit.
* A D = 2 run of 4 rounds checkpointed after round 2 and resumed by a fresh
  algorithm is bitwise its uninterrupted twin, in the eager loop and in
  fused blocks of 2.
* A D = 2 step resumes at D = 4 and in one process, and a single-process
  step at D = 2: the restored state is the saved one bit for bit, and the
  two rounds after it stay within 1e-6 of the scale of the uninterrupted
  twin's trees (the on-mesh weighted sum reassociates across ranks).
* The watchdog on the mesh (FedAvg, NaN clients with the guard off, the
  update-norm check on): every rank gives rank 0's verdict (rank 1's own
  health check is inverted, so a local verdict would show), and every
  rollback restores the last saved step through the checkpoint on every
  rank: a skip at full participation, retries with re-drawn cohorts at
  ``frac`` 0.5.
* A save that raises on rank 0 leaves every rank running; rank 0 counts
  the failure and the next save lands; no other rank writes.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402

CASE = dict(algo="salientgrads", impl="topk", data_seed=4, frac=1.0, seed=0,
            robust="none", spec="nan=0.34", defense=None)
ROUNDS, STEP = 4, 2
#: the watchdog's cases: (name, frac, the verdict it must meet)
WATCHDOG = [("full", 1.0, "skip"), ("frac", 0.5, "retry")]
WATCHDOG_CASE = dict(algo="fedavg", impl="dense", data_seed=9, seed=0,
                     robust="none", spec="nan=0.25", defense=None,
                     guard=False)
SPAWN_TIMEOUT_S = 240
FIELDS = ("global_params", "personal", "residual", "eval_cache")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single_run(directory):
    """The single process: ``ROUNDS`` rounds, a checkpoint after round
    ``STEP``; its state at the step and at the end."""
    a = mw.robust_algo(CASE)
    mgr = mw._ckpt(directory)
    state = a.init_state()
    saved = None
    for r in range(ROUNDS):
        state, _ = a.run_round(state, r)
        if r + 1 == STEP:
            mgr.save(STEP, state)
            saved = mw._state_np(state)
    return dict(saved=saved, end=mw._state_np(state))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    d = {k: str(root / k) for k in ("single", "eager", "fused", "fail")}
    single = _single_run(d["single"])
    d2 = mw.run_ranks(2, [
        ("ckpt_run_case", dict(case=CASE, directory=d["eager"],
                               rounds=ROUNDS, save_after=STEP)),
        ("ckpt_run_case", dict(case=CASE, directory=d["fused"],
                               rounds=ROUNDS, save_after=STEP,
                               loop="fused")),
        ("ckpt_resume_case", dict(case=CASE, directory=d["single"],
                                  step=STEP, rounds=ROUNDS)),
        *[("watchdog_case", dict(
            case=dict(WATCHDOG_CASE, frac=frac),
            directory=str(root / f"wd_{name}"))) for name, frac, _ in
          WATCHDOG],
        ("save_failure_case", dict(case=CASE, directory=d["fail"]))],
        timeout=SPAWN_TIMEOUT_S)
    d4 = mw.run_ranks(4, [("ckpt_resume_case", dict(
        case=CASE, directory=d["eager"], step=STEP, rounds=ROUNDS))],
        timeout=SPAWN_TIMEOUT_S)
    one = mw._resume(mw.robust_algo(CASE), mw._ckpt(d["eager"]), STEP,
                     ROUNDS)
    return dict(dirs=d, single=single, eager=d2[0], fused=d2[1],
                from_single=d2[2],
                watchdog=dict(zip([w[0] for w in WATCHDOG], d2[3:5])),
                fail=d2[5], d4=d4[0], d1=one)


def _eq(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in b)


def _rel(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b) / \
        max(float(np.max(np.abs(v))) for v in b.values())


def _whole(ranks, which, field):
    """A row field of the ranks' states ``which``, the blocks joined."""
    trees = [r[which][field] for r in ranks]
    return {k: np.concatenate([t[k] for t in trees]) for k in trees[0]}


def _load(directory, step):
    return torch.load(os.path.join(directory, "run", str(step), "state.pt"),
                      weights_only=True)


def test_mesh_step_is_a_single_process_step(runs):
    """Field names, shapes and dtypes of a single-process step; the row
    fields the ranks' rows in client order, the replicated fields the
    ranks' own, bitwise."""
    mesh = _load(runs["dirs"]["eager"], STEP)["fields"]
    single = _load(runs["dirs"]["single"], STEP)["fields"]
    assert sorted(mesh) == sorted(single)
    for f, v in single.items():
        if isinstance(v, dict) and all(isinstance(x, torch.Tensor)
                                       for x in v.values()):
            assert sorted(mesh[f]) == sorted(v), f
            for k, x in v.items():
                assert mesh[f][k].shape == x.shape, (f, k)
                assert mesh[f][k].dtype == x.dtype, (f, k)
        else:
            assert (mesh[f] is None) == (v is None), f
    ranks = runs["eager"]
    for f, field in (("personal_params", "personal"),
                     ("agg_residual", "residual")):
        want = _whole(ranks, "saved", field)
        assert mesh[f][next(iter(want))].shape[0] == 8
        assert _eq({k: v.numpy() for k, v in mesh[f].items()}, want), f
    for i, rank in enumerate(ranks):
        assert _eq({k: v.numpy() for k, v in
                    mesh["global_params"].items()},
                   rank["saved"]["global_params"])
        assert rank["lo"] == i * 4


@pytest.mark.parametrize("loop", ["eager", "fused"])
def test_mesh_resume_is_bitwise_its_uninterrupted_twin(runs, loop):
    for rank in runs[loop]:
        res = rank["resumed"]
        assert (res["lo"], res["hi"]) == (rank["lo"], rank["hi"])
        for field in FIELDS:
            if rank["saved"][field] is not None:
                assert _eq(res["restored"][field], rank["saved"][field]), \
                    field
                assert _eq(res["end"][field], rank["end"][field]), field


@pytest.mark.parametrize("which", ["d4", "d1", "from_single"])
def test_mesh_step_resumes_at_another_width(runs, which):
    """A D = 2 step at D = 4 and in one process, a single-process step at
    D = 2: restored bitwise, then within 1e-6 of the uninterrupted twin
    (the D = 2 run, the single process)."""
    got = runs[which]
    ranks = got if isinstance(got, list) else [got]
    if which == "from_single":
        saved, end = runs["single"]["saved"], runs["single"]["end"]
    else:
        twin = runs["eager"]
        saved = {f: (_whole(twin, "saved", f) if f in ("personal",
                                                       "residual")
                     else twin[0]["saved"][f]) for f in FIELDS}
        end = {f: (_whole(twin, "end", f) if f in ("personal", "residual")
                   else twin[0]["end"][f]) for f in FIELDS}
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        for f in ("personal", "residual"):
            assert _eq(rank["restored"][f],
                       {k: v[lo:hi] for k, v in saved[f].items()}), f
            mine = rank["end"][f]
            assert _rel(mine, {k: v[lo:hi] for k, v in end[f].items()}) \
                <= 1e-6, f
        assert _eq(rank["restored"]["global_params"], saved["global_params"])
        assert _rel(rank["end"]["global_params"],
                    end["global_params"]) <= 1e-6
    assert len(ranks) == {"d4": 4, "d1": 1, "from_single": 2}[which]


@pytest.mark.parametrize("name,frac,verdict", WATCHDOG,
                         ids=[w[0] for w in WATCHDOG])
def test_mesh_watchdog_rolls_back_through_the_checkpoint(runs, name, frac,
                                                         verdict):
    ranks = runs["watchdog"][name]
    logs = [r["log"] for r in ranks]
    assert all(log == logs[0] for log in logs[1:]), logs
    assert all(r["totals"] == ranks[0]["totals"] for r in ranks)
    verdicts = [v for _, v, _ in logs[0]]
    assert verdict in verdicts, verdicts
    # every rollback restored the last saved state, on every rank
    assert all(same for _, v, same in logs[0] if v != "ok")
    for r in ranks:
        for v in r["end"]["global_params"].values():
            assert np.isfinite(v).all()
    assert ranks[0]["totals"]["rounds_retried"] == verdicts.count("retry")
    assert ranks[0]["totals"]["rounds_skipped"] == verdicts.count("skip")


def test_mesh_save_failure_leaves_every_rank_running(runs):
    rank0, rank1 = runs["fail"]
    assert rank0["failures"] == 1 and rank0["done"] == [False, True]
    assert rank1["failures"] == 0 and rank1["done"] == [True, True]
    assert rank0["steps"] == rank1["steps"] == [2]
    # rank 0 alone writes
    assert (rank0["writes"], rank1["writes"]) == (2, 0)
