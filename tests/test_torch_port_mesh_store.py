"""The client store on the port's client mesh, on the CPU: gloo ranks
(``tests/_torch_mesh_workers.py``) at D = 2 and 4, ``small3dcnn``, 8
clients of data seed 4 at ``frac`` 0.5 (4 a round, so at D = 4 a rank may
hold none of them), a store of 2 hot rows, host and disk modes. Each rank's
store holds its block's rows, its host data its block's volumes.

* Against the port's single process with a store: each streamed mesh round
  replayed by one process from the mesh's state before it (every client's
  stored rows loaded into its store, the generator in step). Every stored
  row (the personal stack, the top-k residual), the metrics and the eval
  bitwise; the global model within 1e-6 of its scale where the on-mesh
  weighted mean splits the sum by rank, bitwise under ``robust_agg`` and on
  the top-k wire. The cases: SalientGrads dense (host) and on the top-k
  wire under the guard with NaN clients (disk), FedAvg with the eval cache
  and its fine-tune (disk), FedAvg's median over the int8 wire (host), and
  Ditto (host).
* The fused blocks of 2 (the body uncaptured over gloo) bitwise the eager
  streamed rounds, on slabs of ``min(2 S, C / D)`` rows.
* Checkpoints: a D = 2 step holds the single-process step's files (the
  store sidecar's ids and rows bit for bit); it resumes at D = 2 bitwise
  (eager and fused), and at D = 4 and in one process with the restored
  rows bitwise and the next round's rows and metrics bitwise (its global
  model within 1e-6: the reduce reassociates at another width).
* The watchdog's rollback on the mesh: rank 0's verdict on every rank,
  every rank discards its staged rows and reloads its block from the
  step's sidecar.
* ``make_mesh`` without a device raises where CUDA is absent, before it
  joins a group; a rank holding none of the sampled clients under
  ``robust_agg`` on the int8 wire runs (the resident mesh round).
* Against the JAX package: the port's D = 2 streamed SalientGrads against
  the JAX package's streamed run on its own 2-device CPU mesh, on
  ``tests/test_torch_port_client_store.py``'s cohort (the narrow phased
  ``3dcnn_s2d``, data seed 4) at 4 clients, the smallest count two ranks
  divide, ``frac`` 0.5, the reference's parameters, mask and epoch
  permutations fed at the seams: train losses within rtol 1e-5, the global
  model and every stored row as that test holds them (rtol 1e-5, atol 2e-7;
  the rows within 1e-5 of their leaf's scale), the eval within rtol 2e-5.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402
import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.algorithms.base import \
    sample_client_indexes as jsample  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from neuroimagedisttraining_tpu.parallel.mesh import shard_federated_hybrid  # noqa: E402

ROUNDS, BLOCK = 4, 2
CASES = {
    "salientgrads_dense_host": dict(algo="salientgrads", mode="host",
                                    impl="dense"),
    "salientgrads_topk_guard_disk": dict(algo="salientgrads", mode="disk",
                                         impl="topk", spec="nan=0.34"),
    "fedavg_cache_disk": dict(algo="fedavg", mode="disk", impl="dense",
                              opts=dict(eval_cache=True)),
    "fedavg_median_int8_host": dict(algo="fedavg", mode="host",
                                    impl="int8", robust="median"),
    "ditto_host": dict(algo="ditto", mode="host", impl="dense"),
}
NAMES = list(CASES)
#: the cases whose global model is the single process's bit for bit: the
#: robust statistic and the top-k wire reduce the gathered rows on every
#: rank
EXACT = ("salientgrads_topk_guard_disk", "fedavg_median_int8_host")
#: the case that also runs FedAvg's fine-tune
FINALIZE = "fedavg_cache_disk"
#: the checkpoint case (both row fields in the store) and its step
CKPT_CASE = CASES["salientgrads_topk_guard_disk"]
STEP = 1
WATCHDOG_CASE = dict(algo="fedavg", mode="disk", impl="dense", data_seed=9,
                     spec="nan=0.25", opts=dict(guard=False))
#: the resident mesh round under robust_agg on the int8 wire at D = 4
RESIDENT_INT8 = dict(algo="fedavg", impl="int8", robust="median",
                     data_seed=4, frac=0.5, seed=0, spec="", defense=None)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The single process on one thread, as each rank runs (CPU
    convolutions sum in an order that follows the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The lineages the two ranks write (the D = 2 spawn), which the D = 4
    spawn and one process resume."""
    root = tmp_path_factory.mktemp("store_ckpt")
    return dict(root=root, written=None)


def _ckpt_writes(ckpt):
    root = ckpt["root"]
    return [("store_ckpt_case", dict(
        case=CKPT_CASE, root=str(root / f"rows_{loop}"),
        directory=str(root / f"mesh_{loop}"), loop=loop))
        for loop in ("eager", "fused")] + [
        ("store_watchdog_case", dict(case=WATCHDOG_CASE,
                                     root=str(root / "wd_rows"),
                                     directory=str(root / "wd")))]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def mesh_runs(request, ckpt, tmp_path_factory):
    """Every round case of a D-rank mesh in one spawn, eager and fused; at
    D = 2 the checkpoints and the watchdog, at D = 4 the D = 2 step
    resumed and the resident int8 robust round."""
    d = request.param
    root = tmp_path_factory.mktemp(f"store_D{d}")
    if d != 2 and ckpt["written"] is None:  # run alone: write them first
        ckpt["written"] = mw.run_ranks(2, _ckpt_writes(ckpt),
                                       timeout=SPAWN_TIMEOUT_S)
    cases = [("store_case", dict(case=CASES[n], root=str(root / n),
                                 rounds=ROUNDS, block=BLOCK,
                                 finalize=n == FINALIZE)) for n in NAMES]
    writes = d == 2 and ckpt["written"] is None
    if writes:
        cases += _ckpt_writes(ckpt)
    elif d == 4:
        cases += [("store_resume_case", dict(
            case=CKPT_CASE, root=str(root / "resumed"),
            directory=str(ckpt["root"] / "mesh_eager"), step=STEP)),
            ("robust_case", dict(case=RESIDENT_INT8, rounds=ROUNDS,
                                 fused=False))]
    got = mw.run_ranks(d, cases, timeout=SPAWN_TIMEOUT_S)
    k = len(NAMES)
    if writes:
        ckpt["written"] = got[k:]
    return dict(d=d, root=root, own=dict(zip(NAMES, got[:k])),
                tail=got[k:])


@pytest.fixture(scope="module")
def written(ckpt):
    """The D = 2 spawn's lineages: the eager and the fused checkpoint case
    and the watchdog case, by rank (written first where no D = 2 module
    ran)."""
    if ckpt["written"] is None:
        ckpt["written"] = mw.run_ranks(2, _ckpt_writes(ckpt),
                                       timeout=SPAWN_TIMEOUT_S)
    return ckpt["written"]


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """The single-process replays, by (width, case)."""
    return {}


def _replay(replays, mesh_runs, name):
    key = (mesh_runs["d"], name)
    if key not in replays:
        replays[key] = mw.replay_store(
            CASES[name], mesh_runs["own"][name],
            str(mesh_runs["root"] / f"one_{name}"), rounds=ROUNDS,
            finalize=name == FINALIZE)
    return replays[key]


def _eq(a, b):
    """Bitwise equal numpy arrays, or dicts of them (nested)."""
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in b)
    return np.array_equal(a, b)


def _block(rows, lo, hi):
    return {f: {k: v[lo:hi] for k, v in t.items()} for f, t in rows.items()}


def _rel(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b) / \
        max(float(np.max(np.abs(v))) for v in b.values())


@pytest.mark.parametrize("name", NAMES)
def test_mesh_store_round_is_the_single_process_streamed_round(
        mesh_runs, replays, name):
    ranks = mesh_runs["own"][name]
    off = _replay(replays, mesh_runs, name)
    assert [(r["lo"], r["hi"]) for r in ranks] == [
        (i * 8 // len(ranks), (i + 1) * 8 // len(ranks))
        for i in range(len(ranks))]
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        for r in range(ROUNDS):
            assert _eq(rank["rows"][r + 1], _block(off["rows"][r], lo, hi)), r
            assert _eq(rank["mets"][r], off["mets"][r]), r
            assert _eq(rank["evals"][r], off["evals"][r]), r
            mine, want = rank["states"][r + 1], off["states"][r]
            if name in EXACT:
                assert _eq(mine["global_params"], want["global_params"]), r
            else:
                rel = _rel(mine["global_params"], want["global_params"])
                assert rel <= 1e-6, (r, rel)
            for f in ("mask", "eval_cache"):
                if want[f] is not None:
                    assert _eq(mine[f], want[f]), (r, f)
        # the store held the rank's block, and its counters moved
        assert rank["stats"]["mem_store_hits"] + \
            rank["stats"]["mem_store_misses"] > 0
        if CASES[name]["mode"] == "disk":
            assert rank["stats"]["mem_store_disk_bytes"] > 0
    if name == FINALIZE:
        for rank in ranks:
            assert _eq(rank["final"], off["final"])
            assert _eq(rank["final_rows"],
                       _block(off["final_rows"], rank["lo"], rank["hi"]))
    for rank in ranks[1:]:  # the replicated fields alike on every rank
        assert _eq(rank["states"][-1], ranks[0]["states"][-1])


@pytest.mark.parametrize("name", NAMES)
def test_mesh_store_fused_blocks_are_the_eager_rounds(mesh_runs, name):
    d = mesh_runs["d"]
    for rank in mesh_runs["own"][name]:
        for i, blk in enumerate(rank["fused"]):
            end = BLOCK * (i + 1)
            assert _eq(blk, rank["states"][end]), i
            assert _eq(rank["fused_rows"][i], rank["rows"][end]), i
            for k, series in rank["ys"][i].items():
                assert list(series) == [float(m[k]) for m in
                                        rank["mets"][end - BLOCK:end]], k
        assert _eq(rank["fused_eval"], rank["evals"][-1])
        assert rank["width"] == min(BLOCK * 4, 8 // d)


def _store_file(directory, step):
    (lineage,) = os.listdir(directory)
    path = os.path.join(directory, lineage)
    with np.load(os.path.join(path, f"store_{step}.npz")) as z:
        snap = {k: z[k] for k in z.files}
    state = torch.load(os.path.join(path, str(step), "state.pt"),
                       weights_only=True)["fields"]
    return snap, state


def test_mesh_store_step_holds_the_single_process_files(ckpt, written,
                                                        tmp_path):
    """The D = 2 step against the single process's: the sidecar's keys,
    ids and rows bit for bit, the state file's fields, the global model
    within 1e-6 (round 0's reduce reassociates across the ranks)."""
    one = str(tmp_path / "one")
    mw.store_ckpt_case(None, CKPT_CASE, str(tmp_path / "rows"), one,
                       resume=False)
    mesh_snap, mesh_state = _store_file(
        str(ckpt["root"] / "mesh_eager"), STEP)
    one_snap, one_state = _store_file(one, STEP)
    assert sorted(mesh_snap) == sorted(one_snap)
    for k, v in one_snap.items():
        assert mesh_snap[k].dtype == v.dtype, k
        assert np.array_equal(mesh_snap[k], v), k
    assert one_snap["personal_params::ids"].size > 0
    assert sorted(mesh_state) == sorted(one_state)
    for f in ("personal_params", "agg_residual"):
        assert mesh_state[f] is None and one_state[f] is None
    g = {k: v.numpy() for k, v in mesh_state["global_params"].items()}
    assert _rel(g, {k: v.numpy() for k, v in
                    one_state["global_params"].items()}) <= 1e-6
    assert len(written[0]) == 2


@pytest.mark.parametrize("loop", ["eager", "fused"])
def test_mesh_store_resume_is_bitwise_its_uninterrupted_twin(written, loop):
    for rank in written[0 if loop == "eager" else 1]:
        res = rank["resumed"]
        assert (res["lo"], res["hi"]) == (rank["lo"], rank["hi"])
        assert _eq(res["restored"], rank["saved"])
        assert _eq(res["restored_rows"], rank["saved_rows"])
        assert _eq(res["mets"], rank["mets"][-len(res["mets"]):])
        assert _eq(res["end"], rank["end"])
        assert _eq(res["end_rows"], rank["end_rows"])


def test_mesh_store_step_resumes_at_any_width(mesh_runs, ckpt, written,
                                              tmp_path):
    """The D = 2 step resumed by this mesh's ranks (D = 4) or by one
    process (D = 2's turn): the restored state and rows bitwise, the next
    round's rows and metrics bitwise the uninterrupted D = 2 run's, its
    global model within 1e-6 (the reduce reassociates at another
    width)."""
    twin = written[0]
    if mesh_runs["d"] == 2:
        resumed = [mw.store_resume_case(
            None, CKPT_CASE, str(tmp_path / "rows"),
            str(ckpt["root"] / "mesh_eager"), STEP)]
    else:
        resumed = mesh_runs["tail"][0]
    assert len(resumed) == {2: 1, 4: 4}[mesh_runs["d"]]
    saved = mw._whole_rows(twin, which="saved_rows")
    end = mw._whole_rows(twin, which="end_rows")
    for rank in resumed:
        lo, hi = rank["lo"], rank["hi"]
        assert _eq(rank["restored"], twin[0]["saved"])
        assert _eq(rank["restored_rows"], _block(saved, lo, hi))
        assert _eq(rank["mets"], twin[0]["mets"][STEP:])
        assert _eq(rank["end_rows"], _block(end, lo, hi))
        assert _rel(rank["end"]["global_params"],
                    twin[0]["end"]["global_params"]) <= 1e-6


def test_mesh_store_watchdog_rolls_back_every_rank(written):
    ranks = written[2]
    logs = [r["log"] for r in ranks]
    assert all(log == logs[0] for log in logs[1:]), logs
    verdicts = [v for _, v, _ in logs[0]]
    assert "retry" in verdicts, verdicts
    # every rollback restored the last saved state and, on every rank,
    # its block's rows from the sidecar (the attempt's staged rows gone)
    for r in ranks:
        assert all(same for _, v, same in r["log"] if v != "ok"), r["log"]
        assert r["totals"] == ranks[0]["totals"]
    assert ranks[0]["totals"]["rounds_retried"] == verdicts.count("retry")


def test_mesh_resident_robust_int8_with_an_empty_rank(mesh_runs):
    """The resident mesh round under ``robust_agg`` on the int8 wire where
    a rank holds none of the sampled clients (each of 4 rounds at D = 4
    has one): bitwise the single-process replay (at D = 2 the same case
    through the store)."""
    if mesh_runs["d"] == 2:
        ranks = mesh_runs["own"]["fedavg_median_int8_host"]
        assert any(not set(range(r["lo"], r["hi"])) & set(
            jsample(k, 8, 4).tolist()) for r in ranks for k in range(ROUNDS))
        return
    ranks = mesh_runs["tail"][1]
    assert any(not set(range(r["lo"], r["hi"])) & set(
        jsample(k, 8, 4).tolist()) for r in ranks for k in range(ROUNDS))
    off = mw.replay_robust(RESIDENT_INT8, ranks, ROUNDS)
    for rank in ranks:
        for r in range(ROUNDS):
            assert _eq(rank["states"][r + 1]["global_params"],
                       off["states"][r]["global_params"]), r
            assert _eq(rank["mets"][r], off["mets"][r]), r


def test_make_mesh_without_a_device_raises_without_cuda(tmp_path,
                                                       monkeypatch):
    """No ``device`` where CUDA is absent: ``RuntimeError`` naming CUDA and
    ``device='cpu'``, before any group is joined (the rendezvous file is
    never made)."""
    import torch.distributed as dist

    from neuroimagedisttraining_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rv = tmp_path / "rendezvous"
    with pytest.raises(RuntimeError, match="CUDA is not available; pass "
                       "device='cpu'"):
        make_mesh(1, rank=0, init_method="file://" + str(rv))
    assert not dist.is_initialized()
    assert not rv.exists()


# -------------------------------------------------------- against the JAX


N_X = 4  # the smallest count of the cohort two ranks divide


def _jax_streamed():
    """The JAX package's streamed SalientGrads on its own 2-device CPU
    mesh: its parameters and mask in the port's layout, per round the
    seams of its draws, its metrics, rows and eval."""
    jm, _ = pc.models()
    jd = jsynth(seed=4, n_clients=N_X, samples_per_client=pc.SAMPLES,
                test_per_client=pc.TEST, sample_shape=pc.SS, uneven=True)
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    spe = -(-max(nvals) // pc.BS)
    ja = JSalientGrads(jm, jd, pc.hp(JHyperParams, spe), loss_type="bce",
                       frac=0.5, seed=0, dense_ratio=0.5,
                       itersnip_iterations=1, fused_kernels=True,
                       agg_kernels="pallas", client_store="host",
                       store_hot_clients=2)
    ja.data = shard_federated_hybrid(ja.data, jmake_mesh(2))
    js = ja.init_state(jax.random.PRNGKey(0))
    init = dict(params={k: v.numpy() for k, v in pc.jax_params_to_torch(
        pc.np_tree(js.global_params)).items()},
        mask={k: v.numpy() for k, v in pc.jax_params_to_torch(
            pc.np_tree(js.mask)).items()})
    rng, seams, mets = js.rng, [], []
    n_rows = jd.x_train.shape[1]
    for r in range(2):
        sel = jsample(r, N_X, 2)
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, len(sel) + 1)
        seams.append(dict(perms=[np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(nvals[int(s)]), 1,
            spe * pc.BS, n_rows=n_rows)) for i, s in enumerate(sel)]))
        js, met = ja.run_round(js, r)
        mets.append({k: float(v) for k, v in met.items()})
    ja.store_flush()
    return dict(init=init, seams=seams, mets=mets,
                global_params=js.global_params,
                rows=ja._store.gather_all("personal_params"),
                eval={k: np.asarray(v) for k, v in ja.evaluate(js).items()})


def test_mesh_store_matches_the_reference_streamed(eight_devices, tmp_path):
    """The port's D = 2 streamed SalientGrads against the JAX package's
    streamed run on its 2-device mesh (see the module docstring)."""
    want = _jax_streamed()
    case = dict(algo="salientgrads", mode="host", impl="dense",
                model="3dcnn_s2d", widths=list(pc.WIDTHS),
                sample_shape=list(pc.SS), n_clients=N_X,
                samples=pc.SAMPLES, test=pc.TEST, batch=pc.BS)
    ranks = mw.run_ranks(2, [("store_case", dict(
        case=case, root=str(tmp_path), rounds=2, seams=want["seams"],
        init=want["init"], fused=False))], timeout=SPAWN_TIMEOUT_S)[0]
    for rank in ranks:
        for r in range(2):
            np.testing.assert_allclose(float(rank["mets"][r]["train_loss"]),
                                       want["mets"][r]["train_loss"],
                                       rtol=1e-5)
        pc.compare(mw._tensors(rank["states"][-1]["global_params"]),
                   want["global_params"], "dense")
        ev = rank["evals"][-1]
        assert sorted(ev) == sorted(k for k in want["eval"]
                                    if not k.startswith("acc_per"))
        for k, v in ev.items():
            np.testing.assert_allclose(float(v), float(want["eval"][k]),
                                       rtol=2e-5, err_msg=k)
    rows = mw._whole_rows(ranks, -1)["personal_params"]
    for c in range(N_X):  # each client's stored row
        pc.compare(mw._tensors({k: v[c] for k, v in rows.items()}),
                   jax.tree_util.tree_map(lambda a, c=c: a[c], want["rows"]),
                   "dense", leaf_scale=True)
