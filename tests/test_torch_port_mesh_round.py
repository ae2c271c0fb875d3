"""SalientGrads and FedAvg rounds on the port's client mesh, on the CPU:
gloo ranks (``tests/_torch_mesh_workers.py``) at D = 2 and 4, ``small3dcnn``,
8 clients, 2 rounds (data seed 4 for SalientGrads, 9 for FedAvg, as the
round tests of ``tests/test_torch_port_round.py`` use).

* Against the port off the mesh: each mesh round is replayed off the mesh
  from the mesh's own state before it (the generator in step: both draw the
  same), and each eval of the mesh's state after it. The SNIP mask, every
  trained client's model (and top-k residual row), the train loss and the
  eval are bitwise; the global model, whose cross-rank sum reassociates, is
  within 1e-6 of the tree's largest value (bitwise where the selection does
  not divide over the mesh and every rank reduces all rows off it; the
  low-precision wires, which quantize each rank's partial rather than each
  client's row, within their precision).
* Against the JAX package on its own mesh (``shard_federated_hybrid(data,
  make_mesh(D))``), fed its parameters, mask and epoch permutations: the
  tolerances of ``tests/test_torch_port_round.py`` (rtol 1e-5, atol 2e-7
  after two rounds), full participation and ``frac`` 0.5 (S = 4) and 0.375
  (S = 3, the off-mesh fallback).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402
import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.algorithms.base import \
    sample_client_indexes as jsample  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from neuroimagedisttraining_tpu.parallel.mesh import shard_federated_hybrid  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402

ROUNDS = 2
SEEDS = {"salientgrads": 4, "fedavg": 9}
#: (algorithm, frac, agg_impl, build options) held against the port off
#: the mesh
OFF = [
    ("salientgrads", 1.0, "dense", {}),
    ("salientgrads", 1.0, "bf16", {}),
    ("salientgrads", 1.0, "int8", {}),
    ("salientgrads", 1.0, "hier", {}),
    ("salientgrads", 1.0, "sparse", {}),
    ("salientgrads", 1.0, "topk", {}),
    # dropout: the ranks make the other clients' SNIP and training draws
    ("salientgrads", 1.0, "dense", {"dropout": 0.5}),
    ("salientgrads", 0.5, "dense", {}),
    ("salientgrads", 0.375, "dense", {}),
    ("fedavg", 1.0, "dense", {}),
    ("fedavg", 0.5, "topk", {}),
    ("fedavg", 0.375, "int8", {}),
]
#: per mesh width, the (algorithm, frac) held against the JAX package on its
#: mesh: both algorithms at full participation on 2 ranks, partial
#: participation on 4 (S = 4 reduced on the mesh, S = 3 off it)
JAX = {2: [("salientgrads", 1.0), ("fedavg", 1.0)],
       4: [("salientgrads", 0.5), ("salientgrads", 0.375)]}
#: the global model's bound against the off-mesh replay, of the tree's
#: largest value, for a wire that quantizes each rank's partial on the mesh
LOW_PRECISION = {"bf16": 1e-2, "int8": 5e-2}


def _off_id(cfg):
    algo, frac, impl, build = cfg
    return f"{algo}-{frac}-{impl}" + ("-dropout" if build else "")


def _jax_run(algo, frac, d):
    """The reference on its ``d``-device mesh: its initial parameters and
    mask, per round its epoch permutations (per selected client), and its
    state and metrics after the rounds."""
    seed = SEEDS[algo]
    jd = jsynth(seed=seed, n_clients=8, samples_per_client=8,
                test_per_client=4, sample_shape=(8, 8, 8, 1))
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    spe = -(-max(nvals) // 4)
    hp = JHyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                      weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                      steps_per_epoch=spe, batch_size=4)
    kw = dict(loss_type="bce", frac=frac, seed=0)
    model = jcreate("small3dcnn", num_classes=1)
    ja = (JSalientGrads(model, jd, hp, dense_ratio=0.5, **kw)
          if algo == "salientgrads" else JFedAvg(model, jd, hp, **kw))
    ja.data = shard_federated_hybrid(ja.data, jmake_mesh(d))
    state = ja.init_state(jax.random.PRNGKey(0))
    init = dict(params=pc.np_tree(state.global_params),
                mask=(pc.np_tree(state.mask) if algo == "salientgrads"
                      else None))
    rng, perms, mets = state.rng, [], []
    for r in range(ROUNDS):
        rng, round_key = jax.random.split(rng)
        sel = jsample(r, 8, ja.clients_per_round)
        keys = jax.random.split(round_key, len(sel) + 1)
        perms.append([np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(nvals[c]), 1, spe * 4,
            n_rows=jd.x_train.shape[1])) for i, c in enumerate(sel)])
        state, met = ja.run_round(state, r)
        mets.append(float(met["train_loss"]))
    return dict(init=init, perms=perms, state=state, mets=mets,
                eval=ja.evaluate(state))



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The off-mesh side on one thread, as each rank runs (CPU convolutions sum in an order
    that follows the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def mesh_runs(request, eight_devices):
    """Every case of a D-rank mesh in one spawn: the off-mesh set on the
    port's own draws, the JAX set on the reference's."""
    d = request.param
    jruns = {cfg: _jax_run(*cfg, d) for cfg in JAX[d]}
    cases = [("round_case", dict(algo=a, data_seed=SEEDS[a], frac=f,
                                 agg_impl=i, finalize=(a == "fedavg"),
                                 **b)) for a, f, i, b in OFF]
    for algo, frac in JAX[d]:
        run = jruns[(algo, frac)]
        mask = run["init"]["mask"]
        cases.append(("round_case", dict(
            algo=algo, data_seed=SEEDS[algo], frac=frac, agg_impl="dense",
            perms=run["perms"],
            params={k: v.numpy() for k, v in
                    jax_params_to_torch(run["init"]["params"]).items()},
            mask=None if mask is None else {
                k: v.numpy() for k, v in jax_params_to_torch(mask).items()})))
    cases.append(("eval_terms_case", dict(algo="fedavg", data_seed=9)))
    got = mw.run_ranks(d, cases)
    return d, dict(zip(map(_off_id, OFF), got[:len(OFF)])), jruns, \
        dict(zip(JAX[d], got[len(OFF):-1])), got[-1]


def _eq(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in b)


def _rel(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b) / \
        max(float(np.max(np.abs(v))) for v in b.values())


@pytest.mark.parametrize("cfg", OFF, ids=[_off_id(c) for c in OFF])
def test_mesh_round_is_the_off_mesh_round(mesh_runs, cfg):
    d, off_runs, _, _, _ = mesh_runs
    ranks = off_runs[_off_id(cfg)]
    algo, frac, impl, build = cfg
    a = mw.build_round_algo(algo, SEEDS[algo], frac, impl, **build)
    off = mw.replay_off_mesh(a, ranks, ROUNDS, finalize=(algo == "fedavg"))
    s = a.clients_per_round
    fallback = s % d != 0  # every rank reduces all rows off the mesh
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        assert (lo, hi) == (rank["lo"], lo + 8 // d)
        if algo == "salientgrads":
            assert _eq(rank["mask"], off["mask"])
        for r in range(ROUNDS):
            mine = rank["states"][r + 1]
            for field in ("personal", "residual"):
                if off["states"][r][field] is not None:
                    assert _eq(mine[field], {
                        k: v[lo:hi] for k, v in
                        off["states"][r][field].items()}), (field, r)
            assert _eq(rank["mets"][r], off["mets"][r]), r
            assert _eq(rank["evals"][r], off["evals"][r]), r
            g, want = mine["global_params"], off["states"][r]["global_params"]
            wire = impl if impl in LOW_PRECISION else (
                "bf16" if impl == "hier" and d > 2 else None)
            if fallback:
                assert _eq(g, want), r
            elif wire is not None:
                assert _rel(g, want) < LOW_PRECISION[wire], (r, _rel(g, want))
            else:
                assert _rel(g, want) <= 1e-6, (r, _rel(g, want))
        if algo == "fedavg":
            assert _eq(rank["final"], off["final"])
            assert _eq(rank["final_personal"], {
                k: v[lo:hi] for k, v in off["final_personal"].items()})
    # every rank holds the same global model
    for rank in ranks[1:]:
        assert _eq(rank["states"][-1]["global_params"],
                   ranks[0]["states"][-1]["global_params"])


@pytest.mark.parametrize("which", [0, 1])
def test_mesh_round_matches_reference_mesh(mesh_runs, which):
    """Configuration ``which`` of the mesh width's :data:`JAX` list."""
    d, _, jruns, tranks, _ = mesh_runs
    cfg = JAX[d][which]
    run, ranks = jruns[cfg], tranks[cfg]
    jstate = run["state"]
    for rank in ranks:
        last = rank["states"][-1]
        pc.compare({k: torch.from_numpy(v) for k, v in
                    last["global_params"].items()},
                   jstate.global_params, "dense")
        lo, hi = rank["lo"], rank["hi"]
        for c in range(lo, hi):
            pc.compare({k: torch.from_numpy(v[c - lo]) for k, v in
                        last["personal"].items()},
                       jax.tree_util.tree_map(lambda x: x[c],
                                              jstate.personal_params),
                       "dense")
        for r in range(ROUNDS):
            np.testing.assert_allclose(float(rank["mets"][r]["train_loss"]),
                                       run["mets"][r], rtol=1e-5)
        ev = rank["evals"][-1]
        np.testing.assert_array_equal(ev["acc_per_client"],
                                      np.asarray(run["eval"]["acc_per_client"]))
        for k in ("global_loss", "personal_loss"):
            np.testing.assert_allclose(float(ev[k]),
                                       float(run["eval"][k]), rtol=1e-5)


def test_mesh_eval_terms_are_the_single_process_terms(mesh_runs):
    """The per-client eval sums gathered in client order, bitwise the
    single-process sums."""
    got = mesh_runs[-1]
    a = mw.build_round_algo("fedavg", 9, 1.0, "dense")
    state = a.init_state()
    correct, loss_sum = a._eval_terms(range(8),
                                      lambda c: state.global_params)
    for c_got, l_got in got:
        np.testing.assert_array_equal(c_got, correct.numpy())
        np.testing.assert_array_equal(l_got, loss_sum.numpy())


def test_mesh_refusals_in_the_library():
    """What the mesh round does not run is refused when the algorithm is
    built, and the fused loop when it is called."""
    from neuroimagedisttraining_torch.algorithms import Ditto, FedAvg
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel import mesh as tmesh

    data = tmesh.shard_federated(
        make_synthetic_federated(seed=1, n_clients=4, samples_per_client=4,
                                 test_per_client=2,
                                 sample_shape=(4, 4, 4, 1)),
        tmesh.ClientMesh(None, 0, 2, torch.device("cpu")))
    hp = HyperParams(lr=0.01, local_epochs=1, steps_per_epoch=1,
                     batch_size=2)
    model = create_model("small3dcnn", num_classes=1)
    kw = dict(loss_type="bce", device="cpu")
    for cls, extra, says in (
            (Ditto, {}, "the ditto round"),
            (FedAvg, dict(eval_cache=True), "the eval cache"),
            (FedAvg, dict(eval_clients=2), "eval subset"),
            (FedAvg, dict(fault_spec="nan=0.5"), "faults"),
            (FedAvg, dict(robust_agg="median"), "robust"),
            (FedAvg, dict(client_store="host", frac=0.5), "client store")):
        with pytest.raises(ValueError, match="client mesh") as e:
            cls(model, data, hp, **kw, **extra)
        assert says in str(e.value)
    a = FedAvg(model, data, hp, **kw)
    assert a.num_local_clients == 2 and a.num_clients == 4
    with pytest.raises(ValueError, match="client mesh"):
        a.run_rounds_fused(a.init_state(), 0, 2)
    assert dataclasses.is_dataclass(a.init_state())
