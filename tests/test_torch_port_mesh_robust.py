"""The robustness tier on the port's client mesh, on the CPU: gloo ranks
(``tests/_torch_mesh_workers.py``) at D = 2 and 4, ``small3dcnn``, 8
clients, 2 rounds: faults (drops, NaN, scaling, stragglers, sign flips,
collusion, label flips), the guard's quarantine, the clip and weak-DP
defenses (SalientGrads re-masking after the aggregate) and ``robust_agg``,
in the three cases of ``tests/test_torch_port_robust.py`` and a guarded
``frac`` 0.5 case with the eval cache (S = 4: at D = 4 a rank may hold no
selected client); FedAvg's fine-tune after its case.

* Against the port off the mesh: each mesh round replayed off the mesh
  from the mesh's state before it (the generator in step). The mask, every
  client's trained model (and top-k residual row), the fault counters, the
  train loss and the eval bitwise; the global model bitwise under
  ``robust_agg`` (every rank computes the statistic of the same gathered
  rows), else within 1e-6 of its scale (the on-mesh weighted sum
  reassociates across ranks).
* The fused mesh block (the body uncaptured over gloo) bitwise its eager
  mesh rounds under the faults.
* Against the JAX package's single-device run (its robust round on the
  CPU), fed its parameters' draws at the seams (epoch permutations, fault
  draws, the colluders' direction, the weak-DP noise, the int8 uniforms):
  the tolerances of ``tests/test_torch_port_robust.py`` (rtol 1e-5, atol
  2e-7; int8 norm-wise 1e-4; the train loss rtol 1e-5, int8 1e-4), the
  counters equal.
* A clean guarded mesh round bitwise the unguarded one on the dense, int8
  and top-k wires; a round with no survivor carries the previous global
  model and keeps every personal row.
"""
import numpy as np
import pytest

import jax

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
from neuroimagedisttraining_tpu.robust import aggregation as jagg  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from test_torch_port_robust import (  # noqa: E402
    jax_collude,
    jax_dp_noise,
    jax_fault_draws,
)

ROUNDS = 2
N = 8
#: the robust cases: the three of tests/test_torch_port_robust.py on the
#: mesh's cohort (SalientGrads on data seed 4, FedAvg on 9), and a guarded
#: partial-participation case
CASES = {
    # drops, NaN, scaling, label flips (one survivor in round 0), Krum,
    # the weak-DP defense and its re-mask
    "salientgrads_krum_weak_dp": dict(
        algo="salientgrads", impl="dense", data_seed=4, frac=1.0, seed=11,
        robust="krum", spec="drop=0.3,nan=0.3,scale=0.3:10x,labelflip=0.3",
        defense="weak_dp"),
    # stragglers, collusion, label flips, the median of the int8 wire's
    # decoded deltas, the norm clip; then FedAvg's fine-tune
    "fedavg_int8_median_clip": dict(
        algo="fedavg", impl="int8", data_seed=9, frac=1.0, seed=0,
        robust="median",
        spec="straggle=0.4,signflip=0.3,collude=0.4:5x,labelflip=0.4,"
             "nan=0.2", defense="norm_diff_clipping", finalize=True),
    # top-k under the guard with NaN clients each round
    "salientgrads_topk_nan": dict(
        algo="salientgrads", impl="topk", data_seed=4, frac=1.0, seed=0,
        robust="none", spec="nan=0.34", defense=None),
    # half the cohort a round (S = 4), drops, NaN and scaling under the
    # guard and the clip, with the eval cache
    "salientgrads_frac_guard": dict(
        algo="salientgrads", impl="dense", data_seed=4, frac=0.5, seed=3,
        robust="none", spec="drop=0.25,nan=0.25,scale=0.25:10x",
        defense="norm_diff_clipping", opts=dict(eval_cache=True)),
}
NAMES = sorted(CASES)
#: the clean guarded rounds' wires, and the round with no survivor
CLEAN = ("dense", "int8", "topk")
NO_SURVIVOR = dict(algo="fedavg", impl="dense", data_seed=9, frac=1.0,
                   seed=0, robust="none", spec="nan=1.0", defense=None)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The off-mesh side on one thread, as each rank runs (CPU convolutions
    sum in an order that follows the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(case):
    """The reference's single-device run of ``case``: per round the seams
    of its draws (as numpy), and its state and metrics after the rounds."""
    jd = jsynth(seed=case["data_seed"], n_clients=N, samples_per_client=8,
                test_per_client=4, sample_shape=(8, 8, 8, 1))
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    spe = -(-max(nvals) // 4)
    hp = JHyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                      weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                      steps_per_epoch=spe, batch_size=4)
    kw = dict(loss_type="bce", frac=case["frac"], seed=case["seed"],
              agg_impl=case["impl"], fault_spec=case["spec"],
              robust_agg=case["robust"])
    if case["defense"]:
        kw["defense"] = jagg.RobustAggregator(case["defense"], 5.0, 0.025)
    model = jcreate("small3dcnn", num_classes=1)
    ja = (JSalientGrads(model, jd, hp, dense_ratio=0.5, **kw)
          if case["algo"] == "salientgrads" else JFedAvg(model, jd, hp, **kw))
    state = ja.init_state(jax.random.PRNGKey(0))
    if case["impl"] == "topk":
        state = state.replace(agg_residual=jax.tree_util.tree_map(
            jax.numpy.zeros_like, state.personal_params))
    jparams = pc.np_tree(state.global_params)
    n_params = sum(int(np.prod(v.shape))
                   for v in jax.tree_util.tree_leaves(jparams))
    init = dict(params={k: v.numpy() for k, v in
                        jax_params_to_torch(jparams).items()},
                mask=({k: v.numpy() for k, v in jax_params_to_torch(
                    pc.np_tree(state.mask)).items()}
                      if case["algo"] == "salientgrads" else None))
    rng, seams, mets = state.rng, [], []
    for r in range(ROUNDS):
        rng, round_key = jax.random.split(rng)
        sel = jsample(r, N, ja.clients_per_round)
        s = len(sel)
        keys = jax.random.split(round_key, s + 1)
        seam = dict(
            perms=[np.array(epoch_permutations(
                jax.random.split(keys[i])[0], jax.numpy.int32(nvals[c]), 1,
                spe * 4, n_rows=jd.x_train.shape[1]))
                for i, c in enumerate(sel)],
            faults=jax_fault_draws(case["seed"], r, sel).numpy())
        if case["impl"] == "int8":
            nb, b = tc.bucket_shape(n_params)
            seam["agg_uniforms"] = np.array(jax.random.uniform(
                jax.random.fold_in(round_key, pc.AGG_SALT), (s, nb, b)))
        if "collude" in case["spec"]:
            seam["collude"] = {k: v.numpy() for k, v in jax_params_to_torch(
                jax_collude(case["seed"], r, jparams)).items()}
        if case["defense"] == "weak_dp":
            seam["dp_noise"] = {k: v.numpy() for k, v in jax_dp_noise(
                keys[s], jparams, s).items()}
        seams.append(seam)
        state, met = ja.run_round(state, r)
        mets.append({k: float(v) for k, v in met.items()})
    return dict(init=init, seams=seams, state=state, mets=mets)


@pytest.fixture(scope="module")
def jruns():
    return {name: _jax_run(CASES[name]) for name in NAMES}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def mesh_runs(request, jruns):
    """Every case of a D-rank mesh in one spawn: the robust cases on the
    port's own draws (eager and fused) and on the reference's, the clean
    guarded rounds and the round with no survivor."""
    d = request.param
    cases = [("robust_case", dict(case=CASES[n])) for n in NAMES]
    cases += [("robust_case", dict(
        case=dict(CASES[n], init=jruns[n]["init"]), seams=jruns[n]["seams"],
        fused=False)) for n in NAMES]
    cases += [("clean_guard_case", dict(case=dict(
        CASES["salientgrads_topk_nan"], impl=impl))) for impl in CLEAN]
    cases.append(("robust_case", dict(case=NO_SURVIVOR, rounds=1,
                                      fused=False)))
    got = mw.run_ranks(d, cases, timeout=SPAWN_TIMEOUT_S)
    k = len(NAMES)
    return dict(d=d, own=dict(zip(NAMES, got[:k])),
                ref=dict(zip(NAMES, got[k:2 * k])),
                clean=dict(zip(CLEAN, got[2 * k:2 * k + len(CLEAN)])),
                empty=got[-1])


def _eq(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in b)


def _rel(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b) / \
        max(float(np.max(np.abs(v))) for v in b.values())


@pytest.mark.parametrize("name", NAMES)
def test_mesh_robust_round_is_the_single_process_round(mesh_runs, name):
    case, ranks = CASES[name], mesh_runs["own"][name]
    off = mw.replay_robust(case, ranks, ROUNDS)
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        if off["mask"] is not None:
            assert _eq(rank["mask"], off["mask"])
        for r in range(ROUNDS):
            mine, want = rank["states"][r + 1], off["states"][r]
            for field in ("personal", "residual"):
                if want[field] is not None:
                    assert _eq(mine[field], {k: v[lo:hi] for k, v in
                                             want[field].items()}), (field,
                                                                     r)
            assert _eq(rank["mets"][r], off["mets"][r]), r
            assert _eq(rank["evals"][r], off["evals"][r]), r
            if want["eval_cache"] is not None:
                assert _eq(mine["eval_cache"], want["eval_cache"]), r
            g, gw = mine["global_params"], want["global_params"]
            if case["robust"] != "none":
                assert _eq(g, gw), r
            else:
                assert _rel(g, gw) <= 1e-6, (r, _rel(g, gw))
        if case.get("finalize"):
            assert _eq(rank["final"], off["final"])
            assert _eq(rank["final_personal"], {
                k: v[lo:hi] for k, v in off["final_personal"].items()})
    for rank in ranks[1:]:
        assert _eq(rank["states"][-1]["global_params"],
                   ranks[0]["states"][-1]["global_params"])
    # the counters over all S clients, so the same on every rank
    assert sum(float(m["clients_quarantined"]) + float(m["clients_dropped"])
               for m in ranks[0]["mets"]) > 0


@pytest.mark.parametrize("name", NAMES)
def test_mesh_robust_fused_block_is_its_eager_rounds(mesh_runs, name):
    for rank in mesh_runs["own"][name]:
        eager = rank["states"][-1]
        for field in ("global_params", "personal", "residual",
                      "eval_cache"):
            if eager[field] is not None:
                assert _eq(rank["fused"][field], eager[field]), field
        for k, series in rank["ys"].items():
            assert list(series) == [float(m[k]) for m in rank["mets"]], k


@pytest.mark.parametrize("name", NAMES)
def test_mesh_robust_round_matches_reference(mesh_runs, jruns, name):
    """Against the JAX package's single-device run on its own draws."""
    case, run = CASES[name], jruns[name]
    impl = "int8" if case["impl"] == "int8" else "dense"
    jstate = run["state"]
    for rank in mesh_runs["ref"][name]:
        for r in range(ROUNDS):
            for k in ("clients_dropped", "clients_quarantined"):
                assert float(rank["mets"][r][k]) == run["mets"][r][k], (r, k)
            np.testing.assert_allclose(
                float(rank["mets"][r]["train_loss"]),
                run["mets"][r]["train_loss"],
                rtol=1e-4 if impl == "int8" else 1e-5)
        last = rank["states"][-1]
        pc.compare({k: torch.from_numpy(v) for k, v in
                    last["global_params"].items()},
                   jstate.global_params, impl)
        lo, hi = rank["lo"], rank["hi"]
        for c in range(lo, hi):
            pc.compare({k: torch.from_numpy(v[c - lo]) for k, v in
                        last["personal"].items()},
                       jax.tree_util.tree_map(lambda x, c=c: x[c],
                                              jstate.personal_params), impl)
        if case["algo"] == "salientgrads":
            for k, m in rank["mask"].items():
                assert np.all(last["global_params"][k][m == 0] == 0), k


@pytest.mark.parametrize("impl", CLEAN)
def test_mesh_clean_guarded_round_is_bitwise_unguarded(mesh_runs, impl):
    for rank in mesh_runs["clean"][impl]:
        on, off = rank[True], rank[False]
        assert float(on["mets"]["clients_quarantined"]) == 0.0
        assert float(on["mets"]["train_loss"]) == \
            float(off["mets"]["train_loss"])
        for field in ("global_params", "personal", "residual"):
            assert (on["state"][field] is None) == \
                (off["state"][field] is None)
            if on["state"][field] is not None:
                assert _eq(on["state"][field], off["state"][field]), field


def test_mesh_round_with_no_survivor_carries_the_global(mesh_runs):
    """Every client poisoned: the previous global model carries bit for
    bit on every rank, and every rank keeps its personal rows."""
    for rank in mesh_runs["empty"]:
        before, after = rank["states"]
        assert float(rank["mets"][0]["clients_quarantined"]) == N
        assert _eq(after["global_params"], before["global_params"])
        assert _eq(after["personal"], before["personal"])
