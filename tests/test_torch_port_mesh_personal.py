"""The seven algorithms besides SalientGrads and FedAvg on the port's client
mesh, on the CPU: Local, Ditto, SubAvg, DPSGD, DisPFL, FedFomo and
TurboAggregate, gloo ranks (``tests/_torch_mesh_workers.py``) at D = 2 and
4, ``small3dcnn``, 8 clients, 2 rounds; data seed 4, but DPSGD and the
uniform-mask DisPFL seed 5 (``tests/test_torch_port_personal.py`` says
why). At ``frac`` 0.5 the sampled algorithms draw 4 clients a round, so at
D = 4 a rank may hold none of them.

* Against the port off the mesh: each mesh round replayed by one process
  from the mesh's state before it (the generator in step). Every client's
  row (the personal models, DisPFL's and SubAvg's masks, FedFomo's
  ``p_choose``), the metrics and the eval bitwise; the global model bitwise
  where every rank reduces the gathered rows (SubAvg, TurboAggregate),
  within 1e-6 of its scale where the sum is split by rank (Ditto's on-mesh
  weighted mean).
* The fused mesh block of Local, Ditto, SubAvg, DPSGD and DisPFL (the body
  uncaptured over gloo), the eval every round, bitwise its eager mesh
  rounds.
* A DisPFL and a FedFomo checkpoint (the masks, ``p_choose``'s rows)
  written by the two ranks, resumed at width 1 (one process) and at width
  4: the restored rows and two more rounds bitwise the uninterrupted
  run's.
* Against the JAX package on its own client mesh (``shard_federated_
  hybrid(data, make_mesh(2))``: two of the eight virtual CPU devices), fed
  its parameters, masks and draws at the seams (each leg's epoch
  permutations, DisPFL's screening rows). One reference run per algorithm
  serves both widths: the D = 4 mesh is held to the same 2-device run (a
  run per width would compile each algorithm's round once more for a
  result that differs by round-off only). The tolerances of the
  single-process tests:
  train losses within rtol 1e-5, the models per leaf within rtol 1e-5
  (atol 1e-5 of the leaf's largest value), masks and the mask change
  bitwise, accuracies bitwise and eval losses within 2e-5; TurboAggregate's
  global model within rtol 1e-5 once whole quanta (2^-16, at most one a
  sampled client) are taken off; FedFomo's ``p_choose`` increments within
  the error their validation losses carry (``tests/
  test_torch_port_fedfomo.py``) and the round's neighbor choice bitwise.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402
from neuroimagedisttraining_tpu import algorithms as jalgos  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from neuroimagedisttraining_tpu.parallel.mesh import shard_federated_hybrid  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402

ROUNDS = 2
N = 8
#: the personal cases (see ``_torch_mesh_workers.build_personal_algo``):
#: SubAvg over two epochs (its second leg) and Ditto's personal leg over
#: two; DisPFL with uniform per-client masks, half its clients active, its
#: screening gradients
CASES = {
    "local": dict(algo="local", data_seed=4, frac=0.5),
    "ditto": dict(algo="ditto", data_seed=4, frac=0.5, personal_epochs=2,
                  opts=dict(lamda=0.5)),
    "subavg": dict(algo="subavg", data_seed=4, frac=0.5, epochs=2,
                   opts=dict(acc_thresh=0.4)),
    "dpsgd": dict(algo="dpsgd", data_seed=5, frac=0.5,
                  opts=dict(neighbor_mode="random")),
    "dispfl": dict(algo="dispfl", data_seed=5, frac=0.5,
                   opts=dict(sparsity_distribution="uniform", active=0.5,
                             different_initial=True, total_rounds=4)),
    "fedfomo": dict(algo="fedfomo", data_seed=4, frac=0.5, val=3),
    "turboaggregate": dict(algo="turboaggregate", data_seed=4, frac=0.5),
}
NAMES = list(CASES)
#: the algorithms with a fused loop
FUSED = ("local", "ditto", "subavg", "dpsgd", "dispfl")
#: the reference's classes
J_CLASSES = {"local": "LocalOnly", "ditto": "Ditto", "subavg": "SubAvg",
             "dpsgd": "DPSGD", "dispfl": "DisPFL", "fedfomo": "FedFomo",
             "turboaggregate": "TurboAggregate"}
#: the algorithms that train every client each round
WHOLE = ("dpsgd", "dispfl", "fedfomo")
#: the algorithms whose checkpoint is written at width 2 and resumed
CKPT = ("dispfl", "fedfomo")
CKPT_STEP, CKPT_ROUNDS = 2, 4
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The off-mesh side on one thread, as each rank runs (CPU convolutions
    sum in an order that follows the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stack(j_stacked):
    """A reference ``[C, ...]`` stack as the port's stacked tree (numpy)."""
    rows = [jax_params_to_torch(_np(jax.tree_util.tree_map(
        lambda a, c=c: a[c], j_stacked))) for c in range(N)]
    return {k: np.stack([r[k].numpy() for r in rows]) for k in rows[0]}


def _perms(keys, sel, c, epochs=1):
    return [np.array(epoch_permutations(
        jax.random.split(keys[i])[0], jnp.int32(c["nvals"][int(s)]), epochs,
        c["spe"] * 4, n_rows=c["n_rows"])) for i, s in enumerate(sel)]


def _jax_draws(name, rng, sel, c):
    """The reference's draws of one round from its state key: the next key
    and the port's seams."""
    s = len(sel)
    if name == "ditto":
        rng, k_global, k_personal = jax.random.split(rng, 3)
        return rng, dict(
            perms=_perms(jax.random.split(k_global, s + 1), sel, c),
            perms_2=_perms(jax.random.split(k_personal, s), sel, c,
                           epochs=CASES[name]["personal_epochs"]))
    if name == "dispfl":
        rng, k_train, k_screen = jax.random.split(rng, 3)
        skeys = jax.random.split(k_screen, N)
        return rng, dict(
            perms=_perms(jax.random.split(k_train, N), sel, c),
            screen_idx=[np.array(jax.random.randint(
                jax.random.split(skeys[i])[0], (4,), 0, max(n, 1)))
                for i, n in enumerate(c["nvals"])])
    rng, round_key = jax.random.split(rng)
    keys = jax.random.split(round_key, s)
    seams = dict(perms=_perms(keys, sel, c))
    if name == "subavg":  # the later epochs' leg
        seams["perms_2"] = _perms([jax.random.fold_in(k, 1) for k in keys],
                                  sel, c, epochs=CASES[name]["epochs"] - 1)
    return rng, seams


def _jax_run(name):
    """The reference's run of a case on its 2-device mesh: its initial
    parameters
    (and DisPFL's masks) in the port's layout, per round the seams of its
    draws, and its state, metrics and eval after each round."""
    case = CASES[name]
    jd = jsynth(seed=case["data_seed"], n_clients=N, samples_per_client=8,
                test_per_client=4, val_per_client=case.get("val", 0),
                sample_shape=(8, 8, 8, 1))
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    c = dict(nvals=nvals, spe=-(-max(nvals) // 4), n_rows=jd.x_train.shape[1])
    hp = JHyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                      weight_decay=5e-4, grad_clip=10.0,
                      local_epochs=case.get("epochs", 1),
                      steps_per_epoch=c["spe"], batch_size=4)
    kw = dict(loss_type="bce", frac=case["frac"], seed=0,
              **case.get("opts", {}))
    if name == "ditto":
        kw["personal_hp"] = hp.replace(local_epochs=case["personal_epochs"])
    model = jcreate("small3dcnn", num_classes=1)
    ja = getattr(jalgos, J_CLASSES[name])(model, jd, hp, **kw)
    ja.data = shard_federated_hybrid(ja.data, jmake_mesh(2))
    key = jax.random.PRNGKey(0)
    state = ja.init_state(key)
    init = {}
    if name == "dispfl":
        init["params"] = jax_params_to_torch(_np(jinit(
            model, jax.random.split(key, 3)[0], ja.init_sample_shape)))
        init["masks"] = _stack(state.masks)
    elif hasattr(state, "global_params"):
        init["params"] = jax_params_to_torch(_np(state.global_params))
    else:
        init["params"] = {k: torch.from_numpy(v[0]) for k, v in
                          _stack(state.personal_params).items()}
    init["params"] = {k: v.numpy() for k, v in init["params"].items()}
    rng, seams, rounds = state.rng, [], []
    for r in range(ROUNDS):
        sel = (np.arange(N) if name in WHOLE
               else ja._selected_client_indexes(r))
        rng, seam = _jax_draws(name, rng, sel, c)
        seams.append(seam)
        p_before = (np.asarray(state.p_choose, np.float64)
                    if name == "fedfomo" else None)
        state, met = ja.run_round(state, r)
        ev = ja.evaluate(state)
        rounds.append(dict(
            mets={k: float(v) for k, v in met.items()},
            evals={k: np.asarray(v) for k, v in ev.items()},
            fields={f: (_stack(getattr(state, f)) if f != "p_choose"
                        else np.asarray(getattr(state, f), np.float64))
                    for f in ("personal_params", "masks", "p_choose")
                    if hasattr(state, f)},
            global_params=(jax_params_to_torch(_np(state.global_params))
                           if hasattr(state, "global_params") else None),
            p_before=p_before))
    return dict(init=init, seams=seams, rounds=rounds)


@pytest.fixture(scope="module")
def jruns(eight_devices):
    return {name: _jax_run(name) for name in NAMES}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The lineages of CKPT the two ranks write (the D = 2 spawn), which
    the D = 4 spawn and one process resume."""
    return dict(dirs={n: str(tmp_path_factory.mktemp(f"ck_{n}"))
                      for n in CKPT}, written=None)


def _ckpt_writes(ckpt):
    return [("personal_ckpt_case", dict(
        case=CASES[n], directory=ckpt["dirs"][n], rounds=CKPT_ROUNDS,
        save_after=CKPT_STEP)) for n in CKPT]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def mesh_runs(request, jruns, ckpt):
    """Every case of a D-rank mesh in one spawn: each algorithm on the
    port's own draws (eager, and fused where it fuses) and on the
    reference's; at D = 2 the checkpoints written, at D = 4 resumed."""
    d = request.param
    if d != 2 and ckpt["written"] is None:  # run alone: write them first
        ckpt["written"] = dict(zip(CKPT, mw.run_ranks(
            2, _ckpt_writes(ckpt), timeout=SPAWN_TIMEOUT_S)))
    cases = [("personal_case", dict(case=CASES[n], fused=n in FUSED))
             for n in NAMES]
    cases += [("personal_case", dict(
        case=CASES[n], seams=jruns[n]["seams"], init=jruns[n]["init"],
        record=n == "fedfomo")) for n in NAMES]
    cases += _ckpt_writes(ckpt) if d == 2 else [
        ("personal_resume_case", dict(case=CASES[n],
                                      directory=ckpt["dirs"][n],
                                      step=CKPT_STEP, rounds=CKPT_ROUNDS))
        for n in CKPT]
    got = mw.run_ranks(d, cases, timeout=SPAWN_TIMEOUT_S)
    k = len(NAMES)
    tail = dict(zip(CKPT, got[2 * k:]))
    if d == 2:
        ckpt["written"] = tail
    return dict(d=d, own=dict(zip(NAMES, got[:k])),
                ref=dict(zip(NAMES, got[k:2 * k])), ckpt=tail)


def _eq(a, b):
    """Bitwise equal numpy arrays, or dicts of them (nested)."""
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in b)
    return np.array_equal(a, b)


def _rows(v, lo, hi):
    return ({k: x[lo:hi] for k, x in v.items()} if isinstance(v, dict)
            else v[lo:hi])


def _rel(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b) / \
        max(float(np.max(np.abs(v))) for v in b.values())


@pytest.mark.parametrize("name", NAMES)
def test_mesh_round_is_the_single_process_round(mesh_runs, name):
    ranks = mesh_runs["own"][name]
    off = mw.replay_personal(CASES[name], ranks, ROUNDS)
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        for r in range(ROUNDS):
            mine, want = rank["states"][r + 1], off["states"][r]
            assert mine.keys() == want.keys()
            for f, v in want.items():
                if f in off["row_fields"]:
                    assert _eq(mine[f], _rows(v, lo, hi)), (f, r)
                elif name == "ditto":  # the on-mesh weighted mean
                    assert _rel(mine[f], v) <= 1e-6, (f, r, _rel(mine[f], v))
                else:
                    assert _eq(mine[f], v), (f, r)
            assert _eq(rank["mets"][r], off["mets"][r]), r
            assert _eq(rank["evals"][r], off["evals"][r]), r
    for rank in ranks[1:]:  # the replicated fields alike on every rank
        for f, v in ranks[0]["states"][-1].items():
            if f not in off["row_fields"]:
                assert _eq(rank["states"][-1][f], v), f
    if name in ("subavg", "dispfl"):  # the masks moved
        assert any(not _eq(r["states"][-1]["masks"], r["states"][0]["masks"])
                   for r in ranks)
    if name == "fedfomo":  # some neighbor weighed in
        assert any((r["states"][-1]["p_choose"] != 1).any() for r in ranks)


@pytest.mark.parametrize("name", FUSED)
def test_mesh_fused_block_is_its_eager_rounds(mesh_runs, name):
    for rank in mesh_runs["own"][name]:
        assert _eq(rank["fused"], rank["states"][-1])
        for k, series in rank["ys"].items():
            assert list(series) == [float(m[k]) for m in rank["mets"]], k
        for k, series in rank["ys_eval"].items():
            assert list(series) == [float(e[k]) for e in rank["evals"]], k


def _leaf_close(got, want, what):
    for k, v in want.items():
        atol = max(2e-7, 1e-5 * float(np.max(np.abs(v))))
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=atol,
                                   err_msg=f"{what} {k}")


def _turbo_close(got, want, clients, what):
    """The difference less its whole quanta (at most one a sampled
    client) within rtol 1e-5 (atol 2e-7)."""
    quantum = 2.0 ** -16
    for k, v in want.items():
        want_k = v.double().numpy()
        d = got[k].astype(np.float64) - want_k
        steps = np.round(d / quantum)
        assert np.abs(steps).max() <= clients, (what, k)
        assert (np.abs(d - steps * quantum)
                <= 2e-7 + 1e-5 * np.abs(want_k)).all(), (what, k)


def _fomo_bound(lstrd, trained, vals, nei):
    """Each visit's weight recomputed in float64 from the port's own terms
    (its validation losses in call order, self first) and its
    cross-framework error bound (``tests/test_torch_port_fedfomo.py``):
    both as ``[C, C]`` increments."""
    want, err = np.zeros((N, N)), np.zeros((N, N))
    for i in range(N):
        s = vals[i][0]
        for t, j in enumerate(nei[i]):
            model = trained if j == i else lstrd
            nrm = np.sqrt(sum(float(((model[k][j].astype(np.float64)
                                      - lstrd[k][i]) ** 2).sum())
                              for k in lstrd))
            lj = vals[i][1 + t]
            if nrm > 0:
                want[i, j] += (s - lj) / nrm
                err[i, j] += 2e-5 * (abs(s) + abs(lj)) / nrm
    return want, err


def _check_fomo(ranks, run, r):
    """Round ``r``'s ``p_choose`` of the mesh fed the reference's draws:
    its neighbor choice the reference's, its increments the weights of
    its own terms (rtol 1e-5) and the reference's within their bound."""
    algo = mw.build_personal_algo(CASES["fedfomo"])
    before = np.concatenate([x["states"][r]["p_choose"] for x in ranks])
    after = np.concatenate([x["states"][r + 1]["p_choose"] for x in ranks])
    nei = algo._choose_neighbors(r, before.astype(np.float32))
    if r:  # the reference chose from its own p_choose
        np.testing.assert_array_equal(nei, algo._choose_neighbors(
            r, run["rounds"][r]["p_before"].astype(np.float32)))
    lstrd = {k: np.concatenate([x["states"][r]["personal_params"][k]
                                for x in ranks]) for k in
             ranks[0]["states"][r]["personal_params"]}
    trained = {k: np.concatenate([x["trained"][r][k] for x in ranks])
               for k in lstrd}
    vals = [v for x in ranks for v in
            np.asarray(x["vals"][r]).reshape(x["hi"] - x["lo"], -1)]
    want, err = _fomo_bound(lstrd, trained, vals, nei)
    upd = after.astype(np.float64) - before
    np.testing.assert_allclose(upd, want, rtol=1e-5, atol=1e-6)
    j_upd = run["rounds"][r]["fields"]["p_choose"] - \
        run["rounds"][r]["p_before"]
    assert (np.abs(upd - j_upd) <= err + 1e-5 * np.abs(j_upd)
            + 1e-7).all(), (r, np.abs(upd - j_upd).max())


@pytest.mark.parametrize("name", NAMES)
def test_mesh_round_matches_reference(mesh_runs, jruns, name):
    """The mesh fed the reference's parameters, masks and draws, against
    the reference's single-device rounds (see the module docstring)."""
    run, ranks = jruns[name], mesh_runs["ref"][name]
    for rank in ranks:
        lo, hi = rank["lo"], rank["hi"]
        for r in range(ROUNDS):
            want, mine = run["rounds"][r], rank["states"][r + 1]
            met = rank["mets"][r]
            assert sorted(met) == sorted(want["mets"])
            for k, v in want["mets"].items():
                if k == "mask_change" or k.endswith("_acc"):
                    assert float(met[k]) == v, (r, k)
                else:
                    np.testing.assert_allclose(
                        float(met[k]), v, rtol=2e-5 if "test" in k else 1e-5,
                        err_msg=f"{name} round {r} {k}")
            if "personal_params" in want["fields"]:
                _leaf_close(mine["personal_params"], _rows(
                    want["fields"]["personal_params"], lo, hi), r)
            if "masks" in want["fields"]:
                assert _eq(mine["masks"],
                           _rows(want["fields"]["masks"], lo, hi)), r
            if name == "turboaggregate":
                _turbo_close(mine["global_params"], want["global_params"],
                             4, r)
            elif want["global_params"] is not None:
                _leaf_close(mine["global_params"], {
                    k: v.numpy() for k, v in want["global_params"].items()},
                    r)
            ev, jev = rank["evals"][r], want["evals"]
            assert sorted(ev) == sorted(k for k in jev
                                        if not k.startswith("acc_per"))
            for k, v in ev.items():
                if k == "mean_mask_density":
                    assert float(v) == float(jev[k]), (r, k)
                else:
                    np.testing.assert_allclose(float(v), float(jev[k]),
                                               rtol=2e-5, err_msg=k)
    if name == "fedfomo":
        for r in range(ROUNDS):
            _check_fomo(ranks, run, r)


@pytest.mark.parametrize("name", CKPT)
def test_mesh_checkpoint_resumes_at_any_width(mesh_runs, ckpt, name):
    """The step the two ranks wrote: resumed by this mesh's ranks (D = 4)
    or by one process (D = 2's turn), the restored rows and the rounds
    after it bitwise the uninterrupted run's."""
    written = ckpt["written"][name]
    if mesh_runs["d"] == 2:
        resumed = [mw.personal_resume_case(None, CASES[name],
                                           ckpt["dirs"][name], CKPT_STEP,
                                           CKPT_ROUNDS)]
    else:
        resumed = mesh_runs["ckpt"][name]
    for part in ("saved", "end"):
        whole = mw._join_fields(
            mw.build_personal_algo(CASES[name]),
            [dict(states={0: w[part]}) for w in written], 0)
        for rank in resumed:
            got = rank["restored" if part == "saved" else "end"]
            for f, v in whole.items():
                assert _eq(got[f], _rows(v, rank["lo"], rank["hi"])), \
                    (part, f)
