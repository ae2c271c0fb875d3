"""The port's FedFomo against the JAX package's, on the CPU.

* The neighbor choice (``_choose_neighbors``, host numpy and Python's
  ``random``) bitwise the reference's on the same float32 ``p_choose``:
  the all-ones matrix of round 0, whose ``np.argsort`` sees nothing but
  ties, and perturbed ones (negative entries, exact ties), over rounds and
  neighbor counts.
* Two rounds on ``tests/_torch_port_cohort.py``'s narrow model (3
  clients, 5 training and 3 validation rows each, 2 neighbors a client),
  the port fed the reference's epoch permutations: train losses within
  rtol 1e-5; the personal models per leaf within rtol 1e-5 (atol 1e-5 of
  the leaf's largest value); the eval's accuracies bitwise and losses
  within 2e-5. ``p_choose``: its increments equal the weights recomputed
  from the port's own terms, and agree with the reference's within the
  error the validation losses carry across the frameworks (a weight is a
  difference of two losses over a norm, so it keeps their absolute error,
  up to 7e-5 of a weight here, not their relative one); untouched where no
  neighbor was visited.
* Seeds. A neighbor's weight ``(L_i(own) - L_i(model_j)) / ||delta||`` is
  a difference of two validation losses, and the positive clipping and
  the next round's top-K read its sign and order, so a weight within the
  frameworks' round-off of zero, or two within it of each other, flips a
  discrete choice; the stem's max-pool and relu ties flip as in the other
  baselines (ROADMAP Queue 3, "Not faults"). Data seeds 3, 4, 6, 7 and 8
  pass this test; 5 does not (a train loss 4.3e-5 off) and 9 does
  not (a GroupNorm bias 4.4e-7 off, atol 2e-7). The run uses seed 4
  (:data:`SEED`).
* The validation split is required; the fused loop is refused with the
  reference's message.
"""
import dataclasses
import pickle

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedFomo as JFedFomo  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_torch.algorithms import FedFomo, FedFomoState  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402

N = pc.N_CLIENTS
#: the data seed of the two-round run
SEED = 4
VAL = 3
FRAC = 0.67


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cohort(seed=SEED, n_clients=N, sample_shape=pc.SS, val=VAL):
    kw = dict(seed=seed, n_clients=n_clients, samples_per_client=pc.SAMPLES,
              test_per_client=pc.TEST, val_per_client=val,
              sample_shape=sample_shape, uneven=True)
    jd, td = jsynth(**kw), make_synthetic_federated(**kw)
    jm, tm = pc.models()
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    return dict(jm=jm, tm=tm, jd=jd, td=td, nvals=nvals,
                spe=-(-max(nvals) // pc.BS), n_rows=jd.x_train.shape[1])


@pytest.fixture(scope="module")
def cohort():
    return _cohort()


def _algo(c, jax_side, frac=FRAC):
    hp = pc.hp(JHyperParams if jax_side else HyperParams, c["spe"])
    if jax_side:
        return JFedFomo(c["jm"], c["jd"], hp, loss_type="bce", frac=frac,
                        seed=0)
    return FedFomo(c["tm"], c["td"], hp, loss_type="bce", frac=frac, seed=0,
                   device="cpu")


@pytest.mark.parametrize("n_clients,frac", [(3, 0.67), (8, 1.0), (8, 0.5)])
def test_choose_neighbors_bitwise(n_clients, frac):
    """Round 0's all-ones ``p_choose`` and perturbed ones (negative entries
    and exact ties), float32 as the reference reads it, over ten rounds."""
    c = _cohort(n_clients=n_clients, sample_shape=pc.SS if n_clients == N
                else (9, 9, 9, 1))
    if n_clients != N:
        from neuroimagedisttraining_tpu.models import create_model as jcreate
        from neuroimagedisttraining_torch.models import create_model

        c["jm"] = jcreate("small3dcnn", num_classes=1)
        c["tm"] = create_model("small3dcnn", num_classes=1)
    jalgo, talgo = _algo(c, True, frac), _algo(c, False, frac)
    assert talgo._n_nei == jalgo._n_nei
    rs = np.random.RandomState(n_clients)
    ps = [np.ones((n_clients, n_clients), np.float32)]
    for _ in range(3):
        p = (1.0 + rs.randn(n_clients, n_clients)).astype(np.float32)
        p[rs.rand(n_clients, n_clients) < 0.3] = np.float32(0.75)  # ties
        ps.append(p)
    for p in ps:
        for r in range(10):
            got = talgo._choose_neighbors(r, p.copy())
            want = jalgo._choose_neighbors(r, p.copy())
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            assert (got[:, -1] == np.arange(n_clients)).all()


def _reference(c, rounds=2):
    """The reference's rounds: its initial state, then per round its state,
    train loss, eval and the epoch permutations of its draws."""
    jalgo = _algo(c, True)
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    out, rng, s = [], jstate.rng, jstate
    for r in range(rounds):
        rng, k_train = jax.random.split(rng)
        perms = pc.perms_from_keys(jax.random.split(k_train, N), c)
        s, met = jalgo.run_round(s, r)
        ev = jalgo.evaluate(s)
        out.append((s, float(met["train_loss"]),
                    {k: np.asarray(v) for k, v in ev.items()}, perms))
    return jstate, out


def _visit_weights(lstrd, trained, vals, nei):
    """The weight of every visit ``(i, t)`` recomputed in float64 from the
    port's own terms (its validation losses in call order, self first,
    and its models), and the bound of each weight's cross-framework error:
    a validation loss agrees within 2e-5 of itself across the frameworks
    (their forwards sum in other orders, tests/test_torch_port_eval.py),
    so a weight within ``(|dL_i| + |dL_j|) / ||delta||``."""
    vals = np.asarray(vals, np.float64).reshape(N, -1)
    w = np.zeros(nei.shape)
    bound = np.zeros(nei.shape)
    for i in range(N):
        s = vals[i, 0]
        for t, j in enumerate(nei[i]):
            model = trained if j == i else lstrd
            nrm = np.sqrt(sum(float(((model[k][j] - lstrd[k][i]).double()
                                     ** 2).sum()) for k in lstrd))
            lj = vals[i, 1 + t]
            if nrm > 0:
                w[i, t] = (s - lj) / nrm
                bound[i, t] = 2e-5 * (abs(s) + abs(lj)) / nrm
    return w, bound


def test_two_rounds_match_reference(cohort):
    """Per round: the neighbor choice bitwise the reference's on its own
    ``p_choose``; the port's ``p_choose`` increments equal the weights
    recomputed from its own terms (rtol 1e-5) and only the visited entries
    move; against the reference each increment within the error its
    validation losses carry (:func:`_visit_weights`) plus rtol 1e-5, a
    weight being a difference of two losses over a norm; the rest as the
    module says."""
    c = cohort
    jstate, rounds = _reference(c)
    algo = _algo(c, False)
    state = algo.init_state(params={
        k: v[0] for k, v in pc.stack(jstate.personal_params).items()})
    assert isinstance(state, FedFomoState)
    np.testing.assert_array_equal(state.p_choose.numpy(),
                                  np.asarray(jstate.p_choose))
    vals, trained = [], []
    val_loss, train_stacked = algo._val_loss, algo._train_stacked

    def record_loss(params, i):
        out = val_loss(params, i)
        vals.append(float(out))
        return out

    def record_trained(*args, **kw):
        out = train_stacked(*args, **kw)
        trained.append(out[0])
        return out

    algo._val_loss, algo._train_stacked = record_loss, record_trained
    j_prev = np.asarray(jstate.p_choose, np.float64)
    for r, (js, jloss, jev, perms) in enumerate(rounds):
        nei = algo._choose_neighbors(r, state.p_choose.numpy())
        np.testing.assert_array_equal(nei, _algo(c, True)._choose_neighbors(
            r, j_prev.astype(np.float32)))
        before, lstrd = state.p_choose.double().numpy(), state.personal_params
        vals.clear()
        state, met = algo.run_round(state, r, perms=perms)
        np.testing.assert_allclose(float(met["train_loss"]), jloss,
                                   rtol=1e-5)
        pc.compare(state.personal_params, js.personal_params, "f32",
                   stacked=True, leaf_scale=True)
        w, bound = _visit_weights(lstrd, trained[-1], vals, nei)
        want_upd, err = np.zeros((N, N)), np.zeros((N, N))
        np.add.at(want_upd, (np.arange(N)[:, None], nei), w)
        np.add.at(err, (np.arange(N)[:, None], nei), bound)
        upd = state.p_choose.double().numpy() - before
        np.testing.assert_allclose(upd, want_upd, rtol=1e-5, atol=1e-6)
        visited = np.zeros((N, N), bool)
        visited[np.arange(N)[:, None], nei] = True
        assert not (upd != 0)[~visited].any()
        j_now = np.asarray(js.p_choose, np.float64)
        j_upd = j_now - j_prev
        assert (np.abs(upd - j_upd) <= err + 1e-5 * np.abs(j_upd)
                + 1e-7).all(), (r, upd, j_upd, err)
        j_prev = j_now
        ev = algo.evaluate(state)
        assert sorted(ev) == sorted(jev)
        np.testing.assert_array_equal(ev["acc_per_client"].numpy(),
                                      jev["acc_per_client"])
        np.testing.assert_allclose(float(ev["personal_loss"]),
                                   float(jev["personal_loss"]), rtol=2e-5)
    # some neighbor weighed in
    assert float((state.p_choose - 1).abs().max()) > 0


def test_fedfomo_refusals(cohort):
    """No validation split: the reference's ``ValueError``; a fused block:
    the reference's message; the central options: no central aggregate."""
    c = cohort
    no_val = _cohort(val=0)
    with pytest.raises(ValueError) as e:
        _algo(no_val, False)
    with pytest.raises(ValueError) as je:
        _algo(no_val, True)
    assert str(e.value) == str(je.value)
    algo, jalgo = _algo(c, False), _algo(c, True)
    with pytest.raises(ValueError) as e:
        algo.run_rounds_fused(algo.init_state(), 0, 2)
    with pytest.raises(ValueError) as je:
        jalgo.run_rounds_fused(jalgo.init_state(jax.random.PRNGKey(0)), 0, 2)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError, match="no central aggregate"):
        FedFomo(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                device="cpu", robust_agg="median")
    assert algo.cost_trained_clients_per_round() == N


def test_cli_runs_end_to_end(tmp_path):
    """``main_fedfomo`` (the runner) on the CPU: two rounds with the eval,
    the JAX CLI's identity and ``stat_info`` keys, the validation split of
    ``--val_fraction`` on both sides bitwise, the cost counters counting
    every client."""
    from neuroimagedisttraining_tpu.experiments import config as jconfig
    from neuroimagedisttraining_tpu.experiments import runner as jrunner
    from neuroimagedisttraining_torch.experiments import config as tconfig
    from neuroimagedisttraining_torch.experiments import main_fedfomo
    from neuroimagedisttraining_torch.experiments import runner as trunner

    def argv(side):
        return ["--dataset", "synthetic", "--model", "small3dcnn",
                "--comm_round", "2", "--frac", "0.5", "--val_fraction", "0.2",
                "--results_dir", str(tmp_path / side), "--log_dir", ""]

    res = main_fedfomo.main(argv("t") + ["--device", "cpu"], algo="fedfomo")
    rounds = [h for h in res["history"] if h["round"] >= 0]
    assert len(rounds) == 2 and all(np.isfinite(h["train_loss"])
                                    and "personal_acc" in h for h in rounds)
    assert res["identity"] == jconfig.run_identity(
        jconfig.parse_args(argv("t"), "fedfomo"), "fedfomo")
    assert res["state"].p_choose.shape == (8, 8)
    jres = jrunner.main(argv("j"), algo="fedfomo")
    with open(res["stat_path"], "rb") as f:
        ts = pickle.load(f)
    with open(jres["stat_path"], "rb") as f:
        js = pickle.load(f)
    assert sorted(ts) == sorted(k for k in js if k != "obs_metrics")
    assert ts["sum_training_flops"] == pytest.approx(js["sum_training_flops"])
    args = tconfig.parse_args(argv("t2") + ["--device", "cpu"], "fedfomo")
    algo, data = trunner.build_algorithm(args, "fedfomo")
    jalgo, jdata = jrunner.build_algorithm(jconfig.parse_args(argv("j2"),
                                                              "fedfomo"),
                                           "fedfomo")
    pc.assert_data_equal(dataclasses.replace(data, x_val=data.x_val.cpu(),
                                             y_val=data.y_val.cpu()), jdata)
    assert algo.cost_trained_clients_per_round() == 8
