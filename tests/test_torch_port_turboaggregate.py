"""The port's TurboAggregate and its MPC primitives against the JAX
package's, on the CPU.

* ``ops/mpc.py``: every function bitwise the reference's on the same
  inputs and the same ``np.random.RandomState`` (the modular inverse, field
  division, ``_matmul_mod`` at K >= 3 with every entry near p, where a
  plain int64 matmul would wrap, Lagrange coefficients, Horner evaluation,
  Shamir sharing and reconstruction, LCC encode and decode, additive
  shares, the key agreement, the fixed-point transport with its ties
  rounded half to even).
* The secure sum: ``_secure_weighted_sum`` bitwise the reference's on the
  same stacked locals and weights.
* Two rounds on ``tests/_torch_port_cohort.py``'s narrow cohort (3
  clients, 2 sampled), the port fed the reference's epoch permutations:
  train losses within rtol 1e-5, the global model within rtol 1e-5 (atol
  2e-7) once whole quanta (2^-16), at most one per sampled client, are
  taken off: each client's weighted model is rounded to the quantum, and
  where the two frameworks' locals straddle a half-quantum it rounds the
  other way (an exact step of 2^-16, not drift: 19 values of 27,289 in
  round 0 here, 68 in round 1); the eval's accuracies bitwise and losses
  within 2e-5.
* The fused loop is refused with the reference's message.
"""
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import TurboAggregate as JTurbo  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.ops import mpc as jmpc  # noqa: E402
from neuroimagedisttraining_torch.algorithms import TurboAggregate  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.ops import mpc as tmpc  # noqa: E402

P = jmpc.DEFAULT_PRIME
FRAC = 0.67


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(got, want):
    if isinstance(want, (int, np.integer)):
        assert type(got) is type(want) and got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(fn, *args, rng_seed=None, **kw):
    """``fn`` of both packages on the same inputs (a fresh
    ``RandomState(rng_seed)`` each, where given)."""
    out = []
    for mod in (tmpc, jmpc):
        extra = dict(kw)
        if rng_seed is not None:
            extra["rng"] = np.random.RandomState(rng_seed)
        out.append(getattr(mod, fn)(*args, **extra))
    return out


def _near_p(rs, shape):
    return P - 1 - rs.randint(0, 1000, size=shape).astype(np.int64)


# every function of the module, each a case of its own
MPC_CASES = ["mod_inverse", "field_div", "matmul_mod", "lagrange_coeffs",
             "poly_eval", "shamir", "lcc", "additive_shares", "dh",
             "quantize"]


@pytest.mark.parametrize("case", MPC_CASES)
def test_mpc_bitwise(case):
    rs = np.random.RandomState(7)
    if case == "mod_inverse":
        for a in (1, 2, 3, P - 1, 12345, -5, P + 7):
            _equal(*_both("mod_inverse", a, P))
        for mod in (tmpc, jmpc):
            with pytest.raises(ZeroDivisionError, match="no inverse for 0"):
                mod.mod_inverse(P, P)
    elif case == "field_div":
        num = rs.randint(0, P, size=(5, 4)).astype(np.int64)
        for den in (3, P - 2, 99991):
            _equal(*_both("field_div", num, den, P))
    elif case == "matmul_mod":
        for k in (1, 3, 4, 9):
            a, b = _near_p(rs, (6, k)), _near_p(rs, (k, 7))
            got, want = _both("_matmul_mod", a, b, P)
            _equal(got, want)
            # exact: Python ints do not wrap
            exact = [[sum(int(a[i, j]) * int(b[j, m]) for j in range(k)) % P
                      for m in range(7)] for i in range(6)]
            assert got.tolist() == exact
    elif case == "lagrange_coeffs":
        for targets, nodes in (([0], [1, 2, 3]), ([5, 6, 7, 8], [1, 2, 3]),
                               ([P - 1, 0], [1, 4, 9, 16, 25])):
            _equal(*_both("lagrange_coeffs", targets, nodes, P))
    elif case == "poly_eval":
        coeffs = _near_p(rs, (4, 3, 2))
        for x in (0, 1, 5, P - 1):
            _equal(*_both("_poly_eval", coeffs, x, P))
    elif case == "shamir":
        x = rs.randint(0, P, size=(7, 3)).astype(np.int64)
        got, want = _both("shamir_share", x, 5, 2, P, rng_seed=3)
        _equal(got, want)
        for holders in ([0, 1, 2], [1, 3, 4], [0, 1, 2, 3, 4]):
            rec = _both("shamir_reconstruct", got[holders], holders, P)
            _equal(*rec)
            _equal(rec[0], x)
    elif case == "lcc":
        x = rs.randint(0, P, size=(6, 4)).astype(np.int64)
        enc = _both("lcc_encode", x, 7, 3, 2, P, rng_seed=5)
        _equal(*enc)
        ids = [0, 2, 3, 5, 6]
        dec = _both("lcc_decode", enc[0][ids], ids, 7, 3, 2, P)
        _equal(*dec)
        _equal(dec[0].reshape(6, 4), x)
        for mod in (tmpc, jmpc):
            with pytest.raises(ValueError, match="K=4 chunks"):
                mod.lcc_encode(x, 7, 4, 2, P, rng=np.random.RandomState(0))
            with pytest.raises(ValueError, match="need >= K\\+T = 5"):
                mod.lcc_decode(enc[0][ids[:4]], ids[:4], 7, 3, 2, P)
    elif case == "additive_shares":
        x = rs.randint(-P, P, size=(9, 2)).astype(np.int64)
        for n in (2, 3, 8):
            got, want = _both("additive_shares", x, n, P, rng_seed=n)
            _equal(got, want)
            _equal(np.mod(got.sum(axis=0), P), np.mod(x, P))
    elif case == "dh":
        for sk, g in ((5, 2), (123456, 7), (P - 2, 3)):
            pk = _both("dh_keygen", sk, g, P)
            _equal(*pk)
            _equal(*_both("dh_key_agreement", pk[0], 77, P))
    elif case == "quantize":
        scale = 2 ** 16
        # half-quantum ties round half to even, as numpy's round does
        x = np.concatenate([rs.randn(200) * 3, (np.arange(-6, 7) + 0.5)
                            / scale, [0.0, -0.0, 1e-9, -1e-9]])
        q = _both("quantize", x, scale, P)
        _equal(*q)
        assert q[0][200:213].tolist() == [int(np.mod(np.round(v * scale), P))
                                         for v in x[200:213]]
        _equal(*_both("dequantize", q[0], scale, P))


def _algo(c, jax_side, frac=FRAC, **kw):
    hp = pc.hp(JHyperParams if jax_side else HyperParams, c["spe"])
    if jax_side:
        return JTurbo(c["jm"], c["jd"], hp, loss_type="bce", frac=frac,
                      seed=0, **kw)
    return TurboAggregate(c["tm"], c["td"], hp, loss_type="bce", frac=frac,
                          seed=0, device="cpu", **kw)


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort()


@pytest.mark.parametrize("n_groups", [2, 3, 5])
def test_secure_weighted_sum_bitwise(cohort, n_groups):
    """The same stacked locals (random, at the narrow model's shapes) and
    float64 weights: the port's secure sum equals the reference's bit for
    bit, and lies within one quantum per client of the plain f64 weighted
    mean."""
    c = cohort
    jalgo = _algo(c, True, n_groups=n_groups)
    talgo = _algo(c, False, n_groups=n_groups)
    rs = np.random.RandomState(n_groups)
    jp = jax.tree_util.tree_map(np.asarray, jalgo.init_state(
        jax.random.PRNGKey(0)).global_params)
    stacked = jax.tree_util.tree_map(
        lambda a: (rs.randn(pc.N_CLIENTS, *a.shape) * 0.1).astype(
            np.float32), jp)
    w = np.asarray([5.0, 7.0, 6.0], np.float64)
    w = w / w.sum()
    want = jax_params_to_torch(pc.np_tree(jalgo._secure_weighted_sum(
        jax.tree_util.tree_map(jnp.asarray, stacked), w)))
    t_stacked = pc.stack(stacked)
    got = talgo._secure_weighted_sum(t_stacked, w)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
        mean = np.tensordot(w, t_stacked[k].double().numpy(), axes=1)
        assert np.abs(got[k].double().numpy() - mean).max() <= \
            pc.N_CLIENTS * 0.5 / talgo.quant_scale + 1e-7


def _ref_rounds(c, rounds=2):
    """The reference's rounds: its initial state, then per round its state,
    metrics, eval, and the epoch permutations of its draws."""
    jalgo = _algo(c, True)
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    out, rng, s = [], jstate.rng, jstate
    for r in range(rounds):
        sel = jalgo._selected_client_indexes(r)
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, len(sel))
        perms = [np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(c["nvals"][int(cl)]), 1,
            c["spe"] * pc.BS, n_rows=c["n_rows"]))
            for i, cl in enumerate(sel)]
        s, met = jalgo.run_round(s, r)
        ev = jalgo.evaluate(s)
        out.append((s, {k: float(v) for k, v in met.items()},
                    {k: np.asarray(v) for k, v in ev.items()}, perms))
    return jstate, out


def test_two_rounds_match_reference(cohort):
    c = cohort
    jstate, rounds = _ref_rounds(c)
    algo = _algo(c, False)
    state = algo.init_state(params=jax_params_to_torch(pc.np_tree(
        jstate.global_params)))
    quantum = 1.0 / algo.quant_scale
    for r, (js, jmet, jev, perms) in enumerate(rounds):
        state, met = algo.run_round(state, r, perms=perms)
        assert sorted(met) == sorted(jmet)
        np.testing.assert_allclose(float(met["train_loss"]),
                                   jmet["train_loss"], rtol=1e-5)
        want = jax_params_to_torch(pc.np_tree(js.global_params))
        for k, v in want.items():
            # the difference less its whole quanta (at most one a client)
            # within rtol 1e-5 (atol 2e-7)
            want_k = v.double().numpy()
            d = state.global_params[k].double().numpy() - want_k
            steps = np.round(d / quantum)
            assert np.abs(steps).max() <= algo.clients_per_round, (r, k)
            assert (np.abs(d - steps * quantum)
                    <= 2e-7 + 1e-5 * np.abs(want_k)).all(), (r, k)
        ev = algo.evaluate(state)
        assert sorted(ev) == sorted(jev)
        np.testing.assert_array_equal(ev["acc_per_client"].numpy(),
                                      jev["acc_per_client"])
        np.testing.assert_allclose(float(ev["global_loss"]),
                                   float(jev["global_loss"]), rtol=2e-5)


def test_turboaggregate_refuses_fused_and_central_options(cohort):
    c = cohort
    algo = _algo(c, False)
    jalgo = _algo(c, True)
    with pytest.raises(ValueError) as e:
        algo.run_rounds_fused(algo.init_state(), 0, 2)
    with pytest.raises(ValueError) as je:
        jalgo.run_rounds_fused(jalgo.init_state(jax.random.PRNGKey(0)), 0, 2)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError) as e:
        algo.run(2, fuse_rounds=2)
    assert str(e.value) == str(je.value)
    for kw in (dict(fault_spec="drop=0.2"), dict(robust_agg="median"),
               dict(agg_impl="int8")):
        with pytest.raises(ValueError, match="secure sum"):
            _algo(c, False, **kw)


def test_cli_runs_end_to_end(tmp_path):
    """``main_turboaggregate`` (the runner) on the CPU: two rounds with the
    eval, ``--n_groups`` reaching the algorithm, the JAX CLI's identity and
    ``stat_info`` keys."""
    from neuroimagedisttraining_tpu.experiments import config as jconfig
    from neuroimagedisttraining_tpu.experiments import runner as jrunner
    from neuroimagedisttraining_torch.experiments import config as tconfig
    from neuroimagedisttraining_torch.experiments import main_turboaggregate
    from neuroimagedisttraining_torch.experiments import runner as trunner

    def argv(side):
        return ["--dataset", "synthetic", "--model", "small3dcnn",
                "--comm_round", "2", "--frac", "0.5", "--n_groups", "4",
                "--results_dir", str(tmp_path / side), "--log_dir", ""]

    res = main_turboaggregate.main(argv("t") + ["--device", "cpu"],
                                   algo="turboaggregate")
    rounds = [h for h in res["history"] if h["round"] >= 0]
    assert len(rounds) == 2 and all(np.isfinite(h["train_loss"])
                                    and "global_acc" in h for h in rounds)
    assert res["identity"] == jconfig.run_identity(
        jconfig.parse_args(argv("t"), "turboaggregate"), "turboaggregate")
    jres = jrunner.main(argv("j"), algo="turboaggregate")
    with open(res["stat_path"], "rb") as f:
        ts = pickle.load(f)
    with open(jres["stat_path"], "rb") as f:
        js = pickle.load(f)
    assert sorted(ts) == sorted(k for k in js if k != "obs_metrics")
    algo, _ = trunner.build_algorithm(tconfig.parse_args(
        argv("t2") + ["--device", "cpu"], "turboaggregate"), "turboaggregate")
    assert algo.n_groups == 4 and algo.clients_per_round == 4
