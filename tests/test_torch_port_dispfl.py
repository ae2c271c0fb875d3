"""The port's DisPFL against the JAX package's, on the CPU.

Two rounds on ``tests/_torch_port_cohort.py``'s narrow cohort (3 clients),
the port fed the reference's draws at its seams: the epoch permutations of
each client's update key, the screening batch rows (the ``randint`` of each
client's screening key) and, under ``dis_gradient_check``, the uniform
regrow scores; the initial masks are the reference's. Each configuration's
reference run is made once per module.

* Masks bitwise after each round, so the mask-change fraction too; train
  losses within rtol 1e-5; the personal models per leaf within rtol 1e-5
  (atol 1e-5 of the leaf's largest value: an element's round-off follows
  its leaf's scale); the local tests' accuracies bitwise and losses within
  2e-5 (the forwards' summation orders, ``tests/test_torch_port_eval.py``);
  the eval's mean mask density bitwise.
* The configurations cover ERK and uniform masks, one shared and per-client
  initial masks (``different_initial``, ``diff_spa``), static masks, partial
  participation (``active`` 0.5), the random, ring and full neighbor modes
  and the random regrow of ``dis_gradient_check``.
* Seeds. Fire and regrow pick by magnitude, and the stem's max-pool routes
  a tied window's gradient by a rule of its own in each framework
  (ROADMAP, "Near-ties in max-pool and relu"): a discrete flip, not drift,
  that no tolerance should hide. The ERK and static runs use data seed 4.
  The uniform run uses data seed 5: on seed 4 it flips a stem max-pool tie
  in round 0 (the stem kernel 3e-4 off), on seeds 6 and 9 in round 1; seeds
  3, 5, 7 and 8 have none.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import DisPFL as JDisPFL  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_torch.algorithms import DisPFL, DisPFLState  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402

N = pc.N_CLIENTS
ROUNDS = 2

#: configuration -> (DisPFL options, frac, data seed)
CONFIGS = {
    "erk_random": (dict(), 0.34, 4),
    "uniform_ring_active_gradient_check": (
        dict(sparsity_distribution="uniform", neighbor_mode="ring",
             active=0.5, different_initial=True, dis_gradient_check=True),
        0.67, 5),
    "static_full_diff_spa": (
        dict(static_masks=True, neighbor_mode="full", diff_spa=True), 0.67,
        4),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_COHORTS = {}


def cohort(name):
    """Both sides' models and data at the configuration's data seed, made
    once per module."""
    seed = CONFIGS[name][2]
    if seed not in _COHORTS:
        _COHORTS[seed] = pc.cohort(seed)
    return _COHORTS[seed]


def _kw(name):
    opts, frac, _ = CONFIGS[name]
    return dict(loss_type="bce", frac=frac, seed=0, total_rounds=4,
                **opts)


def _draws(rng, c, template, algo):
    """The reference's draws of one DisPFL round from its state key: the
    next key, each client's epoch permutations, screening rows and (under
    ``dis_gradient_check``) regrow scores."""
    rng, k_train, k_screen = jax.random.split(rng, 3)
    keys = jax.random.split(k_train, N)
    perms = [np.array(epoch_permutations(
        jax.random.split(keys[i])[0], jnp.int32(n), 1, c["spe"] * pc.BS,
        n_rows=c["n_rows"])) for i, n in enumerate(c["nvals"])]
    skeys = jax.random.split(k_screen, N)
    rows = [np.array(jax.random.randint(
        jax.random.split(skeys[i])[0], (pc.BS,), 0, max(n, 1)))
        for i, n in enumerate(c["nvals"])]
    regrow = None
    if algo.dis_gradient_check:
        leaves, treedef = jax.tree_util.tree_flatten(template)

        def scores(key):
            ks = jax.random.split(key, len(leaves))
            return jax.tree_util.tree_unflatten(
                treedef, [jax.random.uniform(k, l.shape)
                          for l, k in zip(leaves, ks)])

        regrow = pc.stack(jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *[scores(k) for k in skeys]))
    return rng, dict(perms=perms, screen_idx=rows, regrow_u=regrow)


_REFERENCE = {}


def reference(name):
    """A configuration's reference run, made once per module: its initial
    parameters and state, and after each round its state, metrics, eval
    and the draws it made."""
    if name not in _REFERENCE:
        c = cohort(name)
        jalgo = JDisPFL(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                        **_kw(name))
        key = jax.random.PRNGKey(0)
        params = jinit(c["jm"], jax.random.split(key, 3)[0],
                       jalgo.init_sample_shape)
        jstate = jalgo.init_state(key)
        rounds, rng = [], jstate.rng
        s = jstate
        for r in range(ROUNDS):
            rng, seams = _draws(rng, c, params, jalgo)
            s, met = jalgo.run_round(s, r)
            ev = jalgo.evaluate(s)
            rounds.append((s, {k: float(v) for k, v in met.items()},
                           {k: np.asarray(v) for k, v in ev.items()},
                           seams))
        _REFERENCE[name] = dict(params=params, init=jstate, rounds=rounds)
    return _REFERENCE[name]


def _masks_equal(t_masks, j_masks, what):
    want = pc.stack(j_masks)
    for k, v in want.items():
        assert torch.equal(t_masks[k], v), f"{what}: {k}"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dispfl_two_rounds_match_reference(name):
    c, ref = cohort(name), reference(name)
    algo = DisPFL(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                  device="cpu", **_kw(name))
    state = algo.init_state(
        params=jax_params_to_torch(pc.np_tree(ref["params"])),
        masks=pc.stack(ref["init"].masks))
    assert isinstance(state, DisPFLState)
    for k, v in pc.stack(ref["init"].personal_params).items():
        assert torch.equal(state.personal_params[k], v), k
    for r, (jstate, jmet, jev, seams) in enumerate(ref["rounds"]):
        state, met = algo.run_round(state, r, **seams)
        assert list(met) == list(jmet)
        np.testing.assert_allclose(float(met["train_loss"]),
                                   jmet["train_loss"], rtol=1e-5)
        _masks_equal(state.masks, jstate.masks, f"{name} round {r}")
        assert float(met["mask_change"]) == jmet["mask_change"]
        for k in ("new_mask_test_acc", "old_mask_test_acc"):
            assert float(met[k]) == jmet[k], (r, k)
        for k in ("new_mask_test_loss", "old_mask_test_loss"):
            np.testing.assert_allclose(float(met[k]), jmet[k], rtol=2e-5)
        pc.compare(state.personal_params, jstate.personal_params, "f32",
                   stacked=True, leaf_scale=True)
        ev = algo.evaluate(state)
        assert float(ev["mean_mask_density"]) == float(
            jev["mean_mask_density"])
        np.testing.assert_array_equal(ev["acc_per_client"].numpy(),
                                      jev["acc_per_client"])
        np.testing.assert_allclose(float(ev["personal_loss"]),
                                   float(jev["personal_loss"]), rtol=2e-5)
    if not algo.static_masks:
        assert float(met["mask_change"]) > 0
    if algo.active < 1:  # the coins left clients out of an aggregation
        assert any(not algo._host_inputs(r)["active"].all()
                   for r in range(ROUNDS))


def test_dispfl_mask_distance_matrix():
    """The end-of-run pairwise mask distances, on the per-client masks of
    the ``different_initial`` run."""
    name = "uniform_ring_active_gradient_check"
    c, ref = cohort(name), reference(name)
    jalgo = JDisPFL(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                    **_kw(name))
    algo = DisPFL(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                  device="cpu", **_kw(name))
    jstate = ref["rounds"][-1][0]
    state = DisPFLState(personal_params=pc.stack(jstate.personal_params),
                        masks=pc.stack(jstate.masks),
                        generator=algo.generator())
    got, want = algo.mask_distance_matrix(state), np.asarray(
        jalgo.mask_distance_matrix(jstate))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (N, N) and (np.diag(got) == 0).all()
    assert (got[~np.eye(N, dtype=bool)] > 0).all()
