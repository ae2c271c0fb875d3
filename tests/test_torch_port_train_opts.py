"""The port's training options against the JAX package's, on the CPU:
replacement batching, ``remat_local`` and stratified SNIP.

* Replacement batching: two SalientGrads rounds on
  ``tests/test_torch_port_round.py``'s cohort (data seed 4), the port fed the
  reference's with-replacement batch indices (``randint`` of each step's
  split key); within rtol 1e-5 (atol 2e-7), as the epoch-batched rounds.
* ``remat_local``: bit for bit the rounds without it (the recompute runs
  the same forward on the same dropout masks), eager and fused.
* The exact stratified folds: the port's numpy replica of
  ``StratifiedKFold(25, shuffle=True, random_state=42)`` against
  scikit-learn itself (1.9.0 here) and the reference's schedules, index for
  index, errors message for message.
* Stratified SNIP on ``small3dcnn`` (2 clients x 50 samples of 8^3): the
  per-client scores of both modes within rtol 1e-5 of the reference's (the
  "balanced" draws fed), the masks from init agreeing on more than 99.9% of
  the kernel coordinates, density 0.5.
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.ops import sparsity as jsp  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvg,
    SalientGrads,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
)
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model, make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402

N = pc.N_CLIENTS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort()


def _hp(cls, spe, batching="epoch"):
    return cls(lr=0.01, lr_decay=0.998, momentum=0.9, weight_decay=5e-4,
               grad_clip=10.0, local_epochs=1, steps_per_epoch=spe,
               batch_size=pc.BS, batching=batching)


# -- replacement batching -----------------------------------------------------

def _replacement_idx(keys, c, steps):
    """The reference's with-replacement rows of each client's update run
    on ``keys[i]``: per step ``randint(split(step_key)[0], [batch], 0,
    max(n, 1))``."""
    out = []
    for i, n in enumerate(c["nvals"]):
        rows = [np.asarray(jax.random.randint(
            jax.random.split(k)[0], (pc.BS,), 0, max(n, 1)))
            for k in jax.random.split(keys[i], steps)]
        out.append(np.stack(rows))
    return out


def test_replacement_batching_rounds_match_reference(cohort):
    c = cohort
    spe = 2  # every step runs: 2 batches of 4 from shards of 2..6 rows
    kw = dict(loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
              itersnip_iterations=1)
    jalgo = JSalientGrads(c["jm"], c["jd"], _hp(JHyperParams, spe,
                                                "replacement"),
                          fused_kernels=True, agg_kernels="pallas", **kw)
    talgo = SalientGrads(c["tm"], c["td"], _hp(HyperParams, spe,
                                               "replacement"),
                         device="cpu", **kw)
    assert talgo._full_batches()
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    params = jax_params_to_torch(pc.np_tree(jstate.global_params))
    state = SalientGradsState(
        global_params=params,
        mask=jax_params_to_torch(pc.np_tree(jstate.mask)),
        personal_params=broadcast_tree(params, N),
        generator=torch.Generator())
    rng = jstate.rng
    for r in range(2):
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, N + 1)
        jstate, jmet = jalgo.run_round(jstate, r)
        state, tmet = talgo.run_round(
            state, r, batch_idx=_replacement_idx(keys, c, spe))
        np.testing.assert_allclose(float(tmet["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    pc.compare(state.global_params, jstate.global_params, "dense")
    pc.compare(state.personal_params, jstate.personal_params, "dense",
               stacked=True)


def test_replacement_own_draws_stay_in_each_shard(cohort):
    """Without the seam the round draws every step's rows from the state's
    generator, each in its client's valid range, and reproducibly."""
    c = cohort
    algo = FedAvg(c["tm"], c["td"], _hp(HyperParams, 3, "replacement"),
                  device="cpu")
    s0 = algo.init_state()
    from neuroimagedisttraining_torch.core.state import clone_generator

    inp = algo._round_inputs(s0.global_params, np.arange(N),
                             torch.arange(N), torch.tensor(0.01),
                             clone_generator(s0.generator))
    assert tuple(inp.perms.shape) == (N, 1, 3 * pc.BS)
    for i, n in enumerate(c["nvals"]):
        assert int(inp.perms[i].max()) < n
    a, _ = algo.run_round(s0, 0)
    b, _ = algo.run_round(s0, 0)
    for k in a.global_params:
        assert torch.equal(a.global_params[k], b.global_params[k]), k
    with pytest.raises(ValueError, match="batching"):
        HyperParams(batching="bogus")


# -- remat --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["salientgrads", "fedavg"])
def test_remat_is_bitwise_remat_off(cohort, name):
    """One round with ``remat_local`` equals the round without it, eager and
    fused (the recompute is the same forward), on a model whose dropout
    draws."""
    c = cohort
    tm = create_model("3dcnn_s2d", sample_shape=pc.SS, num_classes=1,
                      widths=pc.WIDTHS, dropout_rate=0.5)
    cls = SalientGrads if name == "salientgrads" else FedAvg
    calls = []
    tm.register_forward_pre_hook(lambda *a: calls.append(1))
    out, forwards = {}, {}
    for remat in (False, True):
        algo = cls(tm, c["td"], pc.hp(HyperParams, c["spe"]), device="cpu",
                   remat_local=remat)
        s0 = algo.init_state(generator=torch.Generator().manual_seed(5))
        algo._dropout_calls(s0.global_params)  # the probe's forward
        calls.clear()
        e, met = algo.run_round(algo.clone_state(s0), 0)
        forwards[remat] = len(calls)
        f, ys = algo.run_rounds_fused(algo.clone_state(s0), 0, 1)
        out[remat] = (e, float(met["train_loss"]), f,
                      float(ys["train_loss"][0]))
    # the recompute: every training step's forward runs twice
    assert forwards[True] == 2 * forwards[False] > 0
    (e0, l0, f0, fl0), (e1, l1, f1, fl1) = out[False], out[True]
    assert l0 == l1 == fl0 == fl1
    for k in e0.global_params:
        assert torch.equal(e0.global_params[k], e1.global_params[k]), k
        assert torch.equal(e1.global_params[k], f1.global_params[k]), k
        assert torch.equal(e0.personal_params[k], e1.personal_params[k]), k


# -- the exact stratified folds -----------------------------------------------

def _labels(case):
    rng = np.random.RandomState(3)
    if case == "binary":
        return rng.permutation(np.repeat([0, 1], 25)).astype(np.int32)
    if case == "float_targets":
        return rng.permutation(np.repeat([1.0, 0.0], [31, 29])).astype(
            np.float32)
    if case == "three_classes_first_appearance":
        y = rng.permutation(np.repeat([0, 1, 2], [30, 27, 26]))
        return np.concatenate([[2, 1], y]).astype(np.int32)
    if case == "imbalanced":  # one class under 25: the splitter warns
        return rng.permutation(np.repeat([0, 1], [40, 12])).astype(np.int32)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["binary", "float_targets",
                                  "three_classes_first_appearance",
                                  "imbalanced"])
def test_fold_replica_matches_sklearn(case):
    from sklearn.model_selection import StratifiedKFold

    y = _labels(case)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = [tr for tr, _ in StratifiedKFold(
            25, shuffle=True, random_state=42).split(np.zeros_like(y), y)]
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = tsp.stratified_kfold_train_sides(y)
    assert len(got) == len(want) == 25
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [str(w.message) for w in got_w] == [str(w.message)
                                              for w in want_w]


@pytest.mark.parametrize("y", [np.repeat([0, 1], 20).astype(np.int32),
                               np.zeros(10, np.int32),
                               np.linspace(0, 1, 60).astype(np.float32)],
                         ids=["every_class_small", "fewer_rows",
                              "continuous"])
def test_fold_replica_refuses_as_sklearn(y):
    from sklearn.model_selection import StratifiedKFold

    with pytest.raises(ValueError) as want:
        list(StratifiedKFold(25, shuffle=True, random_state=42).split(
            np.zeros_like(y), y))
    with pytest.raises(ValueError) as got:
        tsp.stratified_kfold_train_sides(y)
    assert str(got.value) == str(want.value)


def test_stacked_fold_schedules_match_reference():
    rng = np.random.RandomState(0)
    y = rng.randint(0, 2, (3, 64)).astype(np.int32)
    y[:, :26] = 0
    y[:, 26:52] = 1
    n = np.array([60, 64, 57], np.int32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for got, want in zip(tsp.stacked_fold_schedules(y, n),
                             jsp.stacked_fold_schedules(y, n)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        n[2] = 20  # client 2: fewer valid rows than splits
        with pytest.raises(ValueError) as want_e:
            jsp.stacked_fold_schedules(y, n)
        with pytest.raises(ValueError) as got_e:
            tsp.stacked_fold_schedules(y, n)
    assert str(got_e.value) == str(want_e.value)
    assert "stratified_mode='balanced'" in str(got_e.value)


# -- stratified SNIP ----------------------------------------------------------

SNIP_BS = 8


@pytest.fixture(scope="module")
def snip_cohort():
    kw = dict(seed=1, n_clients=2, samples_per_client=50, test_per_client=4,
              sample_shape=(8, 8, 8, 1), uneven=False)
    jm = jcreate("small3dcnn", num_classes=1)
    tm = create_model("small3dcnn", num_classes=1)
    jd, td = jsynth(**kw), make_synthetic_federated(**kw)
    params = pc.np_tree(jinit(jm, jax.random.PRNGKey(1), (8, 8, 8, 1)))
    return dict(jm=jm, tm=tm, jd=jd, td=td, params=params,
                sd=jax_params_to_torch(params))


def _jax_balanced_idx(key, y, n_valid, n_iters=25):
    """The reference's balanced SNIP draws for one client."""
    valid = jnp.arange(y.shape[0]) < n_valid
    yc = jnp.clip(jnp.asarray(y).astype(jnp.int32), 0, 1)
    counts = jnp.zeros((2,)).at[yc].add(valid.astype(jnp.float32))
    p = valid / jnp.maximum(counts[yc], 1.0)
    p = p / jnp.maximum(p.sum(), 1e-9)
    return np.stack([np.asarray(jax.random.choice(
        jax.random.split(k)[0], y.shape[0], (SNIP_BS,), replace=True, p=p))
        for k in jax.random.split(key, n_iters)])


def _assert_scores_close(ts, js):
    for k, v in jax_params_to_torch(pc.np_tree(js)).items():
        scale = float(v.abs().max()) or 1.0
        np.testing.assert_allclose(ts[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("mode", ["exact", "balanced"])
def test_stratified_snip_scores_and_mask_match_reference(snip_cohort, mode):
    s = snip_cohort
    jd, td = s["jd"], s["td"]
    y_host = np.asarray(jd.y_train)
    n = [int(v) for v in np.asarray(jd.n_train)]
    key = jax.random.PRNGKey(2)
    keys = jax.random.split(key, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sched = jsp.stacked_fold_schedules(y_host, np.asarray(jd.n_train))
    snip_idx = []
    for c in range(2):
        if mode == "exact":
            js = jsp.make_snip_fold_score_fn(japply(s["jm"]), "bce")(
                s["params"], jd.x_train[c], jd.y_train[c],
                jnp.asarray(sched[0][c]), jnp.asarray(sched[1][c]), keys[c])
            ts = tsp.make_snip_fold_score_fn(make_apply_fn(s["tm"]), "bce")(
                s["sd"], td.x_train[c], td.y_train[c], sched[0][c],
                sched[1][c])
        else:
            js = jsp.make_snip_score_fn(
                japply(s["jm"]), "bce", SNIP_BS, stratified=True,
                num_classes=2)(s["params"], jd.x_train[c], jd.y_train[c],
                               n[c], keys[c], 25)
            idx = _jax_balanced_idx(keys[c], y_host[c], n[c])
            snip_idx.append(idx)
            ts = tsp.make_snip_score_fn(
                make_apply_fn(s["tm"]), "bce", SNIP_BS, stratified=True)(
                    s["sd"], td.x_train[c], td.y_train[c], n[c], 25, idx=idx)
        _assert_scores_close(ts, js)
    # the whole init: the reference's SNIP (its own draws) against the
    # port's from the same parameters and, for "balanced", the same draws
    hp_kw = dict(lr=0.01, local_epochs=1, steps_per_epoch=7,
                 batch_size=SNIP_BS)
    kw = dict(loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
              stratified_sampling=True, stratified_mode=mode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jalgo = JSalientGrads(s["jm"], jd, JHyperParams(**hp_kw),
                              agg_kernels="pallas", **kw)
        talgo = SalientGrads(s["tm"], td, HyperParams(**hp_kw), device="cpu",
                             **kw)
    p_rng, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    jparams = jinit(s["jm"], p_rng, (8, 8, 8, 1))
    jmask, _ = jalgo._global_mask_jit(jparams, jd.x_train, jd.y_train,
                                      jd.n_train, m_rng)
    mkeys = jax.random.split(m_rng, 2)
    tstate = talgo.init_state(
        params=jax_params_to_torch(pc.np_tree(jparams)),
        snip_idx=(None if mode == "exact" else
                  [_jax_balanced_idx(mkeys[c], y_host[c], n[c])
                   for c in range(2)]))
    want = jax_params_to_torch(pc.np_tree(jmask))
    agree = sum(int((tstate.mask[k] == v).sum()) for k, v in want.items())
    assert agree / sum(v.numel() for v in want.values()) > 0.999
    assert abs(tsp.mask_density(tstate.mask) - 0.5) < 1e-3
    assert abs(tsp.mask_density(tstate.mask)
               - float(jsp.mask_density(jmask))) < 1e-3


def test_balanced_probs_match_reference(snip_cohort):
    jd = snip_cohort["jd"]
    y = np.asarray(jd.y_train)[0]
    valid = np.arange(y.shape[0]) < 45
    counts = np.bincount(y[valid], minlength=2).astype(np.float32)
    want = valid / np.maximum(counts[y], 1.0)
    want = want / want.sum()
    got = tsp.balanced_probs(torch.from_numpy(y.copy()), 45, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(got[45:] == 0)
    with pytest.raises(ValueError, match="stratified_mode"):
        SalientGrads(snip_cohort["tm"], snip_cohort["td"],
                     HyperParams(batch_size=SNIP_BS), device="cpu",
                     stratified_sampling=True, stratified_mode="folds")
