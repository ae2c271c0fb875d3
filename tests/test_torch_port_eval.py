"""The port's eval protocol against the JAX package's, on the CPU: the sampled
subset (``eval_clients``), the personal eval and the in-state cache
(``eval_cache``), in both round loops.

On ``tests/test_torch_port_round.py``'s narrow cohort (data seed 4, 3
clients, uneven shards; ``frac`` 0.5 draws 2 of the 3). The reference's own
cache test fails on jax 0.9.0, so the port's personal eval and its cache
are held to the JAX package's FULL personal eval (its ``_eval_personal``)
on the same parameters: per-client correct counts and accuracies bit for
bit, the protocol means of those accuracies within one float32 ulp (rtol
1.2e-7, the two frameworks sum them in another order), losses within rtol
2e-5: on identical parameters the two frameworks' forwards differ by their
convolutions' and GroupNorm statistics' summation orders (the forward is
held at rtol 1e-5 in ``tests/test_torch_port_model.py``), which moved the
per-client loss sums by up to 8.9e-6 relative here, so the reference's
own 4e-7 (its subset-width reassociation, one framework) is the bound
inside the port only. Inside the port, a cached eval against the full pass
and against a cache-off twin: accuracies bit for bit, losses within 4e-7
(both read 0.0); a fused block against ``run_round`` + ``evaluate``: bit
for bit.
"""
import dataclasses

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402

#: losses inside the port (cached against full, cache on against off)
LOSS_RTOL = 4e-7
#: losses against the JAX package on the same parameters (see above)
JAX_LOSS_RTOL = 2e-5
#: the protocol mean of equal per-client accuracies, summed in another order
MEAN_RTOL = 1.2e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small CPU ops: one thread keeps them fast among the suite's
    parallel workers (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort(seed=4)


@pytest.fixture(scope="module")
def jref(cohort):
    """The JAX package's FedAvg on the same cohort, for its full personal
    eval, and a reference param tree to shape converted trees by."""
    c = cohort
    ja = JFedAvg(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                 loss_type="bce", frac=1.0, seed=0)
    return ja, pc.np_tree(jinit(c["jm"], jax.random.PRNGKey(0), pc.SS))


def _algo(c, name="salientgrads", frac=1.0, **kw):
    hp = pc.hp(HyperParams, c["spe"])
    kw = {**dict(loss_type="bce", frac=frac, seed=0, device="cpu"), **kw}
    if name == "salientgrads":
        return SalientGrads(c["tm"], c["td"], hp, dense_ratio=0.5,
                            itersnip_iterations=1, **kw)
    return FedAvg(c["tm"], c["td"], hp, **kw)


def _host(ev):
    return {k: float(v) for k, v in ev.items() if not k.startswith("acc_per")}


def _jax_full_personal(jref, c, personal):
    """The JAX package's full personal eval of the port's stack."""
    ja, template = jref
    ev = ja._eval_personal(pc.to_jax_tree(personal, template, lead=1),
                           c["jd"].x_test, c["jd"].y_test, c["jd"].n_test)
    return {k: np.asarray(v) for k, v in ev.items()}


def _assert_matches_jax(terms, ev, jev):
    """The port's per-client terms ``(correct, loss_sum, total)`` and
    protocol means ``ev`` (``personal_acc``/``personal_loss``) against the
    JAX full personal eval ``jev``."""
    correct, loss_sum, total = (t.numpy() for t in terms)
    np.testing.assert_array_equal(correct, jev["correct"])
    np.testing.assert_array_equal(total, jev["total"])
    np.testing.assert_array_equal(
        correct.astype(np.float32) / np.maximum(total, 1).astype(np.float32),
        jev["acc_per_client"])
    np.testing.assert_allclose(ev["personal_acc"], float(jev["acc"]),
                               rtol=MEAN_RTOL)
    np.testing.assert_allclose(loss_sum, jev["loss_sum"],
                               rtol=JAX_LOSS_RTOL)
    np.testing.assert_allclose(ev["personal_loss"], float(jev["loss"]),
                               rtol=JAX_LOSS_RTOL)


class _Count:
    """Counts the calls of ``algo``'s named methods."""

    def __init__(self, algo, *names):
        self.n = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(algo, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.n[_name] += 1
                return _fn(*a, **k)

            setattr(algo, name, wrapped)


def _spread_personal(state, c, scale=0.05):
    """``state`` whose personal models differ by client (a numpy-seeded
    perturbation of the global model per row)."""
    rs = np.random.RandomState(7)
    pers = {k: v + torch.from_numpy(
        (scale * rs.randn(*v.shape)).astype(np.float32))
        for k, v in state.personal_params.items()}
    return dataclasses.replace(state, personal_params=pers)


def test_eval_subset_matches_reference(cohort, jref):
    """``eval_clients=2`` of 3: the JAX package's seeded subset, and the
    global and personal means over it equal the JAX ``eval_clients`` eval
    of the same parameters."""
    c = cohort
    ja = JFedAvg(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                 loss_type="bce", frac=1.0, seed=3, eval_clients=2)
    algo = _algo(c, "fedavg", seed=3, eval_clients=2)
    want = np.asarray(ja._eval_idx)
    assert algo._eval_rows == [int(i) for i in want]
    np.testing.assert_array_equal(algo._eval_idx.numpy(), want)
    state = _spread_personal(algo.init_state(), c)
    _, template = jref
    jstate = ja.init_state(jax.random.PRNGKey(0)).replace(
        global_params=pc.to_jax_tree(state.global_params, template),
        personal_params=pc.to_jax_tree(state.personal_params, template,
                                       lead=1))
    tev, jev = algo.evaluate(state), ja.evaluate(jstate)
    assert sorted(tev) == sorted(jev)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
    assert tev["acc_per_client"].shape == (2,)
    for k in ("global_acc", "personal_acc"):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]),
                                   rtol=MEAN_RTOL)
    for k in ("global_loss", "personal_loss"):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]),
                                   rtol=JAX_LOSS_RTOL)
    # the subset's terms, not the cohort's
    full = _algo(c, "fedavg").evaluate(state)
    assert float(full["global_loss"]) != float(tev["global_loss"])


@pytest.mark.parametrize("source", ["round", "clone", "fused", "finalize"])
def test_personal_eval_matches_reference(cohort, jref, source):
    """At ``frac`` 0.5, after two rounds, the personal half of ``evaluate``
    on the state that a round, a clone of it, a fused block or FedAvg's
    finalize produced is the full pass over that stack, and equals the JAX
    package's full personal eval of it (per-client terms and accuracies bit
    for bit, losses within 2e-5)."""
    c = cohort
    algo = _algo(c, "fedavg", frac=0.5)
    s0, _ = algo.run_round(algo.init_state(), 0)
    if source == "fused":
        t = algo.run_rounds_fused(s0, 1, 1)[0]
    else:
        t, _ = algo.run_round(s0, 1)
        if source == "clone":
            t = algo.clone_state(t)
        elif source == "finalize":
            t, _ = algo.finalize(t)
    ev = _host(algo.evaluate(t))
    full = algo._eval_personal(t.personal_params)
    assert ev["personal_acc"] == float(full["acc"])
    assert ev["personal_loss"] == float(full["loss"])
    _assert_matches_jax((full["correct"], full["loss_sum"], full["total"]),
                        ev, _jax_full_personal(jref, c, t.personal_params))


CACHE_CASES = [
    pytest.param("salientgrads", 1.0, id="sg-full"),
    pytest.param("salientgrads", 0.5, id="sg-sampled"),
    pytest.param("fedavg", 0.5, id="fedavg-sampled"),
]


@pytest.mark.parametrize("name,frac", CACHE_CASES)
def test_eval_cache_matches_cache_off_and_reference(cohort, jref, name,
                                                    frac):
    """Two rounds with ``eval_cache`` against the same rounds without it,
    from one state: the eval after each equal (accuracies bit for bit,
    losses within 4e-7), with no personal forward in the cached eval; the
    cache's terms are the full eval's of the round's personal stack, and
    the JAX full personal eval's."""
    c = cohort
    on = _algo(c, name, frac=frac, eval_cache=True)
    off = _algo(c, name, frac=frac)
    s_on = on.init_state()
    assert s_on.eval_cache is not None
    s_off = dataclasses.replace(off.clone_state(s_on), eval_cache=None)
    count = _Count(on, "eval_client")
    for r in range(2):
        s_on, m_on = on.run_round(s_on, r)
        s_off, m_off = off.run_round(s_off, r)
        assert float(m_on["train_loss"]) == float(m_off["train_loss"])
        count.n["eval_client"] = 0
        ev_on, ev_off = _host(on.evaluate(s_on)), _host(off.evaluate(s_off))
        assert count.n["eval_client"] == 3  # the global half's only
        assert sorted(ev_on) == sorted(ev_off)
        for k in ev_on:
            if k.endswith("loss"):
                np.testing.assert_allclose(ev_on[k], ev_off[k],
                                           rtol=LOSS_RTOL)
            else:
                assert ev_on[k] == ev_off[k], (r, k)
    full = on._eval_personal(s_on.personal_params)
    cache = s_on.eval_cache
    for k in ("correct", "loss_sum", "total"):
        assert torch.equal(cache[k], full[k]), k
    _assert_matches_jax((cache["correct"], cache["loss_sum"],
                         cache["total"]), ev_on,
                        _jax_full_personal(jref, c, s_on.personal_params))


FUSED_CASES = [
    pytest.param("salientgrads", 1.0, dict(eval_cache=True),
                 id="sg-cache-full"),
    pytest.param("salientgrads", 0.5, dict(eval_cache=True),
                 id="sg-cache-sampled"),
    pytest.param("fedavg", 0.5, dict(eval_cache=True),
                 id="fedavg-cache-sampled"),
    pytest.param("salientgrads", 0.5, dict(eval_clients=2),
                 id="sg-subset-sampled"),
]


@pytest.mark.parametrize("name,frac,kw", FUSED_CASES)
def test_fused_eval_protocol_bitwise_run_round(cohort, name, frac, kw):
    """A fused block of two rounds with the eval after each (the cache's
    refresh inside the round body, the eval's re-reduce or subset in the
    eval graph) equals two ``run_round`` + ``evaluate`` calls bit for bit,
    the state's cache included, and leaves its input state's cache as it
    was."""
    c = cohort
    algo = _algo(c, name, frac=frac, **kw)
    s0 = algo.init_state()
    keep = None if s0.eval_cache is None else {
        k: v.clone() for k, v in s0.eval_cache.items()}
    su, evals, losses = algo.clone_state(s0), [], []
    for r in range(2):
        su, met = algo.run_round(su, r)
        losses.append(float(met["train_loss"]))
        evals.append(_host(algo.evaluate(su)))
    sf, ys = algo.run_rounds_fused(s0, 0, 2, eval_every=1)
    np.testing.assert_array_equal(ys["train_loss"], losses)
    for i, ev in enumerate(evals):
        assert {k: float(v[i]) for k, v in ys["eval"].items()} == ev, i
    for f in ("global_params", "personal_params", "eval_cache"):
        a, b = getattr(su, f), getattr(sf, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert all(torch.equal(a[k], b[k]) for k in a), f
    if keep is not None:
        assert all(torch.equal(keep[k], s0.eval_cache[k]) for k in keep)


@pytest.mark.parametrize("order", ["dropped-first", "cached-first"])
def test_fused_blocks_follow_the_state_cache(cohort, order):
    """One algorithm's fused blocks meet a state whose cache FedAvg's
    finalize dropped and one whose cache is live, in either order: each
    block equals ``run_round`` + ``evaluate`` from its state bit for bit,
    the cache included (None where it came in None)."""
    c = cohort
    algo = _algo(c, "fedavg", frac=0.5, eval_cache=True)
    s0 = algo.init_state()
    dropped, _ = algo.finalize(s0)
    assert dropped.eval_cache is None
    states = [dropped, s0] if order == "dropped-first" else [s0, dropped]
    for s in states:
        su, met = algo.run_round(s, 0)
        ev = _host(algo.evaluate(su))
        sf, ys = algo.run_rounds_fused(s, 0, 1, eval_every=1)
        assert float(ys["train_loss"][0]) == float(met["train_loss"])
        assert {k: float(v[0]) for k, v in ys["eval"].items()} == ev
        for f in ("personal_params", "eval_cache"):
            a, b = getattr(su, f), getattr(sf, f)
            assert (a is None) == (b is None) == (s.eval_cache is None
                                                  and f == "eval_cache"), f
            if a is not None:
                assert all(torch.equal(a[k], b[k]) for k in a), f


def test_fedavg_finalize_drops_eval_cache(cohort):
    """FedAvg's fine-tune retrains every personal row: its finalize drops
    the cache, and its final record is the cache-off twin's, bit for
    bit."""
    c = cohort
    on = _algo(c, "fedavg", eval_cache=True)
    off = _algo(c, "fedavg")
    s, _ = on.run_round(on.init_state(), 0)
    t_on, rec_on = on.finalize(s)
    t_off, rec_off = off.finalize(dataclasses.replace(off.clone_state(s),
                                                      eval_cache=None))
    assert s.eval_cache is not None and t_on.eval_cache is None
    assert _host(rec_on) == _host(rec_off)
    assert all(torch.equal(t_on.personal_params[k], t_off.personal_params[k])
               for k in t_off.personal_params)


@pytest.mark.parametrize("name", ["salientgrads", "fedavg"])
def test_eval_cache_constructor_refusals(cohort, name):
    """The cache needs the personal stack and the whole cohort: refused
    with ``track_personal=False`` and with ``eval_clients``, with the JAX
    package's messages."""
    c = cohort
    for kw in (dict(track_personal=False), dict(eval_clients=2)):
        with pytest.raises(ValueError) as e:
            _algo(c, name, eval_cache=True, **kw)
        jcls = JFedAvg
        if name == "salientgrads":
            from neuroimagedisttraining_tpu.algorithms import SalientGrads \
                as jcls
        with pytest.raises(ValueError) as je:
            jcls(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                 eval_cache=True, **kw)
        assert str(e.value) == str(je.value)
