"""The port's robustness tier (``neuroimagedisttraining_torch/robust``, the
guarded round body) against the JAX package's, on the CPU.

The reference's random draws are fed to the port at its seams: the fault
draws (``RoundInputs.faults``: per client the reference's ``u[4]``, straggle
fraction and ``u2[3]``, from ``fold_in`` of (seed, salt, round, client id)),
the colluders' Rademacher tree, the weak-DP noise (per client and leaf,
``jax.random.normal`` on the split defense key), the epoch permutations and
the int8 uniforms.

Tolerances: the parser, the injector, the label flip, every guard function,
the wire roundtrip and the robust order statistics (median, trimmed mean)
and Krum's pick bit for bit; Multi-Krum's mean within 1e-6 (its Gram
matrix sums in another order); the norm clip within 1e-6 relative (its
norm does); whole rounds, SalientGrads and FedAvg with faults, the guard, a
robust statistic and a defense, as ``tests/test_torch_port_wires.py``
holds the wires (rtol 1e-5, atol 2e-7, int8 norm-wise 1e-4), the counters
equal. In the port a guarded clean round equals the unguarded one and the
fused loop equals the eager one, bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.algorithms.base import \
    sample_client_indexes as jsample  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402
from neuroimagedisttraining_tpu.robust import aggregation as jagg  # noqa: E402
from neuroimagedisttraining_tpu.robust import faults as jfaults  # noqa: E402
from neuroimagedisttraining_tpu.robust import guard as jguard  # noqa: E402
from neuroimagedisttraining_tpu.robust import recovery as jrecovery  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvg,
    FedAvgState,
    SalientGrads,
    SalientGradsState,
    sample_client_indexes,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
    zeros_like_tree,
)
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from neuroimagedisttraining_torch.robust import aggregation as tagg  # noqa: E402
from neuroimagedisttraining_torch.robust import faults as tfaults  # noqa: E402
from neuroimagedisttraining_torch.robust import guard as tguard  # noqa: E402
from neuroimagedisttraining_torch.robust import recovery as trecovery  # noqa: E402

N = pc.N_CLIENTS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small CPU ops: one torch thread keeps them fast among the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the reference's draws ----------------------------------------------------

def jax_fault_draws(seed, round_idx, client_ids):
    """The reference injector's per-client draws as the port's ``[S, 8]``
    seam: ``u[4]``, the straggle fraction, ``u2[3]``."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), jfaults.FAULT_SALT)
    rkey = jax.random.fold_in(base, jnp.int32(round_idx))
    rows = []
    for cid in client_ids:
        k = jax.random.fold_in(rkey, int(cid))
        u = jax.random.uniform(k, (4,))
        frac = jax.random.uniform(jax.random.fold_in(k, 1), minval=0.25,
                                  maxval=0.75)
        u2 = jax.random.uniform(jax.random.fold_in(k, 2), (3,))
        rows.append(np.concatenate([np.asarray(u), [np.asarray(frac)],
                                    np.asarray(u2)]))
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def jax_collude(seed, round_idx, jtree):
    """The reference's colluders' direction for a round (numpy leaves)."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), jfaults.FAULT_SALT)
    rkey = jax.random.fold_in(base, jnp.int32(round_idx))
    dkey = jax.random.fold_in(rkey, jfaults.COLLUDE_SALT)
    leaves, treedef = jax.tree_util.tree_flatten(jtree)
    keys = jax.random.split(dkey, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.rademacher(k, x.shape, x.dtype))
        for k, x in zip(keys, leaves)])


def jax_dp_noise(defense_key, jparams, s):
    """The reference weak-DP draw of ``s`` clients, as the port's stacked
    tree."""
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rows = []
    for ck in jax.random.split(defense_key, s):
        lk = jax.random.split(ck, len(leaves))
        rows.append(jax_params_to_torch(pc.np_tree(
            jax.tree_util.tree_unflatten(treedef, [
                jax.random.normal(k, x.shape, jnp.float32)
                for k, x in zip(lk, leaves)]))))
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def round_draws(rng, c):
    """One reference round's draws: next key, permutations, int8 uniforms,
    the defense key."""
    rng, round_key = jax.random.split(rng)
    keys = jax.random.split(round_key, N + 1)
    nb, b = tc.bucket_shape(c["n_params"], pc.BUCKET)
    u = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(round_key, pc.AGG_SALT), (N, nb, b))))
    return rng, pc.perms_from_keys(keys, c), u, keys[N]


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# -- the parser ---------------------------------------------------------------

SPECS = ["", "drop=0.2", "drop=0.2,straggle=0.1,nan=0.05,scale=0.02:100x",
         "scale=0.5:7X", "collude=0.3:4x,signflip=0.1,labelflip=0.25",
         " drop = 0.5 , ,nan=1"]
BAD_SPECS = ["drop", "bogus=0.1", "drop=0.1:3x", "scale=0.1:0x",
             "nan=1.5", "drop=0.1,drop=0.2", "straggle=-0.1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_reference(spec):
    j, t = jfaults.parse_fault_spec(spec), tfaults.parse_fault_spec(spec)
    if j is None:
        assert t is None
        return
    assert tuple(t.__dataclass_fields__) == tuple(j.__dataclass_fields__)
    for f in j.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.describe() == j.describe() and t.any_active == j.any_active


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_fault_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as je:
        jfaults.parse_fault_spec(spec)
    with pytest.raises(ValueError) as te:
        tfaults.parse_fault_spec(spec)
    assert str(te.value) == str(je.value)


# -- the injector and the label flip ------------------------------------------

S_INJ, SEED = 6, 3
INJECT_SPECS = {
    "drop": "drop=0.5", "straggle": "straggle=0.6", "nan": "nan=0.4",
    "scale": "scale=0.5:30x", "signflip": "signflip=0.5",
    "collude": "collude=0.5:4x",
    "mixed": "drop=0.3,straggle=0.5,nan=0.2,scale=0.4:9x,signflip=0.4,"
             "collude=0.3:3x",
}


def _stack_and_global(seed=0):
    rng = np.random.RandomState(seed)
    g = {"a": rng.randn(3, 4).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    st = {k: (v[None] + 0.1 * rng.randn(S_INJ, *v.shape)).astype(np.float32)
          for k, v in g.items()}
    return st, g


@pytest.mark.parametrize("kind", sorted(INJECT_SPECS))
def test_injector_matches_reference_bitwise(kind):
    spec = INJECT_SPECS[kind]
    st, g = _stack_and_global()
    ids = np.array([4, 0, 9, 2, 7, 5], np.int32)
    jfn = jfaults.make_fault_fn(jfaults.parse_fault_spec(spec), SEED)
    jout, jdrop = jfn(st, g, jnp.asarray(ids), jnp.float32(2))
    tfn = tfaults.make_fault_fn(tfaults.parse_fault_spec(spec), SEED)
    direction = (_t(jax_collude(SEED, 2, g)) if "collude" in spec else None)
    tout, tdrop = tfn(_t(st), _t(g), jax_fault_draws(SEED, 2, ids),
                      direction)
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    for k in st:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    trace = jfaults.fault_trace_round(jfaults.parse_fault_spec(spec), SEED,
                                      2, ids)
    assert any(v.any() for v in trace.values()), spec  # something fired
    # a client with no fault passes through as it was
    clean = ~np.any(np.stack(list(trace.values())), axis=0)
    for k in st:
        np.testing.assert_array_equal(tout[k].numpy()[clean], st[k][clean])


@pytest.mark.parametrize("dtype,num_classes", [
    (np.int32, 1), (np.int32, 2), (np.int32, 3), (np.float32, 1)])
def test_labelflip_matches_reference_bitwise(dtype, num_classes):
    spec = "labelflip=0.5"
    ids = np.arange(8, dtype=np.int32)
    rng = np.random.RandomState(1)
    y = rng.randint(0, max(num_classes, 2), (8, 5)).astype(dtype)
    jflip = jfaults.make_labelflip_fn(jfaults.parse_fault_spec(spec), SEED,
                                      num_classes)
    want = np.asarray(jflip(jnp.asarray(y), jnp.asarray(ids),
                            jnp.float32(1)))
    tspec = tfaults.parse_fault_spec(spec)
    flags = tfaults.labelflip_flags(tspec, jax_fault_draws(SEED, 1, ids))
    tflip = tfaults.make_labelflip_fn(tspec, SEED, num_classes)
    got = tflip(torch.from_numpy(y), flags[:, None])
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(flags.sum()) < 8
    assert tfaults.make_labelflip_fn(tfaults.parse_fault_spec("nan=1"),
                                     SEED, 2) is None


def test_own_fault_draws_are_keyed_by_population_id():
    """The port's own draws: a pure function of (seed, round, client id),
    whatever the cohort; the host replay reads the same draws."""
    spec = tfaults.parse_fault_spec("drop=0.5,nan=0.5,labelflip=0.5")
    a = tfaults.client_draws(5, 3, [7, 1, 4])
    b = tfaults.client_draws(5, 3, [4, 9, 7])
    assert torch.equal(a[0], b[2]) and torch.equal(a[2], b[0])
    assert not torch.equal(tfaults.client_draws(5, 4, [7]), a[:1])
    assert not torch.equal(tfaults.client_draws(6, 3, [7]), a[:1])
    assert bool(((a[:, 4] >= 0.25) & (a[:, 4] < 0.75)).all())
    trace = tfaults.fault_trace_round(spec, 5, 3, [7, 1, 4])
    np.testing.assert_array_equal(trace["dropped"], (a[:, 0] < 0.5).numpy())
    np.testing.assert_array_equal(trace["labelflipped"],
                                  (a[:, 7] < 0.5).numpy())
    d1 = tfaults.collude_direction(5, 3, {"w": torch.zeros(4, 5)})
    d2 = tfaults.collude_direction(5, 3, {"w": torch.zeros(4, 5)})
    assert torch.equal(d1["w"], d2["w"])
    assert set(d1["w"].unique().tolist()) <= {-1.0, 1.0}


# -- the guard ----------------------------------------------------------------

def _guard_case(bad):
    st, g = _stack_and_global(1)
    if bad:
        st["a"][1, 0, 2] = np.nan
        st["b"][4, 3] = np.inf
    w = np.array([3, 5, 2, 4, 6, 1], np.float32)
    w = w / w.sum()
    ok = np.array([True, not bad, True, True, not bad, True])
    return st, g, w, ok


@pytest.mark.parametrize("bad", [False, True], ids=["clean", "quarantined"])
def test_guard_functions_match_reference_bitwise(bad):
    st, g, w, ok = _guard_case(bad)
    np.testing.assert_array_equal(
        tguard.finite_screen(_t(st)).numpy(),
        np.asarray(jguard.finite_screen(st)))
    np.testing.assert_array_equal(
        np.asarray(jguard.finite_screen(st)), ok)
    js, jw, jn = jguard.quarantine(st, jnp.asarray(w), jnp.asarray(ok))
    ts, tw, tn = tguard.quarantine(_t(st), torch.from_numpy(w),
                                   torch.from_numpy(ok))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int(tn) == int(jn) == int(ok.sum())
    for k in st:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    if not bad:  # the clean no-op: the inputs as they were
        np.testing.assert_array_equal(tw.numpy(), w)
        for k in st:
            np.testing.assert_array_equal(ts[k].numpy(), st[k])
    prev = {k: v + 1.0 for k, v in st.items()}
    jr = jguard.merge_residual(jnp.asarray(ok), st, prev)
    tr = tguard.merge_residual(torch.from_numpy(ok), _t(st), _t(prev))
    personal = {k: np.stack([v[0] * (c + 2) for c in range(8)])
                for k, v in st.items()}
    sel = np.array([6, 0, 3, 7, 1, 2], np.int32)
    ju = jguard.merge_updates(jnp.asarray(ok), st, personal,
                              jnp.asarray(sel))
    tu = tguard.merge_updates(torch.from_numpy(ok), _t(st), _t(personal),
                              torch.from_numpy(sel.astype(np.int64)))
    for k in st:
        np.testing.assert_array_equal(tr[k].numpy(), np.asarray(jr[k]))
        np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
    for survivors in (0, 2):
        jc_ = jguard.carry_if_empty(g, prev, jnp.int32(survivors))
        tc_ = tguard.carry_if_empty(_t(g), _t(prev),
                                    torch.tensor(survivors, dtype=torch.int32))
        for k in g:
            np.testing.assert_array_equal(tc_[k].numpy(),
                                          np.asarray(jc_[k]))


@pytest.mark.parametrize("bad", [False, True], ids=["clean", "quarantined"])
def test_guarded_aggregate_matches_reference(bad):
    """The guarded weighted mean: within 1e-6 of the reference's (the two
    frameworks' contractions); in the port a clean round is bitwise its
    unguarded aggregate, and no survivor carries the fallback."""
    from neuroimagedisttraining_tpu.core.state import weighted_tree_sum

    st, g, w, ok = _guard_case(bad)
    want = jguard.guarded_aggregate(st, jnp.asarray(w), jnp.asarray(ok),
                                    weighted_tree_sum, g)

    def agg(s, wv):
        return tc.weighted_mean(s, wv)

    got = tguard.guarded_aggregate(_t(st), torch.from_numpy(w),
                                   torch.from_numpy(ok), agg, _t(g))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        assert bool(torch.isfinite(got[k]).all())
    if not bad:
        plain = agg(_t(st), torch.from_numpy(w))
        for k in g:
            assert torch.equal(got[k], plain[k]), k
    none = tguard.guarded_aggregate(_t(st), torch.from_numpy(w),
                                    torch.zeros(S_INJ, dtype=torch.bool),
                                    agg, _t(g))
    for k in g:
        assert torch.equal(none[k], _t(g)[k])


# -- the robust statistics and the defenses -----------------------------------

def _mat_case(masked, seed=2):
    rng = np.random.RandomState(seed)
    mat = rng.randn(7, 40).astype(np.float32)
    mat[5] *= 30.0  # an outlier row
    w = np.full(7, 1 / 7, np.float32)
    if masked:
        w[[1, 5]] = 0.0
        mat[1, 3] = np.nan  # a quarantined row's poison never votes
    return mat, w


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("kind", jagg.ROBUST_AGGS[1:])
def test_robust_combine_mat_matches_reference(kind, masked):
    mat, w = _mat_case(masked)
    kw = dict(trim_frac=0.2, krum_f=0, norm_bound=5.0)
    want = np.asarray(jagg.robust_combine_mat(jnp.asarray(mat),
                                              jnp.asarray(w), kind, **kw))
    got = tagg.robust_combine_mat(torch.from_numpy(mat),
                                  torch.from_numpy(w), kind, **kw).numpy()
    if kind in ("median", "trimmed_mean", "krum"):
        np.testing.assert_array_equal(got, want)
    elif kind == "norm_krum":
        # the same row picked; its clip factor's norm sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(np.isfinite(got))


def test_robust_combine_mat_edges():
    mat, w = _mat_case(False)
    one = np.zeros(7, np.float32)
    one[3] = 1.0
    for kind in ("krum", "median", "trimmed_mean", "multikrum"):
        got = tagg.robust_combine_mat(torch.from_numpy(mat),
                                      torch.from_numpy(one), kind).numpy()
        want = np.asarray(jagg.robust_combine_mat(
            jnp.asarray(mat), jnp.asarray(one), kind))
        np.testing.assert_array_equal(got, want)
        if kind != "multikrum":  # one survivor: its own row
            np.testing.assert_array_equal(got, mat[3])
    assert tagg.resolve_krum_f(0, 8) == jagg.resolve_krum_f(0, 8) == 2
    assert tagg.resolve_krum_f(3, 8) == 3
    with pytest.raises(ValueError, match="not a robust estimator"):
        tagg.robust_combine_mat(torch.from_numpy(mat), torch.from_numpy(w),
                                "none")


def test_defenses_match_reference():
    """norm_diff_clipping within 1e-6 relative (the norm's summation
    order), weak-DP with the reference's noise fed, within the same."""
    st, g = _stack_and_global(4)
    st = {k: v * 20 for k, v in st.items()}  # some rows past the bound
    key = jax.random.PRNGKey(7)
    for dtype in ("norm_diff_clipping", "weak_dp"):
        jd = jagg.RobustAggregator(dtype, norm_bound=3.0, stddev=0.05)
        want = jd.apply(st, g, key)
        leaves, treedef = jax.tree_util.tree_flatten(g)
        rows = []
        for ck in jax.random.split(key, S_INJ):
            lk = jax.random.split(ck, len(leaves))
            rows.append(jax.tree_util.tree_unflatten(treedef, [
                np.asarray(jax.random.normal(k, x.shape, jnp.float32))
                for k, x in zip(lk, leaves)]))
        noise = {k: torch.from_numpy(np.stack([r[k] for r in rows]))
                 for k in g}
        got = tagg.RobustAggregator(dtype, norm_bound=3.0,
                                    stddev=0.05).apply(_t(st), _t(g), noise)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)
    assert tagg.RobustAggregator("none").apply(_t(st), _t(g)) is not None
    with pytest.raises(ValueError, match="unknown defense"):
        tagg.RobustAggregator("clip")


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_wire_roundtrip_mat_matches_reference_bitwise(wire):
    rng = np.random.RandomState(5)
    mat = rng.randn(4, 1000).astype(np.float32)
    key = jax.random.PRNGKey(3)
    # jitted, as the reference's round runs it (XLA's scale spelling)
    want = np.asarray(jax.jit(lambda m, k: jc.wire_roundtrip_mat(
        m, wire, bucket_size=256, rng=k if wire == "int8" else None))(
            jnp.asarray(mat), key))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (4, 4, 256))))
    got = tc.wire_roundtrip_mat(torch.from_numpy(mat), wire,
                                bucket_size=256,
                                uniforms=u if wire == "int8" else None)
    np.testing.assert_array_equal(got.numpy(), want)
    if wire == "int8":
        # one client's decoded row is its contribution to the reducing wire
        w = torch.tensor([1.0, 0.0, 0.0, 0.0])
        red = tc._reduce_mat(torch.from_numpy(mat), w, bucket_size=256,
                             wire="int8", uniforms=u)
        assert torch.equal(red, got[0])


# -- guarded, faulted, robust rounds ------------------------------------------

@pytest.fixture(scope="module")
def cohort():
    return pc.cohort()


def _port_state(cls, jstate, mask=False, topk=False):
    params = jax_params_to_torch(pc.np_tree(jstate.global_params))
    kw = dict(global_params=params,
              personal_params=broadcast_tree(params, N),
              generator=torch.Generator(),
              agg_residual=(zeros_like_tree(broadcast_tree(params, N))
                            if topk else None))
    if mask:
        kw["mask"] = jax_params_to_torch(pc.np_tree(jstate.mask))
    return cls(**kw)


ROUND_CASES = {
    # SalientGrads on the dense wire: drops, NaN, scaling, label flips
    # (one survivor in round 0), Krum, the weak-DP defense and its re-mask
    "salientgrads_krum_weak_dp": dict(
        algo="salientgrads", impl="dense", seed=11, robust="krum",
        spec="drop=0.3,nan=0.3,scale=0.3:10x,labelflip=0.3",
        defense="weak_dp"),
    # FedAvg on the int8 wire: stragglers, collusion, label flips, the
    # median of the wire-decoded deltas, the norm clip
    "fedavg_int8_median_clip": dict(
        algo="fedavg", impl="int8", seed=0, robust="median",
        spec="straggle=0.4,signflip=0.3,collude=0.4:5x,labelflip=0.4,"
             "nan=0.2", defense="norm_diff_clipping"),
    # SalientGrads top-k under the guard with a NaN client each round
    "salientgrads_topk_nan": dict(
        algo="salientgrads", impl="topk", seed=0, robust="none",
        spec="nan=0.34", defense=None),
}


def _algos(c, case):
    spe = c["spe"]
    jcls, tcls = ((JSalientGrads, SalientGrads)
                  if case["algo"] == "salientgrads" else (JFedAvg, FedAvg))
    kw = dict(loss_type="bce", frac=1.0, seed=case["seed"],
              agg_bucket_size=pc.BUCKET, agg_topk_density=pc.DENSITY,
              agg_impl=case["impl"], fault_spec=case["spec"],
              robust_agg=case["robust"])
    jextra = dict(agg_kernels="pallas")
    textra = {}
    if case["algo"] == "salientgrads":
        kw.update(dense_ratio=0.5, itersnip_iterations=1)
        jextra["fused_kernels"] = True
    if case["defense"]:
        jextra["defense"] = jagg.RobustAggregator(case["defense"], 5.0, 0.025)
        textra["defense"] = tagg.RobustAggregator(case["defense"], 5.0,
                                                  0.025)
    return (jcls(c["jm"], c["jd"], pc.hp(JHyperParams, spe), **kw, **jextra),
            tcls(c["tm"], c["td"], pc.hp(HyperParams, spe), device="cpu",
                 **kw, **textra))


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_robust_round_matches_reference(cohort, name):
    c, case = cohort, ROUND_CASES[name]
    jalgo, talgo = _algos(c, case)
    sg = case["algo"] == "salientgrads"
    topk = case["impl"] == "topk"
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    if topk:
        jstate = jstate.replace(agg_residual=jax.tree_util.tree_map(
            jnp.zeros_like, jstate.personal_params))
    state = _port_state(SalientGradsState if sg else FedAvgState, jstate,
                        mask=sg, topk=topk)
    prev_personal = state.personal_params
    rng = jstate.rng
    ids = np.arange(N)
    jparams = pc.np_tree(jstate.global_params)
    for r in range(2):
        rng, perms, u, dkey = round_draws(rng, c)
        seams = dict(perms=perms, faults=jax_fault_draws(case["seed"], r,
                                                         ids))
        if case["impl"] == "int8":
            seams["agg_uniforms"] = u
        if "collude" in case["spec"]:
            seams["collude"] = jax_params_to_torch(
                jax_collude(case["seed"], r, jparams))
        if case["defense"] == "weak_dp":
            seams["dp_noise"] = jax_dp_noise(dkey, jparams, N)
        trace = jfaults.fault_trace_round(jalgo.fault_spec, case["seed"], r,
                                          ids)
        jstate, jmet = jalgo.run_round(jstate, r)
        state, tmet = talgo.run_round(state, r, **seams)
        for k in ("clients_dropped", "clients_quarantined"):
            assert float(tmet[k]) == float(jmet[k]), (r, k)
        assert float(tmet["clients_dropped"]) == trace["dropped"].sum()
        np.testing.assert_allclose(
            float(tmet["train_loss"]), float(jmet["train_loss"]),
            rtol=1e-4 if case["impl"] == "int8" else 1e-5)
        # quarantined and dropped clients keep their previous personal rows
        ok = ~(trace["dropped"] | trace["poisoned"])
        for i in np.nonzero(~ok)[0]:
            for k, v in state.personal_params.items():
                assert torch.equal(v[i], prev_personal[k][i]), (r, i, k)
        prev_personal = state.personal_params
    impl = "int8" if case["impl"] == "int8" else "dense"
    pc.compare(state.global_params, jstate.global_params, impl)
    pc.compare(state.personal_params, jstate.personal_params, impl,
               stacked=True)
    for v in state.global_params.values():
        assert bool(torch.isfinite(v).all())
    if topk:
        pc.compare_residual(state.agg_residual, jstate.agg_residual,
                            jstate.personal_params)
        for v in state.agg_residual.values():
            assert bool(torch.isfinite(v).all())
    if sg:
        for k, m in state.mask.items():
            assert torch.all(state.global_params[k][m == 0] == 0), k


def _port_only(c, **kw):
    algo = SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                        device="cpu", agg_bucket_size=pc.BUCKET,
                        agg_topk_density=pc.DENSITY, **kw)
    return algo, algo.init_state()


@pytest.mark.parametrize("impl", ["dense", "int8", "topk"])
def test_clean_guarded_round_is_bitwise_unguarded(cohort, impl):
    """Guard on, no client faulted: the round equals the unguarded one bit
    for bit (the quarantine's selects keep every row and the weights)."""
    c = cohort
    off, s0 = _port_only(c, agg_impl=impl)
    on, _ = _port_only(c, agg_impl=impl, guard=True)
    a, ma = off.run_round(off.clone_state(s0), 0)
    b, mb = on.run_round(on.clone_state(s0), 0)
    assert float(mb["clients_quarantined"]) == 0.0
    assert float(ma["train_loss"]) == float(mb["train_loss"])
    for f in ("global_params", "personal_params", "agg_residual"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None)
        for k in x or {}:
            assert torch.equal(x[k], y[k]), (f, k)


def test_zero_survivor_round_carries_previous_global(cohort):
    """Every client poisoned: the previous global model carries bit for bit
    and every personal row is kept."""
    c = cohort
    algo, s0 = _port_only(c, fault_spec="nan=1.0")
    s1, met = algo.run_round(algo.clone_state(s0), 0)
    assert float(met["clients_quarantined"]) == N
    for k in s0.global_params:
        assert torch.equal(s1.global_params[k], s0.global_params[k]), k
        assert torch.equal(s1.personal_params[k], s0.personal_params[k]), k
    with pytest.raises(ValueError, match="requires the guard"):
        _port_only(c, fault_spec="drop=0.5", guard=False)


@pytest.mark.parametrize("impl,robust", [("dense", "multikrum"),
                                         ("topk", "trimmed_mean"),
                                         ("int8", "norm_krum"),
                                         ("int8", "none")])
def test_fused_rounds_bitwise_eager_under_faults(cohort, impl, robust):
    """Two fused rounds (the CPU runs the body a graph holds) equal two
    eager ones, with the port's own keyed fault draws, under the guard, a
    robust statistic and the weak-DP defense."""
    c = cohort
    algo, s0 = _port_only(
        c, agg_impl=impl, robust_agg=robust,
        fault_spec="drop=0.2,nan=0.3,scale=0.3:50x,labelflip=0.3",
        defense=tagg.RobustAggregator("weak_dp", 5.0, 0.025))
    e, hist = algo.clone_state(s0), []
    for r in range(2):
        e, met = algo.run_round(e, r)
        hist.append({k: float(v) for k, v in met.items()})
    f, ys = algo.run_rounds_fused(algo.clone_state(s0), 0, 2)
    for name in algo._round_metric_names:
        assert [h[name] for h in hist] == list(ys[name]), name
    for fld in ("global_params", "personal_params", "agg_residual"):
        x, y = getattr(e, fld), getattr(f, fld)
        for k in x or {}:
            assert torch.equal(x[k], y[k]), (fld, k)
    assert torch.equal(e.generator.get_state(), f.generator.get_state())


# -- the watchdog -------------------------------------------------------------

def test_retry_cohorts_match_reference():
    for r in range(4):
        for retry in range(3):
            np.testing.assert_array_equal(
                sample_client_indexes(r, 10, 4, retry=retry),
                jsample(r, 10, 4, retry=retry))
    np.testing.assert_array_equal(sample_client_indexes(2, 5, 5, retry=2),
                                  np.arange(5))


class _S:
    def __init__(self, **leaves):
        self.global_params = leaves


def test_watchdog_verdicts_match_reference():
    """A scripted run through both watchdogs: the same verdict for every
    attempt, the same per-round and total counters, the same backoff; and
    the same rollback: the state in hand, else the reference's error when
    there is no checkpoint to restore from."""
    script = [  # (round, train_loss, update scale)
        (0, 0.5, 1.0), (1, float("nan"), 1.0), (1, 9.0, 1.0),
        (1, 0.4, 1.0), (2, 0.3, 50.0), (2, float("inf"), 1.0),
        (2, float("nan"), 1.0), (3, 0.1, 1.0)]
    sleeps = {"j": [], "t": []}
    kw = dict(max_retries=2, backoff_s=0.5, loss_threshold=5.0,
              norm_threshold=10.0)
    jw = jrecovery.RoundWatchdog(sleep=sleeps["j"].append, **kw)
    tw = trecovery.RoundWatchdog(sleep=sleeps["t"].append, **kw)
    base = np.ones((3, 4), np.float32)
    for r, loss, scale in script:
        jv = jw.judge(r, {"train_loss": jnp.float32(loss)},
                      _S(w=jnp.asarray(base * (1 + scale))),
                      _S(w=jnp.asarray(base)))
        tv = tw.judge(r, {"train_loss": torch.tensor(loss)},
                      _S(w=torch.from_numpy(base * (1 + scale))),
                      _S(w=torch.from_numpy(base)))
        assert tv == jv, (r, loss, scale)
        assert tw.round_counters() == jw.round_counters()
    assert tw.totals() == jw.totals() == {"rounds_retried": 4.0,
                                          "rounds_skipped": 1.0}
    assert sleeps["t"] == sleeps["j"]
    prev = _S(w=torch.ones(2))
    assert tw.rollback(prev) is prev
    with pytest.raises(RuntimeError) as te:
        tw.rollback(None)
    with pytest.raises(RuntimeError) as je:
        jw.rollback(None)
    assert str(te.value) == str(je.value)
    assert trecovery.tree_finite({"a": torch.ones(2), "n": torch.ones(1,
                                  dtype=torch.int64)})
    assert not trecovery.tree_finite(
        {"w": torch.tensor([1.0, float("nan")])})


def test_watchdog_retry_redraws_the_cohort(cohort):
    """Under a retry nonce the round trains the re-drawn cohort, and the
    port's fault draws follow the population ids it drew."""
    c = cohort
    algo = SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                        device="cpu", frac=0.67, fault_spec="nan=0.5")
    assert algo.clients_per_round == 2
    for nonce in (0, 1, 2):
        algo.set_retry_nonce(nonce)
        np.testing.assert_array_equal(algo._selected_client_indexes(3),
                                      jsample(3, N, 2, retry=nonce))
    algo.set_retry_nonce(0)
