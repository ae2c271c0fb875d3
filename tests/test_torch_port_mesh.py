"""The port's client mesh (``parallel/mesh.py``) and the on-mesh halves of
``parallel/collectives.py`` against the JAX package's own on-mesh reduce, on
the CPU: gloo ranks (one process each, ``tests/_torch_mesh_workers.py``) at
D = 2, 4 and 8 against the reference's ``make_mesh(D)`` on its 8-device CPU
mesh, on the inputs of ``tests/test_collectives.py`` and
``tests/test_agg_topk_hier.py`` (C = 8, buckets of 16).

Tolerances: against the unsharded dense aggregate 1e-5 (the reference's own
bound for its mesh); against the reference's on-mesh result 1e-6 of the
result's largest magnitude (both reassociate the sum across ranks, in other
orders). The int8 wire is fed the reference's uniforms at its seam
(``fold_in(fold_in(key, d), i)`` for rank, or slice, ``d`` and leaf ``i``);
its payloads and the bf16 one are held bit for bit on the same partials.
Each D spawns its ranks once for the module; the ranks import no JAX.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402
from neuroimagedisttraining_tpu.core.state import weighted_tree_sum  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402
from neuroimagedisttraining_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from neuroimagedisttraining_tpu.parallel import shard_over_clients as jshard  # noqa: E402
from neuroimagedisttraining_torch.convert import (  # noqa: E402
    from_reference_layout,
    reference_leaf_order,
    to_reference_layout,
)
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from neuroimagedisttraining_torch.parallel import mesh as tmesh  # noqa: E402

BUCKET = 16
C = 8
#: the aggregation micro-bench on a narrow tree
AGG_BENCH = dict(n_clients=4, iters=2, model_key="small3dcnn",
                 sample_shape=(8, 8, 8, 1))
KEY = 7  # the int8 wire's key
TOPK = 0.2


def _tree(c=C, key=1):
    """tests/test_collectives.py's tree (an odd-sized leaf for the bucket
    padding), as numpy."""
    k = jax.random.PRNGKey(key)
    t = {"conv": {"kernel": jax.random.normal(k, (c, 3, 5, 7)),
                  "bias": jax.random.normal(jax.random.fold_in(k, 1),
                                            (c, 7))},
         "head": {"kernel": jax.random.normal(jax.random.fold_in(k, 2),
                                              (c, 11, 13))}}
    return jax.tree_util.tree_map(np.asarray, t)


def _weights(c=C, seed=1):
    w = np.random.RandomState(seed).rand(c).astype(np.float32)
    return w / w.sum()


def _global_mask():
    k = jax.random.PRNGKey(9)
    m = {"conv": {"kernel": (jax.random.uniform(k, (3, 5, 7)) < 0.4)
                  .astype(jnp.float32), "bias": jnp.ones((7,))},
         "head": {"kernel": (jax.random.uniform(jax.random.fold_in(k, 1),
                                                (11, 13)) < 0.4)
                  .astype(jnp.float32)}}
    return jax.tree_util.tree_map(np.asarray, m)


def _client_masks(tree):
    k2 = jax.random.PRNGKey(11)
    return jax.tree_util.tree_map(
        lambda x: np.asarray((jax.random.uniform(
            jax.random.fold_in(k2, x.size), x.shape) < 0.5)
            .astype(jnp.float32)), tree)


def _dotted(tree):
    """A nested reference tree as ``{dotted name: numpy}``."""
    return {f"{m}.{n}": np.array(v) for m, sub in tree.items()
            for n, v in sub.items()}


def _port(tree, lead=1):
    """A reference tree (``lead`` leading client axes) in this package's
    layout: 2-D kernels transposed, as ``convert.py`` does for dense
    layers."""
    return {k: from_reference_layout(k, torch.from_numpy(v), lead=lead)
            .contiguous().numpy() for k, v in _dotted(tree).items()}


def _ref(port_tree):
    """A port result (numpy, this package's layout) in the reference's
    layout, by dotted name."""
    return {k: to_reference_layout(k, torch.from_numpy(v)).numpy()
            for k, v in port_tree.items()}


def _jref(jtree):
    """A reference result by dotted name, in the reference's layout."""
    return _dotted(jax.tree_util.tree_map(np.asarray, jtree))


def _err(a, b):
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b)


def _scale(b):
    return max(float(np.max(np.abs(v))) for v in b.values())


def _leaf_sizes(tree):
    names = reference_leaf_order(_port(tree))
    port = _port(tree)
    return [int(np.prod(port[k].shape[1:])) for k in names]


def _uniform_table(n_ids, sizes, key=KEY):
    """The reference's int8 draws of rank (or slice) ``d``, payload leaf
    ``i``: ``uniform(fold_in(fold_in(key, d), i), (nb, b))``."""
    out = {}
    for d in range(n_ids):
        kd = jax.random.fold_in(jax.random.PRNGKey(key), d)
        for i, n in enumerate(sizes):
            nb, b = tc.bucket_shape(n, BUCKET)
            out[(d, i)] = np.asarray(jax.random.uniform(
                jax.random.fold_in(kd, i), (nb, b)))
    return out


def _cases(d):
    """Every collective case of a D-rank mesh, run in one spawn."""
    tree, w = _tree(), _weights()
    pt = _port(tree)
    gm = _global_mask()
    honored = jax.tree_util.tree_map(lambda x, m: x * m[None], tree, gm)
    masks = _client_masks(tree)
    honored_m = jax.tree_util.tree_map(lambda x, m: x * m, tree, masks)
    sizes = _leaf_sizes(tree)
    kw = dict(bucket_size=BUCKET)
    cases = {
        "f32": ("reduce_case", dict(fn="weighted_mean", tree=pt, weights=w,
                                    kw=kw)),
        "bf16": ("reduce_case", dict(fn="weighted_mean", tree=pt, weights=w,
                                     kw=dict(kw, wire="bf16"))),
        "int8": ("reduce_case", dict(
            fn="weighted_mean", tree=pt, weights=w, kw=dict(kw, wire="int8"),
            uniforms=_uniform_table(d, sizes))),
        "hier_f32": ("reduce_case", dict(
            fn="weighted_mean", tree=pt, weights=w,
            kw=dict(kw, wire="f32", hier_inner=-1))),
        "sparse": ("reduce_case", dict(
            fn="sparse_weighted_mean", tree=_port(honored), weights=w, kw=kw,
            plan_mask=_port(gm, 0))),
        "sparse_masks": ("reduce_case", dict(
            fn="sparse_weighted_mean", tree=_port(honored_m), weights=w,
            kw=kw, masks=_port(masks), plan_mask=_port(masks),
            plan_stacked=True)),
        "hier_sparse": ("reduce_case", dict(
            fn="sparse_weighted_mean", tree=_port(honored), weights=w,
            kw=dict(kw, hier_inner=2), plan_mask=_port(gm, 0))),
        "topk": ("reduce_case", dict(
            fn="topk_weighted_mean", tree=_port(_tree(key=2)),
            weights=_weights(seed=2), kw=dict(kw, k_frac=TOPK))),
        "partials": ("partial_case", dict(tree=pt, weights=w,
                                          bucket_size=BUCKET)),
    }
    for inner in (2, 4):
        if inner < d and d % inner == 0:
            cases[f"hier_bf16_{inner}"] = ("reduce_case", dict(
                fn="weighted_mean", tree=pt, weights=w,
                kw=dict(kw, wire="bf16", hier_inner=inner)))
            cases[f"hier_int8_{inner}"] = ("reduce_case", dict(
                fn="weighted_mean", tree=pt, weights=w,
                kw=dict(kw, wire="int8", hier_inner=inner),
                uniforms=_uniform_table(d // inner, sizes)))
    if d == 2:
        cases["agg"] = ("agg_case", AGG_BENCH)
    if d == 4:
        # C = 5 does not divide over 4 ranks: every rank holds all 5 rows
        cases["c5"] = ("reduce_case", dict(
            fn="weighted_mean", tree=_port(_tree(c=5)),
            weights=_weights(c=5), kw=kw, shard=False))
    return cases



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The off-mesh side on one thread, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module", params=[2, 4, 8], ids=lambda d: f"D{d}")
def ranks(request, eight_devices):
    d = request.param
    cases = _cases(d)
    names = list(cases)
    got = mw.run_ranks(d, [cases[n] for n in names])
    return d, dict(zip(names, got))


def _jax_mean(d, rng=None, **kw):
    """The reference's on-mesh weighted mean, jitted as its round is."""
    mesh = jmake_mesh(d)
    tree, w = _tree(), _weights()
    fn = jax.jit(lambda t, wv, k: jc.weighted_mean(
        t, wv, mesh=mesh, bucket_size=BUCKET, rng=k, **kw))
    return fn(jshard(tree, mesh), jnp.asarray(w), rng)


def _same_on_every_rank(results):
    for r in results[1:]:
        for k in results[0]:
            np.testing.assert_array_equal(r[k], results[0][k])


@pytest.mark.parametrize("case,kw,dense_tol", [
    ("f32", {}, 1e-5),
    ("hier_f32", dict(hier_inner=-1), 1e-5),
    ("bf16", dict(wire="bf16"), 2e-2),
    ("int8", dict(wire="int8", rng=jax.random.PRNGKey(KEY)), 6e-2),
])
def test_weighted_mean_on_mesh_matches_reference(ranks, case, kw, dense_tol):
    """Every rank returns the same mean, within the wire's bound of the
    dense aggregate and within 1e-6 of the reference's on-mesh mean."""
    d, res = ranks
    _same_on_every_rank(res[case])
    got = _ref(res[case][0])
    want = _jref(_jax_mean(d, **kw))
    dense = _jref(weighted_tree_sum(_tree(), jnp.asarray(_weights())))
    assert _err(got, dense) < dense_tol
    assert _err(got, want) <= 1e-6 * _scale(want)


@pytest.mark.parametrize("wire,inner", [("bf16", 2), ("bf16", 4),
                                        ("int8", 2), ("int8", 4)])
def test_hier_wires_on_mesh_match_reference(ranks, wire, inner):
    """The two-stage reduce with a low-precision cross-slice wire (int8 on
    the reference's per-slice draws) against the reference's."""
    d, res = ranks
    case = f"hier_{wire}_{inner}"
    if case not in res:
        if d % inner:  # slices must tile the mesh, here as in the reference
            for resolve in (tc.resolve_hier_inner, jc.resolve_hier_inner):
                with pytest.raises(ValueError):
                    resolve(d, inner)
        else:  # one slice: both degrade to the exact f32 reduce
            assert tc.resolve_hier_inner(d, inner) == 0 == \
                jc.resolve_hier_inner(d, inner)
        return
    _same_on_every_rank(res[case])
    got = _ref(res[case][0])
    rng = jax.random.PRNGKey(KEY) if wire == "int8" else None
    want = _jref(_jax_mean(d, wire=wire, hier_inner=inner, rng=rng))
    assert _err(got, want) <= 1e-6 * _scale(want)


def test_sparse_on_mesh_matches_reference(ranks):
    """The compressed reduce under one global mask, and under per-client
    masks (numerator and denominator both reduced compressed), and through
    the hier reduce, against the reference's on mesh and the dense
    references."""
    d, res = ranks
    mesh = jmake_mesh(d)
    tree, w = _tree(), jnp.asarray(_weights())
    gm = _global_mask()
    plan = jc.build_sparse_plan(gm)
    honored = jax.tree_util.tree_map(lambda x, m: x * m[None], tree, gm)
    dense = _jref(weighted_tree_sum(honored, w))
    for case, hier in (("sparse", 0), ("hier_sparse", 2)):
        want = _jref(jax.jit(lambda t, wv: jc.sparse_weighted_mean(
            t, wv, plan, mesh=mesh, bucket_size=BUCKET, hier_inner=hier))(
                jshard(honored, mesh), w))
        got = _ref(res[case][0])
        assert _err(got, dense) < 1e-5
        assert _err(got, want) <= 1e-6 * _scale(want)
    masks = _client_masks(tree)
    honored_m = jax.tree_util.tree_map(lambda x, m: x * m, tree, masks)
    mplan = jc.build_sparse_plan(masks, stacked=True)
    want = _jref(jax.jit(lambda t, wv, m: jc.sparse_weighted_mean(
        t, wv, mplan, masks=m, mesh=mesh, bucket_size=BUCKET))(
            jshard(honored_m, mesh), w, masks))
    ref = _jref(jc.masked_weighted_mean(honored_m, w, masks))
    got = _ref(res["sparse_masks"][0])
    assert _err(got, ref) < 1e-5
    assert _err(got, want) <= 1e-6 * _scale(want)


def test_masked_weighted_mean_off_mesh():
    """The per-client-mask form off the mesh: ``sparse_weighted_mean(masks=)``
    bit-equal to the dense ``masked_weighted_mean``, and both within 1e-6
    of the reference's."""
    tree, w = _tree(), _weights()
    masks = _client_masks(tree)
    honored = jax.tree_util.tree_map(lambda x, m: x * m, tree, masks)
    t = {k: torch.from_numpy(v) for k, v in _port(honored).items()}
    m = {k: torch.from_numpy(v) for k, v in _port(masks).items()}
    tw = torch.from_numpy(w)
    plan = tc.build_sparse_plan(m, stacked=True)
    sp = tc.sparse_weighted_mean(t, tw, plan, masks=m, bucket_size=BUCKET)
    dense = tc.masked_weighted_mean(t, tw, m)
    for k in dense:
        assert torch.equal(sp[k], dense[k]), k
    want = _jref(jc.masked_weighted_mean(honored, jnp.asarray(w), masks))
    got = _ref({k: v.numpy() for k, v in dense.items()})
    assert _err(got, want) <= 1e-6 * _scale(want)


def test_topk_selection_is_local_on_mesh(ranks):
    """The top-k selection is per client: each rank's sparsified rows are
    bitwise the off-mesh selection's (and the reference's), the mean within
    1e-6 of the reference's on mesh."""
    d, res = ranks
    tree, w = _tree(key=2), _weights(seed=2)
    t = {k: torch.from_numpy(v) for k, v in _port(tree).items()}
    off_mean, off_sp = tc.topk_weighted_mean(t, torch.from_numpy(w), TOPK,
                                             bucket_size=BUCKET)
    mesh = jmake_mesh(d)
    j_mean, j_sp = jax.jit(lambda t, wv: jc.topk_weighted_mean(
        t, wv, TOPK, mesh=mesh, bucket_size=BUCKET))(
            jshard(tree, mesh), jnp.asarray(w))
    j_sp = _port(jax.tree_util.tree_map(np.asarray, j_sp))
    per = C // d
    for r, (mean, sp) in enumerate(res["topk"]):
        for k in sp:
            rows = slice(r * per, (r + 1) * per)
            np.testing.assert_array_equal(sp[k], off_sp[k][rows].numpy())
            np.testing.assert_array_equal(sp[k], j_sp[k][rows])
    want = _jref(j_mean)
    got = _ref(res["topk"][0][0])
    assert _err(got, _ref({k: v.numpy() for k, v in off_mean.items()})) \
        < 1e-5
    assert _err(got, want) <= 1e-6 * _scale(want)


def test_wire_payloads_bitwise(ranks):
    """The payloads a rank puts on the wire, on the same partial: bf16 the
    reference's cast, int8 the reference's (jitted) quantize on its
    uniforms, bit for bit; the rank's partial within 1e-6 of the
    reference's per-device ``tensordot``."""
    d, res = ranks
    tree, w = _tree(), _weights()
    port = _port(tree)
    names = reference_leaf_order(port)
    per = C // d
    quantize = jax.jit(jc._quantize_int8)
    for r, partials in enumerate(res["partials"]):
        kd = jax.random.fold_in(jax.random.PRNGKey(KEY), r)
        for i, k in enumerate(names):
            v = partials[k]
            rows = to_reference_layout(
                k, torch.from_numpy(port[k][r * per:(r + 1) * per]),
                lead=1).reshape(per, -1).numpy()
            want = np.asarray(jnp.tensordot(
                jnp.asarray(w[r * per:(r + 1) * per]), jnp.asarray(rows),
                axes=1))
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(
                torch.from_numpy(v).to(torch.bfloat16).view(torch.int16)
                .numpy(),
                np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
                .view(np.int16))
            nb, b = tc.bucket_shape(v.size, BUCKET)
            key = jax.random.fold_in(kd, i)
            u = np.asarray(jax.random.uniform(key, (nb, b)))
            q, s = tc._int8_leaf_payload(torch.from_numpy(np.array(v)),
                                         torch.from_numpy(np.array(u)),
                                         BUCKET)
            vb = jnp.pad(jnp.asarray(v), (0, nb * b - v.size)).reshape(nb, b)
            jq, js = quantize(vb, key)
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_indivisible_cohort_takes_the_off_mesh_reduce(ranks):
    """C = 5 on a 4-rank mesh: every rank runs the off-mesh reduce on all
    five rows, bitwise the port's own off-mesh mean (the reference's
    static fallback)."""
    d, res = ranks
    if d != 4:
        assert "c5" not in res
        return
    t5 = {k: torch.from_numpy(v) for k, v in _port(_tree(c=5)).items()}
    want = tc.weighted_mean(t5, torch.from_numpy(_weights(c=5)),
                            bucket_size=BUCKET)
    for got in res["c5"]:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].numpy())


class _Shape:
    """A mesh as the row rule reads it: its axis names and sizes."""

    def __init__(self, d):
        self.axis_names = ("clients",)
        self.shape = {"clients": d}


def test_mesh_axis_rows_is_the_reference_rule(eight_devices):
    """The rule that picks the on-mesh path, the reference's on every mesh
    width 1-8 and cohort 0-17: D <= 1, or C not divisible by D, takes the
    off-mesh path (so a one-rank mesh never reduces on the mesh)."""
    for d in range(1, 9):
        jm = jmake_mesh(d)
        for c in range(18):
            assert tc._mesh_axis_rows(_Shape(d), "clients", c) == \
                jc._mesh_axis_rows(jm, "clients", c), (d, c)
    assert tc._mesh_axis_rows(None, "clients", 8) == 0
    assert tc._mesh_axis_rows(_Shape(4), "space", 8) == 0


def test_resolve_hier_inner_is_the_reference_rule():
    """``resolve_hier_inner`` on every axis size 1-16 and every request,
    errors included, as the reference's."""
    for n in range(1, 17):
        for req in range(-2, 18):
            try:
                want = jc.resolve_hier_inner(n, req)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tc.resolve_hier_inner(n, req)
                assert str(got.value) == str(e)
                continue
            assert tc.resolve_hier_inner(n, req) == want, (n, req)
            if want:
                assert tc._hier_index_groups(n, want) == \
                    jc._hier_index_groups(n, want)


def test_mesh_helpers():
    """The block rule is the reference's ``P("clients")`` layout, the device
    fit its ``fit_client_devices``, and ``shard_federated`` keeps a rank's
    block of the arrays and the whole counts."""
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_tpu.parallel.mesh import \
        fit_client_devices as jfit

    for n in range(0, 20):
        for avail in range(0, 10):
            assert tmesh.fit_client_devices(n, avail) == jfit(n, avail)
    m = tmesh.ClientMesh(None, 2, 4, torch.device("cpu"))
    assert m.block(8) == (4, 6) and m.shape == {"clients": 4}
    with pytest.raises(ValueError):
        m.block(6)
    data = make_synthetic_federated(seed=1, n_clients=8, samples_per_client=4,
                                    test_per_client=2, sample_shape=(2, 2, 2,
                                                                     1))
    mine = tmesh.shard_federated(data, m)
    assert tmesh.mesh_of(mine) is m and tmesh.mesh_of(data) is None
    assert mine.num_clients == 8 and mine.x_train.shape[0] == 2
    assert torch.equal(mine.x_train, data.x_train[4:6])
    assert torch.equal(mine.y_test, data.y_test[4:6])
    assert torch.equal(mine.n_train, data.n_train)
    assert mine.x_train.data_ptr() != data.x_train[4:6].data_ptr()


def test_agg_microbench_times_every_impl(ranks):
    """``agg_microbench`` (``bench_torch.py``'s ``BENCH_CONFIG=agg``) on a
    narrow tree, off the mesh and on 2 ranks: every ``agg_impl`` timed,
    under ``bench.py``'s key names (its modeled ``wire_bytes_<impl>`` left
    out), and the bench's line under ``bench.py``'s metric, refused without
    CUDA."""
    import pathlib
    import sys

    d, res = ranks
    if d != 2:
        assert "agg" not in res
        return
    root = pathlib.Path(__file__).resolve().parent.parent
    off = tc.agg_microbench(None, device="cpu", **AGG_BENCH)
    want = {f"agg_ms_{impl}" for impl in jc.AGG_IMPLS}
    for got, n_dev in [(off, 1)] + [(r, 2) for r in res["agg"]]:
        assert {k for k in got if k.startswith("agg_ms_")} == want
        assert all(np.isfinite(got[k]) and got[k] > 0 for k in want)
        assert (got["n_clients"], got["n_devices"]) == (4, n_dev)
        assert got["n_params"] == 3729 and 0.4 < got["sparse_density"] < 0.6
    sys.path.insert(0, str(root))
    try:
        import bench_torch
    finally:
        sys.path.remove(str(root))
    assert bench_torch.AGG_METRIC in (root / "bench.py").read_text()
    if not torch.cuda.is_available():
        assert bench_torch.agg(emit=False) is None
