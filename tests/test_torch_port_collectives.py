"""The port's aggregation wires (``neuroimagedisttraining_torch/parallel/
collectives.py``) against the JAX package's, on the CPU, on the same
numpy-seeded inputs: a narrow AlexNet3DS2D tree stacked over 4 clients, cut
into 4096-value buckets so that buckets cut inside leaves.

Tolerances: the flat matrix, the int8 payload and scales, the sparse plan,
the top-k selection and the leaf groups bit for bit; the reduces within
rtol 1e-6 (atol 1e-6 of the leaf's largest value, for sums that cancel),
since the reference contracts with XLA's dot and the port with one rounding
per multiply and per add in client order. The port's own "bucketed" and
"sparse" reduces equal its dense one bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.core.state import \
    weighted_tree_sum as jweighted_tree_sum  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402
from neuroimagedisttraining_torch.convert import (  # noqa: E402
    from_reference_layout,
    jax_params_to_torch,
    reference_leaf_order,
    to_reference_layout,
)
from neuroimagedisttraining_torch.core.state import weighted_tree_sum  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: among the suite's parallel workers torch's
    default of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, BUCKET = 4, 4096
SS = phased_sample_shape((69, 69, 69))
KEY = jax.random.PRNGKey(7)


def _template():
    model = jcreate("3dcnn_s2d", num_classes=1, widths=(8, 16, 16, 16, 16),
                    dropout_rate=0.0)
    return jax.tree_util.tree_map(
        np.asarray, jinit(model, jax.random.PRNGKey(1), SS))


def _stacked(seed=0, mask=None):
    """A [C, ...] tree of O(1) values with per-leaf scales spread over
    decades (numpy, reference layout), honoring ``mask`` when given."""
    rng = np.random.RandomState(seed)

    def leaf(p, m=None):
        x = rng.randn(C, *p.shape).astype(np.float32) * np.float32(
            np.exp(rng.randn() * 2))
        return x if m is None else x * m[None]

    if mask is None:
        return jax.tree_util.tree_map(leaf, _template())
    return jax.tree_util.tree_map(leaf, _template(), mask)


def _mask(seed=3, density=0.5):
    rng = np.random.RandomState(seed)

    def leaf(path, p):
        if path[-1].key != "kernel":
            return np.ones(p.shape, np.float32)
        return (rng.rand(*p.shape) < density).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _template())


def _to_torch(jtree, stacked=True):
    """A reference tree (numpy leaves) as this package's tree."""
    if not stacked:
        return jax_params_to_torch(jtree)
    rows = [jax_params_to_torch(jax.tree_util.tree_map(lambda a: a[c], jtree))
            for c in range(C)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _weights():
    w = np.random.RandomState(2).rand(C).astype(np.float32)
    return w / w.sum()


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _close(t_tree, j_tree):
    for k, v in _to_torch(jax.tree_util.tree_map(np.asarray, j_tree),
                          stacked=False).items():
        want = v.numpy()
        np.testing.assert_allclose(t_tree[k].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=k)


def _tree_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reference_layout_roundtrips_and_leaf_order():
    t = _to_torch(_template(), stacked=False)
    for k, v in t.items():
        back = from_reference_layout(k, to_reference_layout(k, v))
        assert torch.equal(back, v), k
    jleaves = jax.tree_util.tree_leaves_with_path(_template())
    names = [".".join(p.key for p in path if p.key != "Conv_0")
             for path, _ in jleaves]
    assert reference_leaf_order(t) == names


def test_stacked_to_mat_and_flatten_bitwise():
    js = _stacked()
    ts = _to_torch(js)
    _bitwise(tc.stacked_to_mat(ts).numpy(),
             jc.stacked_to_mat(jax.tree_util.tree_map(jnp.asarray, js)))
    one = {k: v[0] for k, v in ts.items()}
    _bitwise(tc.tree_to_vec(one).numpy(), jc.tree_to_vec(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), js)))
    spec = tc.flat_spec(one)
    _tree_equal(tc.vec_to_tree(tc.tree_to_vec(one), spec), one)
    assert spec.total == sum(v.numel() for v in one.values())


def test_int8_scale_is_the_jitted_spelling():
    """The reference's round body is jitted, and there its scale is
    ``amax * f32(1/127)``: the port's spelling gives the jitted scales bit
    for bit, while a true divide (the reference's eager result) is one ulp
    off on some buckets."""
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 40, 512) *
         np.exp(rng.randn(6, 40, 1) * 3)).astype(np.float32)
    jitted = np.asarray(jax.jit(jc._int8_scale)(jnp.asarray(x)))
    _bitwise(tc._int8_scale(torch.from_numpy(x)).numpy(), jitted)
    amax = torch.from_numpy(x).abs().amax(-1, keepdim=True)
    assert (amax / 127.0).numpy().view(np.int32).tolist() != \
        jitted.view(np.int32).tolist()


def test_int8_wire_roundtrip_bitwise_given_the_uniforms():
    mat = jc.stacked_to_mat(jax.tree_util.tree_map(jnp.asarray, _stacked()))
    n = mat.shape[1]
    nb, b = tc.bucket_shape(n, BUCKET)
    assert b == BUCKET and nb * b > n  # buckets cut leaves, tail padded
    u = np.array(jax.random.uniform(KEY, (C, nb, b)))
    want = jax.jit(lambda m, k: jc.wire_roundtrip_mat(
        m, "int8", bucket_size=BUCKET, rng=k))(mat, KEY)
    got = tc.wire_roundtrip_mat(torch.from_numpy(np.array(mat)), "int8",
                                bucket_size=BUCKET,
                                uniforms=torch.from_numpy(u))
    _bitwise(got.numpy(), want)
    # and the payload itself, bucket by bucket
    jq, js = jax.jit(jc._quantize_int8)(
        jnp.pad(mat, ((0, 0), (0, nb * b - n))).reshape(C, nb, b), KEY)
    tq, ts = tc._quantize_int8(tc._buckets(torch.from_numpy(
        np.asarray(mat)), BUCKET), torch.from_numpy(u))
    _bitwise(tq.numpy(), jq)
    _bitwise(ts.numpy(), js)
    bf = tc.wire_roundtrip_mat(torch.from_numpy(np.array(mat)), "bf16")
    _bitwise(bf.numpy(), jc.wire_roundtrip_mat(mat, "bf16"))


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_weighted_mean_vs_reference(wire):
    js = jax.tree_util.tree_map(jnp.asarray, _stacked(seed=1))
    ts = _to_torch(_stacked(seed=1))
    w = _weights()
    n = sum(v[0].numel() for v in ts.values())
    nb, b = tc.bucket_shape(n, BUCKET)
    u = torch.from_numpy(np.array(jax.random.uniform(KEY, (C, nb, b))))
    want = jax.jit(lambda s, wv, k: jc.weighted_mean(
        s, wv, bucket_size=BUCKET, wire=wire,
        rng=k if wire == "int8" else None))(js, jnp.asarray(w), KEY)
    got = tc.weighted_mean(ts, torch.from_numpy(w), bucket_size=BUCKET,
                           wire=wire, uniforms=u if wire == "int8" else None)
    _close(got, want)
    if wire == "f32":
        _tree_equal(got, weighted_tree_sum(ts, torch.from_numpy(w)))
        _close(weighted_tree_sum(ts, torch.from_numpy(w)),
               jweighted_tree_sum(js, jnp.asarray(w)))
        # hier off the mesh is the exact f32 reduce, whatever its wire
        _tree_equal(tc.weighted_mean(ts, torch.from_numpy(w),
                                     bucket_size=BUCKET, wire="int8",
                                     hier_inner=-1), got)


@pytest.mark.parametrize("stacked", [False, True])
def test_sparse_plan_matches_reference(stacked):
    mask = _mask()
    if stacked:
        rng = np.random.RandomState(8)
        mask = jax.tree_util.tree_map(
            lambda m: (m[None] * (rng.rand(C, *m.shape) < 0.7)).astype(
                np.float32), mask)
    jplan = jc.build_sparse_plan(mask, stacked=stacked)
    tplan = tc.build_sparse_plan(_to_torch(mask, stacked=stacked),
                                 stacked=stacked)
    assert (tplan.dense_size, tplan.compressed_size) == \
        (jplan.dense_size, jplan.compressed_size)
    assert 0.3 < tplan.density < 0.9
    assert len(tplan.idx) == len(jplan.idx)
    for t, j in zip(tplan.idx, jplan.idx):
        if j is None:
            assert t is None
        else:
            np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


def test_sparse_weighted_mean_vs_reference_and_own_dense():
    mask = _mask()
    js = _stacked(seed=4, mask=mask)
    ts = _to_torch(js)
    w = _weights()
    plan = tc.build_sparse_plan(_to_torch(mask, stacked=False))
    got = tc.sparse_weighted_mean(ts, torch.from_numpy(w), plan,
                                  bucket_size=BUCKET)
    want = jc.sparse_weighted_mean(
        jax.tree_util.tree_map(jnp.asarray, js), jnp.asarray(w),
        jc.build_sparse_plan(mask), bucket_size=BUCKET)
    _close(got, want)
    _tree_equal(got, weighted_tree_sum(ts, torch.from_numpy(w)))
    with pytest.raises(ValueError, match="different tree"):
        tc.sparse_weighted_mean({"x": ts["Dense_0.kernel"]},
                                torch.from_numpy(w), plan)


@pytest.mark.parametrize("sample", [0, 2000])
@pytest.mark.parametrize("with_plan", [False, True])
def test_topk_sparsify_selects_the_reference_set(sample, with_plan):
    mask = _mask()
    js = _stacked(seed=6, mask=mask if with_plan else None)
    ts = _to_torch(js)
    jplan = jc.build_sparse_plan(mask) if with_plan else None
    tplan = tc.build_sparse_plan(_to_torch(mask, stacked=False)) \
        if with_plan else None
    want = jc.topk_sparsify(jax.tree_util.tree_map(jnp.asarray, js), 0.1,
                            plan=jplan, bucket_size=BUCKET, sample=sample)
    got = tc.topk_sparsify(ts, 0.1, plan=tplan, bucket_size=BUCKET,
                           sample=sample)
    for k, v in _to_torch(jax.tree_util.tree_map(np.asarray, want)).items():
        _bitwise(got[k].numpy(), v.numpy())
    kept = sum(int((v != 0).sum()) for v in got.values())
    total = (tplan.compressed_size if with_plan else
             sum(v[0].numel() for v in ts.values())) * C
    assert 0.05 < kept / total < 0.2


def test_leaf_groups_identical():
    ts = _to_torch(_stacked())
    for bucket in (BUCKET, 1 << 18, 1):
        jsizes = [int(np.prod(x.shape[1:])) for x in
                  jax.tree_util.tree_leaves(_stacked())]
        tsizes = [ts[k][0].numel() for k in reference_leaf_order(ts)]
        assert tsizes == jsizes
        assert tc._leaf_groups(tsizes, bucket) == \
            jc._leaf_groups(jsizes, bucket)
    assert len(tc.topk_groups(ts, BUCKET)) > 3


def test_topk_weighted_mean_and_dead_select():
    mask = _mask()
    js = _stacked(seed=9)
    ts = _to_torch(js)
    w = _weights()
    tplan = tc.build_sparse_plan(_to_torch(mask, stacked=False))
    dead = tc.plan_dead_select(ts, tplan)
    jdead = jc.plan_dead_select(jax.tree_util.tree_map(jnp.asarray, js),
                                jc.build_sparse_plan(mask))
    for k, v in _to_torch(jax.tree_util.tree_map(np.asarray, jdead)).items():
        _bitwise(dead[k].numpy(), v.numpy())
    agg, sp = tc.topk_weighted_mean(dead, torch.from_numpy(w), 0.1,
                                    plan=tplan, bucket_size=BUCKET)
    jagg, _ = jc.topk_weighted_mean(jdead, jnp.asarray(w), 0.1,
                                    plan=jc.build_sparse_plan(mask),
                                    bucket_size=BUCKET)
    _close(agg, jagg)
    _tree_equal(agg, weighted_tree_sum(sp, torch.from_numpy(w)))


def test_wire_argument_checks():
    ts = _to_torch(_stacked())
    w = torch.from_numpy(_weights())
    with pytest.raises(ValueError, match="uniforms"):
        tc.weighted_mean(ts, w, wire="int8")
    with pytest.raises(ValueError, match="wire"):
        tc.weighted_mean(ts, w, wire="fp8")
    with pytest.raises(ValueError, match="density"):
        tc.topk_count(10, 0.0)
    assert tc.topk_count(10, 0.25) == 3 == jc.topk_count(10, 0.25)


@pytest.mark.parametrize("module", [
    "parallel/__init__.py", "parallel/collectives.py",
    "algorithms/fedavg.py", "algorithms/base.py", "ops/kernels.py",
    "robust/__init__.py", "robust/faults.py", "robust/guard.py",
    "robust/aggregation.py", "robust/recovery.py", "parallel/topology.py",
    "algorithms/dispfl.py", "algorithms/subavg.py", "algorithms/ditto.py",
    "algorithms/local_only.py", "algorithms/dpsgd.py"])
def test_port_modules_import_no_jax(module):
    """The aggregation slice's, the robustness tier's and the baselines'
    modules import torch, numpy and the standard library only (the
    package-wide walk is in test_torch_port_round.py)."""
    import ast
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent
            / "neuroimagedisttraining_torch" / module)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] in ("torch", "numpy", "__future__",
                                         "typing", "math", "ctypes",
                                         "hashlib", "os", "shutil",
                                         "subprocess", "time", "pathlib",
                                         "abc", "logging", "dataclasses",
                                         "threading"), \
                (module, mod)
