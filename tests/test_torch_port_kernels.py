"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper in ``neuroimagedisttraining_torch/ops/kernels.py``
runs its plain PyTorch version; these tests hold that plain version to the
Pallas kernel (interpret mode on the CPU) BIT FOR BIT, on the same
numpy-seeded inputs. The CUDA kernels themselves are held to the plain
versions on the card (``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``).
"""
import numpy as np
import pytest

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the repo's deterministic stand-in
    from _hypothesis_fallback import given, settings, strategies as st

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.ops import pallas_kernels as pk  # noqa: E402
from neuroimagedisttraining_tpu.ops import topk_select as jts  # noqa: E402
from neuroimagedisttraining_torch.core import optim  # noqa: E402
from neuroimagedisttraining_torch.ops import kernels  # noqa: E402
from neuroimagedisttraining_torch.ops import topk_select as tts  # noqa: E402

LR = np.float32(1e-3) * np.float32(0.998) ** np.float32(3)
MOM, WD = 0.9, 5e-4


def _sgd_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype(np.float32)
    m = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    k = (rng.rand(*shape) > 0.5).astype(np.float32)
    return p, m, g, k


def _bitwise(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("shape", [(7,), (5, 3), (4, 4, 4, 2), (300, 7),
                                   (3, 3, 3, 8, 5), (1030,)])
@pytest.mark.parametrize("mask_grads", [False, True])
def test_masked_sgd_plain_bitwise_vs_pallas(shape, mask_grads):
    p, m, g, k = _sgd_inputs(shape, seed=len(shape) * 7 + shape[0])
    jp, jm = pk.fused_masked_sgd_leaf(
        jnp.asarray(p), jnp.asarray(m), jnp.asarray(g), jnp.asarray(k),
        jnp.float32(LR), momentum=MOM, wd=WD, mask_grads=mask_grads)
    tp, tm = kernels.masked_sgd_plain(
        torch.from_numpy(p), torch.from_numpy(m), torch.from_numpy(g),
        torch.from_numpy(k), torch.tensor(LR), MOM, WD, mask_grads)
    _bitwise(tp.numpy(), jp)
    _bitwise(tm.numpy(), jm)


def test_fused_masked_sgd_step_in_place_bitwise_vs_pallas_tree():
    shapes = {"a": (33, 9), "b": (9,), "c": (2, 3, 4)}
    ins = {n: _sgd_inputs(s, seed=i) for i, (n, s) in enumerate(shapes.items())}
    jp, jm = pk.fused_masked_sgd_step(
        {n: jnp.asarray(v[0]) for n, v in ins.items()},
        {n: jnp.asarray(v[1]) for n, v in ins.items()},
        {n: jnp.asarray(v[2]) for n, v in ins.items()},
        {n: jnp.asarray(v[3]) for n, v in ins.items()},
        jnp.float32(LR), momentum=MOM, wd=WD)
    names = list(shapes)
    tp = [torch.from_numpy(ins[n][0].copy()) for n in names]
    tm = [torch.from_numpy(ins[n][1].copy()) for n in names]
    kernels.reset_launches()
    kernels.fused_masked_sgd_step(
        tp, tm, [torch.from_numpy(ins[n][2]) for n in names],
        [torch.from_numpy(ins[n][3]) for n in names], float(LR),
        momentum=MOM, wd=WD)
    assert kernels.LAUNCHES["masked_sgd"] == 0  # the plain version ran
    for n, a, b in zip(names, tp, tm):
        _bitwise(a.numpy(), jp[n])
        _bitwise(b.numpy(), jm[n])


def test_fma_is_correctly_rounded():
    """The plain version's single-rounding multiply-add against an exact
    rational evaluation, on inputs built to land near rounding ties."""
    from fractions import Fraction

    rng = np.random.RandomState(3)
    a = rng.randn(400).astype(np.float32)
    b = rng.randn(400).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + 2.0 ** -30)).astype(np.float32)
    got = optim.fma(torch.from_numpy(a), torch.from_numpy(b),
                    torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(Fraction(float(x)) - exact) for x in cands]
        best = min(errs)
        assert abs(Fraction(float(got[i])) - exact) == best, i


def _threshold_rows():
    rng = np.random.RandomState(5)
    ties = np.repeat(np.abs(rng.randn(37)).astype(np.float32), 11)
    rng.shuffle(ties)
    sparse = np.abs(rng.randn(500)).astype(np.float32)
    sparse[rng.rand(500) < 0.7] = 0.0
    return {
        "random": (np.abs(rng.randn(1, 3000)).astype(np.float32), 1234),
        "ties": (ties[None], 200),
        "zeros": (np.zeros((1, 777), np.float32), 300),
        "mostly_zero": (sparse[None], 400),
        "rows": (np.abs(rng.randn(4, 1500)).astype(np.float32), 17),
        "k_eq_n": (np.abs(rng.randn(2, 64)).astype(np.float32), 64),
        "k_1": (np.abs(rng.randn(3, 640)).astype(np.float32), 1),
    }


@pytest.mark.parametrize("case", list(_threshold_rows()))
def test_threshold_plain_bitwise_vs_pallas(case):
    av, k = _threshold_rows()[case]
    jt = pk.threshold_topk(jnp.asarray(av), k)
    tt = kernels.threshold_topk(torch.from_numpy(av), k)
    _bitwise(tt.numpy(), jt)
    # and it IS the k-th largest
    ref = -np.sort(-av, axis=-1)[:, k - 1:k]
    _bitwise(tt.numpy(), ref)


def _threshold_edge_rows():
    """The radix select's edge cases: non-finite and signed-zero patterns
    (NaN counts as +inf, -0.0 as 0), n not a multiple of 4, rows whose
    starts fall off a 16-byte boundary in the flat buffer."""
    rng = np.random.RandomState(6)
    odd = np.abs(rng.randn(1, 1001)).astype(np.float32)
    odd[0, rng.rand(1001) < 0.05] = np.inf
    odd[0, rng.rand(1001) < 0.05] = np.nan
    odd[0, rng.rand(1001) < 0.2] = -0.0
    nan_top = odd.copy()
    nan_top[0, :40] = np.nan
    return {
        "inf_nan_negzero": (odd, 500),
        "inf_nan_negzero_k_small": (odd, 3),
        "nan_ties_inf": (nan_top, 60),
        "inf_nan_negzero_k_n": (odd, 1001),
        "odd_n": (np.abs(rng.randn(1, 4099)).astype(np.float32), 100),
        "ragged_rows": (np.abs(rng.randn(3, 1003)).astype(np.float32), 1003 // 2),
        "one": (np.array([[0.5]], np.float32), 1),
        "bit_edges": (np.array([[1e-45, 1.17549435e-38, 3.4028235e38, 0.0,
                                 np.inf, 2.0, 1.9999999, 1e-45]], np.float32),
                      5),
    }


@pytest.mark.parametrize("case", list(_threshold_rows()) +
                         list(_threshold_edge_rows()))
def test_radix_threshold_bitwise_vs_exact_and_pallas(case):
    """The kernel's algorithm (``radix_threshold``) against the plain search
    and the Pallas kernel (interpret mode), bit for bit."""
    rows = {**_threshold_rows(), **_threshold_edge_rows()}
    av, k = rows[case]
    got = tts.radix_threshold(torch.from_numpy(av), k)
    _bitwise(got.numpy(), tts.exact_threshold(torch.from_numpy(av), k))
    _bitwise(got.numpy(), pk.threshold_topk(jnp.asarray(av), k))
    _bitwise(got.numpy(), jts.exact_threshold(jnp.asarray(av), k))


def test_radix_threshold_row_beyond_vmem_cap():
    """A row longer than the Pallas kernel's THRESHOLD_MAX_N (the reference
    takes its XLA search there), with n not a multiple of 4."""
    n = pk.THRESHOLD_MAX_N + 4099
    rng = np.random.RandomState(12)
    av = np.abs(rng.randn(1, n)).astype(np.float32)
    av[0, rng.rand(n) < 0.3] = 0.0
    for k in (1, n // 3, n):
        got = tts.radix_threshold(torch.from_numpy(av), k)
        _bitwise(got.numpy(), jts.select_threshold(jnp.asarray(av), k,
                                                   kernels="pallas"))
        _bitwise(got.numpy(), tts.exact_threshold(torch.from_numpy(av), k))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_radix_threshold_tie_heavy_rows(seed):
    """Few distinct values, many zeros, k anywhere in [1, n]: the radix
    select equals the plain search and the sort spelling."""
    rng = np.random.RandomState(seed)
    c, n = rng.randint(1, 4), rng.randint(1, 3000)
    values = np.abs(rng.randn(rng.randint(1, 6))).astype(np.float32)
    av = values[rng.randint(0, values.size, (c, n))]
    av[rng.rand(c, n) < rng.rand()] = 0.0
    k = rng.randint(1, n + 1)
    got = tts.radix_threshold(torch.from_numpy(av), k)
    _bitwise(got.numpy(), tts.exact_threshold(torch.from_numpy(av), k))
    _bitwise(got.numpy(), -np.sort(-av, axis=-1)[:, k - 1:k])


def test_threshold_full_row_beyond_vmem_cap_vs_exact_threshold():
    """A row longer than the Pallas kernel's THRESHOLD_MAX_N: the reference
    routes it to its XLA search; the port's search has no cap."""
    n = pk.THRESHOLD_MAX_N + 4099
    assert not pk.threshold_supported(n)
    rng = np.random.RandomState(11)
    av = np.abs(rng.randn(1, n)).astype(np.float32)
    av[0, rng.rand(n) < 0.3] = 0.0
    k = n // 2
    jt = jts.select_threshold(jnp.asarray(av), k, kernels="pallas")
    tt = tts.select_threshold(torch.from_numpy(av), k)
    _bitwise(tt.numpy(), jt)
    _bitwise(tt.numpy(), jts.exact_threshold(jnp.asarray(av), k))


@pytest.mark.parametrize("n", [5, 1024, 5000])
def test_score_mask_plain_bitwise_vs_pallas(n):
    rng = np.random.RandomState(n)
    s = np.abs(rng.randn(n)).astype(np.float32)
    norm = np.float32(s.sum(dtype=np.float32))
    thr = np.float32(np.sort(s / norm)[n // 2])
    jm = pk.fused_score_mask_leaf(jnp.asarray(s), jnp.float32(norm),
                                  jnp.float32(thr))
    tm = kernels.fused_score_mask([torch.from_numpy(s)], torch.tensor(norm),
                                  torch.tensor(thr))[0]
    _bitwise(tm.numpy(), jm)


def test_mask_apply_plain_bitwise_vs_pallas():
    rng = np.random.RandomState(12)
    shapes = {"a": (33, 9), "b": (9,), "c": (2, 3, 4, 5, 6), "d": (1030,)}
    ps = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    ps["b"][0] = np.float32(-0.0)
    ms = {k: (rng.rand(*s) < 0.5).astype(np.float32)
          for k, s in shapes.items()}
    want = pk.fused_mask_apply({k: jnp.asarray(v) for k, v in ps.items()},
                               {k: jnp.asarray(v) for k, v in ms.items()})
    kernels.reset_launches()
    got = kernels.fused_mask_apply(
        {k: torch.from_numpy(v) for k, v in ps.items()},
        {k: torch.from_numpy(v) for k, v in ms.items()})
    assert kernels.LAUNCHES["mask_apply"] == 0  # the plain version ran
    assert list(got) == list(shapes)
    for k in shapes:
        _bitwise(got[k].numpy(), want[k])


def _qr_inputs(c, nb, b, seed):
    """Buckets with per-bucket scales spread over decades, an all-zero
    bucket (scale 1.0), the reference's uniforms and its jitted scales."""
    import jax

    from neuroimagedisttraining_tpu.parallel import collectives as jc

    rng = np.random.RandomState(seed)
    x = (rng.randn(c, nb, b) *
         np.exp(rng.randn(c, nb, 1) * 2)).astype(np.float32)
    x[:, 0] = 0.0
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, (c, nb, b)))
    w = rng.rand(c).astype(np.float32)
    w /= w.sum()
    s = np.array(jax.jit(jc._int8_scale)(jnp.asarray(x)))[..., 0]
    return x, u, w, s, key


@pytest.mark.parametrize("c", [1, 3, 5, 8, 17])
@pytest.mark.parametrize("b", [1024, 4096])
def test_quantize_reduce_plain_vs_pallas(b, c):
    """The int8 payload and the scales bit for bit; the reduced sum within
    rtol 1e-6 (the reference's sum shares XLA's dot, the port's rounds each
    multiply and add in client order). 17 clients are more than one launch
    of the card's kernel takes (it runs them as chunks of 16)."""
    import jax

    from neuroimagedisttraining_tpu.parallel import collectives as jc
    from neuroimagedisttraining_torch.parallel import collectives as tc

    x, u, w, s, key = _qr_inputs(c, 3, b, seed=b + c)
    jq, js = jax.jit(jc._quantize_int8)(jnp.asarray(x), key)
    tq, ts = tc._quantize_int8(torch.from_numpy(x), torch.from_numpy(u))
    _bitwise(tq.numpy(), jq)
    _bitwise(ts.numpy(), js)
    _bitwise(ts[..., 0].numpy(), s)
    assert float(ts[0, 0, 0]) == 1.0  # the all-zero bucket
    assert pk.quantize_reduce_supported(b)
    want = np.asarray(pk.fused_quantize_reduce(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(u), jnp.asarray(s)))
    kernels.reset_launches()
    got = kernels.fused_quantize_reduce(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(u),
        torch.from_numpy(s)).numpy()
    assert kernels.LAUNCHES["quantize_reduce"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    deq = tq.numpy().astype(np.float32) * ts.numpy()
    np.testing.assert_array_equal(got, kernels.quantize_reduce_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(u),
        torch.from_numpy(s)).numpy())
    assert np.abs(got - np.tensordot(w, deq, axes=1)).max() < \
        1e-6 * np.abs(got).max()


def test_quantize_reduce_takes_any_bucket_size():
    """b = 1000 is no multiple of the reference kernel's 1024 tile: the
    reference routes it to its XLA chain; the port's kernel takes it."""
    x, u, w, s, _ = _qr_inputs(3, 4, 1000, seed=7)
    assert not pk.quantize_reduce_supported(1000)
    got = kernels.fused_quantize_reduce(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(u),
        torch.from_numpy(s))
    assert got.shape == (4, 1000)
    assert bool(torch.all(got[0] == 0))


def test_quantize_reduce_plan():
    """The card kernel's launches, decided on the host: chunks of at most 16
    clients in client order, the 16-byte path only for b % 4 == 0 with x, u
    and out on 16-byte boundaries (a view 4 bytes off takes the scalar path),
    and a bucket-aligned grid of (ceil(b / tile), nb)."""
    plan = kernels.quantize_reduce_plan
    tile = kernels.QUANTIZE_REDUCE_TILE
    big = torch.zeros(8 * 3 * 4096 + 8)
    base = big.data_ptr()
    assert base % 16 == 0
    assert plan(8, 3, 4096, [base] * 3)["chunks"] == [(0, 8)]
    assert plan(16, 3, 4096, [base] * 3)["chunks"] == [(0, 16)]
    assert plan(17, 3, 4096, [base] * 3)["chunks"] == [(0, 16), (16, 1)]
    assert plan(40, 3, 4096, [base] * 3)["chunks"] == [(0, 16), (16, 16),
                                                        (32, 8)]
    x = big[:8 * 3 * 4096].view(8, 3, 4096)
    u = big[4:4 + 8 * 3 * 4096].view(8, 3, 4096)
    off = big[1:1 + 8 * 3 * 4096].view(8, 3, 4096)
    assert off.data_ptr() % 16 == 4
    assert plan(8, 3, 4096, [x.data_ptr(), u.data_ptr(), base])["vec"]
    assert plan(8, 3, 1000, [base] * 3)["vec"]
    assert not plan(8, 3, 1001, [base] * 3)["vec"]
    assert not plan(8, 3, 4096, [off.data_ptr(), u.data_ptr(), base])["vec"]
    assert not plan(8, 3, 4096, [x.data_ptr(), off.data_ptr(), base])["vec"]
    assert not plan(8, 3, 4096, [base, base, base + 4])["vec"]
    for nb, b in ((10, 262144), (3, 1000), (3, 1001), (5, 1024), (2, 1025),
                  (1, 1)):
        p = plan(8, nb, b, [base] * 3)
        assert p["tile"] == tile
        assert p["grid"] == (-(-b // tile), nb)
        assert (p["grid"][0] - 1) * tile < b <= p["grid"][0] * tile
    assert plan(8, 70000, 16, [base] * 3)["grid"] == (1, 65535)
    assert plan(8, 3, 4096, [base] * 3, tile=2048)["grid"] == (2, 3)
    for bad in ((0, 3, 4096), (8, 0, 4096), (8, 3, 0), (8, 3, 2 ** 31)):
        with pytest.raises(ValueError):
            plan(*bad, [base] * 3)


@pytest.mark.parametrize("c", [1, 3, 8, 16])
def test_weighted_sum_plain_vs_pallas(c):
    rng = np.random.RandomState(c)
    shapes = {"k": (3, 3, 3, 4, 8), "b": (8,), "d": (130, 7)}
    xs = {k: rng.randn(c, *s).astype(np.float32) for k, s in shapes.items()}
    w = rng.rand(c).astype(np.float32)
    w /= w.sum()
    want = pk.fused_weighted_sum({k: jnp.asarray(v) for k, v in xs.items()},
                                 jnp.asarray(w))
    got = kernels.fused_weighted_sum(
        {k: torch.from_numpy(v) for k, v in xs.items()}, torch.from_numpy(w))
    for k in shapes:
        ref = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(ref).max()))


def test_weighted_sum_vector_leaf_decision():
    """The kernel's 16-byte path takes a leaf whose base is 16-byte aligned
    and whose per-client size is a multiple of 4; an odd size or an offset
    view takes the scalar path."""
    big = torch.zeros(8 * 1000 + 8)
    assert big.data_ptr() % 16 == 0
    assert kernels.weighted_sum_vector_leaf(big[:8000].view(8, 1000))
    assert kernels.weighted_sum_vector_leaf(big[:8 * 12].view(8, 3, 4))
    assert not kernels.weighted_sum_vector_leaf(big[:7 * 999].view(7, 999))
    assert not kernels.weighted_sum_vector_leaf(big[1:8001].view(8, 1000))
    assert kernels.weighted_sum_vector_leaf(big[4:8004].view(8, 1000))
    assert not kernels.weighted_sum_vector_leaf(big[:8].view(8))


def test_wrappers_reject_mismatched_inputs():
    a = torch.zeros(4)
    with pytest.raises(ValueError):
        kernels.fused_masked_sgd_step([a], [a], [a], [torch.zeros(5)], 0.1)
    with pytest.raises(ValueError):
        kernels.threshold_topk(torch.zeros(1, 4), 5)
    with pytest.raises(ValueError):
        kernels.fused_mask_apply({"a": a}, {"a": torch.zeros(5)})
    with pytest.raises(ValueError):
        kernels.fused_weighted_sum({"a": torch.zeros(3, 4)}, torch.ones(2))
    with pytest.raises(ValueError):
        kernels.fused_quantize_reduce(torch.zeros(2, 3, 4), torch.ones(2),
                                      torch.zeros(2, 3, 4), torch.ones(3))
