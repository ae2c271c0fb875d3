"""The stem stage's kernels, entry points and autograd route against the JAX
package's plain spellings, on the CPU.

On the CPU ``ops/kernels.py::stem_fwd`` and ``stem_bwd`` run their plain
versions; the CUDA kernels are held to those on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``). The reference's
Pallas stem kernels cannot be the oracles here (they need ``pl.Unblocked``
and fixed full-size shapes), so each port function is held to the
reference's shape-generic plain spelling, at small shapes whose windows are
ragged.

Tolerances: float32 convolutions within rtol 1e-5 of the sum of the
magnitudes of their terms (the two frameworks sum the 216 products in
different orders, and an output near zero is a cancellation); sums within
rtol 1e-5 (the signed sums of the magnitudes of their terms, for the same
reason); pools, the lhs layout and the tie-routing bitwise.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.ops.experimental import pallas_stem_bwd as jbwd  # noqa: E402
from neuroimagedisttraining_tpu.ops.experimental import pallas_stem_fused as jfused  # noqa: E402
from neuroimagedisttraining_tpu.ops.experimental import pallas_stem_v3 as jv3  # noqa: E402
from neuroimagedisttraining_torch.models.alexnet3d import S2DStemStage, _group_stats  # noqa: E402
from neuroimagedisttraining_torch.models.layers import max_pool3d, phased_input  # noqa: E402
from neuroimagedisttraining_torch.ops import kernels  # noqa: E402
from neuroimagedisttraining_torch.ops.experimental import pallas_stem as tstem  # noqa: E402
from neuroimagedisttraining_torch.ops.experimental import pallas_stem_bwd as tbwd  # noqa: E402
from neuroimagedisttraining_torch.ops.experimental import pallas_stem_fused as tfused  # noqa: E402
from neuroimagedisttraining_torch.ops.experimental import pallas_stem_v3 as tv3  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: among the suite's parallel workers torch's
    default of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: phased per-sample shapes (D', H', 8, W'): ragged pool windows in h, and
#: in d and w
SHAPES = [(11, 13, 8, 11), (12, 14, 8, 13)]
B, F = 2, 8
DN = ("NDHCW", "DHWIO", "NDHWC")


def _inputs(shape, seed, f=F):
    rng = np.random.RandomState(seed)
    x = (0.5 + rng.randn(B, *shape)).astype(np.float32)
    w = (0.2 * rng.randn(3, 3, 3, 8, f)).astype(np.float32)  # DHWIO
    bias = (0.1 * rng.randn(f)).astype(np.float32)
    return x, w, bias


def _jconv(x, w):
    dn = lax.conv_dimension_numbers(x.shape, w.shape, DN)
    return lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1, 1),
                                    "VALID", dimension_numbers=dn)


def _assert_conv_close(got, want, x, w):
    """Within 1e-5 of the sum of the terms' magnitudes, per output."""
    scale = np.asarray(_jconv(np.abs(x), np.abs(w)))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


def _assert_sums_close(got, want, zs):
    """Sums of zs within 1e-5 of the sum of the terms' magnitudes (a sum of
    signed values may cancel to near zero)."""
    scale = np.abs(np.asarray(zs, np.float64)).sum((1, 2, 3))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-5 * scale).all(), float((err / scale).max())


def _wt(w):
    """DHWIO (3, 3, 3, 8, F) -> the reference's (F, 216) remapped kernel."""
    return np.ascontiguousarray(w.reshape(216, w.shape[-1]).T)


def _port_w(w):
    """DHWIO -> the port's (F, 8, 3, 3, 3)."""
    return torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_conv_pallas_matches_lax_conv(shape):
    x, w, _ = _inputs(shape, 0)
    want = np.asarray(_jconv(x, w))
    kernels.reset_launches()
    got = tstem.stem_conv_pallas(torch.from_numpy(x),
                                 torch.from_numpy(_wt(w)))
    assert kernels.LAUNCHES["stem_fwd"] == 0  # the plain version ran
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    _assert_conv_close(got.numpy(), want, x, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_stem_fwd_matches_reference_ref(shape):
    x, w, _ = _inputs(shape, 1)
    rzs, rm, (rs, rq) = jfused.ref(jnp.asarray(x), jnp.asarray(w))
    zs, pooled, stats = tfused.fused_stem_fwd(torch.from_numpy(x),
                                              torch.from_numpy(_wt(w)))
    assert stats.shape[0] == B and stats.shape[2:] == (2, F)
    _assert_conv_close(zs.numpy(), np.asarray(rzs), x, w)
    # the pool of the port's own zs is bitwise; against the reference's
    # pool, as close as the conv
    np.testing.assert_array_equal(
        pooled.numpy(), max_pool3d(zs.permute(0, 4, 1, 2, 3), 3, 3)
        .permute(0, 2, 3, 4, 1).numpy())
    assert pooled.shape == rm.shape
    np.testing.assert_allclose(pooled.numpy(), np.asarray(rm), rtol=1e-5,
                               atol=1e-5)
    tot = stats.sum(1).numpy()
    _assert_sums_close(tot[:, 0], np.asarray(rs), zs.numpy())
    np.testing.assert_allclose(tot[:, 1], np.asarray(rq), rtol=1e-5)
    # the port's plain spelling of the same ref agrees with the reference's
    pz, pm, (ps, pq) = tfused.ref(torch.from_numpy(x), torch.from_numpy(w))
    _assert_conv_close(pz.numpy(), np.asarray(rzs), x, w)
    _assert_sums_close(ps.numpy(), np.asarray(rs), zs.numpy())
    np.testing.assert_allclose(pq.numpy(), np.asarray(rq), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_stem_fwd_v3_matches_reference_ref(shape):
    x, w, bias = _inputs(shape, 2)
    rzs, rm, (rs, rq) = jv3.ref(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(bias))
    lhs = tv3.make_stem_lhs(torch.from_numpy(w))
    zs, pooled, stats = tv3.fused_stem_fwd_v3(torch.from_numpy(x), lhs,
                                              torch.from_numpy(bias))
    _assert_conv_close(zs.numpy(), np.asarray(rzs), x, w)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(rm), rtol=1e-5,
                               atol=1e-5)
    tot = stats.sum(1).numpy()
    _assert_sums_close(tot[:, 0], np.asarray(rs), zs.numpy())
    np.testing.assert_allclose(tot[:, 1], np.asarray(rq), rtol=1e-5)


@pytest.mark.parametrize("f", [8, 64])
def test_make_stem_lhs_bitwise_and_kernel_recovered(f):
    _, w, _ = _inputs(SHAPES[0], 3, f=f)
    want = np.asarray(jv3.make_stem_lhs(jnp.asarray(w)))
    got = tv3.make_stem_lhs(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(tv3.kernel_from_lhs(got).numpy(),
                                  _port_w(w).numpy())
    np.testing.assert_array_equal(
        tstem.kernel_from_wt(torch.from_numpy(_wt(w))).numpy(),
        _port_w(w).numpy())


def _zs_cotangents(shape, seed, quantize):
    """An NDHWC zs (optionally quantized to multiples of 1/4 in [-1, 1], so
    windows hold exact ties) and cotangents for (pooled, s1, s2)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape[0] - 2, shape[1] - 2, shape[3] - 2
    zs = rng.randn(B, d, h, w, F).astype(np.float32)
    if quantize:
        zs = np.round(np.clip(zs, -1, 1) * 4) / 4
    gm = rng.randn(B, d // 3, h // 3, w // 3, F).astype(np.float32)
    g1 = rng.randn(B, F).astype(np.float32)
    g2 = (0.1 * rng.randn(B, F)).astype(np.float32)
    return zs.astype(np.float32), gm, g1, g2


def _port_vjp(zs, gm, g1, g2):
    z = torch.from_numpy(zs).requires_grad_(True)
    m, s1, s2 = tbwd.pool_sum_sumsq(z)
    (dz,) = torch.autograd.grad(
        [m, s1, s2], [z], [torch.from_numpy(gm), torch.from_numpy(g1),
                           torch.from_numpy(g2)])
    return m, s1, s2, dz


@pytest.mark.parametrize("shape", SHAPES)
def test_pool_sum_sumsq_matches_reference_vjp_untied(shape):
    zs, gm, g1, g2 = _zs_cotangents(shape, 4, quantize=False)
    (rm, rs1, rs2), vjp = jax.vjp(jbwd._pool_sum_sumsq_fwd_impl,
                                  jnp.asarray(zs))
    (rdz,) = vjp((jnp.asarray(gm), jnp.asarray(g1), jnp.asarray(g2)))
    kernels.reset_launches()
    m, s1, s2, dz = _port_vjp(zs, gm, g1, g2)
    assert kernels.LAUNCHES["stem_bwd"] == 0  # the plain version ran
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(rm))
    _assert_sums_close(s1.detach().numpy(), np.asarray(rs1), zs)
    np.testing.assert_allclose(s2.detach().numpy(), np.asarray(rs2),
                               rtol=1e-5)
    # no ties: both routings agree up to the order of the float32 adds
    np.testing.assert_allclose(dz.numpy(), np.asarray(rdz), rtol=1e-6,
                               atol=1e-6)
    assert tbwd.supported_shape(zs.shape)
    assert not tbwd.supported_shape(zs.shape[:-1] + (12,))


def _split_numpy(zs, gm, g1, g2):
    """The reference kernel's contract spelled out in numpy: dense term plus
    each window's cotangent split evenly among its tied maxima."""
    b, d, h, w, f = zs.shape
    out = g1[:, None, None, None, :] + (2 * g2)[:, None, None, None, :] * zs
    for bi in range(b):
        for pd in range(d // 3):
            for ph in range(h // 3):
                for pw in range(w // 3):
                    win = zs[bi, 3 * pd:3 * pd + 3, 3 * ph:3 * ph + 3,
                             3 * pw:3 * pw + 3]
                    eq = win == win.max(axis=(0, 1, 2))
                    val = gm[bi, pd, ph, pw] / eq.sum(axis=(0, 1, 2))
                    out[bi, 3 * pd:3 * pd + 3, 3 * ph:3 * ph + 3,
                        3 * pw:3 * pw + 3] += np.where(eq, val, 0.0)
    return out.astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_pool_sum_sumsq_splits_ties_evenly(shape):
    zs, gm, g1, g2 = _zs_cotangents(shape, 5, quantize=True)
    m, _, _, dz = _port_vjp(zs, gm, g1, g2)
    want = _split_numpy(zs, gm, g1, g2)
    np.testing.assert_allclose(dz.numpy(), want, rtol=1e-6, atol=1e-6)
    # ties were there, and the pool's cotangent mass is conserved
    core = zs[:, :3 * (zs.shape[1] // 3), :3 * (zs.shape[2] // 3),
              :3 * (zs.shape[3] // 3)]
    d, h, w = (s // 3 for s in zs.shape[1:4])
    rep = m.detach().numpy().repeat(3, 1).repeat(3, 2).repeat(3, 3)
    counts = (core == rep).reshape(B, d, 3, h, 3, w, 3, F).sum((2, 4, 6))
    assert (counts > 1).mean() > 0.3
    dense = g1[:, None, None, None, :] + \
        (2 * g2)[:, None, None, None, :] * zs
    np.testing.assert_allclose((dz.numpy() - dense).sum(), gm.sum(),
                               rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_bwd_first_matches_torch_autograd_on_ties(shape):
    """ties="first" is torch's own max-pool routing: bitwise the autograd
    cotangent of max_pool3d plus that of the two sums, added in the
    kernel's order (dense term, then the pool's)."""
    zs, gm, g1, g2 = _zs_cotangents(shape, 6, quantize=True)
    z = torch.from_numpy(zs).permute(0, 4, 1, 2, 3).requires_grad_(True)
    (pool_part,) = torch.autograd.grad(
        max_pool3d(z, 3, 3), z, torch.from_numpy(gm).permute(0, 4, 1, 2, 3))
    (dense,) = torch.autograd.grad(
        [z.sum((2, 3, 4)), (z * z).sum((2, 3, 4))], z,
        [torch.from_numpy(g1), torch.from_numpy(g2)])
    want = (dense + pool_part).permute(0, 2, 3, 4, 1)
    zt = torch.from_numpy(zs)
    pooled = max_pool3d(z.detach(), 3, 3).permute(0, 2, 3, 4, 1).contiguous()
    got = kernels.stem_bwd(zt, pooled, torch.from_numpy(gm),
                           torch.from_numpy(g1), torch.from_numpy(g2),
                           ties="first")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    split = kernels.stem_bwd(zt, pooled, torch.from_numpy(gm),
                             torch.from_numpy(g1), torch.from_numpy(g2),
                             ties="split")
    assert not torch.equal(got, split)  # the tie rule matters here
    # bf16: the same routing in the working type
    zb = zt.to(torch.bfloat16)
    pb = pooled.to(torch.bfloat16)
    gb = torch.from_numpy(gm).to(torch.bfloat16)
    got_b = kernels.stem_bwd(zb, pb, gb, torch.from_numpy(g1),
                             torch.from_numpy(g2), ties="first")
    want_b = kernels.stem_bwd(zb.float(), pb.float(), gb.float(),
                              torch.from_numpy(g1), torch.from_numpy(g2),
                              ties="first").to(torch.bfloat16)
    assert got_b.dtype == torch.bfloat16 and torch.equal(got_b, want_b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", ["first", "split"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stem_bwd_bias_grad_is_the_sum_of_dzs(shape, ties, dtype):
    """``bias_grad=True`` returns the default call's dzs bit for bit and,
    as its bias gradient, ``dzs.sum(dim=(0, 1, 2, 3))`` bit for bit (the
    plain version's spelling; the card's kernel is held to it within one
    ulp)."""
    dt = getattr(torch, dtype)
    zs, gm, g1, g2 = _zs_cotangents(shape, 8, quantize=True)
    zt = torch.from_numpy(zs).to(dt)
    pooled = max_pool3d(zt.permute(0, 4, 1, 2, 3), 3, 3).permute(
        0, 2, 3, 4, 1).contiguous()
    args = (zt, pooled, torch.from_numpy(gm).to(dt), torch.from_numpy(g1),
            torch.from_numpy(g2))
    dzs = kernels.stem_bwd(*args, ties=ties)
    got, dbias = kernels.stem_bwd(*args, ties=ties, bias_grad=True)
    assert got.dtype == dt and dbias.dtype == dt
    assert tuple(dbias.shape) == (F,)
    assert torch.equal(got, dzs)
    assert torch.equal(dbias, dzs.sum(dim=(0, 1, 2, 3)))


def test_dbias_agreement_counts_ulps_and_cancellation():
    """The card's gate for the fused bias gradient: ulps against the plain
    per-channel sum, and, past one ulp, the error over the channel's sum of
    magnitudes (large only where the sum does not cancel)."""
    dzs = torch.tensor([[[[[1.0, 1000.0], [2.0, -1000.0]]]]],
                       dtype=torch.bfloat16)  # (1, 1, 1, 2, 2)
    want = dzs.sum(dim=(0, 1, 2, 3))  # [3, 0]
    assert kernels.dbias_agreement(want.clone(), dzs) == (0, 0.0)
    one_up = (want.view(torch.int16) + 1).view(torch.bfloat16)
    assert kernels.dbias_agreement(one_up, dzs)[0] == 1
    # 2 ulp off a sum of 3 fails the gate; 2e-3 off a sum of 1000 and -1000
    # that cancels to 0 passes it (1e-6 of the magnitude)
    off = torch.tensor([3.03125, 0.002], dtype=torch.bfloat16)
    ulps, worst = kernels.dbias_agreement(off, dzs)
    assert ulps > 1 and worst > 1e-5
    off = torch.tensor([3.0, 0.002], dtype=torch.bfloat16)
    ulps, worst = kernels.dbias_agreement(off, dzs)
    assert ulps > 1 and worst <= 1e-5


def _parent_stem_grads(x, ws, bs, g_pooled, g_s1, g_s2):
    """StemStage's backward as it was spelled before the bias gradient
    moved into ``stem_bwd``: dzs, the conv's gradients, then ``dzs``
    summed per channel."""
    zs, pooled, _, _ = kernels.stem_fwd(x, ws, bs)
    gp = g_pooled.permute(0, 2, 3, 4, 1).to(zs.dtype).contiguous()
    dzs = kernels.stem_bwd(zs, pooled, gp, g_s1.contiguous(),
                           g_s2.contiguous(), ties="first")
    dz = dzs.permute(0, 4, 1, 2, 3)
    xin = phased_input(x).contiguous(memory_format=torch.channels_last_3d)
    dx = torch.nn.grad.conv3d_input(xin.shape, ws, dz).permute(0, 2, 3, 1, 4)
    dws = torch.nn.grad.conv3d_weight(xin, ws.shape, dz)
    return dx, dws, dzs.sum(dim=(0, 1, 2, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stem_stage_gradients_bitwise_the_parent_spelling(shape, dtype):
    """StemStage's gradients, the bias's now from ``stem_bwd(...,
    bias_grad=True)``, are bitwise those of the backward that summed dzs
    itself; and with the bias frozen no bias gradient is asked for."""
    from neuroimagedisttraining_torch.models.alexnet3d import StemStage

    dt = getattr(torch, dtype)
    x_np, w_np, b_np = _inputs(shape, 12)
    x = torch.from_numpy(x_np).to(dt)
    ws = _port_w(w_np).to(dt)
    bs = torch.from_numpy(b_np).to(dt)
    rng = np.random.RandomState(13)
    d, h, w = shape[0] - 2, shape[1] - 2, shape[3] - 2
    g_pooled = torch.from_numpy(rng.randn(
        B, F, d // 3, h // 3, w // 3).astype(np.float32)).to(dt)
    g_s1 = torch.from_numpy(rng.randn(B, F).astype(np.float32))
    g_s2 = torch.from_numpy((0.01 * rng.randn(B, F)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, ws, bs)]
    outs = StemStage.apply(*leaves)
    got = torch.autograd.grad(outs, leaves, [g_pooled, g_s1, g_s2])
    want = _parent_stem_grads(x, ws, bs, g_pooled, g_s1, g_s2)
    for name, a, b in zip(("x", "kernel", "bias"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    frozen = [leaves[0], leaves[1], bs]
    outs = StemStage.apply(*frozen)
    dx, dws = torch.autograd.grad(outs, frozen[:2], [g_pooled, g_s1, g_s2])
    assert torch.equal(dx, want[0]) and torch.equal(dws, want[1])


def test_stem_bwd_refuses_a_bias_grad_that_is_not_a_bool():
    zs = torch.zeros(1, 3, 3, 3, 8)
    p = torch.zeros(1, 1, 1, 1, 8)
    g = torch.zeros(1, 8)
    for flag in (1, None, "yes"):
        with pytest.raises(ValueError):
            kernels.stem_bwd(zs, p, p, g, g, ties="first", bias_grad=flag)


def _old_stem(x, w, bias, scale, bias_gn, groups, eps=1e-6):
    """The pool-first stage as the port spelled it before the stem kernels:
    cuDNN conv with the sign-folded bias, f32 statistics, one max-pool."""
    gamma = scale.float().reshape(1, -1, 1, 1, 1)
    beta = bias_gn.float().reshape(1, -1, 1, 1, 1)
    sign = torch.where(scale >= 0, 1.0, -1.0).to(w.dtype)
    zs = torch.nn.functional.conv3d(phased_input(x),
                                    w * sign.reshape(-1, 1, 1, 1, 1),
                                    bias * sign)
    sf = sign.float().reshape(1, -1, 1, 1, 1)
    mu, sig = _group_stats(zs.float() * sf, groups, eps)
    sel = max_pool3d(zs, 3, 3).float() * sf
    return torch.relu((sel - mu) / sig * gamma + beta).to(zs.dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_stem_stage_function_matches_plain_spelling(shape):
    rng = np.random.RandomState(7)
    # two channels per group, as the full-width stage has (64 over 32): with
    # one channel per group the bias cancels from the output and its
    # gradient is round-off
    stage = S2DStemStage(features=F, max_groups=F // 2)
    stage.reset_parameters(torch.Generator().manual_seed(7))
    with torch.no_grad():
        stage.bias.copy_(torch.from_numpy(0.1 * rng.randn(F)))
        stage.scale.copy_(torch.from_numpy(1.0 + 0.3 * rng.randn(F)))
        stage.scale[[1, 4]] = torch.tensor([-0.7, -1.2])
        stage.bias_gn.copy_(torch.from_numpy(0.1 * rng.randn(F)))
    x = torch.from_numpy((0.5 + rng.randn(B, *shape)).astype(np.float32))
    ct = torch.from_numpy(rng.randn(B, F, (shape[0] - 2) // 3,
                                    (shape[1] - 2) // 3,
                                    (shape[3] - 2) // 3).astype(np.float32))
    leaves = [stage.kernel, stage.bias, stage.scale, stage.bias_gn]
    outs = []
    for fn in (stage, lambda xx: _old_stem(
            xx, stage.masked(), stage.bias, stage.scale, stage.bias_gn,
            stage.groups)):
        xx = x.clone().requires_grad_(True)
        kernels.reset_launches()
        y = fn(xx)
        grads = torch.autograd.grad(y, leaves + [xx], ct)
        assert sum(kernels.LAUNCHES.values()) == 0
        outs.append((y.detach(), grads))
    (y, g), (y0, g0) = outs
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("kernel", "bias", "scale", "bias_gn", "x"), g,
                          g0):
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-5, (name, rel)


def test_stem_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 5, 5, 8, 5)
    with pytest.raises(ValueError):
        kernels.stem_fwd(x, torch.zeros(12, 8, 3, 3, 3))  # F not a multiple
    with pytest.raises(ValueError):
        kernels.stem_fwd(x, torch.zeros(72, 8, 3, 3, 3))  # F > 64
    with pytest.raises(ValueError):
        kernels.stem_fwd(x, torch.zeros(8, 8, 3, 3, 3).double())
    with pytest.raises(ValueError):
        kernels.stem_fwd(torch.zeros(1, 2, 5, 8, 5),
                         torch.zeros(8, 8, 3, 3, 3))
    zs = torch.zeros(1, 3, 3, 3, 8)
    p = torch.zeros(1, 1, 1, 1, 8)
    g = torch.zeros(1, 8)
    with pytest.raises(ValueError):
        kernels.stem_bwd(zs, p, p, g, g, ties="max")
    with pytest.raises(ValueError):
        kernels.stem_bwd(zs, p[..., :4], p, g, g, ties="first")
    zs_out, pooled, s1, s2 = kernels.stem_fwd(x, torch.ones(8, 8, 3, 3, 3),
                                              pool=False, stats=False)
    assert tuple(zs_out.shape) == (1, 3, 3, 3, 8)
    assert pooled is None and s1 is None and s2 is None
