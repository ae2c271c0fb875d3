"""The port's data layout, models, losses and optimizer against the JAX
package, on the CPU, on numpy-seeded inputs.

Tolerances: the phase decomposition and kernel remap are exact; the narrow
AlexNet3DS2D forward and its input gradient agree within rtol 1e-5 in
float32 (the two frameworks sum convolutions and GroupNorm statistics in
different orders); BCE, clipping and the SGD step within 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.core import losses as jlosses  # noqa: E402
from neuroimagedisttraining_tpu.core import optim as joptim  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.ops import s2d as js2d  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core import losses as tlosses  # noqa: E402
from neuroimagedisttraining_torch.core import optim as toptim  # noqa: E402
from neuroimagedisttraining_torch.models import create_model, make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.models.layers import group_norm  # noqa: E402
from neuroimagedisttraining_torch.ops import s2d as ts2d  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: among the suite's parallel workers torch's
    default of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: narrow AlexNet3DS2D: the smallest cubic volume that survives three pools
WIDTHS = (8, 16, 16, 16, 16)
VOLUME = (69, 69, 69)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kernel,pad", [(5, 0), (3, 1), (3, 3)])
def test_phase_decompose_exact(kernel, pad):
    rng = np.random.RandomState(kernel + pad)
    x = rng.randn(2, 13, 11, 9).astype(np.float32)
    want = np.asarray(js2d.phase_decompose(x, kernel, pad))
    np.testing.assert_array_equal(ts2d.phase_decompose(x, kernel, pad), want)
    got = ts2d.phase_decompose(torch.from_numpy(x), kernel, pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ts2d.phased_sample_shape((13, 11, 9), kernel, pad) == \
        js2d.phased_sample_shape((13, 11, 9), kernel, pad)


def test_remap_stem_kernel_and_slot_mask_exact():
    w = np.random.RandomState(0).randn(5, 5, 5, 1, 4).astype(np.float32)
    np.testing.assert_array_equal(ts2d.remap_stem_kernel(w),
                                  np.asarray(js2d.remap_stem_kernel(w)))
    for k in (3, 5):
        np.testing.assert_array_equal(ts2d.stem_slot_mask(k),
                                      js2d.stem_slot_mask(k))
    assert int(ts2d.stem_slot_mask(5).sum()) == 125


def test_convert_alexnet3d_params_matches_reference():
    dense = jax.eval_shape(
        lambda: jinit(jcreate("3dcnn"), jax.random.PRNGKey(1),
                      (121, 145, 121, 1)))
    dense = jax.tree_util.tree_map(
        lambda s: np.random.RandomState(s.size % 97).randn(*s.shape)
        .astype(np.float32), dense)
    want = _np_tree(js2d.convert_alexnet3d_params(dense))
    got = ts2d.convert_alexnet3d_params(dense)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, a), (_, b) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _narrow_pair(pool_first, seed=0):
    """The same narrow AlexNet3DS2D on both sides, with one negative
    GroupNorm scale in the stem (exercising the sign fold)."""
    ss = js2d.phased_sample_shape(VOLUME)
    jm = jcreate("3dcnn_s2d", num_classes=1, widths=WIDTHS,
                 dropout_rate=0.0, pool_first=pool_first)
    params = _np_tree(jinit(jm, jax.random.PRNGKey(seed), ss))
    rng = np.random.RandomState(seed)
    stem = params["S2DStemStage_0"]
    stem["scale"] = (1.0 + 0.3 * rng.randn(WIDTHS[0])).astype(np.float32)
    stem["scale"][1] = -0.7
    stem["bias_gn"] = (0.1 * rng.randn(WIDTHS[0])).astype(np.float32)
    stem["bias"] = (0.1 * rng.randn(WIDTHS[0])).astype(np.float32)
    tm = create_model("3dcnn_s2d", num_classes=1, widths=WIDTHS,
                      dropout_rate=0.0, pool_first=pool_first,
                      sample_shape=ss)
    return jm, params, tm, jax_params_to_torch(params), ss


def test_converted_state_dict_matches_model_parameters():
    _, _, tm, sd, _ = _narrow_pair(True)
    names = dict(tm.named_parameters())
    assert sorted(sd) == sorted(names)
    for k, v in sd.items():
        assert v.shape == names[k].shape, k
    assert len(sd) == 24 and sum(k.endswith(".kernel") for k in sd) == 7


@pytest.mark.parametrize("pool_first", [True, False])
def test_alexnet3d_s2d_forward_and_input_grad(pool_first):
    jm, params, tm, sd, ss = _narrow_pair(pool_first)
    x = np.random.RandomState(2).randn(3, *ss).astype(np.float32)
    japp = japply(jm)
    jl, jvjp = jax.vjp(lambda xx: japp(params, xx, train=False, rng=None),
                       jnp.asarray(x))
    ct = np.random.RandomState(3).randn(*jl.shape).astype(np.float32)
    (jgx,) = jvjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = make_apply_fn(tm)(sd, xt, train=False)
    (tgx,) = torch.autograd.grad(tl, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-6)
    # The input gradient is held to the same network in float64: the port's
    # float32 gradient lies within 1e-5 of it (norm-wise; measured 4.1e-6),
    # while the reference's own float32 gradient on XLA:CPU lies 3.8e-5 from
    # it, so port and reference are compared at 1e-4.
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    l64 = make_apply_fn(tm.double())({k: v.double() for k, v in sd.items()},
                                     x64, train=False)
    (g64,) = torch.autograd.grad(l64, x64, torch.from_numpy(ct).double())
    g64 = g64.numpy()

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(tgx.numpy(), g64) < 1e-5
    assert rel(tgx.numpy(), np.asarray(jgx)) < 1e-4


def test_pool_first_equals_textbook_order():
    _, _, tm, sd, ss = _narrow_pair(True)
    _, _, tm2, _, _ = _narrow_pair(False)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, *ss)
                         .astype(np.float32))
    a = make_apply_fn(tm)(sd, x, train=False)
    b = make_apply_fn(tm2)(sd, x, train=False)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,shape", [
    ("small3dcnn", (9, 8, 7, 1)),
    ("small3dcnn_s2d", js2d.phased_sample_shape((9, 8, 7), 3, 1)),
])
def test_small_models_forward(name, shape):
    jm = jcreate(name, num_classes=1)
    params = _np_tree(jinit(jm, jax.random.PRNGKey(5), shape))
    x = np.random.RandomState(5).randn(4, *shape).astype(np.float32)
    jl = np.asarray(japply(jm)(params, jnp.asarray(x), train=False, rng=None))
    tl = make_apply_fn(create_model(name, num_classes=1))(
        jax_params_to_torch(params), torch.from_numpy(x), train=False)
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("channels", [8, 48, 64])
def test_group_norm_matches_flax(channels):
    import flax.linen as nn

    from neuroimagedisttraining_tpu.models.layers import group_norm as jgn

    rng = np.random.RandomState(channels)
    x = (3.0 + rng.randn(2, 5, 4, 3, channels)).astype(np.float32)
    scale = rng.randn(channels).astype(np.float32)
    bias = rng.randn(channels).astype(np.float32)
    mod = jgn(channels)
    want = np.asarray(mod.apply({"params": {"scale": scale, "bias": bias}},
                                jnp.asarray(x)))
    gn = group_norm(channels)
    assert gn.num_groups == mod.num_groups
    gn.scale.data = torch.from_numpy(scale)
    gn.bias.data = torch.from_numpy(bias)
    got = gn(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert isinstance(mod, nn.GroupNorm)


def test_bf16_apply_casts_and_returns_f32():
    _, _, tm, sd, ss = _narrow_pair(True)
    x = torch.randn((2,) + tuple(ss), generator=torch.Generator()
                    .manual_seed(0))
    out = make_apply_fn(tm, torch.bfloat16)(sd, x, train=False)
    ref = make_apply_fn(tm)(sd, x, train=False)
    assert out.dtype == torch.float32 and out.shape == (2, 1)
    torch.testing.assert_close(out, ref, rtol=0.1, atol=0.1)


def test_dropout_fed_masks_and_generator():
    _, _, tm, sd, ss = _narrow_pair(True)
    tm.dropout_rate = 0.5
    x = torch.from_numpy(np.random.RandomState(6).randn(2, *ss)
                         .astype(np.float32))
    app = make_apply_fn(tm)
    keep_all = [torch.ones(2, 16, dtype=torch.bool),
                torch.ones(2, 64, dtype=torch.bool)]
    # all-kept masks scale by 1/keep_prob = 2 at both layers
    assert torch.isfinite(app(sd, x, train=True, rng=keep_all)).all()
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    torch.testing.assert_close(app(sd, x, train=True, rng=g1),
                               app(sd, x, train=True, rng=g2))
    with pytest.raises(ValueError):
        app(sd, x, train=True, rng=None)


def test_bce_and_predictions():
    rng = np.random.RandomState(7)
    logits = (rng.randn(64, 1) * 8).astype(np.float32)
    logits[:3, 0] = [0.0, 40.0, -40.0]
    y = rng.randint(0, 2, 64).astype(np.int32)
    want = np.asarray(jlosses.bce_with_logits_per_example(
        jnp.asarray(logits), jnp.asarray(y)))
    got = tlosses.bce_with_logits_per_example(torch.from_numpy(logits),
                                              torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tlosses.predictions(torch.from_numpy(logits), "bce").numpy(),
        np.asarray(jlosses.predictions(jnp.asarray(logits), "bce")))


def test_clip_and_sgd_step():
    rng = np.random.RandomState(8)
    shapes = [(4, 3, 3), (17,), (5, 2)]
    g = [(rng.randn(*s) * 5).astype(np.float32) for s in shapes]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    m = [rng.randn(*s).astype(np.float32) for s in shapes]
    tg = [torch.from_numpy(a) for a in g]
    np.testing.assert_allclose(
        float(toptim.global_norm(tg)),
        float(joptim.global_norm([jnp.asarray(a) for a in g])), rtol=1e-6)
    jc = joptim.clip_by_global_norm([jnp.asarray(a) for a in g], 10.0)
    tc = toptim.clip_by_global_norm(tg, 10.0)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    lr = jnp.float32(1e-3)
    jp, jm = joptim.sgd_momentum_step(
        [jnp.asarray(a) for a in p], [jnp.asarray(a) for a in m],
        [jnp.asarray(a) for a in g], lr, 0.9, 5e-4)
    tp, tm = toptim.sgd_momentum_step(
        [torch.from_numpy(a) for a in p], [torch.from_numpy(a) for a in m],
        tg, torch.tensor(1e-3), 0.9, 5e-4)
    for a, b in zip(tp + tm, list(jp) + list(jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
