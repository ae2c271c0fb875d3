"""The 3D-ResNet family (``3dresnet``, ``3dresnet_s2d``) and ``avg_pool3d``
against the JAX package, on the CPU, on numpy-seeded inputs.

The JAX models take no widths, so every case runs them at full width on the
smallest volume their pools survive, 29x33x29 (phased for the k3/p3 stem:
(17, 19, 8, 17)); weights are the reference's, converted. Tolerances:
``avg_pool3d`` within rtol 1e-6 of flax's ``nn.avg_pool``; the forwards
(logits and features) within 1e-5 norm-wise (the frameworks sum the
convolutions and GroupNorm statistics in other orders; 14 of each, measured
4e-7 to 2e-6); the twin on the dense model's converted weights within the
JAX package's own bound, 2e-4 (``tests/test_s2d.py``); the gradients within
1e-4 norm-wise (measured 1.7e-6), the 37 dead slots of the phased stem
kernel exactly zero; the converters, the wires' ``[C, N]`` matrix and the
per-layer FLOPs exact. The SNIP mask and a SalientGrads round on the twin
are in ``tests/test_torch_port_resnet3d_round.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
import flax.linen as fnn  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.models.resnet3d import \
    convert_resnet3d_params as jconvert  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phase_decompose as jphase  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402
from neuroimagedisttraining_tpu.utils import flops as jflops  # noqa: E402
from neuroimagedisttraining_torch.convert import (  # noqa: E402
    jax_params_to_torch,
    reference_leaf_order,
)
from neuroimagedisttraining_torch.models import (  # noqa: E402
    convert_resnet3d_params,
    create_model,
    make_apply_fn,
)
from neuroimagedisttraining_torch.models.layers import avg_pool3d  # noqa: E402
from neuroimagedisttraining_torch.ops.s2d import phase_decompose  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from neuroimagedisttraining_torch.utils import flops as tflops  # noqa: E402

VOLUME = (29, 33, 29)
DENSE = VOLUME + (1,)
PHASED = phased_sample_shape(VOLUME, kernel=3, pad=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many CPU ops on one worker of the suite's parallel run: one thread
    (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(key):
    return PHASED if key.endswith("_s2d") else DENSE


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _shapes(key, **kw):
    """The reference's parameter tree of ``key`` as shapes (no compile)."""
    return jax.eval_shape(lambda: jinit(jcreate(key, num_classes=1, **kw),
                                        jax.random.PRNGKey(0),
                                        _sample(key)))


def _random_tree(shapes, seed, lead=()):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rs.randn(*lead, *s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("padding", [0, 1])
@pytest.mark.parametrize("kernel,strides", [(3, None), (2, 1), ((3, 2, 3),
                                                               (2, 2, 1))])
def test_avg_pool3d_matches_flax(kernel, strides, padding):
    """NCDHW, floor mode, ``strides`` defaulting to ``kernel``, the padding
    counted in every window's mean (flax's ``count_include_pad=True``)."""
    x = np.random.RandomState(0).randn(2, 7, 8, 9, 3).astype(np.float32)
    k = (kernel,) * 3 if isinstance(kernel, int) else kernel
    s = k if strides is None else (
        (strides,) * 3 if isinstance(strides, int) else strides)
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), k, s,
                                   [(padding, padding)] * 3))
    got = avg_pool3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), kernel,
                     strides, padding).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _pair(key, seed=0, **kw):
    """Both sides' ``key`` at full width on the 29x33x29 volume, the
    reference's parameters (numpy) and their conversion."""
    jm = jcreate(key, num_classes=1, **kw)
    params = pc.np_tree(jinit(jm, jax.random.PRNGKey(seed), _sample(key)))
    tm = create_model(key, num_classes=1, sample_shape=_sample(key), **kw)
    return jm, params, tm, jax_params_to_torch(params)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_forward_matches_reference(block):
    """Eval-mode ``[logits, features]`` of a batch of 2 with the
    reference's weights; the converted names are the model's parameters
    (49 leaves for basic blocks, 70 for bottlenecks)."""
    jm, params, tm, sd = _pair("3dresnet", block=block)
    names = dict(tm.named_parameters())
    assert sorted(sd) == sorted(names)
    assert all(sd[k].shape == names[k].shape for k in sd)
    assert len(sd) == {"basic": 49, "bottleneck": 70}[block]
    x = np.random.RandomState(1).randn(2, *DENSE).astype(np.float32)
    jl, jf = japply(jm)(params, jnp.asarray(x), train=False, rng=None)
    tl, tf = make_apply_fn(tm)(sd, torch.from_numpy(x), train=False)
    assert tl.shape == (2, 1) and tf.shape == (2, 512)
    assert _rel(tl.detach(), jl) < 1e-5
    assert _rel(tf.detach(), jf) < 1e-5


@pytest.mark.parametrize("pool_first", [True, False])
def test_resnet_s2d_forward_matches_reference(pool_first):
    """The twin on phased input, from the reference converter's weights,
    against the reference's twin (1e-5) and against the port's dense
    ``3dresnet`` on the raw volume (2e-4, ``tests/test_s2d.py``'s bound)."""
    jd, dparams, td, dsd = _pair("3dresnet")
    jm = jcreate("3dresnet_s2d", num_classes=1, pool_first=pool_first)
    params = pc.np_tree(jconvert(dparams))
    tm = create_model("3dresnet_s2d", num_classes=1, pool_first=pool_first,
                      sample_shape=PHASED)
    sd = jax_params_to_torch(params)
    x = np.random.RandomState(1).randn(2, *VOLUME).astype(np.float32)
    xs = np.array(jphase(jnp.asarray(x), kernel=3, pad=3))
    np.testing.assert_array_equal(
        phase_decompose(torch.from_numpy(x), kernel=3, pad=3).numpy(), xs)
    jl, jf = japply(jm)(params, jnp.asarray(xs), train=False, rng=None)
    tl, tf = make_apply_fn(tm)(sd, torch.from_numpy(xs), train=False)
    assert _rel(tl.detach(), jl) < 1e-5
    assert _rel(tf.detach(), jf) < 1e-5
    dl, dfeat = make_apply_fn(td)(dsd, torch.from_numpy(x[..., None]),
                                  train=False)
    np.testing.assert_allclose(tl.detach().numpy(), dl.detach().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tf.detach().numpy(), dfeat.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_resnet_s2d_gradients_match_reference():
    """The gradient of a BCE loss of the twin's logits, train mode, every
    leaf: norm-wise within 1e-4 of the reference's; the stem kernel's 37
    dead slots of 64 (per output and phase layout) exactly zero on both
    sides, the live ones not."""
    jm, params, tm, sd = _pair("3dresnet_s2d")
    x = np.random.RandomState(0).randn(2, *PHASED).astype(np.float32)
    y = np.array([0.0, 1.0], np.float32)

    def jloss(p):
        logits, _ = japply(jm)(p, jnp.asarray(x), train=True,
                               rng=jax.random.PRNGKey(0))
        return jnp.mean(jax.nn.softplus(logits[:, 0]) - y * logits[:, 0])

    jg = jax_params_to_torch(pc.np_tree(jax.grad(jloss)(params)))
    leaves = {k: v.requires_grad_(True) for k, v in sd.items()}
    logits, _ = make_apply_fn(tm)(leaves, torch.from_numpy(x), train=True,
                                  rng=torch.Generator())
    loss = torch.mean(torch.nn.functional.softplus(logits[:, 0])
                      - torch.from_numpy(y) * logits[:, 0])
    tg = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert sorted(tg) == sorted(jg)
    num = sum(float(((tg[k] - jg[k]) ** 2).sum()) for k in jg)
    den = sum(float((jg[k] ** 2).sum()) for k in jg)
    assert (num / den) ** 0.5 < 1e-4
    assert all(bool(torch.isfinite(g).all()) for g in tg.values())
    gk = tg["S2DResNetStem_0.kernel"]
    dead = tm.S2DResNetStem_0.slot_mask.expand_as(gk) == 0
    assert int((tm.S2DResNetStem_0.slot_mask == 0).sum()) == 37
    assert bool((gk[dead] == 0).all()) and bool((jg[
        "S2DResNetStem_0.kernel"][dead] == 0).all())
    assert bool((gk[~dead] != 0).any())


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_convert_resnet3d_params_matches_reference(block):
    """The port's converter on its own dicts, bitwise the reference's on
    the same values."""
    shapes = _shapes("3dresnet", block=block)
    params = _random_tree(shapes, 3)
    want = jax_params_to_torch(pc.np_tree(jconvert(params)))
    got = convert_resnet3d_params(jax_params_to_torch(params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy().view(np.uint32),
                                      want[k].numpy().view(np.uint32),
                                      err_msg=k)
    names = dict(create_model("3dresnet_s2d", block=block,
                              sample_shape=PHASED).named_parameters())
    assert sorted(names) == sorted(got)


@pytest.mark.parametrize("key", ["3dresnet", "3dresnet_s2d"])
def test_flat_matrix_and_leaf_order_match_reference(key):
    """The aggregation wires' ``[C, N]`` matrix of a converted stack equals
    the reference's element for element, through the nested
    ``BasicBlock3D_i/Conv3d_j/Conv_0`` scopes and the phased
    ``(2, 2, 2, 8, 64)`` stem kernel."""
    shapes = _shapes(key)
    js = _random_tree(shapes, 5, lead=(3,))
    rows = [jax_params_to_torch(jax.tree_util.tree_map(lambda a: a[c], js))
            for c in range(3)]
    ts = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    names = [".".join(p.key for p in path if p.key != "Conv_0")
             for path, _ in jax.tree_util.tree_leaves_with_path(shapes)]
    assert reference_leaf_order(ts) == names
    got = tc.stacked_to_mat(ts).numpy()
    want = np.asarray(jc.stacked_to_mat(
        jax.tree_util.tree_map(jnp.asarray, js)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("key,block", [("3dresnet", "basic"),
                                       ("3dresnet", "bottleneck"),
                                       ("3dresnet_s2d", "basic")])
def test_per_layer_flops_match_reference(key, block):
    """Per-layer dense FLOPs equal the reference's counter: the phased stem
    at its conv output's extent (where the reference sows ``conv_out``),
    the 1x1 downsample convs, the dense layers."""
    shapes = _shapes(key, block=block)
    want = jflops.per_layer_flops(jcreate(key, num_classes=1, block=block),
                                  shapes, _sample(key))
    tm = create_model(key, num_classes=1, block=block,
                      sample_shape=_sample(key))
    got = tflops.per_layer_flops(tm, {k: v.detach() for k, v in
                                      tm.named_parameters()}, _sample(key))
    want = {".".join(p for p in path if p != "Conv_0"): v
            for path, v in want.items()}
    assert got == want
    assert any(".Conv3d_2" in k for k in got)  # a downsample conv
    if key == "3dresnet_s2d":
        # the stem conv's 17x19x17 output at 29x33x29, not the pooled one
        assert got["S2DResNetStem_0"] == 2.0 * 17 * 19 * 17 * 64 * 8 * 8


@pytest.mark.parametrize("key", ["3dresnet", "3dresnet_s2d"])
def test_volume_below_29_raises_naming_it(key):
    """The stem, the stages' strides and the 3x3x3/s3 average pool need 29
    voxels a side; below that the model refuses at construction, naming
    the volume (the phased shape for the twin; the reference's initializer
    fails with a ZeroDivisionError)."""
    create_model(key, sample_shape=_sample(key))
    vols = ((28, 33, 29), (29, 33, 28), (8, 8, 8))
    for vol in vols:
        shape = (phased_sample_shape(vol, kernel=3, pad=3)
                 if key.endswith("_s2d") else vol + (1,))
        shown = (f"ResNet3DL3S2D: the phased sample shape "
                 f"{'x'.join(map(str, shape))}" if key.endswith("_s2d") else
                 f"ResNet3DL3: the volume {'x'.join(map(str, vol))}")
        with pytest.raises(ValueError, match=shown + " is too small"):
            create_model(key, sample_shape=shape)
