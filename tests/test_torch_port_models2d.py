"""The 2D image models (the 16 2D registry keys) against the JAX package,
on the CPU, on numpy-seeded inputs.

Every key at a small size: batch 2; ``num_blocks`` (1, 1, 1, 1) where the
class takes it; ResNet-IP's ``layers`` (1, 1, 1); the ImageNet-layout
ResNets on 32x32; weights the reference's, converted
(``convert.jax_params_to_torch``). Tolerances: logits within 1e-5
norm-wise (VGG's GroupNorms over 16 values at 1x1 put single logits 2e-5
apart), gradients of a fixed random projection of the logits within
1e-4 norm-wise per leaf (the frameworks sum convolutions and norm
statistics in other orders). ``CNNDropOut`` in training takes the
reference's own keep masks. ``OriginalResNet18``'s updated running
statistics within rtol 1e-5; the algorithms' forward of it (parameters
alone) raises flax's message. The leaf order and the wires' ``[C, N]``
matrix are exact, and so are the per-layer FLOPs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
import flax.linen as fnn  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.models import meta as jmeta  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402
from neuroimagedisttraining_tpu.utils import flops as jflops  # noqa: E402
from neuroimagedisttraining_torch.convert import (  # noqa: E402
    jax_params_to_torch,
    reference_leaf_order,
)
from neuroimagedisttraining_torch.models import (  # noqa: E402
    MODEL_NAMES,
    MODELS_2D,
    create_model,
    init_params,
    make_apply_fn,
)
from neuroimagedisttraining_torch.models import meta as tmeta  # noqa: E402
from neuroimagedisttraining_torch.models.layers import (  # noqa: E402
    ScopeCollectionNotFound,
)
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from neuroimagedisttraining_torch.utils import flops as tflops  # noqa: E402

CLASSES = 10
SMALL = {"resnet18": dict(num_blocks=(1, 1, 1, 1)),
         "original_resnet18": dict(num_blocks=(1, 1, 1, 1)),
         "tiny_resnet18": dict(num_blocks=(1, 1, 1, 1)),
         "resnet_ip": dict(layers=(1, 1, 1))}
#: the MNIST-family models' own input
MNIST = ("cnn", "lenet5", "cnn_dropout")
#: the inputs' seed: on seed 1 a relu of ``resnet18``'s first block sits at
#: round-off and flips between the frameworks (a 4e-3 step in the
#: gradients below it), as ROADMAP's near-ties note describes
INPUT_SEED = 2
#: the reference's gradient run op by op, not as one compiled program: the
#: jitted XLA:CPU program of the hypernetworks' gradient sits 5e-3 off both
#: the op-by-op reference and the port, which agree within 1.1e-5
EAGER = ("resnet_meta",)


def _grad_fn(key, fn):
    fn = jax.value_and_grad(fn, has_aux=True)
    return fn if key in EAGER else jax.jit(fn)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many CPU ops on one worker of the suite's parallel run: one thread
    (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(key):
    if key in MNIST:
        return (28, 28, 1)
    return (64, 64, 3) if key == "tiny_resnet18" else (32, 32, 3)


def _pair(key, seed=0):
    """Both sides' model of ``key``, the reference's variables and the
    port's parameters converted from them."""
    kw = SMALL.get(key, {})
    jm = jcreate(key, num_classes=CLASSES, **kw)
    ss = _sample(key)
    variables = jax.jit(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((1,) + ss), train=False))(
        jax.random.PRNGKey(seed))
    tm = create_model(key, num_classes=CLASSES, sample_shape=ss, **kw)
    params = jax_params_to_torch(pc.np_tree(variables["params"]))
    return jm, tm, variables, params, ss


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_registry_has_every_reference_key():
    from neuroimagedisttraining_tpu.models import _registry

    assert sorted(MODEL_NAMES) == sorted(_registry())
    assert len(MODELS_2D) == 16 and set(MODELS_2D) <= set(MODEL_NAMES)


def _dropout_recorder(masks):
    """A flax interceptor that records each Dropout's keep mask (in call
    order) and returns the layer's output computed from it."""
    def intercept(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != \
                "__call__" or mod.deterministic:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = 1.0 - mod.rate
        kept = next_fun(jnp.ones_like(x), **kwargs) != 0
        masks.append(kept)
        return jnp.where(kept, x / keep, jnp.zeros_like(x))
    return intercept


@pytest.mark.parametrize("key", MODELS_2D)
def test_forward_and_gradients_match_reference(key):
    """Logits (eval, and training where the model differs there) and the
    parameter gradients of ``sum(logits * R)``."""
    jm, tm, variables, params, ss = _pair(key)
    rng = np.random.RandomState(INPUT_SEED)
    x = rng.randn(2, *ss).astype(np.float32)
    r = rng.randn(2, CLASSES).astype(np.float32)
    tx = torch.from_numpy(x)
    if key == "original_resnet18":
        stats = jax_params_to_torch(pc.np_tree(variables["batch_stats"]))
        want = jax.jit(lambda v: jm.apply(v, x, train=False))(variables)
        got = tm.apply_with_stats(params, stats, tx, train=False)

        def jloss(p):
            out, upd = jm.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                x, train=True, mutable=["batch_stats"])
            return jnp.sum(out * r), (out, upd)

        (_, (jout, jupd)), jg = _grad_fn(key, jloss)(variables["params"])
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        tout, tupd = tm.apply_with_stats(leaves, stats, tx, train=True)
        want_stats = jax_params_to_torch(pc.np_tree(jupd["batch_stats"]))
        assert sorted(tupd) == sorted(want_stats)
        for k, v in want_stats.items():
            np.testing.assert_allclose(tupd[k].detach().numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    else:
        japp, tapp = japply(jm), make_apply_fn(tm)
        want = jax.jit(lambda p: japp(p, x, train=False, rng=None))(
            variables["params"])
        got = tapp(params, tx, train=False)

        def jloss(p):
            masks = []
            with fnn.intercept_methods(_dropout_recorder(masks)):
                out = japp(p, x, train=True, rng=jax.random.PRNGKey(3))
            return jnp.sum(out * r), (out, masks)

        (_, (jout, masks)), jg = _grad_fn(key, jloss)(variables["params"])
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        keep = ([torch.from_numpy(np.array(m)) for m in masks] if masks
                else None)
        if key == "cnn_dropout":
            assert [m.shape for m in masks] == [(2, 12, 12, 64), (2, 128)]
        tout = tapp(leaves, tx, train=True, rng=keep)
    assert _rel(got.detach().numpy(), want) < 1e-5
    assert _rel(tout.detach().numpy(), jout) < 1e-5
    names = list(leaves)
    grads = torch.autograd.grad(
        torch.sum(tout * torch.from_numpy(r)), [leaves[k] for k in names])
    want_g = jax_params_to_torch(pc.np_tree(jg))
    assert sorted(want_g) == sorted(names)
    for k, g in zip(names, grads):
        assert _rel(g.numpy(), want_g[k].numpy()) < 1e-4, (
            k, _rel(g.numpy(), want_g[k].numpy()))


def test_original_resnet18_without_batch_stats_raises_flax_message():
    """The algorithms run a model on its parameters alone: the BatchNorm
    ResNet raises at its first forward, with flax's message."""
    jm, tm, variables, params, ss = _pair("original_resnet18")
    x = np.zeros((1,) + ss, np.float32)
    with pytest.raises(Exception) as je:
        japply(jm)(variables["params"], x, train=True,
                   rng=jax.random.PRNGKey(0))
    with pytest.raises(ScopeCollectionNotFound) as te:
        make_apply_fn(tm)(params, torch.from_numpy(x), train=True,
                          rng=torch.Generator())
    assert type(je.value).__name__ == "ScopeCollectionNotFound"
    assert str(je.value).startswith(str(te.value)), (str(je.value),
                                                     str(te.value))


def test_meta_net_and_random_mask_match_reference():
    """``MetaNet`` on converted weights; ``init_random_mask`` bitwise from
    the reference's uniforms, at its density."""
    target = (5, 5, 3, 8)
    rng = np.random.RandomState(2)
    mask = (rng.rand(*target) < 0.3).astype(np.float32)
    jm = jmeta.MetaNet(target_shape=target)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(mask))["params"]
    tm = tmeta.MetaNet(target)
    tp = jax_params_to_torch(pc.np_tree(p))
    want = jm.apply({"params": p}, jnp.asarray(mask))
    got = torch.func.functional_call(tm, tp, (torch.from_numpy(mask),))
    assert got.shape == target
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    key = jax.random.PRNGKey(4)
    jmask = np.asarray(jmeta.init_random_mask(key, target, 0.2))
    u = torch.from_numpy(np.array(jax.random.uniform(
        key, (int(np.prod(target)),))))
    tmask = tmeta.init_random_mask(target, 0.2, scores=u)
    np.testing.assert_array_equal(tmask.numpy(), jmask)
    assert int(tmask.sum()) == int(0.2 * np.prod(target))
    g = tmeta.init_random_mask(target, 0.2,
                               generator=torch.Generator().manual_seed(0))
    assert int(g.sum()) == int(0.2 * np.prod(target))


@pytest.mark.parametrize("key", ["resnet18", "resnet_ip", "resnet_meta",
                                 "vgg11", "cnn_cifar10_meta"])
def test_leaf_order_and_flat_matrix_match_reference(key):
    """The wires' ``[C, N]`` matrix of a converted stack equals the
    reference's element for element: flax's auto-names sorted as strings
    (``Conv_10`` before ``Conv_2``), HWIO kernels, the dual leaves."""
    jm, tm, variables, params, ss = _pair(key)
    shapes = variables["params"]
    rng = np.random.RandomState(5)
    js = jax.tree_util.tree_map(
        lambda a: rng.randn(3, *a.shape).astype(np.float32), shapes)
    rows = [jax_params_to_torch(jax.tree_util.tree_map(lambda a: a[c], js))
            for c in range(3)]
    ts = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    names = [".".join(p.key for p in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(shapes)]
    assert reference_leaf_order(ts) == names
    assert sorted(ts) == sorted(dict(tm.named_parameters()))
    got = tc.stacked_to_mat(ts).numpy()
    want = np.asarray(jc.stacked_to_mat(
        jax.tree_util.tree_map(jnp.asarray, js)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_resnet18_at_cifar_width():
    """``resnet18`` at its full width: 62 leaves, 11,173,962 parameters,
    21 SNIP kernels of 11,164,352 entries (the ``cifar`` config's row)."""
    tm = create_model("resnet18", num_classes=10)
    params = dict(tm.named_parameters())
    assert len(params) == 62
    assert sum(v.numel() for v in params.values()) == 11_173_962
    kern = [v for k, v in params.items() if k.endswith(".kernel")]
    assert len(kern) == 21 and sum(v.numel() for v in kern) == 11_164_352
    p = init_params(tm, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in p.values())


@pytest.mark.parametrize("key", MODELS_2D)
def test_per_layer_flops_match_reference(key):
    """Per-layer dense FLOPs equal the reference's counter, also where it
    counts nothing (ResNet-IP has no ``kernel`` leaf) and where it counts
    the hypernetworks' dense layers, not the generated convs."""
    jm, tm, variables, params, ss = _pair(key)
    if key == "original_resnet18":
        # a forward on the parameters alone: flax's BatchNorm error
        with pytest.raises(Exception) as je:
            jflops.per_layer_flops(jm, variables["params"], ss)
        with pytest.raises(ScopeCollectionNotFound) as te:
            tflops.per_layer_flops(tm, params, ss)
        assert str(je.value).startswith(str(te.value))
        return
    want = jflops.per_layer_flops(jm, variables["params"], ss)
    got = tflops.per_layer_flops(tm, params, ss)
    assert got == {".".join(path): v for path, v in want.items()}
    if key == "resnet_ip":
        assert got == {}
