"""The dense-stem AlexNet family (``3dcnn``, ``3dcnn_deeper``,
``3dcnn_regression``), its losses and the ``flat`` layout against the JAX
package, on the CPU, on numpy-seeded inputs.

The JAX models take no widths, so every case runs them at full width on the
smallest volume their three pools survive, 69^3. Tolerances: the forward
with converted weights within rtol 1e-5 (atol 1e-6) on the logits and
within 1e-5 of the largest feature on the regression head's features (the
frameworks sum convolutions and GroupNorm statistics in different orders);
the converted ``[C, N]`` matrix bit for bit; the CE and MSE per-example
losses within rtol 1e-6; one SalientGrads round against the reference's
(the main path's kernel flags, Pallas in interpret mode; its epoch
permutations fed at the seams, dropout 0, data seed 2, whose
round has no max-pool or relu tie flip between the frameworks) within the
round tests' rtol 1e-5 on the loss and parameters (atol 1e-5 of each
leaf's largest value: every weight trains) and per-client accuracies
equal; ``--layout flat`` (channel-less storage, the channel injected at
apply time) against ``channels`` bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core import losses as jlosses  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    SalientGrads,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import (  # noqa: E402
    jax_params_to_torch,
    reference_leaf_order,
)
from neuroimagedisttraining_torch.core import losses as tlosses  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
)
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model, make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402

VOLUME = (69, 69, 69)
SAMPLE = VOLUME + (1,)
KEYS = ("3dcnn", "3dcnn_deeper", "3dcnn_regression")
N_CLIENTS, SAMPLES, TEST, BS = 2, 4, 3, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many CPU ops on one worker of the suite's parallel run: one thread
    (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(key, seed=0, dropout_rate=0.5):
    """Both sides' model ``key`` at full width on the 69^3 volume, the
    reference's parameters (numpy) and their conversion."""
    jm = jcreate(key, num_classes=1, dropout_rate=dropout_rate)
    params = pc.np_tree(jinit(jm, jax.random.PRNGKey(seed), SAMPLE))
    tm = create_model(key, num_classes=1, dropout_rate=dropout_rate,
                      sample_shape=SAMPLE)
    return jm, params, tm, jax_params_to_torch(params)


@pytest.mark.parametrize("key", KEYS)
def test_dense_forward_matches_reference(key):
    """Eval-mode forward of a batch of 2 with the reference's weights; the
    list outputs of the deeper ([logits, logits]) and regression ([pred,
    NDHWC features]) models included, and the converted names are the
    model's parameters."""
    jm, params, tm, sd = _pair(key)
    names = dict(tm.named_parameters())
    assert sorted(sd) == sorted(names)
    assert all(sd[k].shape == names[k].shape for k in sd)
    x = np.random.RandomState(1).randn(2, *SAMPLE).astype(np.float32)
    jout = japply(jm)(params, jnp.asarray(x), train=False, rng=None)
    tout = make_apply_fn(tm)(sd, torch.from_numpy(x), train=False)
    if key == "3dcnn":
        jout, tout = [jout], [tout]
    assert isinstance(tout, list) and len(tout) == len(jout)
    logits = tout[0].detach().numpy()
    assert logits.shape == (2, 1)
    np.testing.assert_allclose(logits, np.asarray(jout[0]), rtol=1e-5,
                               atol=1e-6)
    if key == "3dcnn_deeper":
        assert tout[1] is tout[0]
    if key == "3dcnn_regression":
        feats, want = tout[1].detach().numpy(), np.asarray(jout[1])
        assert feats.shape == want.shape == (2, 1, 1, 1, 128)
        np.testing.assert_allclose(feats, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("key", KEYS)
def test_flat_matrix_and_leaf_order_match_reference(key):
    """The aggregation wires' ``[C, N]`` matrix of a converted stack equals
    the reference's element for element, through the nested
    ``_Features_0/Conv3d_i/Conv_0`` scopes: the same leaf order, each leaf
    in its reference layout."""
    shapes = jax.eval_shape(lambda: jinit(jcreate(key, num_classes=1),
                                          jax.random.PRNGKey(0), SAMPLE))
    rs = np.random.RandomState(5)
    js = jax.tree_util.tree_map(
        lambda s: rs.randn(3, *s.shape).astype(np.float32), shapes)
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


def test_ce_and_mse_losses_match_reference():
    """Per-example and mean CE and MSE (and BCE) against the JAX package's,
    on plain and list (``[logits, features]``) outputs, and the hard
    predictions: argmax for CE and MSE alike, the reference's rule."""
    rs = np.random.RandomState(3)
    logits = rs.randn(8, 5).astype(np.float32) * 3
    labels = rs.randint(0, 5, 8).astype(np.int32)
    preds = rs.randn(8, 1).astype(np.float32)
    targets = rs.randn(8).astype(np.float32)
    bin_labels = rs.randint(0, 2, 8).astype(np.int32)
    feats = rs.randn(8, 4).astype(np.float32)
    cases = [("ce", logits, labels), ("mse", preds, targets),
             ("bce", preds, bin_labels)]
    for kind, out, y in cases:
        for wrap in (lambda a: a, lambda a: [a, feats]):
            j = jlosses.PER_EXAMPLE_LOSSES[kind](
                wrap(jnp.asarray(out)), jnp.asarray(y))
            t = tlosses.PER_EXAMPLE_LOSSES[kind](
                wrap(torch.from_numpy(out)), torch.from_numpy(y))
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       err_msg=kind)
            np.testing.assert_allclose(
                float(tlosses.make_loss_fn(kind)(
                    wrap(torch.from_numpy(out)), torch.from_numpy(y))),
                float(jlosses.make_loss_fn(kind)(
                    wrap(jnp.asarray(out)), jnp.asarray(y))), rtol=1e-6)
            np.testing.assert_array_equal(
                tlosses.predictions(wrap(torch.from_numpy(out)),
                                    kind).numpy(),
                np.asarray(jlosses.predictions(wrap(jnp.asarray(out)),
                                               kind)))
    for name in ("bce_with_logits_loss", "softmax_ce_loss", "mse_loss"):
        out, y = (logits, labels) if name.startswith("softmax") else \
            (preds, targets if name.startswith("mse") else bin_labels)
        np.testing.assert_allclose(
            float(getattr(tlosses, name)(torch.from_numpy(out),
                                         torch.from_numpy(y))),
            float(getattr(jlosses, name)(jnp.asarray(out), jnp.asarray(y))),
            rtol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        tlosses.make_loss_fn("hinge")


def test_apply_fn_casts_every_list_output_to_f32():
    """bf16 compute: each floating output of a list comes back float32."""
    _, _, tm, sd = _pair("3dcnn_regression")
    x = torch.from_numpy(np.random.RandomState(4).randn(
        1, *SAMPLE).astype(np.float32))
    out = make_apply_fn(tm, torch.bfloat16)(sd, x, train=False)
    assert [t.dtype for t in out] == [torch.float32, torch.float32]


@pytest.mark.parametrize("key", KEYS)
def test_volume_below_69_raises_naming_it(key):
    """Three 3x3x3/s3 pools need 69 voxels a side; below that the model
    refuses at construction, naming the volume (the reference's
    initializer fails with a ZeroDivisionError)."""
    create_model(key, sample_shape=SAMPLE)
    for vol in ((68, 69, 69, 1), (69, 69, 68), (8, 8, 8, 1)):
        with pytest.raises(ValueError,
                           match="x".join(map(str, vol[:3])) + " is too"):
            create_model(key, sample_shape=vol)


def _cohort(seed):
    kw = dict(seed=seed, n_clients=N_CLIENTS, samples_per_client=SAMPLES,
              test_per_client=TEST, sample_shape=SAMPLE, uneven=False)
    return jsynth(**kw), make_synthetic_federated(**kw)


def _hp(cls):
    return cls(lr=0.01, lr_decay=0.998, momentum=0.9, weight_decay=5e-4,
               grad_clip=10.0, local_epochs=1, steps_per_epoch=SAMPLES // BS,
               batch_size=BS)


def test_salientgrads_round_on_dense_alexnet_matches_reference():
    """One SalientGrads round on the dense-stem AlexNet3D from the
    reference's parameters and SNIP mask, fed the reference's epoch
    permutations: the loss, the global and personal models and the eval."""
    jd, td = _cohort(2)
    jm = jcreate("3dcnn", num_classes=1, dropout_rate=0.0)
    tm = create_model("3dcnn", num_classes=1, dropout_rate=0.0,
                      sample_shape=SAMPLE)
    jalgo = JSalientGrads(jm, jd, _hp(JHyperParams), loss_type="bce",
                          frac=1.0, seed=0, dense_ratio=0.5,
                          itersnip_iterations=1, fused_kernels=True,
                          agg_kernels="pallas")
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = SalientGrads(tm, td, _hp(HyperParams), loss_type="bce",
                         frac=1.0, seed=0, dense_ratio=0.5,
                         itersnip_iterations=1, device="cpu")
    g0 = jax_params_to_torch(pc.np_tree(jstate.global_params))
    state = SalientGradsState(
        global_params=g0, mask=jax_params_to_torch(pc.np_tree(jstate.mask)),
        personal_params=broadcast_tree(g0, N_CLIENTS),
        generator=torch.Generator())
    _, round_key = jax.random.split(jstate.rng)
    keys = jax.random.split(round_key, N_CLIENTS + 1)
    perms = [np.array(epoch_permutations(
        jax.random.split(keys[c])[0], jnp.int32(SAMPLES), 1, SAMPLES,
        n_rows=SAMPLES)) for c in range(N_CLIENTS)]
    jstate, jmet = jalgo.run_round(jstate, 0)
    state, tmet = talgo.run_round(state, 0, perms=perms)
    np.testing.assert_allclose(float(tmet["train_loss"]),
                               float(jmet["train_loss"]), rtol=1e-5)
    pc.compare(state.global_params, jstate.global_params, "dense",
               leaf_scale=True)
    for c in range(N_CLIENTS):
        pc.compare({k: v[c] for k, v in state.personal_params.items()},
                   jax.tree_util.tree_map(lambda a: a[c],
                                          jstate.personal_params),
                   "dense", leaf_scale=True)
    jev, tev = jalgo.evaluate(jstate), talgo.evaluate(state)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
    assert float(tev["mask_density"]) == float(jev["mask_density"])
    for k in ("global_loss", "personal_loss"):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=1e-5)


def test_flat_layout_equals_channels_bitwise():
    """``channel_inject`` over channel-less storage (``--layout flat``)
    against the channels layout: the same SNIP mask, round, eval and
    ``init_sample_shape``, bit for bit, with dropout drawing."""
    _, td = _cohort(3)
    flat = td.__class__(**{**td.__dict__, "x_train": td.x_train[..., 0],
                           "x_test": td.x_test[..., 0]})
    runs = {}
    for name, data, inject in (("channels", td, False), ("flat", flat,
                                                         True)):
        tm = create_model("3dcnn", num_classes=1, sample_shape=SAMPLE)
        algo = SalientGrads(tm, data, _hp(HyperParams), loss_type="bce",
                            seed=0, dense_ratio=0.5, itersnip_iterations=1,
                            channel_inject=inject, device="cpu")
        assert algo.init_sample_shape == SAMPLE
        s = algo.init_state()
        s, met = algo.run_round(s, 0)
        runs[name] = (s, float(met["train_loss"]),
                      {k: float(v) for k, v in algo.evaluate(s).items()
                       if not k.startswith("acc_per")})
    (sc, lc, ec), (sf, lf, ef) = runs["channels"], runs["flat"]
    assert lc == lf and ec == ef
    for f in ("mask", "global_params", "personal_params"):
        a, b = getattr(sc, f), getattr(sf, f)
        assert all(torch.equal(a[k], b[k]) for k in a), f
