"""Augmented rounds on the image side against the JAX package, on the CPU:
SalientGrads and FedAvg on ``cnn_cifar10`` (and SalientGrads on
``resnet18``, ``num_blocks`` (1, 1, 1, 1), below), 4 clients of CIFAR-shaped numpy-seeded
images, CE over 10 classes, CIFAR-10's black pad value, so every training
and SNIP batch is cropped and flipped on both sides.

The port is fed the reference's draws: its epoch permutations, its crop and
flip draws per step (the ``augment`` seam) and its SNIP batches and their
crop and flip draws (``snip_idx``, ``snip_augment``). SNIP: the port's
scores within 1e-4 norm-wise of the reference's on the same draws, and its
mask within 0.1% of the reference's (score round-off at the threshold).
From the reference's initial state, 2 rounds: the global and personal rows
within rtol 1e-5 and atol 2e-7 (``tests/test_torch_port_resnet3d_round.py``'s
bounds), the train losses within rtol 1e-5, per-client accuracies equal,
eval losses within 2e-5.

``resnet18`` is held to the reference run in float64 instead
(``tests/test_torch_port_resnet18_f64.py``, a subprocess with JAX's x64
mode):
at batch 4 its 2-round trajectory is ill-conditioned in float32, so the
reference's own float32 run lands up to 1.3e-1 (a small GroupNorm bias,
norm-wise) from its float64 run on the same draws, and the reference's
float32 SNIP scores up to 3e-3 from float64 on some batches. There the
port's float64 rows are held to the reference's float64 ones at this
file's bounds (rtol 1e-5, atol 2e-7); its float32 SNIP scores (within
1e-4) and rows (within 1e-5, and under a cap) are no further from float64
than the reference's float32 ones, and its well-conditioned float32 rows
are within 1e-5 of float64.

Then the port alone: a fused block of 2 bitwise its eager rounds (with
dropout, whose keep masks the round draws after each step's crop and flip),
one gloo D = 2 mesh round bitwise its single-process replay, SalientGrads on
ResNet-IP (no maskable leaf) raising the reference's error, and
``bench_torch``'s ``cifar`` configuration at ``bench.py``'s constants.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_mesh_workers as mw  # noqa: E402
import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import cifar as jcifar  # noqa: E402
from neuroimagedisttraining_tpu.data.types import FederatedData as JData  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.ops import sparsity as jsp  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvg,
    FedAvgState,
    SalientGrads,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
)
from neuroimagedisttraining_torch.data import CropFlip  # noqa: E402
from neuroimagedisttraining_torch.data.types import FederatedData  # noqa: E402
from neuroimagedisttraining_torch.models import create_model, make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402

N_CLIENTS, SAMPLES, TEST, BS, CLASSES = 4, 8, 4, 4, 10
PAD = jcifar.black_pad_value(jcifar.CIFAR10_MEAN, jcifar.CIFAR10_STD)
MODELS = {"cnn_cifar10": {}, "resnet18": dict(num_blocks=(1, 1, 1, 1))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many CPU ops on one worker of the suite's parallel run: one thread
    (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=3):
    """Both sides' cohort (the same arrays), its pad value set."""
    rng = np.random.RandomState(seed)
    arrays = dict(
        x_train=rng.randn(N_CLIENTS, SAMPLES, 32, 32, 3).astype(np.float32),
        y_train=rng.randint(0, CLASSES, (N_CLIENTS, SAMPLES)).astype(
            np.int32),
        n_train=np.full(N_CLIENTS, SAMPLES, np.int32),
        x_test=rng.randn(N_CLIENTS, TEST, 32, 32, 3).astype(np.float32),
        y_test=rng.randint(0, CLASSES, (N_CLIENTS, TEST)).astype(np.int32),
        n_test=np.full(N_CLIENTS, TEST, np.int32))
    jd = JData(**{k: jnp.asarray(v) for k, v in arrays.items()},
               class_num=CLASSES, aug_pad_value=PAD)
    td = FederatedData(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                       class_num=CLASSES, aug_pad_value=PAD)
    return jd, td


def _hp(cls):
    return cls(lr=0.01, lr_decay=0.998, momentum=0.9, weight_decay=5e-4,
               grad_clip=10.0, local_epochs=1, steps_per_epoch=SAMPLES // BS,
               batch_size=BS)


def _aug_draws(key, b=BS):
    """``data.cifar.random_crop_flip``'s draws from its key, as the port's
    ``[3, b]`` (top offsets, left offsets, flips)."""
    k1, k2, k3 = jax.random.split(key, 3)
    return np.stack([
        np.asarray(jax.random.randint(k1, (b,), 0, 9)),
        np.asarray(jax.random.randint(k2, (b,), 0, 9)),
        np.asarray(jax.random.bernoulli(k3, 0.5, (b,))).astype(np.int64)])


def _round_draws(rng, local_steps):
    """The reference's draws of a round from its state key, per client:
    the epoch permutation and each step's crop and flip
    (``k_drop = fold_in(k_steps, s)``, ``k_aug, k_drop = split(k_drop)``)."""
    rng, round_key = jax.random.split(rng)
    keys = jax.random.split(round_key, N_CLIENTS + 1)
    perms, augs = [], []
    for c in range(N_CLIENTS):
        k_perm, k_steps = jax.random.split(keys[c])
        perms.append(np.array(epoch_permutations(
            k_perm, jnp.int32(SAMPLES), 1, SAMPLES, n_rows=SAMPLES)))
        augs.append(np.stack([_aug_draws(jax.random.split(
            jax.random.fold_in(k_steps, s))[0]) for s in range(local_steps)]))
    return rng, perms, augs


def _snip_draws(n_iters=1):
    """The reference's SNIP draws of ``init_state(PRNGKey(0))``: per client
    its batch rows and their crop and flip."""
    _, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    idx, aug = [], []
    for ck in jax.random.split(m_rng, N_CLIENTS):
        rows, draws = [], []
        for k in jax.random.split(ck, n_iters):
            k_idx, k_drop = jax.random.split(k)
            rows.append(np.asarray(jax.random.randint(k_idx, (BS,), 0,
                                                      SAMPLES)))
            draws.append(_aug_draws(jax.random.split(k_drop)[0]))
        idx.append(np.stack(rows))
        aug.append(np.stack(draws))
    return idx, aug


def _algos(name, key, jd, td, augment="auto"):
    jm = jcreate(key, num_classes=CLASSES, **MODELS[key])
    tm = create_model(key, num_classes=CLASSES, **MODELS[key])
    if name == "salientgrads":
        kw = dict(loss_type="ce", frac=1.0, seed=0, dense_ratio=0.5,
                  itersnip_iterations=1, augment=augment)
        return (JSalientGrads(jm, jd, _hp(JHyperParams), **kw),
                SalientGrads(tm, td, _hp(HyperParams), device="cpu", **kw))
    kw = dict(loss_type="ce", frac=1.0, seed=0, augment=augment)
    return (JFedAvg(jm, jd, _hp(JHyperParams), **kw),
            FedAvg(tm, td, _hp(HyperParams), device="cpu", **kw))


@pytest.mark.parametrize("name,key,augment", [
    ("salientgrads", "cnn_cifar10", "auto"),
    ("fedavg", "cnn_cifar10", "auto")])
def test_augmented_rounds_match_reference(name, key, augment):
    jd, td = _data()
    ja, ta = _algos(name, key, jd, td, augment)
    assert (ja.augment_fn is not None) == (ta.augment_fn is not None) == (
        augment == "auto")
    js = ja.init_state(jax.random.PRNGKey(0))
    g0 = jax_params_to_torch(pc.np_tree(js.global_params))
    if name == "salientgrads":
        # SNIP on the reference's batches and crop and flip draws
        idx, aug = _snip_draws()
        jscore = jsp.make_snip_score_fn(japply(ja.model), "ce", BS,
                                        augment_fn=ja.augment_fn)
        if ta.augment_fn is None:
            aug = None
        _, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
        ckeys = jax.random.split(m_rng, N_CLIENTS)
        tscore = tsp.make_snip_score_fn(make_apply_fn(ta.model), "ce", BS,
                                        augment_fn=ta.augment_fn)
        for c in range(N_CLIENTS):
            want = jax_params_to_torch(pc.np_tree(jscore(
                js.global_params, jd.x_train[c], jd.y_train[c],
                jnp.int32(SAMPLES), ckeys[c], 1)))
            got = tscore(g0, td.x_train[c], td.y_train[c], SAMPLES, 1,
                         idx=idx[c], augment=None if aug is None else aug[c])
            for k, v in want.items():
                assert pc.rel(got[k], v) < 1e-4, (c, k, pc.rel(got[k], v))
        init = ta.init_state(params=g0, snip_idx=idx, snip_augment=aug)
        jmask = jax_params_to_torch(pc.np_tree(js.mask))
        agree = sum(int((init.mask[k] == v).sum()) for k, v in jmask.items())
        assert agree / sum(v.numel() for v in jmask.values()) > 0.999
        state = SalientGradsState(
            global_params=g0, mask=jmask,
            personal_params=broadcast_tree(g0, N_CLIENTS),
            generator=torch.Generator())
    else:
        state = FedAvgState(global_params=g0,
                            personal_params=broadcast_tree(g0, N_CLIENTS),
                            generator=torch.Generator())
    rng = js.rng
    for r in range(2):
        rng, perms, augs = _round_draws(rng, ta.hp.local_steps)
        js, jmet = ja.run_round(js, r)
        state, tmet = ta.run_round(state, r, perms=perms, augment=augs)
        np.testing.assert_allclose(float(tmet["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    pc.compare(state.global_params, js.global_params, "dense")
    for c in range(N_CLIENTS):
        pc.compare({k: v[c] for k, v in state.personal_params.items()},
                   jax.tree_util.tree_map(lambda a: a[c],
                                          js.personal_params), "dense")
    tev, jev = ta.evaluate(state), ja.evaluate(js)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
    for k in ("global_loss", "personal_loss"):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=2e-5)


def _fused_pair(algo, state, rounds=2):
    s, mets, evals = algo.clone_state(state), [], []
    for r in range(rounds):
        s, met = algo.run_round(s, r)
        mets.append(float(met["train_loss"]))
        evals.append({k: float(v) for k, v in algo.evaluate(s).items()
                      if not k.startswith("acc_per")})
    sf, ys = algo.run_rounds_fused(algo.clone_state(state), 0, rounds,
                                   eval_every=1)
    host = ys.materialize()
    assert list(host["train_loss"]) == mets
    for i, ev in enumerate(evals):
        assert {k: float(v[i]) for k, v in host["eval"].items()} == ev
    for f in ("global_params", "personal_params"):
        a, b = getattr(s, f), getattr(sf, f)
        assert all(torch.equal(a[k], b[k]) for k in a), f


@pytest.mark.parametrize("name", ["salientgrads", "fedavg"])
def test_fused_block_bitwise_eager_with_augment(name):
    """A fused block of 2 against 2 eager rounds and evals: SalientGrads on
    ``cnn_cifar10``; FedAvg on ``cnn_dropout`` (MNIST-shaped images, a pad
    value of its own), where each step draws its crop and flip, then its
    two dropout masks."""
    if name == "salientgrads":
        algo = mw.build_image_algo("salientgrads")
    else:
        rng = np.random.RandomState(8)
        data = FederatedData(
            x_train=torch.from_numpy(rng.randn(3, 10, 28, 28, 1).astype(
                np.float32)),
            y_train=torch.from_numpy(rng.randint(0, 10, (3, 10)).astype(
                np.int32)),
            n_train=torch.tensor([10, 7, 9], dtype=torch.int32),
            x_test=torch.from_numpy(rng.randn(3, 4, 28, 28, 1).astype(
                np.float32)),
            y_test=torch.from_numpy(rng.randint(0, 10, (3, 4)).astype(
                np.int32)),
            n_test=torch.full((3,), 4, dtype=torch.int32), class_num=10,
            aug_pad_value=(-0.42,))
        torch.manual_seed(0)
        algo = FedAvg(create_model("cnn_dropout", num_classes=10), data,
                      _hp(HyperParams).__class__(
                          lr=0.01, momentum=0.9, local_epochs=2,
                          steps_per_epoch=3, batch_size=4),
                      loss_type="ce", frac=1.0, seed=0, device="cpu")
        assert algo._dropout_calls(algo._template(algo.init_state()))
    assert isinstance(algo.augment_fn, CropFlip)
    _fused_pair(algo, algo.init_state())


def test_augment_off_and_callable():
    """``augment=False`` trains on the raw batches, and draws no crop;
    a callable is used as it is, fed each step's ``[3, batch]`` draws."""
    _, td = _data()
    calls = []

    def ident(xb, draws):
        calls.append(tuple(draws.shape))
        return xb

    states = {}
    for aug in ("auto", False, ident):
        torch.manual_seed(0)
        a = FedAvg(create_model("cnn_cifar10", num_classes=CLASSES), td,
                   _hp(HyperParams), loss_type="ce", frac=1.0, seed=0,
                   augment=aug, device="cpu")
        s = a.init_state()
        states[str(aug)], _ = a.run_round(s, 0)
    assert calls and set(calls) == {(3, BS)}
    a, b, c = (states[k].global_params for k in states)
    assert not all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_mesh_round_bitwise_single_process():
    """One gloo D = 2 mesh round of augmented SalientGrads replayed by one
    process from the mesh's state: the mask, every client's row, the train
    loss and the eval bitwise, the global model within 1e-6 of its largest
    value (the cross-rank sum reassociates)."""
    (ranks,) = mw.run_ranks(2, [("image_round_case", dict(rounds=1))])
    replay = mw.replay_off_mesh(mw.build_image_algo(), ranks, 1)
    for k, v in replay["mask"].items():
        np.testing.assert_array_equal(ranks[0]["mask"][k], v)
    got = mw._whole(ranks, 1, "personal")
    for k, v in replay["states"][0]["personal"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in replay["states"][0]["global_params"].items():
        g = ranks[0]["states"][1]["global_params"][k]
        assert float(np.abs(g - v).max()) <= 1e-6 * max(
            float(np.abs(v).max()), 1e-30), k
    for r in ranks:
        assert float(r["mets"][0]["train_loss"]) == float(
            replay["mets"][0]["train_loss"])
        for k in ("global_acc", "personal_acc", "personal_loss",
                  "global_loss"):
            np.testing.assert_allclose(r["evals"][0][k],
                                       replay["evals"][0][k], rtol=1e-6)


def test_salientgrads_on_resnet_ip_raises_reference_error():
    """ResNet-IP has no leaf named ``kernel``: both SNIP passes fail at the
    global mask's concatenation, with the same error."""
    jd, td = _data()
    kw = dict(loss_type="ce", frac=1.0, seed=0, dense_ratio=0.5)
    ja = JSalientGrads(jcreate("resnet_ip", num_classes=CLASSES,
                               layers=(1, 1, 1)), jd, _hp(JHyperParams), **kw)
    ta = SalientGrads(create_model("resnet_ip", num_classes=CLASSES,
                                   layers=(1, 1, 1)), td, _hp(HyperParams),
                      device="cpu", **kw)
    with pytest.raises(ValueError) as je:
        ja.init_state(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as te:
        ta.init_state()
    assert str(te.value) == str(je.value)
    # without SNIP (the dense control) it trains, as the reference does
    ta = SalientGrads(create_model("resnet_ip", num_classes=CLASSES,
                                   layers=(1, 1, 1)), td, _hp(HyperParams),
                      device="cpu", snip_mask=False, **kw)
    s, met = ta.run_round(ta.init_state(), 0)
    assert np.isfinite(float(met["train_loss"]))


def test_bench_cifar_config_matches_bench_py():
    """``bench_torch.bench_config("cifar")`` holds ``bench.py``'s CIFAR
    constants and metric; its cohort builder makes the shapes, labels and
    pad value; ``cifar()`` returns None without CUDA."""
    import bench_torch as b

    cfg = b.bench_config("cifar")
    assert cfg["metric"] == ("salientgrads_rounds_per_sec_cifar_resnet18gn_"
                             "100clients_frac0.1")
    assert (cfg["model_key"], cfg["n_clients"], cfg["samples_per_client"],
            cfg["test_per_client"], cfg["batch"], cfg["local_epochs"],
            cfg["steps_per_epoch"], cfg["frac"], cfg["dense_ratio"],
            cfg["lr"], cfg["compute_dtype"]) == (
        "resnet18", 100, 500, 100, 16, 5, 32, 0.1, 0.3, 0.1, "bfloat16")
    small = dict(cfg, n_clients=3, samples_per_client=6, test_per_client=2)
    d = b.cifar_data(small, torch.Generator().manual_seed(0))
    assert tuple(d.x_train.shape) == (3, 6, 32, 32, 3)
    assert d.x_train.dtype == torch.bfloat16 and d.class_num == 10
    assert d.aug_pad_value == PAD
    assert int(d.y_train.max()) < 10
    if not torch.cuda.is_available():
        assert b.cifar(emit=False) is None
