"""The port's SNIP mask and SalientGrads rounds against the JAX package, on
the CPU, on a numpy-seeded cohort, with the reference's random draws fed to
the port at its seams (SNIP batch indices, epoch permutations; dropout 0).

The JAX side runs the main path's kernel flags (``fused_kernels=True``,
``agg_kernels="pallas"``: Pallas in interpret mode). Tolerances: SNIP scores
rtol 1e-4; the mask from identical scores bit for bit; after two rounds the
global and personal parameters within rtol 1e-5 (atol 2e-7 for the conv
biases ahead of a GroupNorm, which hold only round-off, ~1e-10),
per-client accuracies equal.

A max-pool or relu decision that sits within float32 round-off of its tie
routes the gradient one way in one framework and the other way in the other:
a discrete flip, not drift. On this cohort (data seed 4) two rounds have
none; of data seeds 3..9, seeds 3, 5 and 9 flip once in round 2 (parameter
excess 1e-4 over the tolerance) and agree to ~1e-7 in round 1.
"""
import ast
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.algorithms.base import \
    sample_client_indexes as jsample  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.models import make_apply_fn as japply  # noqa: E402
from neuroimagedisttraining_tpu.ops import sparsity as jsp  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    SalientGrads,
    SalientGradsState,
    sample_client_indexes,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
)
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model, make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: among the suite's parallel workers torch's
    default of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTHS = (8, 16, 16, 16, 16)
SS = phased_sample_shape((69, 69, 69))
N_CLIENTS, SAMPLES, TEST, BS = 3, 6, 5, 4
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models():
    kw = dict(num_classes=1, widths=WIDTHS, dropout_rate=0.0)
    return (jcreate("3dcnn_s2d", **kw),
            create_model("3dcnn_s2d", sample_shape=SS, **kw))


def _data():
    kw = dict(seed=4, n_clients=N_CLIENTS, samples_per_client=SAMPLES,
              test_per_client=TEST, sample_shape=SS, uneven=True)
    return jsynth(**kw), make_synthetic_federated(**kw)


def _hp(cls, spe):
    return cls(lr=0.01, lr_decay=0.998, momentum=0.9, weight_decay=5e-4,
               grad_clip=10.0, local_epochs=1, steps_per_epoch=spe,
               batch_size=BS)


def _snip_idx(key, n_valid, n_iters):
    """The reference's SNIP batch draw for one client."""
    out = []
    for k in jax.random.split(key, n_iters):
        k_idx, _ = jax.random.split(k)
        out.append(np.asarray(jax.random.randint(
            k_idx, (BS,), 0, max(int(n_valid), 1))))
    return np.stack(out)


def _assert_tree_close(t_tree, j_tree, rtol, atol=0.0):
    want = jax_params_to_torch(_np(j_tree))
    assert sorted(want) == sorted(t_tree)
    for k, v in want.items():
        np.testing.assert_allclose(t_tree[k].detach().numpy(), v.numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_synthetic_cohorts_identical():
    jd, td = _data()
    for f in ("x_train", "y_train", "n_train", "x_test", "y_test", "n_test"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), err_msg=f)


def test_sample_client_indexes_matches_reference():
    for r in range(5):
        np.testing.assert_array_equal(sample_client_indexes(r, 10, 4),
                                      jsample(r, 10, 4))
    np.testing.assert_array_equal(sample_client_indexes(0, 6, 6),
                                  np.arange(6))


def test_snip_scores_and_mask():
    jm, tm = _models()
    jd, td = _data()
    params = _np(jinit(jm, jax.random.PRNGKey(1), SS))
    sd = jax_params_to_torch(params)
    jscore = jsp.make_snip_score_fn(japply(jm), "bce", BS)
    tscore = tsp.make_snip_score_fn(make_apply_fn(tm), "bce", BS)
    keys = jax.random.split(jax.random.PRNGKey(2), N_CLIENTS)
    jtot, ttot = None, None
    for c in range(N_CLIENTS):
        n = int(jd.n_train[c])
        js = _np(jscore(params, jd.x_train[c], jd.y_train[c], n, keys[c], 2))
        ts = tscore(sd, td.x_train[c], td.y_train[c], n, 2,
                    idx=_snip_idx(keys[c], n, 2))
        want = jax_params_to_torch(js)
        for k, v in want.items():
            scale = float(v.abs().max()) or 1.0
            np.testing.assert_allclose(ts[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=k)
        jtot = js if jtot is None else jax.tree_util.tree_map(
            np.add, jtot, js)
    # mask from IDENTICAL scores: bit for bit (the Pallas threshold and
    # score-mask kernels on the JAX side, the plain versions here)
    jmask = _np(jsp.mask_from_scores(jtot, 0.5, kernels="pallas"))
    tmask = tsp.mask_from_scores(jax_params_to_torch(jtot), 0.5)
    for k, v in jax_params_to_torch(jmask).items():
        np.testing.assert_array_equal(tmask[k].numpy(), v.numpy(),
                                      err_msg=k)
    assert abs(tsp.mask_density(tmask) - float(jsp.mask_density(jmask))) \
        == 0.0
    assert abs(tsp.mask_density(tmask) - 0.5) < 1e-3


def test_salientgrads_two_rounds_match_reference():
    jm, tm = _models()
    jd, td = _data()
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    spe = -(-max(nvals) // BS)
    jalgo = JSalientGrads(jm, jd, _hp(JHyperParams, spe), loss_type="bce",
                          frac=1.0, seed=0, dense_ratio=0.5,
                          itersnip_iterations=1, fused_kernels=True,
                          agg_kernels="pallas")
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = SalientGrads(tm, td, _hp(HyperParams, spe), loss_type="bce",
                         frac=1.0, seed=0, dense_ratio=0.5,
                         itersnip_iterations=1, device="cpu")

    # the port's own init (SNIP fed the reference's batch draws) agrees
    # with the reference's mask up to score round-off at the threshold
    _, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    ckeys = jax.random.split(m_rng, N_CLIENTS)
    init = talgo.init_state(
        params=jax_params_to_torch(_np(jstate.global_params)),
        snip_idx=[_snip_idx(ckeys[c], nvals[c], 1) for c in range(N_CLIENTS)])
    jmask = jax_params_to_torch(_np(jstate.mask))
    agree = sum(int((init.mask[k] == v).sum()) for k, v in jmask.items())
    assert agree / sum(v.numel() for v in jmask.values()) > 0.999

    # rounds from the reference's mask, fed the reference's permutations
    state = SalientGradsState(
        global_params=jax_params_to_torch(_np(jstate.global_params)),
        mask=jmask,
        personal_params=broadcast_tree(
            jax_params_to_torch(_np(jstate.global_params)), N_CLIENTS),
        generator=torch.Generator())
    rng = jstate.rng
    for r in range(2):
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, N_CLIENTS + 1)
        perms = [np.array(epoch_permutations(
            jax.random.split(keys[c])[0], jnp.int32(nvals[c]), 1, spe * BS,
            n_rows=jd.x_train.shape[1])) for c in range(N_CLIENTS)]
        jstate, jmet = jalgo.run_round(jstate, r)
        state, tmet = talgo.run_round(state, r, perms=perms)
        np.testing.assert_allclose(float(tmet["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
        jev = jalgo.evaluate(jstate)
        tev = talgo.evaluate(state)
        np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                      np.asarray(jev["acc_per_client"]))
        assert tev["mask_density"] == float(jev["mask_density"])
        # the protocol means of equal per-client accuracies, summed in
        # another order: within one float32 ulp
        for k in ("global_acc", "personal_acc"):
            np.testing.assert_allclose(float(tev[k]), float(jev[k]),
                                       rtol=1.2e-7)
        for k in ("global_loss", "personal_loss"):
            np.testing.assert_allclose(float(tev[k]), float(jev[k]),
                                       rtol=1e-5)
    _assert_tree_close(state.global_params, jstate.global_params, 1e-5, 2e-7)
    for c in range(N_CLIENTS):
        _assert_tree_close(
            {k: v[c] for k, v in state.personal_params.items()},
            jax.tree_util.tree_map(lambda a: a[c], jstate.personal_params),
            1e-5, 2e-7)


def test_run_on_cpu_end_to_end():
    """The library entry point, on the CPU, with its own draws."""
    _, tm = _models()
    _, td = _data()
    algo = SalientGrads(tm, td, _hp(HyperParams, 3), loss_type="bce",
                        dense_ratio=0.5, device="cpu")
    state, history = algo.run(comm_rounds=2, eval_every=1)
    assert [h["round"] for h in history] == [0, 1, -1]
    for h in history:
        for k, v in h.items():
            assert np.isfinite(v), (k, h)
    assert abs(history[-1]["mask_density"] - 0.5) < 1e-3
    for k, m in state.mask.items():
        if k.endswith(".kernel"):
            assert torch.all(state.global_params[k][m == 0] == 0), k


def test_client_update_dropout_seam():
    """Fed dropout masks replace the generator's draws: the same masks give
    the same update; all-dropped masks zero the head's input, so the
    update differs from all-kept ones."""
    from neuroimagedisttraining_torch.core.trainer import (
        epoch_permutations,
        make_client_update,
        round_lr,
    )
    from neuroimagedisttraining_torch.models import init_params

    ss = phased_sample_shape((9, 8, 7), 3, 1)
    tm = create_model("small3dcnn_s2d", dropout_rate=0.5)
    td = make_synthetic_federated(seed=1, n_clients=1, samples_per_client=8,
                                  test_per_client=2, sample_shape=ss,
                                  uneven=False)
    hp = _hp(HyperParams, 2)
    g = torch.Generator().manual_seed(0)
    params = init_params(tm, g)
    mask = {k: torch.ones_like(v) for k, v in params.items()}
    perms = epoch_permutations(g, 8, 1, 8, n_rows=8)
    update = make_client_update(make_apply_fn(tm), "bce", hp,
                                full_batches=True)

    def run(keep):
        drop = [[torch.full((BS, 16), keep)] for _ in range(hp.local_steps)]
        return update({k: v.clone() for k, v in params.items()}, mask,
                      td.x_train, td.y_train, 8, torch.tensor([0]), perms,
                      round_lr(hp, 0), dropout=drop)[0]

    a, b, c = run(True), run(True), run(False)
    for k in params:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["Dense_0.kernel"], c["Dense_0.kernel"])


def test_entry_point_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    _, tm = _models()
    _, td = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        SalientGrads(tm, td, _hp(HyperParams, 3))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted((ROOT / "neuroimagedisttraining_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for mod in ("experiments/__init__", "experiments/__main__",
                "experiments/config", "experiments/runner",
                "experiments/logging_utils", "experiments/main_salientgrads",
                "experiments/main_sailentgrads", "experiments/main_fedavg",
                "utils/__init__", "utils/records", "utils/flops",
                "data/abcd", "data/partition", "robust/__init__",
                "robust/faults", "robust/guard", "robust/aggregation",
                "robust/recovery", "parallel/topology", "algorithms/dispfl",
                "algorithms/subavg", "algorithms/ditto",
                "algorithms/local_only", "algorithms/dpsgd",
                "experiments/main_dispfl", "experiments/main_subavg",
                "experiments/main_ditto", "experiments/main_local",
                "experiments/main_dpsgd", "utils/checkpoint",
                "core/client_store"):
        assert f"neuroimagedisttraining_torch/{mod}.py" in names, mod
    banned = ("jax", "flax", "orbax", "neuroimagedisttraining_tpu")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, (f, mod)
