"""The SNIP mask and one SalientGrads round on the 3D-ResNet twin
(``3dresnet_s2d``) against the JAX package, on the CPU, held as
``tests/test_torch_port_round.py`` holds AlexNet's.

Full width on the smallest volume the ResNet's pools survive, 29x33x29
(phased (17, 19, 8, 17)); 2 clients x 4 samples, one step of batch 4. The
SNIP row holds every kernel of the model, 8.3M entries: the port's SNIP
scores (fed the reference's batch draws) make a mask within 0.1% of the
reference's own SNIP mask, and the same scores make it bit for bit through
the reference's Pallas threshold and score-mask kernels (interpret mode).
From the reference's mask the round, fed its epoch permutations and run
with its kernel flags (Pallas in interpret mode): loss and parameters
within rtol 1e-5 (atol 2e-7), per-client accuracies equal, eval losses
within 2e-5. The gradients themselves are held in
``tests/test_torch_port_resnet3d.py``.

Data seed 5: on seeds 4 and 6 a relu or max-pool decision at round-off
flips between the frameworks in the round (a 1e-4 step in the last block's
gradient), as ROADMAP's near-ties note describes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.ops import sparsity as jsp  # noqa: E402
from neuroimagedisttraining_tpu.ops.s2d import phased_sample_shape  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    SalientGrads,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
)
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model, make_apply_fn  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402

PHASED = phased_sample_shape((29, 33, 29), kernel=3, pad=3)
N_CLIENTS, SAMPLES, TEST, BS = 2, 4, 2, 4
DATA_SEED = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many CPU ops on one worker of the suite's parallel run: one thread
    (see ``tests/test_torch_port_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hp(cls):
    return cls(lr=0.01, lr_decay=0.998, momentum=0.9, weight_decay=5e-4,
               grad_clip=10.0, local_epochs=1, steps_per_epoch=SAMPLES // BS,
               batch_size=BS)


def _snip_idx(key, n_valid, n_iters):
    """The reference's SNIP batch draw for one client."""
    out = []
    for k in jax.random.split(key, n_iters):
        k_idx, _ = jax.random.split(k)
        out.append(np.asarray(jax.random.randint(
            k_idx, (BS,), 0, max(int(n_valid), 1))))
    return np.stack(out)


@pytest.fixture(scope="module")
def reference():
    """The reference's SalientGrads on ``3dresnet_s2d``: its init (SNIP),
    one round and its eval, made once for the module."""
    kw = dict(seed=DATA_SEED, n_clients=N_CLIENTS, samples_per_client=SAMPLES,
              test_per_client=TEST, sample_shape=PHASED, uneven=False)
    jd, td = jsynth(**kw), make_synthetic_federated(**kw)
    jalgo = JSalientGrads(jcreate("3dresnet_s2d", num_classes=1), jd,
                          _hp(JHyperParams), loss_type="bce", frac=1.0,
                          seed=0, dense_ratio=0.5, itersnip_iterations=1,
                          fused_kernels=True, agg_kernels="pallas")
    s0 = jalgo.init_state(jax.random.PRNGKey(0))
    s1, met = jalgo.run_round(s0, 0)
    return dict(td=td, s0=s0, s1=s1, met=met, ev=jalgo.evaluate(s1),
                tm=create_model("3dresnet_s2d", num_classes=1,
                                sample_shape=PHASED))


def _talgo(ref):
    return SalientGrads(ref["tm"], ref["td"], _hp(HyperParams),
                        loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                        itersnip_iterations=1, device="cpu")


def test_snip_mask_on_resnet_twin_matches_reference(reference):
    ref = reference
    td, s0 = ref["td"], ref["s0"]
    g0 = jax_params_to_torch(pc.np_tree(s0.global_params))
    jmask = jax_params_to_torch(pc.np_tree(s0.mask))
    n_kernel = sum(v.numel() for k, v in jmask.items()
                   if k.endswith(".kernel"))
    assert n_kernel > 8_000_000  # the SNIP row: every kernel of the model
    # the port's own SNIP, fed the reference's batch draws, agrees with the
    # reference's mask up to score round-off at the threshold
    _, m_rng, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    ckeys = jax.random.split(m_rng, N_CLIENTS)
    idx = [_snip_idx(ckeys[c], SAMPLES, 1) for c in range(N_CLIENTS)]
    init = _talgo(ref).init_state(params=g0, snip_idx=idx)
    agree = sum(int((init.mask[k] == v).sum()) for k, v in jmask.items())
    assert agree / sum(v.numel() for v in jmask.values()) > 0.999
    # from IDENTICAL scores the masks are bit for bit (the reference's
    # Pallas threshold and score-mask kernels, the plain versions here)
    score = tsp.make_snip_score_fn(make_apply_fn(ref["tm"]), "bce", BS)
    scores = [score(g0, td.x_train[c], td.y_train[c], SAMPLES, 1,
                    idx=idx[c]) for c in range(N_CLIENTS)]
    tot = {k: scores[0][k] + scores[1][k] for k in scores[0]}
    want = jax_params_to_torch(pc.np_tree(jsp.mask_from_scores(
        pc.to_jax_tree(tot, s0.global_params), 0.5, kernels="pallas")))
    got = tsp.mask_from_scores(tot, 0.5)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert abs(tsp.mask_density(got) - 0.5) < 1e-3


def test_salientgrads_round_on_resnet_twin_matches_reference(reference):
    ref = reference
    s0 = ref["s0"]
    talgo = _talgo(ref)
    g0 = jax_params_to_torch(pc.np_tree(s0.global_params))
    state = SalientGradsState(
        global_params=g0, mask=jax_params_to_torch(pc.np_tree(s0.mask)),
        personal_params=broadcast_tree(g0, N_CLIENTS),
        generator=torch.Generator())
    _, round_key = jax.random.split(s0.rng)
    keys = jax.random.split(round_key, N_CLIENTS + 1)
    perms = [np.array(epoch_permutations(
        jax.random.split(keys[c])[0], jnp.int32(SAMPLES), 1, SAMPLES,
        n_rows=SAMPLES)) for c in range(N_CLIENTS)]
    state, tmet = talgo.run_round(state, 0, perms=perms)
    np.testing.assert_allclose(float(tmet["train_loss"]),
                               float(ref["met"]["train_loss"]), rtol=1e-5)
    pc.compare(state.global_params, ref["s1"].global_params, "dense")
    for c in range(N_CLIENTS):
        pc.compare({k: v[c] for k, v in state.personal_params.items()},
                   jax.tree_util.tree_map(lambda a: a[c],
                                          ref["s1"].personal_params),
                   "dense")
    tev, jev = talgo.evaluate(state), ref["ev"]
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
    assert float(tev["mask_density"]) == float(jev["mask_density"])
    for k in ("global_loss", "personal_loss"):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=2e-5)
