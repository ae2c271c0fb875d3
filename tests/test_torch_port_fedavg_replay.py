"""FedAvg's exact-schedule gate replayed through the port, on the CPU:
the reference's ten rounds of SmallCNN3D on 8 uneven clients at full
participation, the port fed the reference's epoch permutations; round 2
within rtol 1e-5 of the reference's, round 10 within ten times the
same-framework chaos floor (the port's own run from parameters perturbed by
1e-7). (FedAvg's wires and refusals are in
``tests/test_torch_port_fedavg.py``.)"""
import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_torch.algorithms import FedAvg  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fedavg_exact_schedule_replay_ten_rounds():
    """The reference's exact-schedule gate, replayed through the port:
    SmallCNN3D, 8 clients of uneven shards, full participation (torch on
    one thread: small ops among the suite's parallel workers)."""
    kw = dict(seed=5, n_clients=8, samples_per_client=12, test_per_client=4,
              sample_shape=(8, 8, 8, 1), uneven=True)
    jd, td = jsynth(**kw), make_synthetic_federated(**kw)
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    bs, rounds, gate = 4, 10, 2
    spe = -(-max(nvals) // bs)
    hk = dict(lr=0.05, lr_decay=0.99, momentum=0.9, weight_decay=0.0,
              grad_clip=10.0, local_epochs=1, steps_per_epoch=spe,
              batch_size=bs)
    jalgo = JFedAvg(jcreate("small3dcnn", num_classes=1), jd,
                    JHyperParams(**hk), loss_type="bce", frac=1.0, seed=0,
                    track_personal=False)
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax_params_to_torch(pc.np_tree(jstate.global_params))
    c = dict(nvals=nvals, spe=spe, bs=bs, n_rows=jd.x_train.shape[1])
    rng, snaps, perms = jstate.rng, {}, []
    for r in range(rounds):
        rng, round_key = jax.random.split(rng)
        perms.append(pc.perms_from_keys(jax.random.split(round_key, 9), c))
        jstate, _ = jalgo.run_round(jstate, r)
        if r + 1 in (gate, rounds):
            snaps[r + 1] = jax_params_to_torch(
                pc.np_tree(jstate.global_params))

    def replay(eps=0.0):
        algo = FedAvg(create_model("small3dcnn", num_classes=1), td,
                      HyperParams(**hk), loss_type="bce", frac=1.0,
                      track_personal=False, device="cpu")
        params = {k: v.clone() for k, v in init.items()}
        if eps:
            g = torch.Generator().manual_seed(123)
            params = {k: v + eps * torch.randn(v.shape, generator=g)
                      for k, v in params.items()}
        state, out = algo.init_state(params=params), {}
        for r in range(rounds):
            state, _ = algo.run_round(state, r, perms=perms[r])
            if r + 1 in (gate, rounds):
                out[r + 1] = state.global_params
        return out

    def rms(a, b):
        d = torch.cat([(a[k] - b[k]).reshape(-1) for k in a])
        return float(torch.sqrt(torch.mean(d * d)))

    port, perturbed = replay(), replay(1e-7)
    for k, v in snaps[gate].items():
        np.testing.assert_allclose(port[gate][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    gap, floor = rms(port[rounds], snaps[rounds]), \
        rms(perturbed[rounds], port[rounds])
    print(f"\nround {rounds}: port-vs-reference rms {gap:.3g}, "
          f"same-framework chaos floor {floor:.3g}")
    assert gap < 10 * floor, (gap, floor)
