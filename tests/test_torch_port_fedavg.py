"""The port's FedAvg against the JAX package's, on the CPU.

1. Two rounds on the compressed wires "bucketed", "int8" and "topk", on
   ``tests/test_torch_port_round.py``'s cohort at data seed 9, fed the
   reference's epoch permutations and int8 uniforms (tolerances as in
   ``tests/test_torch_port_wires.py``, but with the atol at 1e-5 of each
   leaf's largest value: FedAvg trains every weight, and an element's
   round-off follows its leaf's scale), then the final fine-tune. Two
   limits of cross-framework parity, both discrete flips and not drift:
   - FedAvg trains every weight, and on data seeds 4, 6 and 7 (of 3..9) a
     max-pool or relu decision within float32 round-off of its tie goes the
     other way in the two frameworks in round 1 (~1e-4 in the first convs),
     the limit ``tests/test_torch_port_round.py`` records for
     SalientGrads; seed 9 has none.
   - Top-k selects on deltas (local - global), whose relative round-off is
     the locals' amplified by the cancellation (~1e-5), so a coordinate that
     close to its group's k-th magnitude swaps between wire and residual.
     On seed 9 round 1 selects the same set on both sides and is held as
     above; round 2 swaps some, and is held norm-wise within 1e-3 with the
     count of swapped coordinates printed.
2. A replay of ``tests/test_convergence_ab.py::
   test_fedavg_round_exact_equivalence_same_schedule`` through the port's
   entry points: ten rounds on the reference's exact batch schedule. After
   two rounds the sides agree to round-off (rtol 1e-5); past that float32
   SGD is chaotic, so at round ten the port-vs-reference gap must stay
   within 10x the same-framework chaos floor (the port replayed from an
   init perturbed by 1e-7).
3. What FedAvg refuses, as the reference does.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_torch.algorithms import FedAvg, FedAvgState  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402

N = pc.N_CLIENTS


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort(seed=9)


@pytest.mark.parametrize("impl", ["bucketed", "int8", "topk"])
def test_fedavg_two_rounds_per_wire(cohort, impl):
    c = cohort
    kw = dict(loss_type="bce", frac=1.0, seed=0, agg_impl=impl,
              agg_bucket_size=pc.BUCKET, agg_topk_density=pc.DENSITY)
    jalgo = JFedAvg(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                    agg_kernels="pallas", **kw)
    talgo = FedAvg(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                   device="cpu", **kw)
    jstate = jalgo.init_state(jax.random.PRNGKey(0))
    state = talgo.init_state(
        params=jax_params_to_torch(pc.np_tree(jstate.global_params)))
    assert isinstance(state, FedAvgState)
    assert (state.agg_residual is None) == (impl != "topk")
    rng = jstate.rng
    for r in range(2):
        rng, perms, u = pc.draws(rng, c)
        jstate, jmet = jalgo.run_round(jstate, r)
        state, tmet = talgo.run_round(state, r, perms=perms, agg_uniforms=u)
        chaotic = impl == "int8" or (impl == "topk" and r == 1)
        np.testing.assert_allclose(
            float(tmet["train_loss"]), float(jmet["train_loss"]),
            rtol=1e-4 if chaotic else 1e-5)
        if impl == "topk":
            want = pc.stack(jstate.agg_residual)
            swaps = sum(int(((state.agg_residual[k] == 0) !=
                             (want[k] == 0)).sum()) for k in want)
            if r == 0:
                pc.compare(state.global_params, jstate.global_params, impl,
                           leaf_scale=True)
                pc.compare_residual(state.agg_residual, jstate.agg_residual,
                                    jstate.personal_params)
            else:
                print(f"\ntopk: {swaps} coordinates of round 2 swapped "
                      "between wire and residual")
    if impl == "int8":
        flips = pc.wire_flips(state.personal_params, jstate.personal_params,
                              impl, u)
        print(f"\nint8: {flips} of {N * c['n_params']} wire values of "
              "round 2 differ")
    wire = "int8" if impl == "topk" else impl  # held norm-wise
    kw = dict(tol=1e-3 if impl == "topk" else 1e-4, leaf_scale=True)
    pc.compare(state.global_params, jstate.global_params, wire, **kw)
    pc.compare(state.personal_params, jstate.personal_params, wire,
               stacked=True, **kw)
    if impl != "bucketed":
        return
    # the final fine-tune: every client from the final global model at
    # round_idx = -1, on the reference's draws
    _, key = jax.random.split(jstate.rng)
    perms = pc.perms_from_keys(jax.random.split(key, N), c)
    jstate, jrec = jalgo.finalize(jstate)
    state, trec = talgo.finalize(state, perms=perms)
    assert trec["round"] == -1 and trec["finetune"]
    pc.compare(state.personal_params, jstate.personal_params, impl,
               stacked=True, leaf_scale=True)
    for k in ("global_loss", "personal_loss"):
        np.testing.assert_allclose(float(trec[k]), float(jrec[k]),
                                   rtol=1e-5)


def test_fedavg_exact_schedule_replay_ten_rounds():
    """The reference's exact-schedule gate, replayed through the port:
    SmallCNN3D, 8 clients of uneven shards, full participation."""
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


def test_fedavg_refuses_what_the_reference_refuses(cohort):
    c = cohort
    hp = pc.hp(HyperParams, c["spe"])
    algo = FedAvg(c["tm"], c["td"], hp, loss_type="bce", agg_impl="sparse",
                  device="cpu")
    with pytest.raises(ValueError, match="static-mask"):
        algo.run_round(algo.init_state(), 0)
    with pytest.raises(ValueError, match="agg_impl"):
        FedAvg(c["tm"], c["td"], hp, agg_impl="nope", device="cpu")
    with pytest.raises(ValueError, match="agg_hier_wire"):
        FedAvg(c["tm"], c["td"], hp, agg_hier_wire="fp8", device="cpu")
    with pytest.raises(ValueError, match="density"):
        FedAvg(c["tm"], c["td"], hp, agg_topk_density=1.5, device="cpu")
    untracked = FedAvg(c["tm"], c["td"], hp, track_personal=False,
                       device="cpu")
    state = untracked.init_state()
    assert state.personal_params is None
    assert untracked.finalize(state) == (state, None)
    assert tc.AGG_IMPLS == jc.AGG_IMPLS and tc.HIER_WIRES == jc.HIER_WIRES
    assert tc.DEFAULT_BUCKET_SIZE == jc.DEFAULT_BUCKET_SIZE


def test_fedavg_runs_on_its_own_draws_and_needs_cuda(cohort):
    c = cohort
    algo = FedAvg(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                  loss_type="bce", agg_impl="int8", agg_bucket_size=pc.BUCKET,
                  device="cpu")
    state, history = algo.run(comm_rounds=1, eval_every=1)
    assert [h["round"] for h in history] == [0, -1]
    assert history[-1]["finetune"]
    for h in history:
        for k, v in h.items():
            assert np.isfinite(v), (k, h)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FedAvg(c["tm"], c["td"], pc.hp(HyperParams, 3))
