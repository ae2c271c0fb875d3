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
   entry points (in ``tests/test_torch_port_fedavg_replay.py``): ten rounds
   on the reference's exact batch schedule. After two rounds the sides
   agree to round-off (rtol 1e-5); past that float32 SGD is chaotic, so at
   round ten the port-vs-reference gap must stay within 10x the
   same-framework chaos floor (the port replayed from an init perturbed by
   1e-7).
3. What FedAvg refuses, as the reference does.
"""
import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_torch.algorithms import FedAvg, FedAvgState  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tc  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jc  # noqa: E402

N = pc.N_CLIENTS


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: these cases run many CPU ops at a narrow width,
    and among the suite's parallel workers torch's default of a thread per
    core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
