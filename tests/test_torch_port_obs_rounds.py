"""The round numerics (``--obs_numerics``) as the rounds produce them,
against the JAX package's rounds, on the CPU.

SalientGrads (numerics with the mask) and FedAvg (without) are built by
each side's CLI ``build_algorithm`` from one command line with
``--obs_numerics 1`` and a fault spec that leaves finite clients beside
poisoned, Byzantine-scaled and dropped or straggling ones; SalientGrads runs
under the weak-DP defense, whose noise its re-mask takes back out of the
new global model. Two rounds, the reference's draws fed to the port at its
seams (epoch permutations, fault draws, DP noise), so each term the plan
reads is pinned: the old global, the new global after the re-mask, the
post-fault, pre-guard locals (a poisoned slot's drift is NaN on both sides,
a scaled slot's is the scaled delta's) and the mask; and the wire model
that gives the JSONL lines their ``comm_*`` values.

Tolerances are the rounds' own (``test_cli_built_rounds_match_reference``):
the loss within rtol 1e-5, the parameters per leaf within rtol 1e-5 / atol
2e-7, the guard's counters, the NaN positions and the mask's churn,
agreement and distance equal. Each finite numerics value within rtol 1e-5
of the scale it is measured on: a norm of a difference of parameters (the
update, a client's drift) within 1e-5 of the norm of the parameters it is a
difference of (``_torch_port_cohort.compare_residual``'s rule: a small
difference of O(1) weights, a GroupNorm scale's update, carries their
round-off), a cosine within 1e-5 absolutely, a largest magnitude within
rtol 1e-5 of itself.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from _torch_cli_helpers import COMM_MEASURED, SMALL, _built  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.obs.comm import WireCostModel as JWire  # noqa: E402
from neuroimagedisttraining_tpu.robust import faults as jfaults  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    FedAvgState,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import broadcast_tree  # noqa: E402
from neuroimagedisttraining_torch.obs.comm import WireCostModel  # noqa: E402
from neuroimagedisttraining_torch.obs.numerics import group_of_name  # noqa: E402
from test_torch_port_robust import jax_dp_noise, jax_fault_draws  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: among the suite's parallel workers torch's
    default of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGV = SMALL + ["--epochs", "1", "--lr", "0.01", "--momentum", "0.9",
                "--wd", "5e-4", "--batch_size", "8", "--obs_numerics", "1"]
#: by case id: the algorithm, the run seed and the rest of its command line
CASES = {
    "salientgrads_weak_dp": ("salientgrads", 11, [
        "--fault_spec", "drop=0.3,nan=0.3,scale=0.3:10x",
        "--defense_type", "weak_dp"]),
    "fedavg_straggle": ("fedavg", 0, [
        "--fault_spec", "straggle=0.4,nan=0.2,scale=0.3:10x"]),
}
#: the mask's discrete readouts: equal, not close
MASK_NAMES = ("num_mask_churn", "num_mask_agree", "num_mask_dist_max")


def _atol(name, old):
    """The absolute part of a numerics value's tolerance (the module's
    docstring), from the round's old global model ``old``."""
    if name.startswith("num_cos"):
        return 1e-5
    if name.startswith("num_maxabs"):
        return 0.0
    group = name.split("/", 1)[1] if "/" in name else None
    sq = sum(float((v.double() ** 2).sum()) for k, v in old.items()
             if group is None or group_of_name(k) == group)
    return 1e-5 * sq ** 0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_numerics_match_reference(name):
    algo, seed, extra = CASES[name]
    ja, jd, ta, _ = _built(algo, ARGV + ["--seed", str(seed)] + extra)
    names = [k for k in ta._round_metric_names if k.startswith("num_")]
    assert names and names == [k for k in ja._round_metric_names
                               if k.startswith("num_")]
    assert (set(MASK_NAMES) <= set(names)) == (algo == "salientgrads")
    weak_dp = "--defense_type" in extra
    assert (ta.defense is not None) == weak_dp

    jstate = ja.init_state(jax.random.PRNGKey(seed))
    jparams = pc.np_tree(jstate.global_params)
    g = jax_params_to_torch(jparams)
    kw = dict(global_params=g,
              personal_params=broadcast_tree(g, ta.num_clients),
              generator=torch.Generator())
    if algo == "salientgrads":
        state = SalientGradsState(
            mask=jax_params_to_torch(pc.np_tree(jstate.mask)), **kw)
    else:
        state = FedAvgState(**kw)
    # the comm_* values of the JSONL lines (--obs_comm): the wire model of
    # the built round, the same bytes (the probe's own readings aside)
    comm = WireCostModel.from_algorithm(ta, state).round_metrics()
    jcomm = JWire.from_algorithm(ja, jstate).round_metrics()
    assert sorted(comm) == sorted(jcomm)
    assert {k: v for k, v in comm.items() if k not in COMM_MEASURED} == \
        {k: v for k, v in jcomm.items() if k not in COMM_MEASURED}
    nvals = [int(n) for n in np.asarray(jd.n_train)]
    spe, bs = ja.hp.steps_per_epoch, ja.hp.batch_size
    s = ta.clients_per_round
    rng = jstate.rng
    seen = {"finite": 0, "nan": 0, "scaled": 0, "dropped/straggled": 0}
    for r in range(2):
        sel = ta._selected_client_indexes(r)
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, s + 1)
        perms = [np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(nvals[c]), 1, spe * bs,
            n_rows=jd.x_train.shape[1])) for i, c in enumerate(sel)]
        seams = dict(perms=perms, faults=jax_fault_draws(seed, r, sel))
        if weak_dp:
            seams["dp_noise"] = jax_dp_noise(keys[s], jparams, s)
        trace = jfaults.fault_trace_round(ja.fault_spec, seed, r, sel)
        old = state.global_params
        jstate, jmet = ja.run_round(jstate, r)
        state, tmet = ta.run_round(state, r, **seams)
        np.testing.assert_allclose(float(tmet["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
        for k in ("clients_dropped", "clients_quarantined"):
            assert float(tmet[k]) == float(jmet[k]), (r, k)
        for k in names:
            t, j = float(tmet[k]), float(jmet[k])
            if k in MASK_NAMES:
                assert t == j, (r, k, t, j)
            elif np.isnan(j):
                assert np.isnan(t), (r, k, t)
            else:
                np.testing.assert_allclose(t, j, rtol=1e-5,
                                           atol=_atol(k, old),
                                           err_msg=f"round {r} {k}")
        drift = np.array([float(jmet[f"num_drift_s{i}"]) for i in range(s)])
        assert np.array_equal(np.isnan(drift), trace["poisoned"]), r
        seen["finite"] += int(np.isfinite(drift).sum())
        seen["nan"] += int(trace["poisoned"].sum())
        seen["scaled"] += int((trace["byzantine"] & ~trace["poisoned"]).sum())
        seen["dropped/straggled"] += int((trace["dropped"]
                                          | trace["straggled"]).sum())
    # the draws cover what the plan must tell apart
    assert min(seen.values()) > 0, seen
    pc.compare(state.global_params, jstate.global_params, "dense")
