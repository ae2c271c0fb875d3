"""Two SalientGrads rounds per compressed ``agg_impl`` in the port and in the
JAX package, on the CPU. ("dense" is ``tests/test_torch_port_round.py``'s
trajectory; FedAvg's wires are in ``tests/test_torch_port_fedavg.py``.)

The cohort is ``tests/test_torch_port_round.py``'s (narrow AlexNet3DS2D,
3 clients, data seed 4, dropout 0); both sides start from the reference's
parameters and SNIP mask, and the port is fed the reference's random draws
at its seams: the epoch permutations, and the int8 wire's stochastic-rounding
uniforms (``jax.random.uniform(fold_in(round_key, 0x616767), [C, nb, b])``
over the reference's flat layout). The JAX side runs the main path's kernel
flags (``agg_kernels="pallas"``: Pallas in interpret mode). Buckets of 4096
values cut inside leaves. Off the mesh the reference's "hier" is its exact
f32 bucketed reduce, so the port's "hier" is held to the reference's
"bucketed" rounds (each reference run is made once per module).

Tolerances: "bucketed", "sparse", "topk" and "hier" within rtol 1e-5 (atol
2e-7 for the conv biases ahead of a GroupNorm), as the dense trajectory of
``tests/test_torch_port_round.py``; the top-k residual ships the same
coordinates and holds the rest within rtol 1e-5 of the locals it is a
difference of; and "bucketed", "sparse" and "hier" equal the port's own
dense twin bit for bit. The "int8" and "bf16" wires norm-wise within 1e-4
(their losses within rtol 1e-4): local training agrees across frameworks
only to ~1e-7, and an input that moves by that much now and then flips a
rounding decision of the wire (a stochastic int8 rounding, or a bf16
round-to-nearest near its tie), each flip worth a whole quantum of one
client's value. The test prints how many wire values differ.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    SalientGrads,
    SalientGradsState,
)
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import (  # noqa: E402
    HyperParams,
    broadcast_tree,
    zeros_like_tree,
)
from neuroimagedisttraining_torch.ops import kernels  # noqa: E402
from neuroimagedisttraining_torch.ops import sparsity as tsp  # noqa: E402

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
    """The cohort, the reference's SNIP init, the reference's draws for two
    rounds, and the port's dense twin run on them."""
    c = pc.cohort()
    c["kw"] = dict(loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                   itersnip_iterations=1, agg_bucket_size=pc.BUCKET,
                   agg_topk_density=pc.DENSITY)
    c["jstate"] = JSalientGrads(
        c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]), fused_kernels=True,
        agg_kernels="pallas", **c["kw"]).init_state(jax.random.PRNGKey(0))
    rng, c["draws"] = c["jstate"].rng, []
    for _ in range(2):
        rng, perms, u = pc.draws(rng, c)
        c["draws"].append((perms, u))
    talgo, state = _port(c, "dense")
    c["dense"] = _run_port(talgo, state, c)[0].global_params
    c["jax_runs"] = {}
    return c


def _port(c, impl, **extra):
    talgo = SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                         agg_impl=impl, device="cpu", **c["kw"], **extra)
    params = jax_params_to_torch(pc.np_tree(c["jstate"].global_params))
    state = SalientGradsState(
        global_params=params,
        mask=jax_params_to_torch(pc.np_tree(c["jstate"].mask)),
        personal_params=broadcast_tree(params, N),
        generator=torch.Generator(),
        agg_residual=(zeros_like_tree(broadcast_tree(params, N))
                      if impl == "topk" else None))
    return talgo, state


def _run_port(talgo, state, c):
    losses = []
    for r, (perms, u) in enumerate(c["draws"]):
        state, met = talgo.run_round(state, r, perms=perms, agg_uniforms=u)
        losses.append(float(met["train_loss"]))
    return state, losses


def _jax_run(c, impl):
    """The reference's two rounds on ``impl``, memoized per cohort."""
    if impl not in c["jax_runs"]:
        jalgo = JSalientGrads(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                              fused_kernels=True, agg_kernels="pallas",
                              agg_impl=impl, **c["kw"])
        jstate = c["jstate"]
        if impl == "topk":
            jstate = jstate.replace(agg_residual=jax.tree_util.tree_map(
                jnp.zeros_like, jstate.personal_params))
        jlosses = []
        for r in range(2):
            jstate, jmet = jalgo.run_round(jstate, r)
            jlosses.append(float(jmet["train_loss"]))
        c["jax_runs"][impl] = (jstate, jlosses)
    return c["jax_runs"][impl]


#: the wires of ``test_salientgrads_two_rounds_per_wire`` here; the sparse
#: ones ("sparse", "topk", "hier") are its cases in
#: ``tests/test_torch_port_wires_sparse.py``
WIRES = ["bucketed", "bf16", "int8"]


@pytest.mark.parametrize("impl", WIRES)
def test_salientgrads_two_rounds_per_wire(cohort, impl):
    two_rounds_per_wire(cohort, impl)


def two_rounds_per_wire(c, impl):
    """Two rounds of the port on ``impl`` against the reference's on the
    same draws."""
    # the reference's off-mesh "hier" is its exact f32 bucketed reduce, so
    # the port's "hier" (on the compressed-plan sparse wire here) is held to
    # the reference's "bucketed" rounds
    jstate, jlosses = _jax_run(c, "bucketed" if impl == "hier" else impl)
    extra = dict(agg_hier_wire="sparse") if impl == "hier" else {}
    talgo, state = _port(c, impl, **extra)
    kernels.reset_launches()
    state, losses = _run_port(talgo, state, c)
    assert sum(kernels.LAUNCHES.values()) == 0  # the plain versions ran
    np.testing.assert_allclose(
        losses, jlosses, rtol=1e-4 if impl in ("int8", "bf16") else 1e-5)
    if impl in ("int8", "bf16"):
        flips = pc.wire_flips(state.personal_params, jstate.personal_params,
                              impl, c["draws"][-1][1])
        print(f"\n{impl}: {flips} of "
              f"{N * c['n_params']} wire values of round 2 differ")
    pc.compare(state.global_params, jstate.global_params, impl)
    pc.compare(state.personal_params, jstate.personal_params, impl,
               stacked=True)
    if impl in ("bucketed", "sparse", "hier"):
        for k, v in c["dense"].items():
            assert torch.equal(state.global_params[k], v), (impl, k)
    if impl in ("sparse", "topk", "hier"):
        assert 0.3 < talgo._agg_sparse_plan.density < 1.0
    if impl == "topk":
        pc.compare_residual(state.agg_residual, jstate.agg_residual,
                            jstate.personal_params)
        # the re-mask held: dead coordinates of the global model are 0
        for k, m in state.mask.items():
            assert torch.all(state.global_params[k][m == 0] == 0), k
    assert abs(tsp.mask_density(state.mask) - 0.5) < 1e-3


def test_hier_off_the_mesh_is_the_exact_reduce(cohort):
    """"hier" on its default bf16 cross-slice wire: off the mesh there is
    one slice, the wire never fires, and the round is the dense one."""
    talgo, state = _port(cohort, "hier")
    state, _ = _run_port(talgo, state, cohort)
    for k, v in cohort["dense"].items():
        assert torch.equal(state.global_params[k], v), k


def test_salientgrads_own_draws_and_argument_checks(cohort):
    """Without seams the round draws the int8 uniforms from the state's
    generator; a run is reproducible from its seed."""
    c = cohort
    outs = []
    for _ in range(2):
        talgo, state = _port(c, "int8")
        state.generator.manual_seed(3)
        state, _ = talgo.run_round(state, 0, perms=c["draws"][0][0])
        outs.append(state.global_params)
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    with pytest.raises(ValueError, match="uniforms"):
        talgo.run_round(state, 1, perms=c["draws"][1][0],
                        agg_uniforms=torch.zeros(N, 2, 3))
    with pytest.raises(ValueError, match="agg_hier_inner"):
        SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, 3),
                     agg_hier_inner=-1, device="cpu")
