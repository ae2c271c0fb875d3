"""The port's fused round loop (``FedAlgorithm.run_rounds_fused``) for the
baselines, on the CPU: DisPFL, SubAvg, Ditto, Local and DPSGD, each block
bit for bit its ``run_round`` + ``evaluate`` calls, and DisPFL's and DPSGD's
blocks against the JAX package's ``run_rounds_fused`` (the cohort and the
one-thread setting of ``tests/test_torch_port_fused.py``, where FedAvg's and
SalientGrads' cases are)."""
import dataclasses

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_torch import algorithms as talgos  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from test_torch_port_fused import cohort, one_thread  # noqa: E402,F401


#: (class, options, frac, local epochs, dropout): every RoundInputs field
#: the five baselines read rides a fused block here (the second leg's
#: permutations and keep masks, DisPFL's screening rows and keep masks, its
#: regrow scores, the adjacency, the active flags, the fire rate)
BASELINES = [
    pytest.param("DisPFL", dict(static_masks=True), 0.67, 1, 0.0,
                 id="dispfl-static"),
    pytest.param("DisPFL", dict(), 0.34, 1, 0.5, id="dispfl-dynamic-dropout"),
    pytest.param("DisPFL", dict(active=0.5, neighbor_mode="ring"), 0.67, 1,
                 0.0, id="dispfl-active"),
    pytest.param("DisPFL", dict(dis_gradient_check=True,
                                different_initial=True), 0.67, 1, 0.0,
                 id="dispfl-gradient-check"),
    pytest.param("SubAvg", dict(acc_thresh=0.4), 2 / 3, 2, 0.5,
                 id="subavg-two-epochs-dropout"),
    pytest.param("Ditto", dict(lamda=0.5), 2 / 3, 1, 0.5,
                 id="ditto-dropout"),
    pytest.param("LocalOnly", dict(), 2 / 3, 1, 0.0, id="local"),
    pytest.param("DPSGD", dict(neighbor_mode="random"), 0.34, 1, 0.0,
                 id="dpsgd"),
]


def _baseline(c, cls_name, opts, frac, epochs, dropout):
    model = c["tm"] if not dropout else create_model(
        "3dcnn_s2d", num_classes=1, widths=pc.WIDTHS, dropout_rate=dropout,
        sample_shape=pc.SS)
    hp = dataclasses.replace(pc.hp(HyperParams, c["spe"]),
                             local_epochs=epochs)
    kw = dict(loss_type="bce", frac=frac, seed=0, device="cpu", **opts)
    if cls_name == "DisPFL":
        kw["total_rounds"] = 4
    if cls_name == "Ditto":
        kw["personal_hp"] = dataclasses.replace(hp, local_epochs=2)
    return getattr(talgos, cls_name)(model, c["td"], hp, **kw)


def _tensor_fields(state):
    """The state's trees of tensors by field (the baselines keep no bare
    tensor)."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), dict)}


@pytest.mark.parametrize("cls_name,opts,frac,epochs,dropout", BASELINES)
def test_baseline_fused_block_bitwise_equals_run_round(
        cohort, cls_name, opts, frac, epochs, dropout):
    """Three fused rounds of each baseline with the eval after each equal
    three ``run_round`` + ``evaluate`` calls bit for bit: every round
    metric (DisPFL's mask change and local-test series too), every eval
    row, every tensor field of the state (masks included) and the
    generator; the input state is left as it was."""
    algo = _baseline(cohort, cls_name, opts, frac, epochs, dropout)
    s0 = algo.init_state()
    keep = algo.clone_state(s0)
    su, rows, evals = algo.clone_state(s0), [], []
    for r in range(3):
        su, met = algo.run_round(su, r)
        rows.append({k: float(v) for k, v in met.items()})
        evals.append({k: float(v) for k, v in algo.evaluate(su).items()
                      if not k.startswith("acc_per")})
    sf, ys = algo.run_rounds_fused(s0, 0, 3, eval_every=1)
    assert set(ys.materialize()) - {"eval"} == set(rows[0])
    for i in range(3):
        assert {k: float(ys[k][i]) for k in rows[0]} == rows[i], i
        assert {k: float(v[i]) for k, v in ys["eval"].items()} == \
            evals[i], i
    fu, ff, fk, f0 = map(_tensor_fields, (su, sf, keep, s0))
    assert set(fu) == set(ff)
    for name, tree in fu.items():
        for k in tree:
            assert torch.equal(tree[k], ff[name][k]), (name, k)
            assert torch.equal(fk[name][k], f0[name][k]), (name, k)
    assert torch.equal(su.generator.get_state(), sf.generator.get_state())
    assert torch.equal(keep.generator.get_state(), s0.generator.get_state())
    if cls_name == "DisPFL" and not algo.static_masks:
        assert max(r["mask_change"] for r in rows) > 0


@pytest.mark.parametrize("name", ["dispfl", "dpsgd"])
def test_baseline_fused_matches_reference_run_rounds_fused(name):
    """Two rounds of the JAX package's ``run_rounds_fused`` for DisPFL
    (ERK masks, random neighbors, fire and regrow) and DPSGD, with the eval
    after each, and the port's block fed the reference's draws at the
    seams (epoch permutations; DisPFL's screening rows), from the
    reference's parameters and masks: train losses within rtol 1e-5,
    DisPFL's masks and mask change bitwise, its local-test accuracies
    bitwise and losses within 2e-5 (the forwards' summation orders), the
    personal models per leaf within rtol 1e-5 (atol 1e-5 of the leaf's
    largest value), per-client accuracies equal. The configurations and
    data seeds are ``tests/test_torch_port_dispfl.py``'s and
    ``tests/test_torch_port_personal.py``'s (DPSGD: seed 5, whose rounds
    flip no max-pool or relu tie between the frameworks)."""
    import test_torch_port_dispfl as tdis
    import test_torch_port_personal as tper
    from neuroimagedisttraining_tpu import algorithms as jalgos

    n_rounds = 2
    if name == "dispfl":
        cfg = "erk_random"
        c = tdis.cohort(cfg)
        jalgo = jalgos.DisPFL(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                              **tdis._kw(cfg))
        talgo = talgos.DisPFL(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                              device="cpu", **tdis._kw(cfg))
        key = jax.random.PRNGKey(0)
        params = tdis.jinit(c["jm"], jax.random.split(key, 3)[0],
                            jalgo.init_sample_shape)
        jstate = jalgo.init_state(key)
        state = talgo.init_state(
            params=jax_params_to_torch(pc.np_tree(params)),
            masks=pc.stack(jstate.masks))
    else:
        c = tper._cohort(name)
        jalgo, talgo = tper._algo(name, c, True), tper._algo(name, c, False)
        jstate = jalgo.init_state(jax.random.PRNGKey(0))
        state = talgo.init_state(params={
            k: v[0] for k, v in pc.stack(jstate.personal_params).items()})
    rng, seams = jstate.rng, []
    for _ in range(n_rounds):
        if name == "dispfl":
            rng, seam = tdis._draws(rng, c, None, jalgo)
            seam.pop("regrow_u")
        else:
            rng, seam = tper._draws(name, rng, dict(c, sel=np.arange(
                pc.N_CLIENTS)))
        seams.append(seam)
    jstate, jys = jalgo.run_rounds_fused(jstate, 0, n_rounds, eval_every=1)
    state, ys = talgo.run_rounds_fused(state, 0, n_rounds, eval_every=1,
                                       seams=seams)
    np.testing.assert_allclose(ys["train_loss"],
                               np.asarray(jys["train_loss"]), rtol=1e-5)
    if name == "dispfl":
        np.testing.assert_array_equal(ys["mask_change"],
                                      np.asarray(jys["mask_change"]))
        for k in ("new_mask_test_acc", "old_mask_test_acc"):
            np.testing.assert_array_equal(ys[k], np.asarray(jys[k]), k)
        for k in ("new_mask_test_loss", "old_mask_test_loss"):
            np.testing.assert_allclose(ys[k], np.asarray(jys[k]), rtol=2e-5)
        for k, v in pc.stack(jstate.masks).items():
            assert torch.equal(state.masks[k], v), k
        assert float(ys["mask_change"][-1]) > 0
    assert sorted(ys["eval"]) == sorted(jys["eval"])
    for k, v in ys["eval"].items():
        want = np.asarray(jys["eval"][k])
        if k.endswith("acc") or k.endswith("density"):
            np.testing.assert_array_equal(v.astype(np.float32), want, k)
        else:
            np.testing.assert_allclose(v, want, rtol=2e-5, err_msg=k)
    pc.compare(state.personal_params, jstate.personal_params, "f32",
               stacked=True, leaf_scale=True)
    jev, tev = jalgo.evaluate(jstate), talgo.evaluate(state)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
