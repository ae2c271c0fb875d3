"""The port's round leaves the state it is given as it was, on the CPU.

The reference's round is a pure function of its state (unless
``donate_state`` is on), and its ``clone_state`` lets a caller run several
rounds or bench cells from one state. The port's ``run_round`` draws from a
copy of the state's generator and writes the trained rows into a copy of the
personal stack, and ``FedAlgorithm.clone_state`` deep-copies a state:

1. after ``run_round`` (and FedAvg's ``finalize``) every tensor of the input
   state, and its generator's ``get_state()``, is bitwise what it was;
2. two rounds run from two ``clone_state`` copies of one state give
   bitwise-equal states and losses.

On ``tests/test_torch_port_round.py``'s narrow cohort, with the rounds'
epoch permutations drawn from the state's generator, on the dense wire and
on the two wires that carry extra state or draws ("topk": the error-feedback
residual; "int8": the uniforms), at full and at partial participation.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402

CASES = [pytest.param(name, impl, frac,
                      id=f"{name}-{impl}-{'full' if frac == 1 else 'partial'}")
         for name, impl, frac in (("salientgrads", "dense", 1.0),
                                  ("salientgrads", "topk", 2 / 3),
                                  ("fedavg", "int8", 1.0),
                                  ("fedavg", "topk", 2 / 3))]


@pytest.fixture(scope="module")
def cohort():
    return pc.cohort(seed=9)


def _algo(c, name, impl, frac):
    kw = dict(loss_type="bce", frac=frac, agg_impl=impl,
              agg_bucket_size=pc.BUCKET, agg_topk_density=pc.DENSITY,
              device="cpu")
    hp = pc.hp(HyperParams, c["spe"])
    if name == "salientgrads":
        return SalientGrads(c["tm"], c["td"], hp, dense_ratio=0.5,
                            itersnip_iterations=1, **kw)
    return FedAvg(c["tm"], c["td"], hp, **kw)


def _snapshot(state):
    """Every field of ``state``: tensors and trees cloned, the generator as
    its ``get_state()``."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Generator):
            out[f.name] = v.get_state().clone()
        elif isinstance(v, dict):
            out[f.name] = {k: t.clone() for k, t in v.items()}
        else:
            out[f.name] = v
    return out


def _assert_bitwise(a, b, what):
    assert a.keys() == b.keys(), what
    for name, va in a.items():
        vb = b[name]
        if isinstance(va, dict):
            assert va.keys() == vb.keys(), (what, name)
            for k in va:
                assert torch.equal(va[k], vb[k]), (what, name, k)
        elif isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), (what, name)
        else:
            assert va is vb, (what, name)


@pytest.mark.parametrize("name,impl,frac", CASES)
def test_run_round_leaves_its_input_state_unchanged(cohort, name, impl,
                                                    frac):
    algo = _algo(cohort, name, impl, frac)
    state = algo.init_state()
    before = _snapshot(state)
    new, met = algo.run_round(state, 0)
    _assert_bitwise(_snapshot(state), before, "after run_round")
    # the round did draw and did train: the new state moved on
    assert not torch.equal(new.generator.get_state(), before["generator"])
    assert any(not torch.equal(new.personal_params[k], v)
               for k, v in before["personal_params"].items())
    assert torch.isfinite(met["train_loss"])
    if name == "fedavg":
        after = _snapshot(new)
        algo.finalize(new)
        _assert_bitwise(_snapshot(new), after, "after finalize")


@pytest.mark.parametrize("name,impl,frac", CASES)
def test_rounds_from_clones_agree_bitwise(cohort, name, impl, frac):
    algo = _algo(cohort, name, impl, frac)
    state = algo.init_state()
    a, b = algo.clone_state(state), algo.clone_state(state)
    assert a.generator is not state.generator
    _assert_bitwise(_snapshot(a), _snapshot(state), "clone")
    losses = ([], [])
    for r in range(2):
        a, ma = algo.run_round(a, r)
        b, mb = algo.run_round(b, r)
        losses[0].append(ma["train_loss"])
        losses[1].append(mb["train_loss"])
    _assert_bitwise(_snapshot(a), _snapshot(b), "two rounds from clones")
    assert all(torch.equal(x, y) for x, y in zip(*losses))


@pytest.mark.parametrize("name,impl,frac", CASES[:1] + CASES[3:])
def test_fused_first_round_state_is_the_eager_rounds(cohort, name, impl,
                                                    frac):
    """``run_rounds_fused(on_first_round=)`` hands over a copy of the
    state after the block's first round, bitwise ``run_round``'s (the CLI
    prices a fused run's cost from it, as the eager loop prices its first
    round's state), and the block's own result is unchanged by it."""
    algo = _algo(cohort, name, impl, frac)
    s0 = algo.init_state()
    got = []
    out, ys = algo.run_rounds_fused(algo.clone_state(s0), 0, 2,
                                    on_first_round=got.append)
    first, _ = algo.run_round(algo.clone_state(s0), 0)
    assert len(got) == 1
    for f in ("global_params", "personal_params", "agg_residual"):
        a, b = getattr(got[0], f), getattr(first, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert all(torch.equal(a[k], b[k]) for k in b), f
    plain, ys2 = algo.run_rounds_fused(algo.clone_state(s0), 0, 2)
    assert all(torch.equal(out.global_params[k], plain.global_params[k])
               for k in plain.global_params)
    assert list(ys.materialize()["train_loss"]) == \
        list(ys2.materialize()["train_loss"])
