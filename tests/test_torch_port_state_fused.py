"""A fused block's first round handed over by ``on_first_round`` is
bitwise the eager round's, on the CPU (the cases and the narrow cohort of
``tests/test_torch_port_state.py``)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_state import (  # noqa: E402,F401
    CASES,
    _algo,
    cohort,
    one_thread,
)


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
