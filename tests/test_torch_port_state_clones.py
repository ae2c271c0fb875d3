"""Two rounds run from two ``FedAlgorithm.clone_state`` copies of one
state give bitwise-equal states and losses, on the CPU (the cases and the
narrow cohort of ``tests/test_torch_port_state.py``)."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_state import (  # noqa: E402,F401
    CASES,
    _algo,
    _assert_bitwise,
    _snapshot,
    cohort,
    one_thread,
)


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
