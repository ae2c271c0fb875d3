"""SalientGrads' two rounds on the sparse wires ("sparse", "topk" and the
"hier" sparse wire) against the reference's, on the CPU: the cases of
``test_salientgrads_two_rounds_per_wire`` beside the dense ones of
``tests/test_torch_port_wires.py``, whose cohort and run they share."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_port_wires import (  # noqa: E402,F401
    cohort,
    one_thread,
    two_rounds_per_wire,
)


@pytest.mark.parametrize("impl", ["sparse", "topk", "hier"])
def test_salientgrads_two_rounds_per_wire(cohort, impl):
    two_rounds_per_wire(cohort, impl)
