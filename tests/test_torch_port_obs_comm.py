"""The port's communication telemetry (``neuroimagedisttraining_torch/obs/
comm.py``) against the JAX package's on the CPU: the wire-cost model's bytes
for every ``agg_impl`` (and every hier wire) exactly, the payload helpers,
``agg_microbench``'s modeled wire bytes, and the aggregation probe, which
leaves the run bitwise as it was."""
import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.obs import comm as jcomm  # noqa: E402
from neuroimagedisttraining_tpu.parallel import collectives as jcoll  # noqa: E402
from neuroimagedisttraining_torch.algorithms import ALGORITHMS  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.obs import comm as tcomm  # noqa: E402
from neuroimagedisttraining_torch.parallel import collectives as tcoll  # noqa: E402

IMPLS = tcoll.AGG_IMPLS


@pytest.fixture(scope="module")
def alexnet():
    """The full-width AlexNet3D's reference template at the ABCD volume, a
    seeded half-density kernel mask in the reference layout and its port
    twin."""
    tmpl = jax.eval_shape(lambda: jinit(jcreate("3dcnn", num_classes=1),
                                        jax.random.PRNGKey(0),
                                        (121, 145, 121, 1)))
    rs = np.random.RandomState(0)
    mask = jax.tree_util.tree_map_with_path(
        lambda p, t: ((rs.rand(*t.shape) < 0.5) if p[-1].key == "kernel"
                      else np.ones(t.shape)).astype(np.float32), tmpl)
    return tmpl, mask, jax_params_to_torch(mask)


@pytest.mark.parametrize("impl", IMPLS)
def test_wire_cost_model_matches_reference(alexnet, impl):
    """One model per side from the same template and mask, under ``impl``
    (hier under each of its wires): the same per-run ``comm_*`` metrics,
    every impl's bytes and the per-group bytes, exactly."""
    tmpl, jmask, tmask = alexnet
    wires = tcoll.HIER_WIRES if impl == "hier" else ("bf16",)
    for wire in wires:
        kw = dict(agg_impl=impl, bucket_size=4096, n_devices=2,
                  topk_density=0.05, hier_wire=wire)
        j = jcomm.WireCostModel.from_params(
            tmpl, plan=jcoll.build_sparse_plan(jmask), **kw)
        t = tcomm.WireCostModel.from_params(
            tmask, plan=tcoll.build_sparse_plan(tmask), **kw)
        assert t.round_metrics() == j.round_metrics(), wire
        assert {i: t.bytes_for(i) for i in IMPLS} == \
            {i: j.bytes_for(i) for i in IMPLS}
        assert t.group_bytes() == j.group_bytes()
        # no plan: the mask-dependent wires are not projected
        assert tcomm.WireCostModel.from_params(tmask, **kw).what_if() == \
            jcomm.WireCostModel.from_params(tmpl, **kw).what_if()


def test_payload_helpers_match_reference():
    """The raw payload bytes of a tree (dense, and under a mask) and one
    client's top-k payload: the reference's, leaf for leaf."""
    rs = np.random.RandomState(1)
    tree = {"a": rs.randn(6, 5).astype(np.float32),
            "b": rs.randn(17).astype(np.float32),
            "c": rs.randn(3, 2, 2).astype(np.float32)}
    mask = {k: (rs.rand(*v.shape) < 0.4).astype(np.float32)
            for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for m in (None, mask):
        assert tcomm.message_payload_nbytes(ttree, m) == \
            jcomm.message_payload_nbytes(tree, m)
        got = tcomm.topk_payload(ttree, 0.25, m)
        want = jcomm.topk_payload(tree, 0.25, m)
        for k in tree:
            np.testing.assert_array_equal(got[k]["idx"], want[k]["idx"])
            np.testing.assert_array_equal(got[k]["val"], want[k]["val"])
        assert tcomm.message_payload_nbytes(got) == \
            jcomm.message_payload_nbytes(want)


def test_agg_microbench_records_wire_bytes():
    """``agg_microbench``'s timings go into a registry it is given, and its
    ``wire_bytes_<impl>`` are the reference microbench's, impl for impl."""
    from neuroimagedisttraining_torch.obs.metrics import MetricsRegistry

    kw = dict(n_clients=4, iters=1, bucket_size=4096,
              model_key="small3dcnn", sample_shape=(8, 8, 8, 1))
    reg = MetricsRegistry()
    got = tcoll.agg_microbench(device="cpu", registry=reg, **kw)
    want = jcoll.agg_microbench(**kw)
    dist = reg.distribution("agg_ms")
    for impl in IMPLS:
        assert got[f"wire_bytes_{impl}"] == want[f"wire_bytes_{impl}"], impl
        assert got[f"agg_ms_{impl}"] > 0
        assert dist.labels(impl=impl).last == got[f"agg_ms_{impl}"], impl


def _algo(impl):
    data = make_synthetic_federated(seed=0, n_clients=4,
                                    samples_per_client=16, test_per_client=4)
    hp = HyperParams(lr=0.01, momentum=0.9, local_epochs=1,
                     steps_per_epoch=2, batch_size=8)
    return ALGORITHMS["salientgrads"](
        create_model("small3dcnn", num_classes=1), data, hp, frac=0.5,
        seed=0, device="cpu", agg_impl=impl, agg_bucket_size=1024)


@pytest.mark.parametrize("impl", ["dense", "int8", "sparse", "topk"])
def test_probe_aggregate_is_a_pure_readout(impl):
    """The probe through the algorithm's own aggregate: its time, and the
    weighted sum's FLOPs and bytes counted from the shapes; a round after
    it bitwise the round of a twin that ran no probe."""
    a, b = _algo(impl), _algo(impl)
    sa, sb = a.init_state(), b.init_state()
    probe = tcomm.probe_aggregate(a, state=sa, iters=2)
    n = sum(p.numel() for p in a.model.parameters())
    s = a.clients_per_round
    assert probe["agg_ms"] > 0 and probe["compile_s"] == 0.0
    assert probe["flops"] == 2.0 * s * n
    assert probe["bytes_accessed"] == 4.0 * (s * n + n + s)
    model = tcomm.WireCostModel.from_algorithm(a, sa)
    assert model.agg_impl == impl and model.density == pytest.approx(
        a._agg_sparse_plan.density if a._agg_sparse_plan is not None
        else tcoll.build_sparse_plan(sa.mask).density)
    sa, _ = a.run_round(sa, 0)
    sb, _ = b.run_round(sb, 0)
    for k, v in sb.global_params.items():
        assert torch.equal(sa.global_params[k], v), k
