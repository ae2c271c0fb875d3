"""The port's round numerics (``neuroimagedisttraining_torch/obs/numerics.py``)
against the JAX package's on the CPU: ``NumericsPlan.compute`` on seeded
trees of the AlexNet3D and ``small3dcnn`` templates, masks on and off; the
eager rounds' numerics bitwise the fused block's, and the training bitwise
the numerics-off run's; the fault-count replay (``obs/health.py``) against
what the round did; and the numerics on a client mesh of gloo ranks."""
import json

import numpy as np
import pytest

import jax

torch = pytest.importorskip("torch")

from _torch_cli_helpers import SMALL  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_tpu.models import init_params as jinit  # noqa: E402
from neuroimagedisttraining_tpu.obs.numerics import (  # noqa: E402
    NumericsPlan as JPlan,
)
from neuroimagedisttraining_torch.algorithms import ALGORITHMS  # noqa: E402
from neuroimagedisttraining_torch.convert import jax_params_to_torch  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.obs.health import make_fault_counts_fn  # noqa: E402
from neuroimagedisttraining_torch.obs.numerics import NumericsPlan  # noqa: E402
from neuroimagedisttraining_torch.robust.faults import (  # noqa: E402
    fault_trace_round,
    parse_fault_spec,
)

#: (JAX model name, per-sample shape): the full-width AlexNet3D at the
#: ABCD volume and the small test model
TEMPLATES = {"3dcnn": (121, 145, 121, 1), "small3dcnn": (8, 8, 8, 1)}
SLOTS = 3


def _trees(name, with_mask, seed=0):
    """Seeded numpy trees on the reference template: the old and new
    global models, ``SLOTS`` stacked locals and (with ``with_mask``) a
    half-density mask on the kernels that every model honours but one
    local's extra live coordinates."""
    tmpl = jax.eval_shape(lambda: jinit(jcreate(name, num_classes=1),
                                        jax.random.PRNGKey(0),
                                        TEMPLATES[name]))
    rs = np.random.RandomState(seed)

    def tree(fn):
        return jax.tree_util.tree_map_with_path(
            lambda p, t: fn(p, t.shape).astype(np.float32), tmpl)

    old = tree(lambda p, s: rs.randn(*s) * 0.05)
    new = jax.tree_util.tree_map(
        lambda o: o + rs.randn(*o.shape).astype(np.float32) * 1e-3, old)
    loc = jax.tree_util.tree_map(
        lambda o: o[None] + rs.randn(SLOTS, *o.shape).astype(np.float32)
        * np.array([1e-3, 2e-3, 5e-3], np.float32).reshape(
            (SLOTS,) + (1,) * o.ndim), old)
    mask = None
    if with_mask:
        mask = tree(lambda p, s: (rs.rand(*s) < 0.5) if p[-1].key == "kernel"
                    else np.ones(s))
        new = jax.tree_util.tree_map(lambda a, m: a * m, new, mask)
        old = jax.tree_util.tree_map(lambda a, m: a * m, old, mask)
        loc = jax.tree_util.tree_map(lambda a, m: a * m[None], loc, mask)
        loc = jax.tree_util.tree_map(
            lambda a: np.concatenate([a[:1], a[1:2] + (a[1:2] == 0) * 1e-3,
                                      a[2:]]), loc)
    return tmpl, old, new, loc, mask


def _numerics64(plan, old, new, loc, mask):
    """The plan's metrics by their definitions, in float64 numpy on the
    reference trees (leaves in its order, groups its top-level scopes)."""
    groups = list(plan.group_names)
    gi = {g: i for i, g in enumerate(groups)}
    upd = np.zeros(len(groups))
    drift = np.zeros((SLOTS, len(groups)))
    maxabs = np.zeros(len(groups))
    dot = np.zeros(SLOTS)
    for (path, o), n, s in zip(
            jax.tree_util.tree_leaves_with_path(old),
            jax.tree_util.tree_leaves(new), jax.tree_util.tree_leaves(loc)):
        g = gi[path[0].key]
        o, n, s = (np.asarray(x, np.float64) for x in (o, n, s))
        u = (n - o).ravel()
        d = (s - o[None]).reshape(SLOTS, -1)
        upd[g] += u @ u
        drift[:, g] += (d * d).sum(1)
        dot += d @ u
        maxabs[g] = max(maxabs[g], np.abs(s).max())
    norm = np.sqrt(upd.sum())
    total = np.sqrt(drift.sum(1))
    out = [norm, *np.sqrt(upd), *np.sqrt(drift).mean(0), *maxabs, *total,
           *(dot / np.maximum(total * norm, 1e-30))]
    if mask is not None:
        def dist(a, b):
            la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
            return np.mean([np.mean((np.asarray(x) != 0) != (np.asarray(y)
                                                             != 0))
                            for x, y in zip(la, lb)])
        dists = np.array([dist(jax.tree_util.tree_map(lambda x: x[j], loc),
                               mask) for j in range(SLOTS)])
        out += [dist(new, old), 1 - dists.mean(), dists.max()]
    return dict(zip(plan.metric_names, out))


@pytest.mark.parametrize("with_mask", [False, True], ids=["dense", "mask"])
@pytest.mark.parametrize("name", sorted(TEMPLATES))
def test_numerics_plan_matches_reference(name, with_mask):
    """The same seeded trees through both plans: the same metric names
    (the layer groups are the reference's top-level scopes), each value
    within rtol 1e-5 of the definitions in float64, and within rtol 1e-5
    of the reference's plus the reference's own distance from float64 (its
    float32 sums over the full-width AlexNet3D's 2.5 M values stray up to
    ~2e-5 from it, the port's do not)."""
    tmpl, old, new, loc, mask = _trees(name, with_mask)
    jplan = JPlan.from_params(tmpl, slots=SLOTS, with_mask=with_mask)
    want = jplan.compute(old, new, loc, mask=mask)
    exact = _numerics64(jplan, old, new, loc, mask)

    def conv(tree, lead=0):
        return None if tree is None else jax_params_to_torch(tree, lead)

    t_old = conv(old)
    plan = NumericsPlan.from_params(t_old, slots=SLOTS, with_mask=with_mask)
    assert plan.metric_names == jplan.metric_names
    got = plan.compute(t_old, conv(new), conv(loc, 1), mask=conv(mask))
    assert list(got) == list(plan.metric_names)
    for k, w in zip(jplan.metric_names, want):
        assert got[k].dtype == torch.float32 and got[k].shape == ()
        v, w, x = float(got[k]), float(w), exact[k]
        np.testing.assert_allclose(v, x, rtol=1e-5, atol=1e-7, err_msg=k)
        assert abs(v - w) <= 1e-5 * abs(w) + 1e-7 + abs(w - x), k


def _algo(name, numerics, **kw):
    data = make_synthetic_federated(seed=0, n_clients=4,
                                    samples_per_client=16, test_per_client=4)
    hp = HyperParams(lr=0.01, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=2, batch_size=8)
    extra = dict(dense_ratio=0.5) if name == "salientgrads" else {}
    return ALGORITHMS[name](create_model("small3dcnn", num_classes=1), data,
                            hp, seed=0, device="cpu",
                            obs_numerics=numerics, **extra, **kw)


@pytest.mark.parametrize("name", ["salientgrads", "fedavg"])
def test_eager_numerics_are_the_fused_block_s(name):
    """Two eager rounds with the numerics: each round's numerics bitwise
    the fused block of the same two rounds (carried in its packed metric
    stack), and the states bitwise the numerics-off rounds'."""
    on, off = _algo(name, True, frac=0.5), _algo(name, False, frac=0.5)
    assert len(on._round_metric_names) > len(off._round_metric_names)
    s_on, s_off = on.init_state(), off.init_state()
    eager, plain, recs = s_on, s_off, []
    for r in range(2):
        eager, m = on.run_round(eager, r)
        plain, _ = off.run_round(plain, r)
        recs.append({k: float(v) for k, v in m.items()})
    fused, ys = on.run_rounds_fused(s_on, 0, 2)
    host = ys.materialize()
    for i, rec in enumerate(recs):
        assert sorted(rec) == sorted(on._round_metric_names)
        for k, v in rec.items():
            assert float(host[k][i]) == v, (i, k)
    for k, v in plain.global_params.items():
        assert torch.equal(eager.global_params[k], v)
        assert torch.equal(fused.global_params[k], v)


def test_fault_counts_replay_the_round():
    """``make_fault_counts_fn`` against what the round did: the replayed
    Byzantine clients are the slots whose drift the 100x scaling blew up,
    and the replayed NaN poisonings the guard's quarantines."""
    spec = "nan=0.3,scale=0.3:100x"
    algo = _algo("salientgrads", True, fault_spec=spec)
    counts = make_fault_counts_fn(spec, 0, algo.num_clients,
                                  algo.clients_per_round)
    state = algo.init_state()
    seen = 0
    for r in range(4):
        state, m = algo.run_round(state, r)
        drift = np.array([float(m[f"num_drift_s{j}"])
                          for j in range(algo.clients_per_round)])
        finite = drift[np.isfinite(drift)]
        blown = int((finite > 10 * finite.min()).sum()) if finite.size \
            else 0
        want = counts(r)
        assert want["clients_byzantine"] == blown, r
        tr = fault_trace_round(parse_fault_spec(spec), 0, r,
                               algo._selected_client_indexes(r))
        assert float(m["clients_quarantined"]) == tr["poisoned"].sum()
        assert int((~np.isfinite(drift)).sum()) == tr["poisoned"].sum()
        seen += blown
    assert seen > 0


def test_mesh_numerics(tmp_path):
    """``--obs_numerics`` on ``--mesh_devices 2`` (two gloo ranks, each
    holding its clients' rows, the per-row terms gathered), with the
    session and the wire model on: eager and in fused blocks, the records
    bitwise the mesh's obs-off run's (less the numerics and the round
    times), the JSONL written once (rank 0), the numerics within rtol
    1e-5 of the one-process run's (only the aggregate's cross-rank sum
    reassociates) and bitwise between the eager and the fused mesh
    runs."""
    argv = ["--algo", "salientgrads"] + SMALL + [
        "--comm_round", "2", "--epochs", "1", "--frac", "0.5", "--log_dir",
        "", "--results_dir", "", "--device", "cpu"]
    mesh = ["--mesh_devices", "2"]
    num = ["--obs_numerics", "1"]
    obs = ["--obs", "1", "--obs_comm", "1", "--obs_jsonl"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the parent's share
    try:
        m_on = trunner.main(argv + mesh + num + obs + [
            str(tmp_path / "eager.obs.jsonl")])
        m_fused = trunner.main(argv + mesh + num + ["--fuse_rounds", "2"]
                               + obs + [str(tmp_path / "fused.obs.jsonl")])
        m_off = trunner.main(argv + mesh)
        one = trunner.main(argv + num)
    finally:
        torch.set_num_threads(threads)
    assert m_on["client_mesh_devices"] == 2
    added = ("num_", "round_time_s")
    for run in (m_on, m_fused):
        assert [{k: v for k, v in h.items() if not k.startswith(added)}
                for h in run["history"]] == m_off["history"]
    for name in ("eager", "fused"):  # rank 0 alone wrote its lines
        with open(tmp_path / f"{name}.obs.jsonl") as f:
            lines = [json.loads(x) for x in f]
        assert [r["round"] for r in lines] == [0, 1, -1]
        assert lines[0]["comm_n_devices"] == 2.0
    for h, hf, h1 in zip(m_on["history"], m_fused["history"],
                         one["history"]):
        for k, v in h.items():
            if k.startswith("num_"):
                assert hf[k] == v, k
                # a cosine to an update of norm ~5e-4 whose coordinates
                # carry the 0.1-scale globals' float32 rounding: the
                # reassociated sum moves it by ~1e-5, absolutely
                np.testing.assert_allclose(
                    v, h1[k], rtol=1e-5,
                    atol=1e-4 if k.startswith("num_cos") else 1e-7,
                    err_msg=k)
    assert "num_mask_agree" in m_on["history"][0]
