"""The port's population client store (``core/client_store.py`` and the
algorithms' ``client_store="host"|"disk"``), on the CPU: the port of
``tests/test_client_store.py``'s matrix.

* The store: rows never written read as the registered default, the disk
  mode's hot-row LRU spills to its memmaps and a later stage of an id wins,
  ``discard`` drops staged rows, the snapshot round-trips and refuses
  another field set or population size with the JAX store's messages,
  bfloat16 rows move byte for byte, and a script of stages, commits,
  gathers and prefetches leaves the port's counters where the JAX
  package's store leaves its own.
* The residency contract: a streamed run (host or disk, dense or top-k,
  guard on or off, NaN faults in the guarded cells) is bitwise the
  resident run, rows, residuals, metrics and the eval included; fused
  blocks (slab buffers of the widest block's width, reused by a narrower
  one); Ditto and the eval cache; the watchdog's discard of a doomed
  attempt and its rollback from a store-backed checkpoint; a store-backed
  kill and resume, and the fallback past a step whose sidecar is gone.
* The refusals of the constructor and the runner, message for message with
  the JAX package's.
* Across frameworks: the port's streamed SalientGrads against the JAX
  package's streamed run on ``tests/test_torch_port_round.py``'s cohort
  (data seed 4) at ``frac`` 2/3, the reference's draws fed at the seams:
  two rounds within rtol 1e-5 (atol 2e-7 for the GroupNorm-fed biases),
  every client's stored row within rtol 1e-5 and 1e-5 of its leaf's scale
  (the bound of the port's other trained stacks against the reference).

The device memory and throughput pins of the reference's matrix run only
on the card (``chip_smoke.py``'s ``state`` phase).
"""
import itertools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import _torch_port_cohort as pc  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import FedAvg as JFedAvg  # noqa: E402
from neuroimagedisttraining_tpu.algorithms import SalientGrads as JSalientGrads  # noqa: E402
from neuroimagedisttraining_tpu.algorithms.base import \
    sample_client_indexes as jsample  # noqa: E402
from neuroimagedisttraining_tpu.core.client_store import \
    ClientStore as JClientStore  # noqa: E402
from neuroimagedisttraining_tpu.core.state import HyperParams as JHyperParams  # noqa: E402
from neuroimagedisttraining_tpu.core.trainer import epoch_permutations  # noqa: E402
from neuroimagedisttraining_tpu.data import make_synthetic_federated as jsynth  # noqa: E402
from neuroimagedisttraining_tpu.experiments import parse_args as jparse  # noqa: E402
from neuroimagedisttraining_tpu.experiments import runner as jrunner  # noqa: E402
from neuroimagedisttraining_tpu.models import create_model as jcreate  # noqa: E402
from neuroimagedisttraining_torch.algorithms import (  # noqa: E402
    Ditto,
    FedAvg,
    SalientGrads,
)
from neuroimagedisttraining_torch.core.client_store import ClientStore  # noqa: E402
from neuroimagedisttraining_torch.core.state import HyperParams  # noqa: E402
from neuroimagedisttraining_torch.data import make_synthetic_federated  # noqa: E402
from neuroimagedisttraining_torch.experiments import parse_args as tparse  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.models import create_model  # noqa: E402
from neuroimagedisttraining_torch.robust.recovery import RoundWatchdog  # noqa: E402
from neuroimagedisttraining_torch.utils.checkpoint import CheckpointManager  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small CPU ops among the suite's parallel workers: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n_clients=12):
    return make_synthetic_federated(
        seed=3, n_clients=n_clients, samples_per_client=8, test_per_client=4,
        sample_shape=(6, 6, 6, 1))


def _hp():
    return HyperParams(lr=0.05, lr_decay=0.998, momentum=0.9,
                       local_epochs=1, steps_per_epoch=2, batch_size=4)


_STORES = itertools.count()


def _mk(cls, store, tmp_path, frac=0.25, **kw):
    extra = {}
    if store:
        extra = dict(client_store=store, store_hot_clients=3,
                     store_dir=str(tmp_path / f"store_{next(_STORES)}"))
    torch.manual_seed(0)
    return cls(create_model("small3dcnn", num_classes=1), _data(), _hp(),
               loss_type="bce", frac=frac, seed=3, device="cpu", **kw,
               **extra)


def _trees_equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def _template():
    return {"w": torch.zeros((3, 2)), "b": torch.ones((4,))}


def _np_template():
    return {"w": np.zeros((3, 2), np.float32), "b": np.ones((4,), np.float32)}


def _row(w, b, n=1):
    return {"w": torch.full((n, 3, 2), w), "b": torch.full((n, 4), b)}


# ---------------------------------------------------------------- the store


def test_store_default_rows_and_roundtrip():
    """A row never written reads as the registered default; a written one
    reads back exactly."""
    st = ClientStore(8, mode="host", hot_clients=4)
    st.register("personal_params", _template())
    got = st.gather("personal_params", np.array([5]))
    assert torch.equal(got["w"][0], torch.zeros((3, 2)))
    assert torch.equal(got["b"][0], torch.ones(4))
    st.stage("personal_params", np.array([5]), _row(7.0, -1.0))
    st.commit()
    back = st.gather("personal_params", np.array([5, 0]))
    assert torch.equal(back["w"][0], torch.full((3, 2), 7.0))
    assert torch.equal(back["w"][1], torch.zeros((3, 2)))
    assert not st._fields["personal_params"].materialized[0]


def test_store_lru_eviction_and_writeback_order(tmp_path):
    """Disk mode with a 2-row hot cache: the overflow spills to the
    memmaps, evicted rows read back exactly, and of an id staged twice the
    later stage wins at commit."""
    st = ClientStore(6, mode="disk", hot_clients=2, root=str(tmp_path / "d"))
    st.register("agg_residual", _template())
    for cid in range(4):
        st.stage("agg_residual", np.array([cid]), _row(float(cid),
                                                       float(cid)))
    st.stage("agg_residual", np.array([1]), _row(99.0, 99.0))
    st.commit()
    assert len(st._fields["agg_residual"].rows) <= 2
    assert st.stats()["mem_store_disk_bytes"] > 0
    w = st.gather("agg_residual", np.arange(4))["w"]
    for cid in range(4):
        assert torch.all(w[cid] == (99.0 if cid == 1 else float(cid))), cid


def test_store_discard_drops_staged_rows():
    """Discarded stages never reach storage: the committed value stays."""
    st = ClientStore(4, mode="host", hot_clients=4)
    st.register("personal_params", _template())
    st.stage("personal_params", np.array([2]), _row(1.0, 1.0))
    st.commit()
    st.stage("personal_params", np.array([2]),
             _row(float("nan"), float("nan")))
    assert list(st.dirty_ids()) == [2]
    st.discard()
    assert list(st.dirty_ids()) == []
    assert torch.all(st.gather("personal_params", [2])["w"] == 1.0)


@pytest.mark.parametrize("mode", ["host", "disk"])
def test_store_snapshot_roundtrip_and_schema_guard(tmp_path, mode):
    """The snapshot carries the written rows; another field set or
    population size is refused with the JAX store's message."""
    st = ClientStore(5, mode=mode, hot_clients=1, root=str(tmp_path / "a"))
    st.register("personal_params", _template())
    st.stage("personal_params", np.array([0, 3]), _row(4.0, 4.0, 2))
    snap = str(tmp_path / "snap.npz")
    st.snapshot_save(snap)
    st2 = ClientStore(5, mode=mode, hot_clients=1, root=str(tmp_path / "b"))
    st2.register("personal_params", _template())
    st2.stage("personal_params", np.array([1]), _row(8.0, 8.0))
    st2.snapshot_load(snap)
    assert _trees_equal(st.gather_all("personal_params"),
                        st2.gather_all("personal_params"))
    assert list(np.nonzero(
        st2._fields["personal_params"].materialized)[0]) == [0, 3]
    jsnap = str(tmp_path / "jsnap.npz")
    jst = JClientStore(5, mode="host", hot_clients=1)
    jst.register("personal_params", _np_template())
    jst.snapshot_save(jsnap)
    for n, field in ((5, "agg_residual"), (7, "personal_params")):
        t = ClientStore(n, mode="host")
        t.register(field, _template())
        j = JClientStore(n, mode="host")
        j.register(field, _np_template())
        with pytest.raises(RuntimeError) as te:
            t.snapshot_load(jsnap)
        with pytest.raises(RuntimeError) as je:
            j.snapshot_load(jsnap)
        assert str(te.value) == str(je.value)


def test_store_bf16_rows_move_byte_for_byte(tmp_path):
    """A bfloat16 leaf (kept as its bit pattern) through the hot set, the
    disk, a snapshot and a gather: the same bits, the same dtype."""
    st = ClientStore(4, mode="disk", hot_clients=1, root=str(tmp_path / "d"))
    tmpl = {"x": torch.zeros(5, dtype=torch.bfloat16)}
    st.register("personal_params", tmpl)
    rows = {"x": torch.randn(3, 5).to(torch.bfloat16)}
    st.stage("personal_params", [0, 1, 3], rows)
    got = st.gather("personal_params", [0, 1, 3])["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, rows["x"])
    st.snapshot_save(str(tmp_path / "s.npz"))
    st2 = ClientStore(4, mode="host")
    st2.register("personal_params", tmpl)
    st2.snapshot_load(str(tmp_path / "s.npz"))
    assert torch.equal(st2.gather("personal_params", [0, 1, 3])["x"],
                       rows["x"])


def test_store_counters_match_reference(tmp_path):
    """One script of registers, stages, commits, gathers, prefetches and a
    discard through the port's store and the JAX package's: the same rows
    out and the same counters (hits, misses, prefetched rows, host and
    disk bytes); the gather time accrues."""
    def script(store, row):
        store.register("personal_params", _template() if row is _row
                       else _np_template())
        store.register("agg_residual", _template() if row is _row
                       else _np_template())
        out = []
        for r in range(5):
            ids = np.array([(3 * r) % 7, (3 * r + 1) % 7])
            store.stage("personal_params", ids, row(float(r), -r, 2))
            if r % 2:
                store.stage("agg_residual", ids[:1], row(r + 0.5, r, 1))
            if r == 3:
                store.discard()
            store.prefetch("personal_params", [(3 * r + 3) % 7, 6])
            out.append(store.gather("personal_params", ids[::-1]))
            out.append(store.gather("agg_residual", [0, 4]))
        store.commit()
        out.append(store.gather_all("personal_params"))
        return out, store.stats()

    def nrow(w, b, n=1):
        return {"w": np.full((n, 3, 2), w, np.float32),
                "b": np.full((n, 4), b, np.float32)}

    t_out, t_stats = script(ClientStore(7, mode="disk", hot_clients=2,
                                        root=str(tmp_path / "t")), _row)
    j_out, j_stats = script(JClientStore(7, mode="disk", hot_clients=2,
                                         root=str(tmp_path / "j")), nrow)
    for t, j in zip(t_out, j_out):
        for k in ("w", "b"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    assert t_stats.pop("store_gather_ms") > 0
    j_stats.pop("store_gather_ms")
    assert t_stats == j_stats


# ------------------------------------------------- the residency contract


def _run_pair(cls, tmp_path, mode, rounds=3, **kw):
    a = _mk(cls, None, tmp_path, **kw)
    b = _mk(cls, mode, tmp_path, **kw)
    sa, sb = a.init_state(), b.init_state()
    for r in range(rounds):
        sa, ma = a.run_round(sa, r)
        sb, mb = b.run_round(sb, r)
        for k in ma:
            assert float(ma[k]) == float(mb[k]), (r, k)
    return a, sa, b, sb


def _assert_rows_match(a, sa, b, sb):
    """Every streamed row bitwise its resident twin, the global model and
    the whole eval included."""
    assert _trees_equal(sa.global_params, sb.global_params)
    b.store_flush()
    assert b._store.dirty_ids().size == 0
    for f in ("personal_params", "agg_residual"):
        if getattr(sa, f, None) is not None:
            assert getattr(sb, f) is None
            assert _trees_equal(getattr(sa, f), b._store.gather_all(f)), f
    ev_a, ev_b = a.evaluate(sa), b.evaluate(sb)
    assert sorted(ev_a) == sorted(ev_b)
    for k in ev_a:
        assert torch.equal(torch.as_tensor(ev_a[k]),
                           torch.as_tensor(ev_b[k])), k


@pytest.mark.parametrize("mode", ["host", "disk"])
@pytest.mark.parametrize("agg_impl", ["dense", "topk"])
@pytest.mark.parametrize("guarded", [False, True])
def test_streamed_bitwise_equals_resident(tmp_path, mode, agg_impl,
                                          guarded):
    """host/disk x dense/top-k x guard off/on (the guarded cells inject NaN
    faults, so quarantined clients keep their previous rows through the
    store's writeback): metrics, rows, residuals and the eval bitwise."""
    kw = dict(agg_impl=agg_impl)
    if guarded:
        kw.update(fault_spec="nan=0.3", guard=True)
    a, sa, b, sb = _run_pair(FedAvg, tmp_path, mode, **kw)
    _assert_rows_match(a, sa, b, sb)


def test_streamed_salientgrads_and_finalize_bitwise(tmp_path):
    """SalientGrads (its SNIP pass over the host data) streamed against
    resident; then FedAvg's final fine-tune, which retrains every client in
    cohorts through the store."""
    a, sa, b, sb = _run_pair(SalientGrads, tmp_path, "disk", dense_ratio=0.5)
    _assert_rows_match(a, sa, b, sb)
    a, sa, b, sb = _run_pair(FedAvg, tmp_path, "host", rounds=2)
    sa, ra = a.finalize(sa)
    sb, rb = b.finalize(sb)
    assert sorted(ra) == sorted(rb)
    assert all(float(ra[k]) == float(rb[k]) for k in ra if k != "round")
    assert _trees_equal(sa.personal_params,
                        b._store.gather_all("personal_params"))


@pytest.mark.parametrize("agg_impl", ["dense", "topk"])
def test_streamed_fused_blocks_bitwise(tmp_path, agg_impl):
    """Fused blocks over the union slab (2 rounds, then 1, then 2): metrics
    and rows bitwise the resident fused blocks; the slab buffers of the
    first block serve the narrower one; the in-graph eval cadence is
    refused with the reference's words."""
    a = _mk(FedAvg, None, tmp_path, agg_impl=agg_impl)
    b = _mk(FedAvg, "host", tmp_path, agg_impl=agg_impl)
    sa, sb = a.init_state(), b.init_state()
    fz = None
    for r0, k in ((0, 2), (2, 1), (3, 2)):
        sa, ya = a.run_rounds_fused(sa, r0, k)
        sb, yb = b.run_rounds_fused(sb, r0, k)
        assert fz is None or b._fused is fz
        fz = b._fused
        for n, v in ya.materialize().items():
            np.testing.assert_array_equal(v, yb[n])
    assert fz.width == 2 * b.clients_per_round
    _assert_rows_match(a, sa, b, sb)
    with pytest.raises(ValueError, match="the fused in-graph eval cadence"):
        b.run_rounds_fused(sb, 5, 2, eval_every=1)


def test_streamed_ditto_and_eval_cache(tmp_path):
    """Ditto's round body on the slab, and FedAvg's in-state eval cache
    refreshed through population ids (eager and fused)."""
    a, sa, b, sb = _run_pair(Ditto, tmp_path, "host")
    _assert_rows_match(a, sa, b, sb)
    a, sa, b, sb = _run_pair(FedAvg, tmp_path, "disk", eval_cache=True)
    assert _trees_equal(sa.eval_cache, sb.eval_cache)
    _assert_rows_match(a, sa, b, sb)
    sa, _ = a.run_rounds_fused(sa, 3, 2)
    sb, _ = b.run_rounds_fused(sb, 3, 2)
    assert _trees_equal(sa.eval_cache, sb.eval_cache)
    _assert_rows_match(a, sa, b, sb)


def test_watchdog_discard_keeps_streamed_identity(tmp_path):
    """A doomed attempt's staged rows discarded (the watchdog's RETRY and
    SKIP): the store stays where the adopted rounds put it."""
    a = _mk(FedAvg, None, tmp_path)
    b = _mk(FedAvg, "disk", tmp_path)
    sa, sb = a.init_state(), b.init_state()
    sa, _ = a.run_round(sa, 0)
    sb, _ = b.run_round(sb, 0)
    b.evaluate(sb)  # the store eval's terms, then invalidated by the discard
    b.run_round(b.clone_state(sb), 1)
    b.store_discard()
    for r in (1, 2):
        sa, ma = a.run_round(sa, r)
        sb, mb = b.run_round(sb, r)
        assert float(ma["train_loss"]) == float(mb["train_loss"]), r
    _assert_rows_match(a, sa, b, sb)


def test_watchdog_rollback_from_a_store_backed_checkpoint(tmp_path):
    """``RoundWatchdog(ckpt_mgr=, template_fn=, store=).rollback(None)``:
    the newest checkpoint's state bitwise, the store's rows reloaded from
    its sidecar (a later round's staged and committed rows gone)."""
    b = _mk(FedAvg, "disk", tmp_path, agg_impl="topk")
    sb = b.init_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), "lineage")
    for r in range(2):
        sb, _ = b.run_round(sb, r)
    mgr.save(2, sb, store=b._store)
    rows = {f: b._store.gather_all(f) for f in b._store.field_names()}
    later, _ = b.run_round(sb, 2)
    b.store_flush()
    wd = RoundWatchdog(ckpt_mgr=mgr, template_fn=b.init_state,
                       store=b._store)
    got = wd.rollback(None)
    assert _trees_equal(got.global_params, sb.global_params)
    assert torch.equal(got.generator.get_state(), sb.generator.get_state())
    for f, want in rows.items():
        assert _trees_equal(b._store.gather_all(f), want), f


def test_store_backed_checkpoint_resume(tmp_path):
    """A kill and resume through a store-backed lineage: rounds 0-1 saved
    with their sidecars, everything rebuilt, restored, rounds 2-3 bitwise
    the resident run; a step whose sidecar is gone is skipped for the next
    older one."""
    a = _mk(FedAvg, None, tmp_path, agg_impl="topk")
    sa = a.init_state()
    for r in range(4):
        sa, _ = a.run_round(sa, r)
    b = _mk(FedAvg, "host", tmp_path, agg_impl="topk")
    sb = b.init_state()
    mgr = CheckpointManager(str(tmp_path / "ck"), "lineage")
    for r in range(2):
        sb, _ = b.run_round(sb, r)
        mgr.save(r + 1, sb, force=True, store=b._store)
    assert os.path.exists(mgr._store_path(2))
    del b, sb
    c = _mk(FedAvg, "disk", tmp_path, agg_impl="topk")
    sc, step = mgr.restore_latest(c.init_state(), store=c._store)
    assert step == 2
    for r in range(2, 4):
        sc, _ = c.run_round(sc, r)
    _assert_rows_match(a, sa, c, sc)
    os.unlink(mgr._store_path(2))
    d = _mk(FedAvg, "host", tmp_path, agg_impl="topk")
    _, step = mgr.restore_latest(d.init_state(), store=d._store)
    assert step == 1


def test_store_stats_keys(tmp_path):
    """The store's counters after streamed rounds: every key a float, the
    hits and misses moved, the gather time accrued."""
    b = _mk(FedAvg, "host", tmp_path)
    sb = b.init_state()
    for r in range(3):
        sb, _ = b.run_round(sb, r)
    stats = b._store.stats()
    for key in ("mem_host_cache_bytes", "mem_store_disk_bytes",
                "mem_store_hits", "mem_store_misses",
                "mem_store_prefetched", "store_gather_ms"):
        assert isinstance(stats[key], float), key
    assert stats["mem_store_hits"] + stats["mem_store_misses"] > 0
    assert stats["store_gather_ms"] > 0


# ------------------------------------------------------------- refusals


def _jax_mk(cls, store, frac=0.25, **kw):
    data = jsynth(seed=3, n_clients=12, samples_per_client=8,
                  test_per_client=4, sample_shape=(6, 6, 6, 1))
    hp = JHyperParams(lr=0.05, lr_decay=0.998, momentum=0.9,
                      local_epochs=1, steps_per_epoch=2, batch_size=4)
    return cls(jcreate("small3dcnn", num_classes=1), data, hp,
               loss_type="bce", frac=frac, seed=3, client_store=store, **kw)


CTOR_REFUSALS = [
    (FedAvg, JFedAvg, dict(track_personal=False)),
    (FedAvg, JFedAvg, dict(frac=1.0)),
    (FedAvg, JFedAvg, dict(eval_clients=4)),
    (SalientGrads, JSalientGrads, dict(track_personal=False)),
]


@pytest.mark.parametrize("cls,jcls,kw", CTOR_REFUSALS)
def test_ctor_refusals_match_reference(tmp_path, cls, jcls, kw):
    """The constructor refuses what the JAX package's refuses, with its
    message; a residual-only store (top-k, no personal stack) runs."""
    with pytest.raises(ValueError) as te:
        _mk(cls, "host", tmp_path, **kw)
    with pytest.raises(ValueError) as je:
        _jax_mk(jcls, "host", **kw)
    assert str(te.value) == str(je.value)
    algo = _mk(cls, "host", tmp_path, track_personal=False, agg_impl="topk")
    s = algo.init_state()
    assert algo._store.field_names() == ("agg_residual",)
    algo.run_round(s, 0)
    algo.store_flush()
    assert algo._store.stats()["mem_host_cache_bytes"] > 0


def test_ctor_refuses_an_algorithm_without_a_store(tmp_path):
    from neuroimagedisttraining_torch.algorithms import LocalOnly

    with pytest.raises(ValueError, match="needs the store-backed round"):
        _mk(LocalOnly, "host", tmp_path)
    with pytest.raises(ValueError, match="client_store 'ssd' not in"):
        _mk(FedAvg, "ssd", tmp_path)


RUNNER_REFUSALS = [
    ("fedavg", ["--client_store", "host", "--track_personal", "0"]),
    ("fedavg", ["--client_store", "host", "--frac", "1.0"]),
    ("fedavg", ["--client_store", "disk", "--eval_clients", "4"]),
    ("fedavg", ["--client_store", "host", "--fuse_rounds", "2",
                "--frequency_of_the_test", "1"]),
    ("dpsgd", ["--client_store", "host"]),
]


@pytest.mark.parametrize("algo,extra", RUNNER_REFUSALS)
def test_runner_refusals_match_reference(algo, extra):
    """The runner refuses each contradiction before any work, with the JAX
    CLI's message."""
    base = ["--dataset", "synthetic", "--model", "small3dcnn",
            "--client_num_in_total", "8", "--comm_round", "1",
            "--frac", "0.5"]
    with pytest.raises(SystemExit) as te:
        trunner.build_algorithm(tparse(base + extra + ["--device", "cpu"],
                                       algo=algo), algo)
    with pytest.raises(SystemExit) as je:
        jrunner.build_algorithm(jparse(base + extra, algo=algo), algo)
    assert str(te.value.code) == str(je.value.code)


def test_cli_streams_a_population(tmp_path):
    """``--client_store disk --store_hot_clients 2`` through the CLI: the
    records and the final state of the resident run, bitwise."""
    def run(tag, extra):
        return trunner.main(
            ["--algo", "salientgrads", "--dataset", "synthetic", "--model",
             "small3dcnn", "--client_num_in_total", "8", "--frac", "0.25",
             "--comm_round", "3", "--device", "cpu", "--results_dir",
             str(tmp_path / tag), "--log_dir", ""] + extra)

    def hist(res):
        return [{k: v for k, v in h.items() if k != "round_time_s"}
                for h in res["history"]]

    res = run("r", [])
    got = run("s", ["--client_store", "disk", "--store_hot_clients", "2"])
    assert hist(got) == hist(res)
    assert _trees_equal(got["state"].global_params,
                        res["state"].global_params)


# ------------------------------------------------------- across frameworks


def test_streamed_salientgrads_matches_the_reference_streamed():
    """The port's streamed SalientGrads against the JAX package's streamed
    run (both ``client_store="host"``, ``frac`` 2/3 of the round test's
    cohort, data seed 4, the reference's mask and draws): two rounds within
    rtol 1e-5, every client's stored row included."""
    c = pc.cohort(seed=4)
    jalgo = JSalientGrads(c["jm"], c["jd"], pc.hp(JHyperParams, c["spe"]),
                          loss_type="bce", frac=2 / 3, seed=0,
                          dense_ratio=0.5, itersnip_iterations=1,
                          fused_kernels=True, agg_kernels="pallas",
                          client_store="host", store_hot_clients=2)
    js = jalgo.init_state(jax.random.PRNGKey(0))
    talgo = SalientGrads(c["tm"], c["td"], pc.hp(HyperParams, c["spe"]),
                         loss_type="bce", frac=2 / 3, seed=0, dense_ratio=0.5,
                         itersnip_iterations=1, device="cpu",
                         client_store="host", store_hot_clients=2)
    ts = talgo.init_state(params=pc.jax_params_to_torch(
        pc.np_tree(js.global_params)))
    ts.mask.update(pc.jax_params_to_torch(pc.np_tree(js.mask)))
    rng = js.rng
    for r in range(2):
        sel = jsample(r, pc.N_CLIENTS, 2)
        rng, round_key = jax.random.split(rng)
        keys = jax.random.split(round_key, len(sel) + 1)
        perms = [np.array(epoch_permutations(
            jax.random.split(keys[i])[0], jnp.int32(c["nvals"][int(s)]), 1,
            c["spe"] * pc.BS, n_rows=c["n_rows"]))
            for i, s in enumerate(sel)]
        js, jmet = jalgo.run_round(js, r)
        ts, tmet = talgo.run_round(ts, r, perms=perms)
        np.testing.assert_allclose(float(tmet["train_loss"]),
                                   float(jmet["train_loss"]), rtol=1e-5)
    pc.compare(ts.global_params, js.global_params, "dense")
    jalgo.store_flush()
    talgo.store_flush()
    # the stored rows are trained local models: as the port's other
    # trained stacks are held, within 1e-5 of each leaf's scale
    pc.compare(talgo._store.gather_all("personal_params"),
               jalgo._store.gather_all("personal_params"), "dense",
               stacked=True, leaf_scale=True)
    jev, tev = jalgo.evaluate(js), talgo.evaluate(ts)
    np.testing.assert_array_equal(tev["acc_per_client"].numpy(),
                                  np.asarray(jev["acc_per_client"]))
    for k in ("global_loss", "personal_loss"):
        np.testing.assert_allclose(float(tev[k]), float(jev[k]), rtol=2e-5)
