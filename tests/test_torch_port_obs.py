"""The port's observability tier (``neuroimagedisttraining_torch/obs``) against
the JAX package's, on the CPU: the session's JSONL, metrics and events
streams, the tracer, the SLO engine, the catalog and the bench history on
the same record streams; the memory watermark; ``devtrace`` on a
hand-written ``torch.profiler`` trace and on a CPU capture of a round; and
the CLI's fused and streamed runs with the session on, bitwise their
obs-off twins."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cli_helpers import SMALL  # noqa: E402
from neuroimagedisttraining_tpu.obs import catalog as jcatalog  # noqa: E402
from neuroimagedisttraining_tpu.obs import devtrace as jdevtrace  # noqa: E402
from neuroimagedisttraining_tpu.obs import export as jexport  # noqa: E402
from neuroimagedisttraining_tpu.obs import regress as jregress  # noqa: E402
from neuroimagedisttraining_tpu.obs import slo as jslo  # noqa: E402
from neuroimagedisttraining_tpu.obs import trace as jtrace  # noqa: E402
from neuroimagedisttraining_torch.experiments import runner as trunner  # noqa: E402
from neuroimagedisttraining_torch.obs import catalog as tcatalog  # noqa: E402
from neuroimagedisttraining_torch.obs import devtrace as tdevtrace  # noqa: E402
from neuroimagedisttraining_torch.obs import export as texport  # noqa: E402
from neuroimagedisttraining_torch.obs import memory as tmemory  # noqa: E402
from neuroimagedisttraining_torch.obs import metrics as tmetrics  # noqa: E402
from neuroimagedisttraining_torch.obs import regress as tregress  # noqa: E402
from neuroimagedisttraining_torch.obs import slo as tslo  # noqa: E402
from neuroimagedisttraining_torch.obs import trace as ttrace  # noqa: E402

SPEC = ("p90:train_loss<0.8@w=4;ewma:train_loss<0.9@a=0.5;"
        "rate:clients_quarantined<0.5@w=3")
#: the keys a machine, not the record stream, decides
HOST_KEYS = ("mem_",)


def _records():
    """A deterministic round stream: a loss spike, quarantines, drift."""
    losses = [0.7, 0.69, 0.68, 1.4, 1.6, 0.66, 0.65, 0.64]
    out = []
    for r, loss in enumerate(losses):
        out.append({"round": r, "train_loss": loss,
                    "clients_quarantined": float(r in (3, 4)),
                    "clients_dropped": 0.0, "round_time_s": 0.5,
                    "num_drift_s0": 1.0 + r, "num_drift_s1": 2.0,
                    "global_acc": 0.5 + 0.01 * r})
    out.append({"round": -1, "global_acc": 0.6, "global_loss": 0.6})
    return out


def _run_session(mod, slo_mod, root, vec):
    session = mod.ObsSession(
        jsonl_path=os.path.join(root, "run.obs.jsonl"),
        trace_dir=os.path.join(root, "tr"), identity="run", comm=True,
        slo=slo_mod.SloEngine(slo_mod.load_slo_spec(SPEC)),
        catalog_path=os.path.join(root, "runs_index.jsonl"),
        catalog_info={"config": {"algo": "fedavg", "seed": 0}})
    session.set_comm_metrics({"comm_bytes_wire": 4096.0,
                              "comm_agg_ms": 2.0})
    for rec in _records():
        r = rec["round"]
        extra = {"acc_per_client": vec(r)} if r >= 0 else None
        session.record_round(dict(rec), extra=extra)
    snap = session.finish()
    return session, snap


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _strip(rec):
    return {k: v for k, v in rec.items() if not k.startswith(HOST_KEYS)}


def test_session_streams_match_reference(tmp_path):
    """The same record stream through both sessions (SLO engine, wire
    metrics, catalog): the same JSONL lines apart from the memory samples,
    the same events, the same metric names and the same catalog entry."""
    j, jsnap = _run_session(jexport, jslo, str(tmp_path / "j"),
                            lambda r: np.array([0.5, r / 10], np.float32))
    t, tsnap = _run_session(texport, tslo, str(tmp_path / "t"),
                            lambda r: torch.tensor([0.5, r / 10]))
    jl, tl = _lines(j.jsonl_path), _lines(t.jsonl_path)
    assert [_strip(r) for r in tl] == [_strip(r) for r in jl]
    assert {k for r in tl for k in r if k.startswith("mem_")} >= {
        "mem_host_rss_bytes", "mem_device_bytes_in_use"}
    assert _lines(t.events_path) == _lines(j.events_path)
    assert t.events_path.endswith("run.events.jsonl")
    assert any(r.get("slo_event") for r in tl)

    def names(snap):
        return sorted(k for k in snap
                      if not k.startswith(("compile_", "mem_")))
    assert names(tsnap) == names(jsnap)
    for k in ("rounds_recorded", "slo_events_total", "train_loss"):
        assert tsnap[k] == jsnap[k], k
    with open(t.metrics_json_path) as f:
        assert json.load(f) == json.loads(json.dumps(tsnap))
    (tc,), (jc,) = (_lines(str(tmp_path / s / "runs_index.jsonl"))
                    for s in "tj")
    assert sorted(tc) == sorted(jc)
    for k in ("identity", "final_metrics", "slo_health", "event_counts",
              "rounds_recorded", "completed", "flags"):
        assert tc[k] == jc[k], k
    # the session restores the null tracer it replaced
    assert ttrace.get_tracer() is ttrace.NULL_TRACER


def test_tracer_spans_match_reference(tmp_path):
    """The same nested spans on both tracers: the same Chrome events
    (names, nesting depth, attributes) apart from the clocks and ids; with
    no tracer set a span is the shared null span."""
    assert ttrace.span("x") is ttrace.span("y")  # the null tracer
    events = {}
    for name, mod in (("j", jtrace), ("t", ttrace)):
        tracer = mod.Tracer()
        mod.set_tracer(tracer)
        try:
            for r in range(2):
                with mod.step_span("round", r):
                    with mod.span("sample"):
                        assert mod.current_span_name() == "sample"
                    with mod.span("dispatch_round") as sp:
                        sp.add("rounds", 1)
        finally:
            mod.set_tracer(None)
        path = tracer.write(str(tmp_path / name / "trace.json"))
        with open(path) as f:
            events[name] = [{k: v for k, v in e.items()
                             if k not in ("ts", "dur", "pid", "tid")}
                            for e in json.load(f)["traceEvents"]]
    assert events["t"] == events["j"]
    assert [e["name"] for e in events["t"]].count("round") == 2


def test_slo_engine_matches_reference():
    """One spec (objectives on train_loss and the quarantines) over one
    record stream: identical events, health trajectories and summaries;
    a replay rebuilds the same state."""
    runs = {}
    for name, mod in (("j", jslo), ("t", tslo)):
        eng = mod.SloEngine(mod.load_slo_spec(SPEC))
        evs, health = [], []
        for rec in _records()[:-1]:
            evs += [e.to_record() for e in eng.observe(rec)]
            health.append(eng.health)
        replayed = mod.SloEngine(mod.load_slo_spec(SPEC))
        replayed.replay(_records()[:-1])
        runs[name] = (evs, health, eng.summary(), replayed.summary())
    assert runs["t"] == runs["j"]
    assert runs["t"][0] and runs["t"][2] == runs["t"][3]


def test_catalog_and_regress_match_reference(tmp_path):
    """The catalog's entry and identity flags and the bench history's
    entries and verdicts: the same keys and values on both sides."""
    from neuroimagedisttraining_tpu.analysis.identity import FLAG_CLASSES

    assert list(tcatalog.IDENTITY_FLAGS) == sorted(
        n for n, (c, _) in FLAG_CLASSES.items() if c == "identity")
    config = {"algo": "salientgrads", "seed": 3, "obs": 1, "lr": 0.01,
              "trace_dir": "x"}
    kw = dict(identity="run", config=config, checkpoint_identity="ck",
              git_sha="abc", final_metrics={"train_loss": 0.5},
              slo_health="ok", event_counts={"GUARD": 1},
              rounds_recorded=3, artifacts={"obs_jsonl": "a"},
              completed=True)
    assert tcatalog.build_entry(**kw) == jcatalog.build_entry(**kw)
    entries = {}
    for name, mod in (("j", jregress), ("t", tregress)):
        path = str(tmp_path / name / "h.jsonl")
        for v in (10.0, 10.2, 9.9, 10.1):
            mod.append_history(path, {"metric": "m", "value": v,
                                      "unit": "rounds/sec"})
        hist = mod.read_history(path, "m")
        values = [e["value"] for e in hist]
        entries[name] = ([sorted(e) for e in hist],
                         mod.detect_regression(values, 7.0),
                         mod.detect_regression(values, 10.0))
    assert entries["t"] == entries["j"]


def test_memory_watermark_reports_the_cpu_as_the_cpu():
    """Without a card ``device_memory`` is one CPU entry (the resident
    set, never under a card's name); the watermark's gauges and the
    store's extra gauges join each sample."""
    (rec,) = tmemory.device_memory()
    assert rec["platform"] == "cpu" and rec["source"] == "host_rss"
    assert rec["bytes_in_use"] > 0 and "peak_bytes_in_use" not in rec
    reg = tmetrics.MetricsRegistry()
    wm = tmemory.MemoryWatermark(reg, sample_every=2)
    wm.attach_extra(lambda: {"mem_store_hits": 3})
    assert wm.maybe_sample(1) is None
    out = wm.maybe_sample(2)
    assert sorted(out) == ["mem_device_bytes_in_use", "mem_host_rss_bytes",
                           "mem_store_hits"]
    assert reg.gauge("mem_store_hits").value == 3.0


def _kernel(name, ts, dur, tid=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur}


def test_devtrace_attributes_a_torch_trace():
    """A ``torch.profiler`` trace: only the kernels count (the CPU ops do
    not), NCCL's kernels are the collectives, and an all-reduce on its own
    stream overlapping compute is overlap; a JAX-format trace reads as the
    JAX package reads it."""
    doc = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 99,
         "tid": 1, "ts": 0, "dur": 1000},
        _kernel("stem_fwd_kernel", 0, 100),
        _kernel("weighted_sum_kernel", 100, 50),
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 120, 60, tid=20),
        _kernel("ncclKernel_AllGather_RING_LL_Sum_int8_t", 200, 40, tid=20),
    ]}
    got = tdevtrace.attribute_trace(doc)
    tot = got["totals"]
    assert list(got["devices"]) == ["GPU 0"]
    assert tot["busy_s"] == pytest.approx(250e-6)
    assert tot["collective_s"] == pytest.approx(100e-6)
    assert tot["agg_share"] == pytest.approx(0.4)
    assert tot["overlap_s"] == pytest.approx(30e-6)  # 120..150
    assert tot["overlap_frac"] == pytest.approx(0.3)
    assert [t["name"] for t in got["top_collectives"]][0].startswith(
        "ncclDevKernel")
    jdoc = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
         "args": {"name": "XLA Modules"}},
        {"ph": "X", "name": "fusion.1", "pid": 1, "tid": 1, "ts": 0,
         "dur": 30},
        {"ph": "X", "name": "all-reduce.3", "pid": 1, "tid": 1, "ts": 30,
         "dur": 10},
        {"ph": "X", "name": "module", "pid": 1, "tid": 2, "ts": 0,
         "dur": 40},
    ]}
    assert tdevtrace.attribute_trace(jdoc) == jdevtrace.attribute_trace(jdoc)


def _small_algo(**kw):
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model

    data = make_synthetic_federated(seed=0, n_clients=4,
                                    samples_per_client=16,
                                    test_per_client=4)
    hp = HyperParams(lr=0.01, momentum=0.9, local_epochs=1,
                     steps_per_epoch=2, batch_size=8)
    return SalientGrads(create_model("small3dcnn", num_classes=1), data, hp,
                        frac=0.5, seed=0, device="cpu", **kw)


def test_devtrace_reads_a_cpu_profile_of_a_round(tmp_path):
    """``trace_one_round`` on the CPU: a trace ``devtrace`` finds, with the
    host spans as user annotations and the round's CPU ops, but no kernel
    lane (no attribution); the caller's state is left as it was."""
    from neuroimagedisttraining_torch.utils.profiling import trace_one_round

    algo = _small_algo()
    state = algo.init_state()
    before = algo.clone_state(state)
    tracer = ttrace.Tracer()
    ttrace.set_tracer(tracer)
    try:
        ms = trace_one_round(algo, state, str(tmp_path / "prof"))
    finally:
        ttrace.set_tracer(None)
    assert ms > 0
    for k, v in before.global_params.items():
        assert torch.equal(state.global_params[k], v)
    (path,) = tdevtrace.find_trace_files(str(tmp_path / "prof"))
    doc = tdevtrace.load_trace_doc(path)
    names = {e.get("name") for e in doc["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"dispatch_round", "sample"} <= names
    assert any(e.get("cat") == "cpu_op" for e in doc["traceEvents"])
    assert not any(e.get("cat") == "kernel" for e in doc["traceEvents"])
    summary = tdevtrace.analyze_profile_dir(str(tmp_path / "prof"))
    assert summary["files"] == 1 and not summary["present"]


#: the CLI's fused and streamed runs, each with every in-process obs flag
OBS_FLAGS = ["--obs", "1", "--obs_numerics", "1", "--obs_comm", "1",
             "--slo_spec", "p99:train_loss<10", "--obs_sample_every", "1"]


@pytest.mark.parametrize("extra", [
    ["--fuse_rounds", "2", "--frequency_of_the_test", "1"],
    ["--client_store", "host", "--frac", "0.5",
     "--fault_spec", "scale=0.25:10x"],
], ids=["fused", "store"])
def test_cli_obs_on_is_bitwise_obs_off(tmp_path, extra):
    """``--obs`` with the numerics, the wire model and the SLO engine on a
    fused run and on a streamed one with faults: the history (less the
    round times and the numerics it adds), the final eval and the state
    bitwise the obs-off run's; the JSONL has a line a round and the final
    one, the store's gauges (the memory watermark's extra) or the fault
    stamps on it."""
    argv = ["--algo", "salientgrads"] + SMALL + [
        "--comm_round", "2", "--epochs", "1", "--log_dir", "",
        "--device", "cpu"] + extra
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        on = trunner.main(argv + OBS_FLAGS + ["--trace_dir",
                                              str(tmp_path / "tr"),
                                              "--results_dir",
                                              str(tmp_path / "res")])
        off = trunner.main(argv + ["--results_dir", ""])
    finally:
        torch.set_num_threads(threads)
    added = ("round_time_s", "num_")
    assert [{k: v for k, v in h.items() if not k.startswith(added)}
            for h in on["history"]] == off["history"]
    assert on["final_eval"].keys() == off["final_eval"].keys()
    for k, v in off["state"].global_params.items():
        assert torch.equal(on["state"].global_params[k], v), k
    lines = _lines(str(tmp_path / "res" / "synthetic" /
                       (on["identity"] + ".obs.jsonl")))
    assert [r["round"] for r in lines] == [0, 1, -1]
    for r in lines[:2]:
        assert r["obs_schema"] == 4 and r["slo_health"] == "ok"
        assert "num_update_norm" in r and "comm_bytes_wire" in r
        if "--client_store" in extra:
            assert r["mem_store_hits"] + r["mem_store_misses"] > 0
            assert "clients_byzantine" in r
    assert os.path.exists(tmp_path / "tr" / (on["identity"] + ".trace.json"))
