"""The port's ``obs/xtrace.py`` and ``obs/live.py`` against the JAX
package's, on the CPU.

1. Headers: the ``xt_*`` trace context and the ``hb_*`` heartbeat ride a
   frame byte for byte as the reference's do, on every delta codec; an
   untraced, heartbeat-free frame reads as None; with the features off a
   frame is byte-identical to one that never heard of them.
2. Tracing: the same span sequence gives the same structure in both
   packages; ``merge_docs`` of the same streams is byte-identical; the
   NTP offset, ``span_index`` and ``validate_parentage`` agree.
3. The fleet ledger: the same (peer, time) observation sequence drives
   both ledgers through LIVE, SUSPECT and DOWN to the same snapshots and
   events, and ``render_frame`` gives the same bytes.
4. A loopback federation with ``--xtrace 1`` and heartbeats on: its merged
   trace's causal tree is closed, the fleet ledger is written, and the
   global model is bitwise the same run with both off.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neuroimagedisttraining_tpu.comm.message import Message as JMessage  # noqa: E402
from neuroimagedisttraining_tpu.fed import wire as jwire  # noqa: E402
from neuroimagedisttraining_tpu.obs import live as jlive  # noqa: E402
from neuroimagedisttraining_tpu.obs import xtrace as jxtrace  # noqa: E402
from neuroimagedisttraining_torch.comm.message import Message  # noqa: E402
from neuroimagedisttraining_torch.fed import wire  # noqa: E402
from neuroimagedisttraining_torch.obs import live, xtrace  # noqa: E402

TREE = {"conv": {"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7},
        "head": [np.linspace(-1, 1, 5).astype(np.float32)]}


def _msgs(impl):
    j = JMessage("fed_update", 1, 0)
    jwire.encode_update(j, TREE, impl, density=0.5)
    t = Message("fed_update", 1, 0)
    wire.encode_update(t, TREE, impl, density=0.5)
    for m in (j, t):
        m.add("n_sum", 16.0)
    return j, t


def _hb(mod):
    hb = mod.HeartbeatConfig("site1", 0.5)
    hb.note_round(3)
    hb.note("train_loss", 1.25)
    hb.note("ignored_str", "nope")
    hb.note("ignored_bool", True)
    return hb


@pytest.mark.parametrize("impl", wire.WIRE_IMPLS)
def test_headers_ride_the_frame_as_the_reference(impl):
    j, t = _msgs(impl)
    assert j.to_bytes() == t.to_bytes()  # off: no header, same bytes
    assert xtrace.extract(t) is None and live.extract_heartbeat(t) is None
    jxtrace.inject(j, jxtrace.TraceContext("r4", "aggregator:7"),
                   wall_ns=123456789)
    xtrace.inject(t, xtrace.TraceContext("r4", "aggregator:7"),
                  wall_ns=123456789)
    jlive.inject_heartbeat(j, _hb(jlive))
    live.inject_heartbeat(t, _hb(live))
    assert j.to_bytes() == t.to_bytes()
    back = Message.from_bytes(j.to_bytes())
    assert xtrace.extract(back) == ("r4", "aggregator:7")
    assert xtrace.send_wall_ns(back) == 123456789
    assert live.extract_heartbeat(back) == jlive.extract_heartbeat(
        JMessage.from_bytes(t.to_bytes()))
    np.testing.assert_array_equal(
        wire.decode_update(back)["conv"]["w"],
        wire.decode_update(Message.from_bytes(_msgs(impl)[1].to_bytes()))
        ["conv"]["w"])


def _spans(mod, process):
    tr = mod.XTracer(process, ref="aggregator")
    with mod.xspan(tr, "fed_round", trace_id="r0", args={"round": 0}):
        with mod.xspan(tr, "dispatch", args={"sites": 2}) as d:
            ctx = d.ctx()
        with mod.xspan(tr, "collect"):
            pass
    with mod.xspan(tr, "site_round", trace_id=ctx.trace_id,
                   parent=ctx.span_id):
        with mod.xspan(tr, "train"):
            pass
    assert mod.xspan(None, "off") is mod._NULL_XSPAN
    tr.note_offset("site1", 2500.0, 40.0)
    return tr


def test_span_structure_and_merge_as_the_reference():
    t, j = _spans(xtrace, "aggregator"), _spans(jxtrace, "aggregator")
    td, jd = t.to_doc(), j.to_doc()
    assert xtrace.structure_of(td) == jxtrace.structure_of(jd)
    assert xtrace.validate_parentage(td) == jxtrace.validate_parentage(jd) \
        == []
    # the same streams merge to the same bytes, lanes shifted by offset
    site = _spans(jxtrace, "site1").to_doc()
    docs = [json.loads(json.dumps(d)) for d in (jd, site)]
    got = json.dumps(xtrace.merge_docs(docs), sort_keys=True)
    want = json.dumps(jxtrace.merge_docs(docs), sort_keys=True)
    assert got == want
    assert sorted(xtrace.span_index(td)) == sorted(jxtrace.span_index(jd))
    assert xtrace.ntp_offset(100, 260, 300) == jxtrace.ntp_offset(100, 260,
                                                                  300)
    assert xtrace.ntp_offset(100, 260, 300) == (60.0, 200.0)


def test_merge_run_dir_writes_the_merged_trace(tmp_path):
    for proc in ("aggregator", "site1", "site2"):
        _spans(xtrace, proc).write(str(tmp_path / (proc
                                                   + xtrace.STREAM_SUFFIX)))
    path = xtrace.merge_run_dir(str(tmp_path))
    doc = json.load(open(path))
    assert doc["xtrace"]["processes"] == ["aggregator", "site1", "site2"]
    assert xtrace.merge_run_dir(str(tmp_path / "none")) is None


def _drive(mod):
    led = mod.FleetLedger(0.5)
    for k in (1, 2, 3):
        led.register(f"site{k}", 0.0)
    records = []
    clock = [(0.4, "site1", 0), (0.9, "site2", 0), (1.2, "site1", 1),
             (2.0, None, None), (3.4, None, None), (3.6, "site3", 2),
             (4.0, "site1", 2)]
    for now, peer, rnd in clock:
        led.note_round(rnd if rnd is not None else led.round)
        evs = led.tick(now) if peer is None else led.observe(
            peer, now, round_idx=rnd, gauges={"train_loss": 0.5 * (rnd + 1),
                                             "bad": "x"})
        evs += led.tick(now)
        records += [e.to_record() for e in evs]
    return led, records


def test_fleet_ledger_as_the_reference():
    (t, t_ev), (j, j_ev) = _drive(live), _drive(jlive)
    assert t_ev == j_ev
    assert {e["event_type"] for e in t_ev} == {"SITE_DOWN", "SITE_RECOVERED"}
    assert t.snapshot(4.5) == j.snapshot(4.5)
    assert t.states() == j.states()
    assert t.fleet_gauges(4.5) == j.fleet_gauges(4.5)
    assert tuple(live.fleet_gauge_keys()) == tuple(jlive.fleet_gauge_keys())
    snap = t.snapshot(4.5)
    for kw in ({}, {"color": True, "slo_health": "degraded"}):
        assert live.render_frame(snap, **kw) == jlive.render_frame(snap, **kw)
    with pytest.raises(ValueError):
        live.FleetLedger(0.0)
    with pytest.raises(ValueError):
        live.FleetLedger(1.0, suspect_after=6.0, down_after=3.0)
    with pytest.raises(ValueError):
        live.HeartbeatConfig("x", 0.0)


def _argv(tmp_path, sub, *extra):
    return ["--algo", "fedavg", "--model", "small3dcnn", "--dataset",
            "synthetic", "--client_num_in_total", "6", "--frac", "1.0",
            "--batch_size", "8", "--epochs", "1", "--comm_round", "2",
            "--lr", "0.05", "--final_finetune", "0", "--device", "cpu",
            "--fed_role", "aggregator", "--fed_mode", "sync",
            "--fed_sites", "2", "--log_dir", str(tmp_path / sub / "log"),
            "--results_dir", str(tmp_path / sub / "res")] + list(extra)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_traced_federation_closes_its_tree_and_stays_bitwise(tmp_path,
                                                             one_thread):
    from neuroimagedisttraining_torch.experiments import runner

    on = runner.main(_argv(tmp_path, "on", "--xtrace", "1",
                           "--obs_heartbeat_every", "0.05"))
    off = runner.main(_argv(tmp_path, "off"))
    for k, v in off["global_params"].items():
        np.testing.assert_array_equal(on["global_params"][k], v)
    fed = on["fed"]
    doc = json.load(open(fed["merged_trace"]))
    assert xtrace.validate_parentage(doc) == []
    names = xtrace.structure_of(doc)["names"]
    for name in ("fed_round", "dispatch", "collect", "combine",
                 "site_round", "train", "encode", "finish", "site_finish"):
        assert names.get(name, 0) >= 1, (name, names)
    assert doc["xtrace"]["processes"] == ["aggregator", "site1", "site2"]
    rounds = [r for r in on["history"] if r["round"] >= 0]
    assert all(r["fed_round_ms"] > 0 for r in rounds)
    assert sorted(p["peer"] for p in fed["fleet"]["peers"]) == [
        "site1", "site2"]
    assert all(p["frames"] >= 2 for p in fed["fleet"]["peers"])
    assert "fed_round_ms" not in off["history"][0]
